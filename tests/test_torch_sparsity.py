"""The port's 2:4 sparsity module against the JAX package's, byte for byte.

Inputs are numpy-seeded and reach both packages with the same bits
(``bridge``); every output is compared as raw bytes, so signed zeros, tie
breaks and the meta byte order must all agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro_torch import bridge
from repro_torch.core import sparsity as tsp

DTYPES = [jnp.float32, jnp.bfloat16, jnp.float8_e4m3fn, jnp.float8_e5m2]


def _jbytes(a) -> bytes:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize]
                  ).tobytes()


def _tbytes(t) -> bytes:
    return bridge.to_numpy_bits(t).tobytes()


def _weight(kind, shape, seed):
    """normal: no ties; ties: small integers (forced ties within groups);
    zeros: 40% exact zeros and 10% -0.0 among normals."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32) * 3
    if kind == "ties":
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    a = rng.normal(size=shape).astype(np.float32)
    a[rng.random(shape) < 0.4] = 0.0
    a[rng.random(shape) < 0.1] = -0.0
    return a


def _pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    return j, bridge.to_torch(np.asarray(j))


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prune_pack_unpack_are_bit_equal(kind, dtype):
    j, t = _pair(_weight(kind, (64, 40), 0), dtype)
    jp, tp = jsp.prune_24(j), tsp.prune_24(t)
    assert tp.dtype == t.dtype
    assert _tbytes(tp) == _jbytes(jp)
    assert bool(tsp.check_24(tp)) and bool(jsp.check_24(jp))
    jv, jm = jsp.pack_24(jp)
    tv, tm = tsp.pack_24(tp)
    assert tv.shape == (32, 40) and tm.shape == (8, 40)
    assert tm.dtype == torch.uint8
    assert _tbytes(tv) == _jbytes(jv)
    assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
    np.testing.assert_array_equal(tsp.unpack_meta(tm).numpy(),
                                  np.asarray(jsp.unpack_meta(jm)))
    assert _tbytes(tsp.unpack_24(tv, tm)) == _jbytes(jsp.unpack_24(jv, jm))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float8_e4m3fn])
def test_prune_keeps_the_reference_signed_zeros(dtype):
    """A pruned negative value is -0.0 in bf16 and fp8 (the reference
    multiplies by the mask); in f32 the reference's XLA selects, +0.0."""
    col = np.array([-3, 1, -2, -0.5, 0, 0, 5, 0], np.float32)[:, None]
    for dt, neg in ((dtype, True), (jnp.float32, False)):
        _, t = _pair(col, dt)
        pruned = tsp.prune_24(t).float().numpy()[:, 0]
        assert pruned[1] == 0 and pruned[3] == 0
        assert bool(np.signbit(pruned[3])) == neg
        assert not np.signbit(pruned[1])


def test_pack_lists_nonzeros_first():
    """A group whose only nonzero sits at slot 2 packs as (2, 0)."""
    col = np.array([-3, 1, -2, -0.5, 0, 0, 5, 0], np.float32)[:, None]
    values, meta = tsp.pack_24(tsp.prune_24(torch.from_numpy(col)))
    assert int(meta[0, 0]) == 40      # (0, 2) | (2, 0) << 4
    assert values[:, 0].tolist() == [-3.0, -2.0, 5.0, 0.0]
    jv, jm = jsp.pack_24(jsp.prune_24(jnp.asarray(col)))
    assert int(np.asarray(jm)[0, 0]) == 40


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_never_names_one_slot_twice(kind, dtype):
    """Kernel D moves each value's bits to the slot its position names; a
    pack whose two positions in a group coincide would need the reference's
    sum instead. Neither package's pack_24 makes one, all-zero groups
    included (their positions come from a sort of distinct keys)."""
    a = _weight(kind, (64, 40), 3)
    a[:8] = 0.0
    j, t = _pair(a, dtype)
    for meta in (tsp.pack_24(tsp.prune_24(t))[1].numpy(),
                 np.asarray(jsp.pack_24(jsp.prune_24(j))[1])):
        pos = [(meta >> s) & 3 for s in (0, 2, 4, 6)]
        assert (pos[0] != pos[1]).all() and (pos[2] != pos[3]).all()


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16,
                                   jnp.float8_e4m3fn])
@pytest.mark.parametrize("block", [4, 16])
def test_prune_block24_is_bit_equal(kind, dtype, block):
    j, t = _pair(_weight(kind, (8 * block, 24), 1), dtype)
    jw, jk = jsp.prune_block24(j, block=block)
    tw, tk = tsp.prune_block24(t, block=block)
    assert _tbytes(tw) == _jbytes(jw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert int(tk.sum()) == 4


@pytest.mark.parametrize("vdtype", [jnp.bfloat16, jnp.float8_e4m3fn])
def test_sparse24_oracle_matches(vdtype):
    jx, tx = _pair(_weight("normal", (2, 3, 64), 2), jnp.bfloat16)
    jw, tw = _pair(_weight("normal", (64, 24), 3), vdtype)
    jv, jm = jsp.pack_24(jsp.prune_24(jw))
    tv, tm = tsp.pack_24(tsp.prune_24(tw))
    want = jsp.sparse24_matmul_ref(jx, jv, jm, out_dtype=jnp.float32)
    got = tsp.sparse24_matmul_ref(tx, tv, tm, out_dtype=torch.float32)
    assert got.shape == (2, 3, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_block24_oracle_matches():
    jx, tx = _pair(_weight("normal", (5, 256), 4), jnp.bfloat16)
    jw, tw = _pair(_weight("normal", (256, 24), 5), jnp.bfloat16)
    jwp, jk = jsp.prune_block24(jw, block=32)
    twp, tk = tsp.prune_block24(tw, block=32)
    want = jsp.block24_matmul_ref(jx, jwp, jk, block=32,
                                  out_dtype=jnp.float32)
    got = tsp.block24_matmul_ref(tx, twp, tk, block=32,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_byte_accounting_matches():
    for k, n in ((4096, 14336), (64, 8)):
        for jdt, tdt in ((jnp.float8_e4m3fn, torch.float8_e4m3fn),
                         (jnp.bfloat16, torch.bfloat16)):
            assert tsp.packed_bytes(k, n, tdt) == jsp.packed_bytes(k, n, jdt)
            assert tsp.dense_bytes(k, n, tdt) == jsp.dense_bytes(k, n, jdt)
    assert tsp.packed_bytes(4096, 14336, torch.bfloat16) \
        == 0.5625 * tsp.dense_bytes(4096, 14336)


def test_shape_checks():
    with pytest.raises(ValueError):
        tsp.prune_24(torch.zeros((6, 4)))
    with pytest.raises(ValueError):
        tsp.pack_24(torch.zeros((12, 4)))
    with pytest.raises(ValueError):
        tsp.prune_block24(torch.zeros((64, 4)), block=32)
