"""Kernel C's plain version, the reference oracle and the wrapper's routing
against the JAX package's paged flash-decode kernel.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernel runs in interpret mode. Rows with no valid position (a slot
with no pages, a slot whose length is 0) are part of every input: there
the kernel and the port's plain version give 0, while both packages'
gather-then-softmax oracles give the mean of the V rows they gathered.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import execution as jex
from repro.kernels.paged_attention import (
    paged_attention_reference as j_reference,
    paged_flash_decode_pallas)
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import registry

# JAX's own kernel-vs-reference tolerance (tests/test_paging.py)
TOL = 2e-5


def _inputs(dtype, B=5, h=4, kvh=2, hd=16, ps=8, mp=4, seed=0):
    """Slots: a partial table, a full one, one page holding one token, no
    pages at all, and a page but length 0."""
    rng = np.random.default_rng(seed)
    pool = B * mp + 1
    q = rng.normal(size=(B, h, hd)).astype(np.float32)
    k = rng.normal(size=(pool, ps, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(pool, ps, kvh, hd)).astype(np.float32)
    pm = np.full((B, mp), -1, np.int32)
    pm[0, :2] = [5, 9]
    pm[1, :4] = [0, 1, 2, 3]
    pm[2, :1] = [7]
    pm[4, :1] = [11]
    lengths = np.array([13, 32, 1, 0, 0], np.int32)[:B]
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tx = [bridge.to_torch(np.asarray(a)) for a in jx]
    return (jx + [jnp.asarray(pm), jnp.asarray(lengths)],
            tx + [torch.from_numpy(pm), torch.from_numpy(lengths)])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_kernel(dtype):
    jargs, targs = _inputs(dtype)
    want = np.asarray(paged_flash_decode_pallas(*jargs, interpret=True))
    got = pa.paged_flash_decode_plain(*targs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert (want[3:] == 0).all() and (got[3:] == 0).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_kernel_at_other_geometries(dtype):
    """Page size 16 and 32, head_dim 32 and 128, 4 query heads per kv."""
    for ps, hd, h, kvh in ((16, 32, 4, 2), (32, 128, 8, 2)):
        jargs, targs = _inputs(dtype, ps=ps, hd=hd, h=h, kvh=kvh, seed=ps)
        want = np.asarray(paged_flash_decode_pallas(*jargs, interpret=True))
        np.testing.assert_allclose(pa.paged_flash_decode_plain(*targs)
                                   .numpy(), want, rtol=TOL, atol=TOL)


def test_reference_matches_jax_reference_on_every_row():
    """Non-empty rows agree with the kernel; the empty ones take the
    reference's uniform softmax (the gather-mean), in both packages."""
    jargs, targs = _inputs(jnp.float32)
    want = np.asarray(j_reference(*jargs))
    got = pa.paged_attention_reference(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(got[3:]).max() > 0.05          # the gather-mean, not 0
    plain = pa.paged_flash_decode_plain(*targs).numpy()
    np.testing.assert_allclose(got[:3], plain[:3], rtol=TOL, atol=TOL)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    _, targs = _inputs(jnp.bfloat16)
    before = pa.LAUNCHES
    got = pa.paged_decode_attention(*targs)
    assert pa.LAUNCHES == before
    assert torch.equal(got, pa.paged_flash_decode_plain(*targs))

    class Tracer:
        def __init__(self):
            self.events = []

        def record(self, kind, **kw):
            self.events.append((kind, kw))

    tr = Tracer()
    pa.paged_decode_attention(*targs, tracer=tr)
    (kind, kw), = tr.events
    assert kind == "paged_attn" and kw["backend"] == "hopper_paged"
    assert kw["meta"] == {"page_size": 8, "pages": 21}


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    _, targs = _inputs(jnp.float32)
    meta = [t.to("meta") for t in targs]
    with pytest.raises(ValueError):
        pa.paged_flash_decode(*meta)
    with pytest.raises(ValueError):
        pa.paged_flash_decode(targs[0][:, :3], *targs[1:])


def test_hopper_paged_backend_is_registered():
    assert "hopper_paged" in registry.available_backends()
    be = registry.get_backend("hopper_paged")
    assert "paged" in be.description
    assert be.dense is registry.get_backend("hopper").dense
    pol = tex.parse_policy("bf16:dense:pallas_paged")
    assert pol.backend == "hopper_paged"
    assert jex.parse_policy("bf16:dense:pallas_paged").backend == \
        "pallas_paged"


def test_sweep_records_parse_and_fill_the_block_cache(monkeypatch):
    monkeypatch.setattr(tex, "BLOCK_CACHE", tex.BlockShapeCache())
    before = pa.LAUNCHES
    recs = pa.sweep_paged_tilings(batch=2, seq=32, head_dim=16,
                                  page_sizes=[8, 16, 12], iters=1,
                                  record_cache=False, device="cpu")
    assert pa.LAUNCHES == before
    assert len(recs) == 2                        # 32 % 12 != 0: skipped
    for rec, ps in zip(recs, (8, 16)):
        m, n, k, prec, blocks = tex.parse_pagedsweep_name(rec.name)
        assert (m, n, k, prec, blocks) == (2, 32, 16, "bf16", (1, ps, 16))
        assert jex.parse_pagedsweep_name(rec.name) == (m, n, k, prec, blocks)
        assert rec.derived["page_size"] == ps and rec.us_per_call > 0
        assert rec.derived["kernel"] == "paged_flash_decode"
    assert (2, 16, 32, "bf16") not in tex.BLOCK_CACHE.entries()
    recs = pa.sweep_paged_tilings(batch=2, seq=32, head_dim=16,
                                  page_sizes=[8, 16], iters=1,
                                  device="cpu")
    best = min(recs, key=lambda r: r.us_per_call)
    blocks, secs = tex.BLOCK_CACHE.entries()[(2, 16, 32, "bf16")]
    assert blocks == (1, best.derived["page_size"], 16)
    assert secs == pytest.approx(best.us_per_call * 1e-6)
    assert tex.BLOCK_CACHE.lookup(2, 16, 32, "bf16") == blocks
