"""The port's Mamba2 (SSD) block against the JAX package's, in f32.

The same inputs, made from a numpy seed, go through both packages; the
parameters are the reference's init bridged bit for bit. The tolerance is
that of the reference's own chunk tests (tests/test_ssm_blocks.py): rtol =
atol = 1e-4 (f32, summation order only). The conv's bf16 activation times
its f32 weight promotes to f32 in both frameworks, checked in bf16 too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import mamba2 as jm2
from repro.models.layers import RuntimeCfg as JRt
from repro_torch import bridge
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.models import mamba2 as tm2
from repro_torch.models.layers import RuntimeCfg as TRt

CFG = get_reduced("zamba2-1.2b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _params(seed=1):
    p = jm2.init_mamba2(jax.random.PRNGKey(seed), CFG, jnp.float32)
    tree = jax.tree.map(np.asarray, p)
    return p, {k: bridge.to_torch(v) for k, v in tree.items()}


@pytest.mark.parametrize("chunks", [1, 4])
def test_ssd_chunk_matches_jax(chunks):
    """The chunk step carried over ``chunks`` chunks of a 32-token input:
    outputs and the carried state."""
    rng = np.random.default_rng(chunks)
    b, S, nh, hp, N = 2, 32, 3, 4, 5
    Lc = S // chunks
    xh, B, C = _np(rng, b, S, nh, hp), _np(rng, b, S, N), _np(rng, b, S, N)
    dt = np.log1p(np.exp(_np(rng, b, S, nh)))
    dA = -np.log1p(np.exp(_np(rng, b, S, nh)))
    h0 = _np(rng, b, nh, hp, N)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for i in range(chunks):
        sl = slice(i * Lc, (i + 1) * Lc)
        args = (xh[:, sl], dt[:, sl], np.cumsum(dA[:, sl], axis=1),
                B[:, sl], C[:, sl])
        jy, jh = jm2._ssd_chunk(*map(jnp.asarray, args), jh)
        ty, th = tm2._ssd_chunk(*map(torch.from_numpy, args), th)
        _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv1d_causal_matches_jax(with_state, dtype):
    rng = np.random.default_rng(2)
    x, w = _np(rng, 2, 5, 12), _np(rng, 4, 12)
    state = _np(rng, 2, 3, 12) if with_state else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(jdt)
    tx = bridge.to_torch(np.asarray(jx))
    jout, jst = jm2._conv1d_causal(
        jx, jnp.asarray(w), None if state is None else jnp.asarray(state))
    tout, tst = tm2._conv1d_causal(
        tx, torch.from_numpy(w),
        None if state is None else torch.from_numpy(state))
    assert tout.dtype == torch.float32 and jout.dtype == jnp.float32
    assert str(tst.dtype).split(".")[-1] == str(jst.dtype)
    _close(tout, jout)
    _close(tst, np.asarray(jst.astype(jnp.float32)))


@pytest.mark.parametrize("s,chunk", [(32, 256), (64, 16), (2, 256)])
def test_block_with_state_matches_jax(s, chunk):
    """Prefill over one chunk, four chunks, and a 2-token prompt (its conv
    state keeps 2 rows, as the reference's does): output, ssm state, conv
    state."""
    jp, tp = _params()
    x = _np(np.random.default_rng(s), 2, s, CFG.d_model)
    jout, (jh, jconv) = jm2.mamba2_block_with_state(
        jnp.asarray(x), jp, CFG, JRt(ssm_chunk=chunk,
                                     act_dtype=jnp.float32))
    tcfg = t_get_reduced("zamba2-1.2b")
    tout, (th, tconv) = tm2.mamba2_block_with_state(
        torch.from_numpy(x), tp, tcfg, TRt(ssm_chunk=chunk,
                                           act_dtype=torch.float32))
    _close(tout, jout)
    _close(th, jh)
    assert tconv.shape == jconv.shape == (2, min(s, 3), CFG.ssm_d_inner
                                          + 2 * CFG.ssm_state)
    _close(tconv, jconv)
    _close(tm2.mamba2_block(torch.from_numpy(x), tp, tcfg,
                            TRt(ssm_chunk=chunk, act_dtype=torch.float32)),
           jout)


def test_prompt_not_a_multiple_of_the_chunk_is_refused_as_in_jax():
    jp, tp = _params()
    x = _np(np.random.default_rng(0), 1, 33, CFG.d_model)
    with pytest.raises(AssertionError):
        jm2.mamba2_block(jnp.asarray(x), jp, CFG,
                         JRt(act_dtype=jnp.float32))
    with pytest.raises(AssertionError):
        tm2.mamba2_block(torch.from_numpy(x), tp, CFG,
                         TRt(act_dtype=torch.float32))


def test_decode_matches_jax():
    """Three steps from a random state: outputs and both state leaves."""
    jp, tp = _params(3)
    rng = np.random.default_rng(4)
    h, conv = jm2.init_mamba2_state(2, CFG)
    h0, c0 = _np(rng, *h.shape), _np(rng, *conv.shape)
    jst = (jnp.asarray(h0), jnp.asarray(c0))
    tst = (torch.from_numpy(h0), torch.from_numpy(c0))
    for _ in range(3):
        x = _np(rng, 2, 1, CFG.d_model)
        jout, jst = jm2.mamba2_decode(jnp.asarray(x), jp, CFG, jst,
                                      JRt(act_dtype=jnp.float32))
        tout, tst = tm2.mamba2_decode(torch.from_numpy(x), tp, CFG, tst,
                                      TRt(act_dtype=torch.float32))
        _close(tout, jout)
        _close(tst[0], jst[0])
        _close(tst[1], jst[1])


def test_decode_leaves_the_given_state_as_it_was():
    _, tp = _params()
    h, conv = tm2.init_mamba2_state(2, CFG)
    h += 1.0
    keep = (h.clone(), conv.clone())
    x = torch.randn((2, 1, CFG.d_model), generator=torch.Generator()
                    .manual_seed(0))
    _, (h2, conv2) = tm2.mamba2_decode(x, tp, CFG, (h, conv),
                                       TRt(act_dtype=torch.float32))
    assert torch.equal(h, keep[0]) and torch.equal(conv, keep[1])
    assert h2 is not h and conv2 is not conv


def test_init_shapes_and_types_match_jax():
    jp = jm2.init_mamba2(jax.random.PRNGKey(0), CFG, jnp.bfloat16)
    tp = tm2.init_mamba2(CFG, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == jp[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(jp[name].dtype), name
    for name in ("A_log", "dt_bias", "D"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    for t, j in zip(tm2.init_mamba2_state(3, CFG),
                    jm2.init_mamba2_state(3, CFG)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
