"""The port's RWKV-6 block against the JAX package's, in f32.

The same inputs, made from a numpy seed, go through both packages; the
parameters are the reference's init bridged bit for bit. The tolerance is
that of the reference's own chunk tests (tests/test_ssm_blocks.py): rtol =
atol = 1e-4. A strong-decay chunk checks the pairwise decay exponent: the
factorized form would overflow f32 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import rwkv6 as jrk
from repro.models.layers import RuntimeCfg as JRt
from repro_torch import bridge
from repro_torch.models import rwkv6 as trk
from repro_torch.models.layers import RuntimeCfg as TRt

CFG = get_reduced("rwkv6-3b")
TOL = dict(rtol=1e-4, atol=1e-4)
JRT, TRT = JRt(act_dtype=jnp.float32), TRt(act_dtype=torch.float32)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _params(seed=1, perturb=True):
    """The reference init, with u and the mixes moved off their constant
    init values so every term is exercised."""
    p = jrk.init_rwkv6(jax.random.PRNGKey(seed), CFG, jnp.float32)
    tree = {k: np.asarray(v) for k, v in p.items()}
    if perturb:
        rng = np.random.default_rng(seed)
        for k in tree:
            if k == "u" or k.startswith("mu_"):
                tree[k] = tree[k] + 0.3 * _np(rng, *tree[k].shape)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: bridge.to_torch(v) for k, v in tree.items()})


@pytest.mark.parametrize("case", ["one_chunk", "four_chunks",
                                  "strong_decay"])
def test_wkv_chunk_matches_jax(case):
    """32 tokens as one chunk or four, carrying the state; and one chunk
    whose decay w = exp(-exp(4)) ~ 1e-24 per step, where a factorized
    exponent overflows: finite and equal to JAX's."""
    rng = np.random.default_rng(len(case))
    b, S, nh, hd = 2, 32, 3, 8
    chunks = 4 if case == "four_chunks" else 1
    Lc = S // chunks
    r, k, v = _np(rng, b, S, nh, hd), _np(rng, b, S, nh, hd), \
        _np(rng, b, S, nh, hd)
    wlog = 4.0 + 0 * _np(rng, b, S, nh, hd) if case == "strong_decay" \
        else 0.5 * _np(rng, b, S, nh, hd)
    w = np.exp(-np.exp(wlog)).astype(np.float32)
    u = _np(rng, nh, hd)
    S0 = _np(rng, b, nh, hd, hd)
    jS, tS = jnp.asarray(S0), torch.from_numpy(S0)
    for i in range(chunks):
        sl = slice(i * Lc, (i + 1) * Lc)
        args = (r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)
        jy, jS = jrk._wkv_chunk(*map(jnp.asarray, args), jS)
        ty, tS = trk._wkv_chunk(*map(torch.from_numpy, args), tS)
        assert bool(torch.isfinite(ty).all())
        _close(ty, jy)
    _close(tS, jS)


@pytest.mark.parametrize("with_prev", [False, True])
def test_token_shift_matches_jax(with_prev):
    rng = np.random.default_rng(0)
    x, prev = _np(rng, 2, 5, 8), _np(rng, 2, 1, 8)
    want = jrk._token_shift(jnp.asarray(x),
                            jnp.asarray(prev) if with_prev else None)
    got = trk._token_shift(torch.from_numpy(x),
                           torch.from_numpy(prev) if with_prev else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,chunk", [(32, 256), (64, 16), (1, 256)])
def test_block_with_state_matches_jax(s, chunk):
    """Prefill as one chunk, four chunks, and one token: output, the wkv
    state and the carried last row."""
    jp, tp = _params()
    x = _np(np.random.default_rng(s), 2, s, CFG.d_model)
    jout, (jS, jprev) = jrk.rwkv6_block_with_state(
        jnp.asarray(x), jp, CFG, JRt(ssm_chunk=chunk, act_dtype=jnp.float32))
    tout, (tS, tprev) = trk.rwkv6_block_with_state(
        torch.from_numpy(x), tp, CFG, TRt(ssm_chunk=chunk,
                                          act_dtype=torch.float32))
    _close(tout, jout)
    _close(tS, jS)
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    _close(trk.rwkv6_block(torch.from_numpy(x), tp, CFG,
                           TRt(ssm_chunk=chunk, act_dtype=torch.float32)),
           jout)


def test_prompt_not_a_multiple_of_the_chunk_is_refused_as_in_jax():
    jp, tp = _params()
    x = _np(np.random.default_rng(0), 1, 33, CFG.d_model)
    with pytest.raises(AssertionError):
        jrk.rwkv6_block(jnp.asarray(x), jp, CFG, JRT)
    with pytest.raises(AssertionError):
        trk.rwkv6_block(torch.from_numpy(x), tp, CFG, TRT)


@pytest.mark.parametrize("decode", [False, True])
def test_channel_mix_matches_jax(decode):
    jp, tp = _params(2)
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 1 if decode else 6, CFG.d_model)
    if decode:
        prev = _np(rng, 2, 1, CFG.d_model)
        jout, jnew = jrk.rwkv6_channel_mix_decode(
            jnp.asarray(x), jp, CFG, jnp.asarray(prev), JRT)
        tout, tnew = trk.rwkv6_channel_mix_decode(
            torch.from_numpy(x), tp, CFG, torch.from_numpy(prev), TRT)
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    else:
        jout = jrk.rwkv6_channel_mix(jnp.asarray(x), jp, CFG, JRT)
        tout = trk.rwkv6_channel_mix(torch.from_numpy(x), tp, CFG, TRT)
    _close(tout, jout)


def test_decode_matches_jax():
    """Three one-token steps from a random state: output, S and the
    carried input row."""
    jp, tp = _params(3)
    rng = np.random.default_rng(6)
    nh, hd = CFG.d_model // CFG.ssm_head_dim, CFG.ssm_head_dim
    S0, prev = _np(rng, 2, nh, hd, hd), _np(rng, 2, 1, CFG.d_model)
    jst = (jnp.asarray(S0), jnp.asarray(prev))
    tst = (torch.from_numpy(S0), torch.from_numpy(prev))
    for _ in range(3):
        x = _np(rng, 2, 1, CFG.d_model)
        jout, jst = jrk.rwkv6_decode(jnp.asarray(x), jp, CFG, jst, JRT)
        tout, tst = trk.rwkv6_decode(torch.from_numpy(x), tp, CFG, tst, TRT)
        _close(tout, jout)
        _close(tst[0], jst[0])
        np.testing.assert_array_equal(tst[1].numpy(), np.asarray(jst[1]))


def test_decode_continues_the_prefill_as_jax_does():
    """Prefill 8 tokens, then decode the 9th from the prefill's state:
    the port's step equals JAX's on the same state."""
    jp, tp = _params(4)
    x = _np(np.random.default_rng(7), 1, 9, CFG.d_model)
    _, (jS, jprev) = jrk.rwkv6_block_with_state(jnp.asarray(x[:, :8]), jp,
                                                CFG, JRT)
    _, (tS, tprev) = trk.rwkv6_block_with_state(torch.from_numpy(x[:, :8]),
                                                tp, CFG, TRT)
    jout, _ = jrk.rwkv6_decode(jnp.asarray(x[:, 8:]), jp, CFG, (jS, jprev),
                               JRT)
    tout, _ = trk.rwkv6_decode(torch.from_numpy(x[:, 8:]), tp, CFG,
                               (tS, tprev), TRT)
    _close(tout, jout)


def test_init_shapes_and_types_match_jax():
    jp = jrk.init_rwkv6(jax.random.PRNGKey(0), CFG, jnp.bfloat16)
    tp = trk.init_rwkv6(CFG, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == jp[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(jp[name].dtype), name
        if t.dtype == torch.float32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(jp[name]))
