"""The port's layers against the JAX package's on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import layers as jl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core import sparsity as tsp
from repro_torch.models import layers as tl

CFG = get_reduced("llama3-8b")


def _arr(shape, seed, dtype=jnp.float32, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a * scale).astype(dtype)
    return j, bridge.to_torch(np.asarray(j))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-6),
                                       (jnp.bfloat16, 1e-2)])
def test_rms_norm(dtype, tol):
    jx, tx = _arr((2, 5, 128), 0, dtype, 3.0)
    jg, tg = _arr((128,), 1, jnp.float32, 0.1)
    _close(tl.rms_norm(tx, tg, CFG.norm_eps), jl.rms_norm(jx, jg, CFG.norm_eps),
           tol)


def test_apply_rope_sequence_and_per_slot_positions():
    jx, tx = _arr((2, 6, 4, 32), 2)
    pos = np.arange(6)
    _close(tl.apply_rope(tx, torch.from_numpy(pos), CFG.rope_theta),
           jl.apply_rope(jx, jnp.asarray(pos), CFG.rope_theta), 1e-5)
    # decode: one token per slot, each at its own position (B, 1)
    jq, tq = _arr((3, 1, 4, 32), 3)
    posb = np.array([[0], [17], [300]])
    _close(tl.apply_rope(tq, torch.from_numpy(posb), CFG.rope_theta),
           jl.apply_rope(jq, jnp.asarray(posb), CFG.rope_theta), 1e-4)


def test_embed_tokens():
    jt, tt = _arr((64, 16), 4, jnp.bfloat16)
    tok = np.array([[3, 0, 63], [5, 5, 1]])
    assert torch.equal(tl.embed_tokens(torch.from_numpy(tok), tt),
                       bridge.to_torch(np.asarray(
                           jl.embed_tokens(jnp.asarray(tok), jt))))


@pytest.mark.parametrize("spec,dtype,tol", [
    ("bf16:dense:jnp", jnp.float32, 1e-5),
    ("bf16:dense:jnp", jnp.bfloat16, 2e-2),
    ("fp8:dense:jnp", jnp.float32, 1e-4),
    ("bf16:dense:pallas", jnp.bfloat16, 2e-2),
    ("fp8:dense:pallas", jnp.float32, 1e-4),
])
def test_swiglu_mlp(spec, dtype, tol):
    """bf16 tolerance: one bf16 rounding (2^-8) of each linear's output,
    which f32 sums in another order can put on the other side."""
    d, f = CFG.d_model, CFG.d_ff
    jx, tx = _arr((2, 3, d), 5, dtype)
    p_j, p_t = {}, {}
    for i, (name, shape) in enumerate((("w_gate", (d, f)), ("w_up", (d, f)),
                                       ("w_down", (f, d)))):
        p_j[name], p_t[name] = _arr(shape, 10 + i, dtype, d ** -0.5)
    jrt = jl.RuntimeCfg(act_dtype=dtype, policy=jex.parse_policy(spec))
    trt = tl.RuntimeCfg(act_dtype=tx.dtype, policy=tex.parse_policy(spec))
    want = jl.swiglu_mlp(jx, p_j, CFG, jrt)
    got = tl.swiglu_mlp(tx, p_t, CFG, trt)
    assert got.dtype == tx.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("spec", ["bf16:dense:jnp", "fp8:dense:pallas"])
def test_lm_logits_padded_vocab(spec):
    """The head stays bf16-dense under any precision; padding is -1e30."""
    vocab, vp = 500, 512
    jh, th = _arr((3, 128), 6, jnp.bfloat16)
    jw, tw = _arr((128, vp), 7, jnp.bfloat16, 128 ** -0.5)
    want = jl.lm_logits(jh, jw, vocab, policy=jex.parse_policy(spec))
    got = tl.lm_logits(th, tw, vocab, policy=tex.parse_policy(spec))
    assert got.dtype == torch.float32 and got.shape == (3, vp)
    assert bool((got[:, vocab:] == -1e30).all())
    _close(got, want, 1e-4)


def test_parse_policy_takes_the_jax_names():
    pol = tex.parse_policy("fp8:dense:pallas")
    assert (pol.precision, pol.sparsity, pol.backend) == \
        ("fp8", "dense", "hopper")
    assert tex.parse_policy("jnp").backend == "torch"
    assert tex.parse_policy("bf16:hopper:64x64x64").blocks == \
        {"bm": 64, "bn": 64, "bk": 64}
    pol = tex.parse_policy("bf16:sparse24:pallas_sparse24")
    assert (pol.sparsity, pol.backend) == ("sparse24", "hopper_sparse24")
    with pytest.raises(ValueError):
        tex.parse_policy("bf16:dense:tpu")


def test_policy_precedence_matches_the_reference():
    """Explicit rt.policy > scope > module default > derived switches."""
    trt = tl.RuntimeCfg(use_pallas=True)
    assert tex.policy_from(CFG, trt).backend == "hopper"
    assert tex.policy_from(CFG, tl.RuntimeCfg()).backend == "torch"
    scoped = tex.parse_policy("fp8:torch")
    with tex.policy_scope(scoped):
        assert tex.policy_from(CFG, trt) == scoped
        explicit = dataclasses.replace(trt, policy=tex.parse_policy("ref"))
        assert tex.policy_from(CFG, explicit).backend == "ref"
    cfg2, rt2 = tex.apply_policy(CFG, trt, tex.parse_policy("fp8:hopper"))
    assert cfg2.precision == "fp8" and rt2.use_pallas
    assert rt2.policy.backend == "hopper"


def test_dense_refuses_sparse24_for_now():
    """dense() under a sparse24 policy (refused until the slice that ported
    it) prunes the weight 2:4 and multiplies: equal to the pruned product,
    on the default backend as on the others."""
    _, tx = _arr((2, 16), 8)
    _, tw = _arr((16, 8), 9)
    rt = tl.RuntimeCfg(act_dtype=torch.float32,
                       policy=tex.ExecutionPolicy(sparsity="sparse24"))
    want = tx @ tsp.prune_24(tw)
    torch.testing.assert_close(tl.dense(tx, tw, CFG, rt), want)
    # a weight the 2:4 format cannot hold (K % 8) stays dense
    _, tw12 = _arr((12, 8), 10)
    _, tx12 = _arr((2, 12), 11)
    torch.testing.assert_close(tl.dense(tx12, tw12, CFG, rt), tx12 @ tw12)


SPARSE_PAIRS = [("bf16:sparse24:jnp", "bf16:sparse24:torch"),
                ("bf16:sparse24:pallas", "bf16:sparse24:hopper"),
                ("bf16:sparse24:pallas_sparse24",
                 "bf16:sparse24:hopper_sparse24"),
                ("fp8:sparse24:jnp", "fp8:sparse24:torch")]


@pytest.mark.parametrize("jspec,tspec", SPARSE_PAIRS)
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_dense_sparse24_on_unpacked_weight(jspec, tspec, dtype, tol):
    """The STE prune in dense(), then the policy's GEMM (f32 tolerance:
    summation order; fp8 quantizes the pruned weight per call)."""
    jx, tx = _arr((2, 8, 64), 12, dtype)
    jw, tw = _arr((64, 48), 13, dtype, 64 ** -0.5)
    jrt = jl.RuntimeCfg(act_dtype=dtype, policy=jex.parse_policy(jspec))
    trt = tl.RuntimeCfg(act_dtype=tx.dtype, policy=tex.parse_policy(tspec))
    got = tl.dense(tx, tw, CFG, trt)
    assert got.dtype == tx.dtype and got.shape == (2, 8, 48)
    tol = max(tol, 1e-4) if jspec.startswith("fp8") else tol
    _close(got, jl.dense(jx, jw, CFG, jrt), tol)


@pytest.mark.parametrize("jspec,tspec", SPARSE_PAIRS[:3])
def test_dense_sparse24_ste_gradient_matches_jax(jspec, tspec):
    """Straight-through: d/dw reaches every weight, pruned or not."""
    jx, tx = _arr((3, 32), 14)
    jw, tw = _arr((32, 16), 15, jnp.float32, 32 ** -0.5)
    jrt = jl.RuntimeCfg(act_dtype=jnp.float32,
                        policy=jex.parse_policy(jspec))
    trt = tl.RuntimeCfg(act_dtype=torch.float32,
                        policy=tex.parse_policy(tspec))
    jgx, jgw = jax.grad(lambda x, w: jnp.sum(jl.dense(x, w, CFG, jrt) ** 2),
                        argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    tgx, tgw = torch.autograd.grad(tl.dense(tx, tw, CFG, trt).square().sum(),
                                   (tx, tw))
    _close(tgx, jgx, 1e-5)
    _close(tgw, jgw, 1e-5)
    assert bool((tgw[tsp.prune_24(tw.detach()) == 0] != 0).any())


def test_lm_logits_under_hopper_sparse24_stays_dense():
    """The head is not pruned: hopper_sparse24 demotes to hopper."""
    vocab, vp = 500, 512
    jh, th = _arr((3, 128), 16, jnp.bfloat16)
    jw, tw = _arr((128, vp), 17, jnp.bfloat16, 128 ** -0.5)
    dense = tl.lm_logits(th, tw, vocab, policy=tex.parse_policy("hopper"))
    got = tl.lm_logits(th, tw, vocab, policy=tex.parse_policy(
        "bf16:sparse24:hopper_sparse24"))
    assert torch.equal(got, dense)
    want = jl.lm_logits(jh, jw, vocab, policy=jex.parse_policy(
        "bf16:sparse24:pallas_sparse24"))
    _close(got, want, 1e-4)
