"""The MoE layer against the JAX package: the top-k router with capacity
(einsum and gather dispatch), the layer itself under each policy (granite's
fine-grained experts and llama4-scout's top-1 with its shared expert), its
group-size check, the batched expert GEMM's plain path and fp8 scales, and
prefill + decode logits of both reduced MoE stacks.

Inputs come from a numpy seed and the params from the JAX init bridged
through numpy; tolerances are tests/test_moe.py's where the quantity is
the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.core import fp8 as jfp8
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro.models.layers import RuntimeCfg as JRt
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core import fp8 as tfp8
from repro_torch.kernels import registry
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import RuntimeCfg as TRt

import test_torch_local_attention as local

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]


def _cfg(arch):
    return get_reduced(arch)


def _logits(cfg, G, gs, seed=0):
    return np.random.default_rng(seed).normal(
        size=(G, gs, cfg.num_experts)).astype(np.float32) * 2.0


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    cfg = _cfg(arch)
    for gs in (1, 4, 5, 64):
        assert tmoe.capacity(cfg, gs) == jmoe.capacity(cfg, gs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("gs", [4, 64])
def test_router_dispatch_matches_jax(arch, gs):
    """Combine weights at test_moe.py's 1e-5 / 1e-6; the dispatch mask and
    the capacity slots exactly (choice-major, then token order)."""
    cfg = _cfg(arch)
    logits = _logits(cfg, 2, gs, seed=gs)
    cap = jmoe.capacity(cfg, gs)
    jc, jd, ja = jmoe.router_dispatch(jnp.asarray(logits), cfg, cap)
    tc, td, ta = tmoe.router_dispatch(torch.from_numpy(logits), cfg, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("gs", [4, 64])
def test_gather_dispatch_matches_jax(arch, gs):
    cfg = _cfg(arch)
    logits = _logits(cfg, 2, gs, seed=gs + 1)
    cap = jmoe.capacity(cfg, gs)
    ji, jw, ja = jmoe.gather_dispatch(jnp.asarray(logits), cfg, cap)
    ti, tw, ta = tmoe.gather_dispatch(torch.from_numpy(logits), cfg, cap)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    live = np.asarray(jw) > 0
    np.testing.assert_array_equal(ti.numpy()[live], np.asarray(ji)[live])
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)


def _layer(arch, dtype):
    cfg = _cfg(arch)
    params = j_init_params(jax.random.PRNGKey(0), cfg, dtype=dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[0]),
                      params["layers"]["b0"]["moe"])
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                  cfg)["layers"][0]["moe"]
    return cfg, jp, tp


# (JAX policy, port policy): the einsum path, the per-expert kernel path
# (one batched launch in the port), fp8 on each.
POLICIES = [("bf16:dense:jnp", "bf16:dense:torch"),
            ("bf16:dense:pallas", "bf16:dense:hopper"),
            ("fp8:dense:jnp", "fp8:dense:torch"),
            ("fp8:dense:pallas", "fp8:dense:hopper")]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jspec,tspec", POLICIES)
@pytest.mark.parametrize("gather", [False, True])
def test_moe_mlp_matches_jax_in_f32(arch, jspec, tspec, gather):
    """f32 weights and activations: the two packages differ only in the
    order of f32 sums (fp8 bytes and scales are bit-equal,
    test_torch_fp8.py), so test_moe.py's 1e-5, relative to the largest
    output (the reduced layers' outputs reach ~100 to ~800)."""
    cfg, jp, tp = _layer(arch, jnp.float32)
    x = np.random.default_rng(7).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    jrt = JRt(act_dtype=jnp.float32, param_dtype=jnp.float32,
              moe_gather_dispatch=gather, policy=jex.parse_policy(jspec))
    trt = TRt(act_dtype=torch.float32, moe_gather_dispatch=gather,
              policy=tex.parse_policy(tspec))
    jo, ja = jmoe.moe_mlp(jnp.asarray(x), jp, cfg, jrt)
    to, ta = tmoe.moe_mlp(torch.from_numpy(x), tp, cfg, trt)
    jo = np.asarray(jo)
    assert np.abs(to.numpy() - jo).max() <= 1e-5 * np.abs(jo).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_jax_in_bf16(arch):
    """bf16 on the kernel path: XLA's fused bf16 chains against PyTorch's
    per-op rounding, a few bf16 ulps (2^-8 relative each) of the largest
    output: 3e-2 of it, test_torch_transformer.py's bf16 bound on logits
    of size ~1."""
    cfg, jp, tp = _layer(arch, jnp.bfloat16)
    x = np.random.default_rng(8).normal(size=(1, 64, cfg.d_model)).astype(
        np.float32)
    jo, _ = jmoe.moe_mlp(jnp.asarray(x, jnp.bfloat16), jp, cfg,
                         JRt(policy=jex.parse_policy("bf16:dense:pallas")))
    to, _ = tmoe.moe_mlp(torch.from_numpy(x).bfloat16(), tp, cfg,
                         TRt(policy=tex.parse_policy("bf16:dense:hopper")))
    jo = np.asarray(jo, np.float32)
    worst = float(np.abs(to.float().numpy() - jo).max())
    assert worst <= 3e-2 * np.abs(jo).max(), (worst, np.abs(jo).max())


def test_shared_expert_is_added_like_jax():
    """llama4-scout's shared expert: the layer without it differs, and both
    packages add the same dense SwiGLU."""
    cfg, jp, tp = _layer("llama4-scout-17b-a16e", jnp.float32)
    assert "shared" in tp and tp["shared"]["w_gate"].dim() == 2
    x = np.random.default_rng(9).normal(size=(1, 16, cfg.d_model)).astype(
        np.float32)
    rt = TRt(act_dtype=torch.float32)
    with_shared, _ = tmoe.moe_mlp(torch.from_numpy(x), tp, cfg, rt)
    without = {k: v for k, v in tp.items() if k != "shared"}
    alone, _ = tmoe.moe_mlp(torch.from_numpy(x), without, cfg, rt)
    assert float((with_shared - alone).abs().max()) > 1e-4
    jo, _ = jmoe.moe_mlp(jnp.asarray(x), jp, cfg,
                         JRt(act_dtype=jnp.float32, param_dtype=jnp.float32))
    jo = np.asarray(jo)
    assert np.abs(with_shared.numpy() - jo).max() <= 1e-5 * np.abs(jo).max()


@pytest.mark.parametrize("tokens", [77, 100])
def test_group_size_check_raises_where_jax_does(tokens):
    """The reference asserts that the group size divides the tokens
    (moe_group_size 64 on the reduced granite): a 77-token prompt fails in
    both packages, and the port keeps the check."""
    cfg, jp, tp = _layer("granite-moe-3b-a800m", jnp.float32)
    x = np.zeros((1, tokens, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_mlp(jnp.asarray(x), jp, cfg,
                     JRt(act_dtype=jnp.float32, param_dtype=jnp.float32))
    with pytest.raises(AssertionError):
        tmoe.moe_mlp(torch.from_numpy(x), tp, cfg,
                     TRt(act_dtype=torch.float32))


@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_expert_gemm_is_each_expert_alone_bit_for_bit(precision):
    """The batched path (one launch of kernel A on the card; its plain twin
    here) gives each expert the bits the hopper backend gives that expert
    alone, with experts that received no token: zeros, no inf or NaN."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(6, 3, 64)).astype(np.float32))
    x[[1, 4]] = 0
    x = x.bfloat16()
    w = torch.from_numpy((rng.normal(size=(6, 64, 32)) / 8).astype(
        np.float32)).bfloat16()
    got = registry.hopper_experts(x, w, precision=precision)
    be = registry.get_backend("hopper")
    one = be.fp8 if precision == "fp8" else be.dense
    want = torch.stack([one(x[e], w[e]) for e in range(6)])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[[1, 4]] == 0).all())


def test_stacked_quantization_matches_jax_per_expert():
    """Each expert's fp8 bytes and inverse scale bit-equal to the
    reference's ``quantize_weight_static`` of that expert, a zero expert
    included (the 1e-12 amax floor: zero bytes, a finite scale)."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(5, 16, 24)).astype(np.float32) * 3.0
    w[2] = 0.0
    q, inv = tfp8.quantize_stack(torch.from_numpy(w))
    assert bool(torch.isfinite(inv).all())
    for e in range(5):
        jq, jinv = jfp8.quantize_weight_static(jnp.asarray(w[e]))
        np.testing.assert_array_equal(
            q[e].view(torch.uint8).numpy(),
            np.asarray(jq).view(np.uint8))
        assert np.float32(inv[e]).tobytes() == np.float32(jinv).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_sparse24_packs_the_shared_expert_but_not_the_experts(arch):
    """``pack_model_params`` packs 2-D ``w_*`` weights only: the expert
    stacks (3-D here, 4-D in the reference) and the router stay dense, the
    attention and shared-expert weights are packed, with the reference's
    bytes."""
    cfg = _cfg(arch)
    params = j_init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    jpacked = jex.pack_model_params(params)
    want = bridge.params_from_numpy(jax.tree.map(np.asarray, jpacked), cfg)
    got = tex.pack_model_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    for gl, wl in zip(got["layers"], want["layers"]):
        moe = gl["moe"]
        for key in ("w_gate", "w_up", "w_down"):
            assert not isinstance(moe[key], tex.PackedWeight)
            assert moe[key].dim() == 3
            assert torch.equal(moe[key], wl["moe"][key])
        assert not isinstance(moe["router"], tex.PackedWeight)
        assert isinstance(gl["attn"]["w_q"], tex.PackedWeight)
        assert isinstance(wl["attn"]["w_q"], tex.PackedWeight)
        assert torch.equal(gl["attn"]["w_q"].values, wl["attn"]["w_q"].values)
        if cfg.moe_shared_expert:
            for key in ("w_gate", "w_up", "w_down"):
                g, w = moe["shared"][key], wl["moe"]["shared"][key]
                assert isinstance(g, tex.PackedWeight)
                assert torch.equal(g.values, w.values)
                assert torch.equal(g.meta, w.meta)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
])
def test_moe_stack_logits_and_caches_match_in_f32(arch, jspec, tspec,
                                                  use_pallas):
    """The reduced MoE stacks, prefill (prompts of 5 and 40 tokens: one
    group each) and 4 decode steps over 2 slots (one group of 2 tokens),
    at test_torch_transformer.py's f32 tolerance. (Under fp8 the layer
    agrees to 1e-5 of its output above, but over a stack a one-ulp f32
    difference can carry a decode activation across an e4m3 rounding
    boundary, ~0.1 on the logits here; the fp8 sessions are held by their
    greedy tokens in test_torch_serve_blocks.py.)"""
    cfg = _cfg(arch)
    ps = [local._prompt(5, 0) % cfg.vocab_size,
          local._prompt(40, 1) % cfg.vocab_size]
    pairs, tc, jc = local.run_stack(cfg, ps, jnp.float32, torch.float32,
                                    jspec, tspec, use_pallas, max_len=64,
                                    steps=4)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t["pos"].numpy(), j["pos"].numpy())
        np.testing.assert_allclose(t["k"].numpy(), j["k"].numpy(),
                                   rtol=1e-4, atol=1e-4)
