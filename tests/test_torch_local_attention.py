"""Local/global attention (gemma3's 5 local : 1 global stack) against the
JAX package: the single-token decode attention, the rolling-window cache
built at prefill, and prefill + decode logits and caches of the reduced
gemma3 (window 64) with prompts shorter and longer than the window, so that
the window rolls at prefill and decode wraps it.

Both stacks run from the same JAX init (bridged bit for bit) and take the
same tokens (the JAX argmax), so every step compares like with like.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import attention as jattn
from repro.models import decode_step as j_decode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models import transformer as jtf
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime.serve_loop import _write_slot_cache
from repro_torch import bridge
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import execution as tex
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime.serve_loop import _write_slot_cache as t_write

CFG = get_reduced("gemma3-12b")
WINDOW = CFG.window_size                       # 64
MAX_LEN, STEPS = 128, 4


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(n,)).astype(np.int32)


def test_port_config_is_the_reference_config():
    t = t_get_reduced("gemma3-12b")
    assert t.superlayer_pattern == CFG.superlayer_pattern == \
        ("attn_local",) * 5 + ("attn_global",)
    assert tt.layer_kinds(t) == list(CFG.superlayer_pattern)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("cache_len", [3, 12, 16])
def test_decode_attention_matches_jax(window, cache_len):
    rng = np.random.default_rng(cache_len + window)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), cache_len, window=window)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), cache_len,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_block_matches_jax(window):
    params = j_init_params(jax.random.PRNGKey(1), CFG, dtype=jnp.float32)
    p = jax.tree.map(lambda a: np.array(a[0]),
                     params["layers"]["b0"]["attn"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, CFG.d_model)).astype(np.float32)
    kc = rng.normal(size=(2, 10, CFG.num_kv_heads, CFG.head_dim)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    rt = JRt(act_dtype=jnp.float32, param_dtype=jnp.float32)
    want, (wk, wv) = jattn.decode_attention_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), CFG,
        (jnp.asarray(kc), jnp.asarray(vc)), 7, rt, window=window)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got, (gk, gv) = tattn.decode_attention_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        CFG, (tk, tv), 7, TRt(act_dtype=torch.float32), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(tk, torch.from_numpy(kc))   # the given cache stays


@pytest.mark.parametrize("s", [5, 8, 13])
def test_kv_to_cache_rolls_like_jax(s):
    """A prompt shorter than the window keeps its rows; one at least as
    long keeps its last ``window`` rows at ``p % window``."""
    rng = np.random.default_rng(s)
    k = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
    want = jtf._kv_to_cache(jnp.asarray(k), jnp.asarray(v), 8)
    got = tt._kv_to_cache(torch.from_numpy(k), torch.from_numpy(v), 8)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def run_stack(cfg, prompts, jdtype, tdtype, jspec, tspec, use_pallas,
              max_len=MAX_LEN, steps=STEPS):
    """Prefill each prompt into its slot of one batched cache, then decode
    ``steps`` steps with a position per slot, under both packages.
    Returns the (port, JAX) logits pairs and both final caches."""
    params = j_init_params(jax.random.PRNGKey(0), cfg, dtype=jdtype)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    jrt = JRt(act_dtype=jdtype, param_dtype=jdtype, use_pallas=use_pallas,
              policy=jex.parse_policy(jspec))
    trt = TRt(act_dtype=tdtype, use_pallas=use_pallas,
              policy=tex.parse_policy(tspec))
    b = len(prompts)
    jc = j_init_cache(cfg, b, max_len, dtype=jdtype)
    tc = tt.init_cache(cfg, b, max_len, dtype=tdtype)
    pairs, tokens = [], []
    for slot, prompt in enumerate(prompts):
        jl, jpc = j_prefill(params, jnp.asarray(prompt)[None], cfg, jrt)
        tl, tpc = tt.prefill(tparams, torch.from_numpy(prompt)[None].long(),
                             cfg, trt)
        jc = _write_slot_cache(jc, jpc, slot)
        t_write(tc, tpc, slot)
        pairs.append((tl[0], jl[0]))
        tokens.append(int(jnp.argmax(jl[0])))
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(steps):
        tok = np.array(tokens, np.int32)[:, None]
        jl, jc = j_decode(params, jnp.asarray(tok), jc, jnp.asarray(pos),
                          cfg, jrt)
        tl, tc = tt.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long(), cfg, trt)
        pairs.extend((tl[i], jl[i]) for i in range(b))
        tokens = [int(t) for t in jnp.argmax(jl, axis=-1)]
        pos = pos + 1
    return pairs, tc, bridge.caches_from_numpy(
        jax.tree.map(np.asarray, jc), cfg)


# prompts shorter than the window, and one longer (rolled at prefill, and
# wrapped again by the decode steps)
PROMPT_SETS = {"short": (5, 40), "past_window": (100, 8)}


@pytest.mark.parametrize("prompts", list(PROMPT_SETS))
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
])
def test_gemma3_logits_and_caches_match_in_f32(prompts, jspec, tspec,
                                               use_pallas):
    """f32 everywhere: 1e-4 on logits and K/V, positions exactly. Local
    layers prefill through the chunked path with their window in both
    packages, whatever ``use_pallas`` says (the flash kernel has no
    window)."""
    ps = [_prompt(n, i) for i, n in enumerate(PROMPT_SETS[prompts])]
    pairs, tc, jc = run_stack(CFG, ps, jnp.float32, torch.float32, jspec,
                              tspec, use_pallas)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    for kind, t, j in zip(tt.layer_kinds(CFG), tc, jc):
        rows = WINDOW if kind == "attn_local" else MAX_LEN
        assert t["k"].shape[1] == rows
        np.testing.assert_array_equal(t["pos"].numpy(), j["pos"].numpy())
        for key in ("k", "v"):
            np.testing.assert_allclose(t[key].numpy(), j[key].numpy(),
                                       rtol=1e-4, atol=1e-4)


def jax_logits(cfg, params, prompts, jrt, dtype, feed, max_len=MAX_LEN):
    """JAX's prefill and decode logits of ``prompts`` with the decode
    inputs given (``feed``: one (B,) token vector per step)."""
    jc = j_init_cache(cfg, len(prompts), max_len, dtype=dtype)
    out = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = j_prefill(params, jnp.asarray(prompt)[None], cfg, jrt)
        jc = _write_slot_cache(jc, jpc, slot)
        out.append(jl[0])
    pos = np.array([len(p) for p in prompts], np.int32)
    for tok in feed:
        jl, jc = j_decode(params, jnp.asarray(tok)[:, None], jc,
                          jnp.asarray(pos), cfg, jrt)
        out.extend(jl)
        pos = pos + 1
    return out


@pytest.mark.parametrize("prompts", list(PROMPT_SETS))
def test_gemma3_logits_match_in_bf16(prompts):
    """bf16: XLA keeps excess precision inside fusions where PyTorch rounds
    after every op (test_torch_rounding.py). On the reduced llama3-8b that
    gap is ~0.02, hence the 3e-2 of test_torch_transformer.py; on the
    reduced gemma3 (six layers, rope theta 1e6) JAX's own bf16 logits sit
    up to ~0.05 from its f32 ones on the same inputs, and the port's bf16
    logits sit as far from JAX's. So the bound is the rounding test's: no
    farther than 1.5 times JAX's own bf16-to-f32 gap over the same
    prefills and decode steps (measured here, JAX in f32 on the bf16
    weights, fed the bf16 run's tokens); positions exactly."""
    ps = [_prompt(n, i) for i, n in enumerate(PROMPT_SETS[prompts])]
    spec = jex.parse_policy("bf16:dense:pallas")
    pairs, tc, jc = run_stack(CFG, ps, jnp.bfloat16, torch.bfloat16,
                              "bf16:dense:pallas", "bf16:dense:hopper", True)
    b = len(ps)
    feed = [np.array([int(jnp.argmax(pairs[b * i + r][1]))
                      for r in range(b)], np.int32)
            for i in range(STEPS)]
    params = j_init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    f32 = jax_logits(CFG, p32, ps, JRt(act_dtype=jnp.float32,
                                       use_pallas=True, policy=spec),
                     jnp.float32, feed)
    jax_gap = max(float(jnp.abs(w.astype(jnp.float32) - f).max())
                  for (_, w), f in zip(pairs, f32))
    worst = max(float(np.abs(g.float().numpy()
                             - np.asarray(w, np.float32)).max())
                for g, w in pairs)
    assert worst <= 1.5 * jax_gap, (worst, jax_gap)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t["pos"].numpy(), j["pos"].numpy())


def test_paged_cache_keeps_the_windows_slot_indexed():
    cfg = t_get_reduced("gemma3-12b")
    caches = tt.init_paged_cache(cfg, 3, 128, 16, 10)
    for kind, c in zip(tt.layer_kinds(cfg), caches):
        if kind == "attn_local":
            assert c["k"].shape == (3, WINDOW, cfg.num_kv_heads,
                                    cfg.head_dim)
        else:
            assert c["k"].shape == (11, 16, cfg.num_kv_heads, cfg.head_dim)
    # a max_len under the window caps the window's rows
    assert tt.init_cache(cfg, 2, 32)[0]["k"].shape[1] == 32
