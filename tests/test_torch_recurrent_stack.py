"""The recurrent stacks of the port against the JAX package: the bridge
(rwkv6-3b's and zamba2-1.2b's layers, zamba2's hybrid tail and shared
attention block, packed or not, and their state caches) and the model's
prefill and decode_step, dense and paged, reduced (chunk 32).

Both packages run from the same JAX init, bridged bit for bit. In f32 the
logits, the state leaves and the K/V rows agree within 1e-4 (the
reference's own SSM tolerance, tests/test_ssm_blocks.py); positions are
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import init_params
from repro.models import transformer as jtf
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core.execution import PackedWeight
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl
from test_torch_serve_recurrent import (
    ARCHS, MAX_LEN, PAGE, SLOTS, STEPS, _close, _params, _prompt)


# ---------------------------------------------------------------------------
# The bridge
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_layers_tail_and_shared_block(arch, packed):
    """Layer s * len(pattern) + i is super-layer s of block b{i}, then the
    hybrid tail's layers, leaf for leaf, bit for bit; the shared attention
    block comes whole, and its invoking layers' dicts are empty. A packed
    tree's 3-D tail stacks become one packed weight per tail layer."""
    cfg = get_reduced(arch)
    params = init_params(jax.random.PRNGKey(0), cfg)
    if packed:
        params = jex.pack_model_params(params)
    tree = jax.tree.map(np.asarray, params)
    port = bridge.params_from_numpy(tree, cfg)
    kinds = tt.layer_kinds(cfg)
    pat = cfg.superlayer_pattern
    assert len(port["layers"]) == len(kinds) == cfg.num_superlayers \
        * len(pat) + cfg.hybrid_tail_layers
    n_body = cfg.num_superlayers * len(pat)
    for li, layer in enumerate(port["layers"]):
        if li < n_body:
            block, idx = tree["layers"][f"b{li % len(pat)}"], li // len(pat)
        else:
            block, idx = tree["tail"], li - n_body
        want = {p: w for p, w in _leaves(block)
                if not isinstance(w, jex.PackedWeight)}
        packs = {p: w for p, w in _leaves(block) if isinstance(
            w, jex.PackedWeight)}
        got = dict(_leaves(layer))
        assert sorted(got) == sorted(list(want) + list(packs)), li
        if kinds[li] == "shared_attn":
            assert layer == {}
        for path, t in got.items():
            if path in packs:
                assert isinstance(t, PackedWeight), (li, path)
                for a, b in ((t.values, packs[path].values),
                             (t.meta, packs[path].meta)):
                    bits = bridge.to_numpy_bits(a)
                    assert bits.tobytes() == np.asarray(b)[idx].view(
                        bits.dtype).tobytes(), (li, path)
                continue
            w = np.asarray(want[path])[idx]
            bits = bridge.to_numpy_bits(t)
            assert tuple(t.shape) == w.shape, (li, path)
            assert bits.tobytes() == w.view(bits.dtype).tobytes(), (li, path)
    assert ("shared_attn" in port) == ("shared_attn" in pat)
    if "shared_attn" in port:
        for path, t in _leaves(port["shared_attn"]):
            w = tree["shared_attn"]
            for k in path:
                w = w[k]
            if packed and isinstance(w, jex.PackedWeight):
                assert isinstance(t, PackedWeight)
                continue
            bits = bridge.to_numpy_bits(t)
            assert bits.tobytes() == np.asarray(w).view(bits.dtype).tobytes()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_state_leaves(arch, paged):
    """Random state leaves (and shared-attention K/V, pooled on a paged
    cache) in the reference's stacked layout arrive bit for bit in the
    port's per-layer list, the tail's after the super-layers'."""
    cfg = get_reduced(arch)
    cache = jtf.init_paged_cache(cfg, 2, 32, 8, 5) if paged \
        else jtf.init_cache(cfg, 2, 32)
    rng = np.random.default_rng(9)
    tree = jax.tree.map(
        lambda a: (rng.integers(-1, 32, a.shape).astype(np.int32)
                   if a.dtype == jnp.int32 else np.asarray(jnp.asarray(
                       rng.normal(size=a.shape), a.dtype))), cache)
    port = bridge.caches_from_numpy(tree, cfg)
    want = tt.init_paged_cache(cfg, 2, 32, 8, 5) if paged \
        else tt.init_cache(cfg, 2, 32)
    assert len(port) == len(want)
    n_body = cfg.num_superlayers * len(cfg.superlayer_pattern)
    pat = cfg.superlayer_pattern
    for li, (layer, init) in enumerate(zip(port, want)):
        src = tree["layers"][f"b{li % len(pat)}"] if li < n_body \
            else tree["tail"]
        idx = li // len(pat) if li < n_body else li - n_body
        assert sorted(layer) == sorted(init)
        for key, t in layer.items():
            assert t.shape == init[key].shape and t.dtype == init[key].dtype
            bits = bridge.to_numpy_bits(t)
            assert bits.tobytes() == np.asarray(src[key])[idx].view(
                bits.dtype).tobytes(), (li, key)


# ---------------------------------------------------------------------------
# prefill and decode_step
# ---------------------------------------------------------------------------

def _run_stack(arch, paged, jspec, tspec, use_pallas):
    """Prefill two prompts (two chunks; fewer than one) into their slots of
    one f32 cache, then STEPS decode steps with a position per slot, under
    both packages, each fed JAX's greedy tokens. Returns the (port, JAX)
    logits pairs and both final caches (JAX's bridged)."""
    cfg = get_reduced(arch)
    params, tparams = _params(arch)
    jrt = JRt(act_dtype=jnp.float32, param_dtype=jnp.float32,
              use_pallas=use_pallas, policy=jex.parse_policy(jspec))
    trt = TRt(act_dtype=torch.float32, use_pallas=use_pallas,
              policy=tex.parse_policy(tspec))
    mp = MAX_LEN // PAGE
    pages = SLOTS * mp
    page_map = np.arange(pages, dtype=np.int32).reshape(SLOTS, mp)
    if paged:
        jc = jtf.init_paged_cache(cfg, SLOTS, MAX_LEN, PAGE, pages,
                                  dtype=jnp.float32)
        tc = tt.init_paged_cache(cfg, SLOTS, MAX_LEN, PAGE, pages,
                                 dtype=torch.float32)
        pooled = [k in tt.PAGED_KINDS for k in tt.layer_kinds(cfg)]
    else:
        jc = jtf.init_cache(cfg, SLOTS, MAX_LEN, dtype=jnp.float32)
        tc = tt.init_cache(cfg, SLOTS, MAX_LEN, dtype=torch.float32)
    prompts = [_prompt(cfg, 64, 1), _prompt(cfg, 5, 2)]
    pairs, tokens = [], []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jtf.prefill(params, jnp.asarray(prompt)[None], cfg, jrt)
        tl, tpc = tt.prefill(tparams, torch.from_numpy(prompt)[None].long(),
                             cfg, trt)
        if paged:
            jc = jsl._paged_write_prompt(cfg.superlayer_pattern, jc, jpc,
                                         slot, jnp.asarray(page_map[slot]))
            tsl._paged_write_prompt(pooled, tc, tpc, slot,
                                    torch.from_numpy(page_map[slot]).long())
        else:
            jc = jsl._write_slot_cache(jc, jpc, slot)
            tsl._write_slot_cache(tc, tpc, slot)
        pairs.append((tl[0], jl[0]))
        tokens.append(int(jnp.argmax(jl[0])))
    pos = np.array([len(p) for p in prompts], np.int32)
    pm = (jnp.asarray(page_map),) if paged else ()
    tpm = (torch.from_numpy(page_map),) if paged else ()
    jstep = jtf.paged_decode_step if paged else jtf.decode_step
    tstep = tt.paged_decode_step if paged else tt.decode_step
    for _ in range(STEPS):
        tok = np.array(tokens, np.int32)[:, None]
        jl, jc = jstep(params, jnp.asarray(tok), jc, jnp.asarray(pos), *pm,
                       cfg, jrt)
        tl, tc = tstep(tparams, torch.from_numpy(tok).long(), tc,
                       torch.from_numpy(pos).long(), *tpm, cfg, trt)
        pairs.extend((tl[i], jl[i]) for i in range(SLOTS))
        tokens = [int(t) for t in jnp.argmax(jl, axis=-1)]
        pos = pos + 1
    return pairs, tc, bridge.caches_from_numpy(
        jax.tree.map(np.asarray, jc), cfg)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
])
def test_logits_and_states_match_jax_in_f32(arch, paged, jspec, tspec,
                                            use_pallas):
    """f32: 1e-4 on the logits of both prefills and every decode step, on
    every state leaf and K/V row at the end; positions exactly."""
    pairs, tc, jc = _run_stack(arch, paged, jspec, tspec, use_pallas)
    for got, want in pairs:
        _close(got, want)
    for t, j in zip(tc, jc):
        assert sorted(t) == sorted(j)
        for key in t:
            if key == "pos":
                np.testing.assert_array_equal(t[key].numpy(), j[key].numpy())
            else:
                _close(t[key], j[key].float().numpy())
