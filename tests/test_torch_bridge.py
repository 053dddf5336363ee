"""The weight bridge carries JAX arrays into the PyTorch port bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import init_params
from repro_torch import bridge


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16,
                                   jnp.float8_e4m3fn, jnp.float8_e5m2])
def test_array_round_trip_is_byte_exact(dtype):
    a = np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32) * 8
    src = np.asarray(jnp.asarray(a).astype(dtype))
    t = bridge.to_torch(src)
    assert t.shape == src.shape
    assert str(t.dtype).split(".")[-1] == str(src.dtype)
    back = bridge.to_numpy_bits(t)
    want = src.view(np.uint8 if src.dtype.itemsize == 1 else
                    np.uint16 if src.dtype.itemsize == 2 else np.uint32)
    assert back.view(want.dtype).tobytes() == want.tobytes()


def test_param_tree_unstacks_layers_bit_for_bit():
    cfg = get_reduced("llama3-8b")
    params = init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    port = bridge.params_from_numpy(tree, cfg)
    assert len(port["layers"]) == cfg.num_layers
    assert port["embed"].dtype == torch.bfloat16
    assert port["final_norm"].dtype == torch.float32
    block = tree["layers"]["b0"]
    for i, layer in enumerate(port["layers"]):
        for group, leaves in (("attn", layer["attn"]), ("mlp", layer["mlp"])):
            for name, t in leaves.items():
                want = np.asarray(block[group][name])[i]
                assert bridge.to_numpy_bits(t).tobytes() == \
                    want.view(np.uint16).tobytes(), (i, group, name)
        for norm in ("norm1", "norm2"):
            np.testing.assert_array_equal(layer[norm].numpy(),
                                          np.asarray(block[norm])[i])
    assert bridge.to_numpy_bits(port["head"]).tobytes() == \
        tree["head"].view(np.uint16).tobytes()


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float8_e4m3fn])
def test_packed_leaves_unstack_bit_for_bit(dtype):
    """The reference's pack_model_params stacks values (n, K/2, N) and
    meta (n, K/8, N); each layer gets its own PackedWeight."""
    from repro.core import execution as jex
    from repro_torch.core.execution import PackedWeight
    cfg = get_reduced("llama3-8b")
    params = init_params(jax.random.PRNGKey(1), cfg)
    params = jax.tree.map(lambda a: a.astype(dtype) if a.ndim == 3 else a,
                          params)
    tree = jax.tree.map(np.asarray, jex.pack_model_params(params))
    port = bridge.params_from_numpy(tree, cfg)
    block = tree["layers"]["b0"]
    carrier = np.uint16 if np.dtype(dtype).itemsize == 2 else np.uint8
    for i, layer in enumerate(port["layers"]):
        for group in ("attn", "mlp"):
            for name, pw in layer[group].items():
                jpw = block[group][name]
                assert isinstance(pw, PackedWeight), (i, name)
                assert pw.values.dtype == bridge.to_torch(
                    np.asarray(jpw.values)).dtype
                assert bridge.to_numpy_bits(pw.values).tobytes() == \
                    np.asarray(jpw.values)[i].view(carrier).tobytes()
                assert pw.meta.dtype == torch.uint8
                assert pw.meta.numpy().tobytes() == \
                    np.asarray(jpw.meta)[i].tobytes()
    assert isinstance(port["head"], torch.Tensor)


def test_configs_are_copies_of_the_reference():
    from repro.configs import ARCHS, REDUCED
    from repro_torch.configs import ARCHS as T_ARCHS, REDUCED as T_REDUCED
    assert sorted(ARCHS) == sorted(T_ARCHS)
    for name in ARCHS:
        assert dataclasses_equal(ARCHS[name], T_ARCHS[name])
        assert dataclasses_equal(REDUCED[name], T_REDUCED[name])


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("paged", [False, True])
def test_caches_unstack_bit_for_bit(paged):
    """A dense cache (n_super, B, S, ...) and a paged one (pools on axis 1)
    with written rows: layer i of each leaf arrives bit for bit (bf16 over
    uint16, pos as int32)."""
    from repro.models import init_cache, init_paged_cache
    cfg = get_reduced("llama3-8b")
    if paged:
        cache = init_paged_cache(cfg, 2, 32, 8, 5)
    else:
        cache = init_cache(cfg, 2, 32)
    rng = np.random.default_rng(7)
    block = cache["layers"]["b0"]
    block = {"k": jnp.asarray(rng.normal(size=block["k"].shape),
                              jnp.bfloat16),
             "v": jnp.asarray(rng.normal(size=block["v"].shape),
                              jnp.bfloat16),
             "pos": jnp.asarray(rng.integers(-1, 32, block["pos"].shape),
                                jnp.int32)}
    tree = jax.tree.map(np.asarray, {"layers": {"b0": block}})
    port = bridge.caches_from_numpy(tree, cfg)
    assert len(port) == cfg.num_layers
    for i, layer in enumerate(port):
        assert layer["k"].dtype == torch.bfloat16
        assert layer["pos"].dtype == torch.int32
        for key in ("k", "v"):
            assert bridge.to_numpy_bits(layer[key]).tobytes() == \
                tree["layers"]["b0"][key][i].view(np.uint16).tobytes()
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      tree["layers"]["b0"]["pos"][i])


BLOCK_ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e",
               "gemma3-12b"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_patterns_unstack_bit_for_bit(arch):
    """Super-layer s of block b{i} becomes the port's layer s * len(pattern)
    + i, leaf for leaf, bit for bit: MoE blocks with their f32 router and
    expert stacks (4-D there, 3-D here) and llama4-scout's shared expert,
    and gemma3's local and global blocks."""
    cfg = get_reduced(arch)
    tree = jax.tree.map(np.asarray,
                        init_params(jax.random.PRNGKey(0), cfg))
    port = bridge.params_from_numpy(tree, cfg)
    pat = cfg.superlayer_pattern
    assert len(port["layers"]) == cfg.num_layers
    for li, layer in enumerate(port["layers"]):
        block = tree["layers"][f"b{li % len(pat)}"]
        s = li // len(pat)
        want = dict(_leaves(block))
        got = dict(_leaves(layer))
        assert sorted(got) == sorted(want), li
        for path, t in got.items():
            w = np.asarray(want[path])[s]
            assert tuple(t.shape) == w.shape, (li, path)
            bits = bridge.to_numpy_bits(t)
            assert bits.tobytes() == w.view(bits.dtype).tobytes(), (li, path)
        if pat[li % len(pat)] == "attn_moe":
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["w_gate"].shape == (
                cfg.num_experts, cfg.d_model, cfg.d_ff)
            assert ("shared" in layer["moe"]) == cfg.moe_shared_expert


@pytest.mark.parametrize("paged", [False, True])
def test_window_caches_unstack_bit_for_bit(paged):
    """gemma3's cache: local blocks keep window rows per slot (in the paged
    cache too), the global block's leaves are rows or page pools; layer
    s * 6 + i gets super-layer s of b{i}."""
    from repro.models import init_cache, init_paged_cache
    cfg = get_reduced("gemma3-12b")
    cache = init_paged_cache(cfg, 2, 96, 16, 7) if paged \
        else init_cache(cfg, 2, 96)
    rng = np.random.default_rng(8)
    tree = {"layers": {
        b: {"k": np.asarray(jnp.asarray(rng.normal(size=leaf["k"].shape),
                                        jnp.bfloat16)),
            "v": np.asarray(jnp.asarray(rng.normal(size=leaf["v"].shape),
                                        jnp.bfloat16)),
            "pos": rng.integers(-1, 96, leaf["pos"].shape).astype(np.int32)}
        for b, leaf in cache["layers"].items()}}
    port = bridge.caches_from_numpy(tree, cfg)
    pat = cfg.superlayer_pattern
    for li, layer in enumerate(port):
        want = tree["layers"][f"b{li % len(pat)}"]
        rows = cfg.window_size if pat[li % len(pat)] == "attn_local" \
            else (16 if paged else 96)
        assert layer["k"].shape[1] == rows
        for key in ("k", "v"):
            assert bridge.to_numpy_bits(layer[key]).tobytes() == \
                want[key][li // len(pat)].view(np.uint16).tobytes()
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      want["pos"][li // len(pat)])
