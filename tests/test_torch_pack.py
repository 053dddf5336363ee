"""The port's pack_model_params and packed matmul dispatch against the JAX
package's, on the reduced llama3-8b from the JAX init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import init_params
from repro_torch import bridge
from repro_torch.core import execution as tex

CFG = get_reduced("llama3-8b")
PROJ = {"attn": ("w_q", "w_k", "w_v", "w_o"),
        "mlp": ("w_gate", "w_up", "w_down")}


def _bits(t) -> bytes:
    return bridge.to_numpy_bits(t).tobytes()


def _jbits(a) -> bytes:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize]
                  ).tobytes()


@pytest.fixture(scope="module", params=[jnp.float32, jnp.bfloat16])
def trees(request):
    params = init_params(jax.random.PRNGKey(0), CFG, dtype=request.param)
    dense = jax.tree.map(np.asarray, params)
    packed = jax.tree.map(np.asarray, jex.pack_model_params(params))
    return dense, packed


def test_pack_model_params_matches_jax_leaf_by_leaf(trees):
    dense, jpacked = trees
    port = tex.pack_model_params(bridge.params_from_numpy(dense, CFG))
    via_bridge = bridge.params_from_numpy(jpacked, CFG)
    for name in ("embed", "head", "final_norm"):
        assert isinstance(port[name], torch.Tensor)
        assert _bits(port[name]) == _bits(via_bridge[name])
    block = jpacked["layers"]["b0"]
    for i, (layer, other) in enumerate(zip(port["layers"],
                                           via_bridge["layers"])):
        for norm in ("norm1", "norm2"):
            assert isinstance(layer[norm], torch.Tensor)
            assert torch.equal(layer[norm], other[norm])
        for group, names in PROJ.items():
            for name in names:
                pw = layer[group][name]
                assert isinstance(pw, tex.PackedWeight), (i, name)
                jpw = block[group][name]
                assert _bits(pw.values) == _jbits(np.asarray(jpw.values)[i])
                assert pw.meta.numpy().tobytes() == \
                    np.asarray(jpw.meta)[i].tobytes()
                dense_w = np.asarray(dense["layers"]["b0"][group][name])[i]
                assert (pw.k, pw.n) == dense_w.shape


def test_pack_model_params_is_idempotent_and_skips_ineligible_leaves():
    w = torch.ones((16, 4))
    tree = {"embed": torch.ones((8, 16)), "head": torch.ones((16, 8)),
            "layers": [{"w_a": w, "w_odd": torch.ones((12, 4)),
                        "w_int": torch.ones((16, 4), dtype=torch.int32),
                        "w_3d": torch.ones((2, 16, 4)), "out_proj": w,
                        "norm": torch.ones((16,))}]}
    packed = tex.pack_model_params(tree)
    layer = packed["layers"][0]
    assert isinstance(layer["w_a"], tex.PackedWeight)
    assert isinstance(layer["out_proj"], tex.PackedWeight)
    for name in ("w_odd", "w_int", "w_3d", "norm"):
        assert layer[name] is tree["layers"][0][name], name
    assert packed["embed"] is tree["embed"] and packed["head"] is tree["head"]
    again = tex.pack_model_params(packed)
    assert again["layers"][0]["w_a"] is layer["w_a"]


@pytest.mark.parametrize("jspec,tspec", [
    ("bf16:sparse24:jnp", "bf16:sparse24:torch"),
    ("bf16:sparse24:pallas", "bf16:sparse24:hopper"),
    ("fp8:sparse24:pallas", "fp8:sparse24:hopper"),
    ("fp8:dense:jnp", "fp8:dense:torch"),
])
def test_matmul_on_packed_weights_matches_jax(jspec, tspec):
    """A PackedWeight goes to the packed GEMM whatever the precision: fp8
    policies multiply it in bf16, as the reference does."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 8, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(64, 40)) * 0.125, jnp.bfloat16)
    jpw = jex.pack_weight(w)
    tpw = tex.PackedWeight(bridge.to_torch(np.asarray(jpw.values)),
                           bridge.to_torch(np.asarray(jpw.meta)))
    want = jex.matmul(x, jpw, jex.parse_policy(jspec), out_dtype=jnp.float32)
    got = tex.matmul(bridge.to_torch(np.asarray(x)), tpw,
                     tex.parse_policy(tspec), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    pw = tex.pack_weight(bridge.to_torch(np.asarray(w)))
    assert _bits(pw.values) == _jbits(jpw.values)
    assert torch.equal(pw.meta, tpw.meta)
