"""Edges of the port's dense decode step against the JAX transformer.

A decode write at or past the end of the dense cache: the reference's
``.at[bidx, slot].set`` drops it (a speculative verify probes up to k-1
positions past an almost-full slot), so the port's in-place write must drop
it too, without a host sync. Four slots of a full cache decode one step at
``max_len - 1 + j``, j = 0..3 spread over the slots in two orders; both
packages start from the same caches and weights (bridged bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init_params
from repro.models.layers import RuntimeCfg as JRt
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt

CFG = get_reduced("llama3-8b")
MAX_LEN, SLOTS = 16, 4


def _full_caches(seed: int):
    """A JAX cache tree (numpy leaves) whose every row is written: k/v
    random, pos the row index."""
    rng = np.random.default_rng(seed)
    shape = (CFG.num_superlayers, SLOTS, MAX_LEN, CFG.num_kv_heads,
             CFG.head_dim)
    pos = np.broadcast_to(np.arange(MAX_LEN, dtype=np.int32),
                          shape[:3]).copy()
    return {"layers": {"b0": {
        "k": rng.normal(size=shape).astype(np.float32),
        "v": rng.normal(size=shape).astype(np.float32), "pos": pos}}}


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0, 2)])
def test_decode_write_past_the_end_is_dropped_as_in_jax(order):
    """Logits within test_torch_transformer.py's f32 tolerance (1e-4); pos
    rows equal; every k/v row but the one in-range write bit-equal to the
    cache the step started from, as in JAX, and that row within 1e-4 of
    JAX's."""
    params = j_init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), CFG)
    jrt = JRt(act_dtype=jnp.float32, param_dtype=jnp.float32,
              policy=jex.parse_policy("bf16:dense:jnp"))
    trt = TRt(act_dtype=torch.float32,
              policy=tex.parse_policy("bf16:dense:torch"))
    tree = _full_caches(seed=sum(order))
    tcaches = bridge.caches_from_numpy(tree, CFG)
    before = [{k: v.clone() for k, v in c.items()} for c in tcaches]
    pos = np.array([MAX_LEN - 1 + j for j in order], np.int32)
    tok = np.array([[3], [17], [250], [99]], np.int32)
    jl, jc = j_decode(params, jnp.asarray(tok),
                      jax.tree.map(jnp.asarray, tree), jnp.asarray(pos),
                      CFG, jrt)
    tl, tc = tt.decode_step(tparams, torch.from_numpy(tok).long(), tcaches,
                            torch.from_numpy(pos).long(), CFG, trt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    want = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), CFG)
    live = order.index(0)                  # the one slot at max_len - 1
    for t, w, b in zip(tc, want, before):
        assert torch.equal(t["pos"], w["pos"])
        for key in ("k", "v"):
            untouched = torch.ones(SLOTS, MAX_LEN, dtype=torch.bool)
            untouched[live, MAX_LEN - 1] = False
            assert torch.equal(t[key][untouched], b[key][untouched])
            assert torch.equal(w[key][untouched], b[key][untouched])
            torch.testing.assert_close(t[key][live, -1], w[key][live, -1],
                                       rtol=1e-4, atol=1e-4)
