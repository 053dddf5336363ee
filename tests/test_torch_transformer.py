"""Port's prefill + decode logits against the JAX transformer.

Two slots are prefilled with prompts of different lengths into one batched
cache, then decoded 8 steps with a position per slot. Both stacks run from
the same JAX init (bridged bit for bit) and take the same tokens (the JAX
argmax), so every step compares like with like.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import decode_step as j_decode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime.serve_loop import _write_slot_cache
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime.serve_loop import _write_slot_cache as t_write

CFG = get_reduced("llama3-8b")
PROMPTS = (np.array([5, 17, 3, 99, 250], np.int32),
           np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32))
MAX_LEN, STEPS = 32, 8


def _run(jdtype, tdtype, jspec, tspec, use_pallas):
    params = j_init_params(jax.random.PRNGKey(0), CFG, dtype=jdtype)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), CFG)
    jrt = JRt(act_dtype=jdtype, param_dtype=jdtype, use_pallas=use_pallas,
              policy=jex.parse_policy(jspec))
    trt = TRt(act_dtype=tdtype, use_pallas=use_pallas,
              policy=tex.parse_policy(tspec))
    jc = j_init_cache(CFG, 2, MAX_LEN, dtype=jdtype)
    tc = tt.init_cache(CFG, 2, MAX_LEN, dtype=tdtype)
    pairs = []
    tokens = []
    for slot, prompt in enumerate(PROMPTS):
        jl, jpc = j_prefill(params, jnp.asarray(prompt)[None], CFG, jrt)
        tl, tpc = tt.prefill(tparams, torch.from_numpy(prompt)[None].long(),
                             CFG, trt)
        jc = _write_slot_cache(jc, jpc, slot)
        t_write(tc, tpc, slot)
        pairs.append((tl[0], jl[0]))
        tokens.append(int(jnp.argmax(jl[0])))
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    for _ in range(STEPS):
        tok = np.array(tokens, np.int32)[:, None]
        jl, jc = j_decode(params, jnp.asarray(tok), jc, jnp.asarray(pos),
                          CFG, jrt)
        tl, tc = tt.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long(), CFG, trt)
        for b in range(2):
            pairs.append((tl[b], jl[b]))
        tokens = [int(t) for t in jnp.argmax(jl, axis=-1)]
        pos = pos + 1
    # the caches agree too (pos rows exactly: -1 where unwritten)
    np.testing.assert_array_equal(tc[0]["pos"].numpy(),
                                  np.asarray(jc["layers"]["b0"]["pos"][0]))
    return pairs


@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
    ("fp8:dense:jnp", "fp8:dense:torch", False),
])
def test_logits_match_in_f32(jspec, tspec, use_pallas):
    """f32 weights, activations and cache: the two differ only in the order
    of f32 sums (and exp), so 1e-4 absolute on logits of size ~1 (fp8
    included: its bytes and scales are bit-equal, test_torch_fp8.py)."""
    for got, want in _run(jnp.float32, torch.float32, jspec, tspec,
                          use_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
    ("fp8:dense:jnp", "fp8:dense:torch", False),
])
def test_logits_match_in_bf16(jspec, tspec, use_pallas):
    """XLA computes bf16 elementwise chains with excess precision (it
    drops the intermediate bf16 roundings inside a fusion) where PyTorch
    rounds after every op, so the two bf16 stacks part by about as much as
    each parts from f32: at this size JAX's own bf16 and f32 logits differ
    by about 0.02 (dense) and 0.16 (fp8, where a moved activation amax
    shifts every e4m3 rounding), as test_torch_rounding.py
    measures. Hence 3e-2 and 0.25 absolute, on logits of size ~1; the f32
    test above is the tight one."""
    tol = 0.25 if jspec.startswith("fp8") else 3e-2
    worst = 0.0
    for got, want in _run(jnp.bfloat16, torch.bfloat16, jspec, tspec,
                          use_pallas):
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
    assert worst <= tol, worst

