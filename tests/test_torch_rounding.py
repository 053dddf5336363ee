"""The port's bf16 logits part from JAX's by framework rounding only.

XLA evaluates bf16 elementwise chains with excess precision (it drops the
intermediate bf16 roundings inside a fusion); PyTorch rounds after every
op. This file measures how far that moves the reduced llama3-8b's first
prefill logits, and so grounds the bf16 tolerances of
test_torch_transformer.py and test_torch_serve.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.layers import RuntimeCfg as JRt
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt

CFG = get_reduced("llama3-8b")
PROMPT = np.array([[5, 17, 3, 99, 250]], np.int32)


@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_bf16_gap_is_framework_rounding(precision):
    """The port's bf16 prefill logits sit no farther from JAX's bf16 logits
    than JAX's own bf16 logits sit from its f32 ones (same weights, upcast):
    the gap the bf16 tolerances allow for is rounding, not a fault.
    Run with ``-s`` to see the three gaps."""
    params = j_init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), CFG)
    spec = f"{precision}:dense"
    jb, _ = j_prefill(params, jnp.asarray(PROMPT), CFG,
                      JRt(policy=jex.parse_policy(spec + ":jnp")))
    jf, _ = j_prefill(p32, jnp.asarray(PROMPT), CFG,
                      JRt(act_dtype=jnp.float32,
                          policy=jex.parse_policy(spec + ":jnp")))
    tb, _ = tt.prefill(tparams, torch.from_numpy(PROMPT).long(), CFG,
                       TRt(policy=tex.parse_policy(spec + ":torch")))
    jax_gap = float(jnp.abs(jb - jf).max())
    port_gap = float(np.abs(tb.numpy() - np.asarray(jb)).max())
    port_f32_gap = float(np.abs(tb.numpy() - np.asarray(jf)).max())
    print(f"{precision}: |jax bf16 - jax f32| {jax_gap:.4f}, "
          f"|port bf16 - jax bf16| {port_gap:.4f}, "
          f"|port bf16 - jax f32| {port_f32_gap:.4f}")
    assert port_gap <= 1.5 * jax_gap
    assert port_f32_gap <= 1.5 * jax_gap
