"""Gradients of the port's training path against JAX's.

The step-0 gradients of the loss for each policy of the train-step test
(f32, every leaf), and the two gradient faults this slice repaired:

1. ``hopper_sparse24.dense`` gave the weight no gradient (``pack_24``
   gathered the values on an integer view); now it is the reference's
   masked gradient.
2. The kernel entry points cut the autograd graph without a word on the
   card (an output filled through ``ctypes``) and differentiated their
   plain twins on the CPU; now they refuse an operand that requires grad
   under grad mode on both devices, as ``jax.grad`` through a
   ``pallas_call`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import registry as jreg
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import fp8_matmul as tfm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import registry as treg
from repro_torch.kernels import sparse24_matmul as tsm

from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, batches, bridge, check_step0_grads, get_reduced, init_params,
    jadam, jex, jtl, one_torch_thread, rts, to_jax, to_torch, torch_step)
from test_torch_train_step import CASES


@pytest.mark.parametrize("case", list(CASES))
def test_step0_grads_match_jax(case):
    """f32 step-0 gradients of every leaf within 1e-5 of the leaf's
    largest (measured: 6e-7)."""
    check_step0_grads("llama3-8b", GRAD_TOL, *CASES[case])


# -- repair 1: the 2:4-primary backend gives the weight its gradient ---------

def test_hopper_sparse24_dense_gives_w_the_reference_gradient():
    """``hopper_sparse24.dense`` prunes and packs ``w`` per call; the
    gradient reaches ``w`` through ``pack_24`` (half of it nonzero), as
    ``jax.grad`` through ``pallas_sparse24.dense`` gives it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 16, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) * 64 ** -0.5).astype(np.float32)
    jgx, jgw = jax.grad(
        lambda a, b: jnp.sum(jreg.get_backend("pallas_sparse24").dense(
            a, b, out_dtype=jnp.float32) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = treg.get_backend("hopper_sparse24").dense(tx, tw,
                                                    out_dtype=torch.float32)
    tgx, tgw = torch.autograd.grad(out.square().sum(), (tx, tw))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)
    assert int((tgw != 0).sum()) == w.size // 2


# -- repair 2: no autograd through a kernel entry point -----------------------

def test_flash_attention_refuses_gradients_as_jax_does():
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(1, 128, h, 64)).astype(np.float32)
               for h in (2, 2, 2))
    with pytest.raises(Exception):
        jax.grad(lambda a: jnp.sum(jops.flash_attention(
            a, jnp.asarray(k), jnp.asarray(v), causal=True)))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    with torch.no_grad():                    # forward-only use still runs
        assert tops.flash_attention(tq, torch.from_numpy(k),
                                    torch.from_numpy(v)).shape == q.shape


def _entry_calls():
    rng = np.random.default_rng(7)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)
    x, w = t(4, 64, dtype=torch.bfloat16), t(64, 32, dtype=torch.bfloat16)
    vals, meta = tsp.pack_24(tsp.prune_24(w))
    return {
        "fp8_matmul": lambda g: tfm.fp8_matmul(x.requires_grad_(g), w),
        "fp8_matmul_batched": lambda g: tfm.fp8_matmul_batched(
            x[None].detach().requires_grad_(g), w[None]),
        "sparse24_matmul": lambda g: tsm.sparse24_matmul(
            x.detach().requires_grad_(g), vals, meta),
        "block24_matmul": lambda g: tops.block24_matmul(
            x.detach().requires_grad_(g), w[:32], (0,), block=32),
        "paged_decode": lambda g: tpa.paged_flash_decode(
            t(2, 4, 16).requires_grad_(g), t(3, 8, 2, 16), t(3, 8, 2, 16),
            torch.tensor([[0], [1]], dtype=torch.int32),
            torch.tensor([5, 8], dtype=torch.int32)),
    }


@pytest.mark.parametrize("name", ["fp8_matmul", "fp8_matmul_batched",
                                  "sparse24_matmul", "block24_matmul",
                                  "paged_decode"])
def test_kernel_entry_points_refuse_gradients(name):
    """Kernels A (direct), C, D (direct) and E refuse an operand that
    requires grad under grad mode, on the CPU as on the card."""
    call = _entry_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert call(False).numel() > 0


def test_training_with_use_pallas_raises_in_both_packages():
    """``rt.use_pallas`` routes attention through the forward-only flash
    kernel: JAX's train step fails to trace, the port's raises."""
    cfg = get_reduced("llama3-8b")
    jopt = jadam.AdamWConfig(total_steps=10, warmup_steps=2)
    jrt, _ = rts("f32", use_pallas=True)
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    state = jtl.init_state(params, jopt)
    batch = batches(cfg, 1, b=1, s=128)[0]
    jstep = jtl.make_train_step(cfg, jopt, jrt,
                                policy=jex.parse_policy("pallas"))
    with pytest.raises(Exception):
        jax.jit(jstep)(state, to_jax(batch))
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, state),
                                           cfg)
    step = torch_step("llama3-8b", "f32", "hopper", use_pallas=True)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        step(tstate, to_torch(batch))
