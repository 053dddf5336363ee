"""Training the MoE block kinds against JAX.

Reduced granite-moe-3b-a800m (8 experts, top 2, two groups of 64
tokens) and llama4-scout-17b-a16e (4 experts, top 1, a shared expert)
under ``bf16:dense:hopper`` against ``bf16:dense:pallas``. The experts'
GEMMs take ``registry.hopper_experts`` (one kernel-A launch for every
expert, its plain twin on the CPU), whose backward is the torch
reference's per-expert gradient; the router, capacity dispatch and the
aux loss (``AUX_LOSS_WEIGHT``) are differentiated by autograd.

* f32 step-0 gradients: every leaf within 1e-5 of the leaf's largest
  entry. In f32 the two packages route alike, so the router's leaf is
  held too (measured worst: llama4-scout's router 9.2e-6, granite's
  ``w_gate`` 2.3e-6).
* Three bf16 steps of granite: each loss within LOSS_TOL, the state
  after them within STATE_TOL, the tolerances of
  ``test_torch_train_step.py`` (measured: losses 7.4e-4, 4.3e-5, 1.6e-4
  relative; state 1.95e-3, a bf16 ulp of a param).
"""
import pytest

from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, HOPPER, check_step0_grads, check_three_steps,
    one_torch_thread)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_step0_grads_match_jax(arch):
    check_step0_grads(arch, GRAD_TOL)


def test_three_bf16_steps_match_jax():
    check_three_steps("granite-moe-3b-a800m", "bf16", *HOPPER)


def test_top1_router_gradient_through_the_combine_weights_is_residue():
    """A top-1 gate is divided by itself (the gates are normalised to sum
    to 1), so a router's gradient through the combine weights is 0 in
    exact arithmetic: in float64 the port's is within 1e-6 of the float32
    one's size, and in float32 each package leaves a rounding residue of
    its own (JAX's nonzero too). So on the card ``[train-blocks]`` holds
    llama4-scout's router along a random cotangent by its aux loss's
    gradient (``chip_smoke.sublayer_grads_check``, TOP1_ROUTER)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_reduced
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(get_reduced("llama4-scout-17b-a16e"),
                              num_experts=16)
    assert cfg.experts_top_k == 1
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 64, 16))
    cot = rng.normal(size=(2, 64, 16, 5)) * 1e4    # on combine (G, gs, E, C)

    def port(dtype):
        lg = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        combine, _, _ = tmoe.router_dispatch(lg, cfg, 5)
        return torch.autograd.grad(
            (combine.to(dtype) * torch.from_numpy(cot).to(dtype)).sum(),
            lg)[0].abs().max().item()
    jax_f32 = float(jnp.abs(jax.grad(lambda lg: jnp.sum(
        jmoe.router_dispatch(lg, cfg, 5)[0] * cot.astype(np.float32)))(
            logits.astype(np.float32))).max())
    f32, f64 = port(torch.float32), port(torch.float64)
    assert f32 > 0 and jax_f32 > 0
    assert f64 <= 1e-6 * f32
