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
