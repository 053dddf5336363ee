"""Training the local/global and embeddings-input block kinds against
JAX: step-0 gradients.

Reduced gemma3-12b (one 5 local : 1 global super-layer, window 64) and
musicgen-medium (seeded normal frames as ``(B, S, d)`` embeddings input,
``tests/torch_train_parity.batches``), f32, every leaf within 1e-5 of
the leaf's largest entry, under ``bf16:dense:hopper`` against
``bf16:dense:pallas`` (measured worst: gemma3 1.7e-6, musicgen 1.1e-6).
"""
import pytest

from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, check_step0_grads, one_torch_thread)


@pytest.mark.parametrize("arch", ["gemma3-12b", "musicgen-medium"])
def test_step0_grads_match_jax(arch):
    check_step0_grads(arch, GRAD_TOL)
