"""Training the hybrid block kinds against JAX (zamba2-1.2b).

Reduced zamba2-1.2b: mamba2's SSD chunk scan (two chunks of 16 per
sequence), the one shared-attention block called twice, whose gradient
sums both calls, and the hybrid tail outside the checkpointed
super-layers; ``bf16:dense:hopper`` against ``bf16:dense:pallas``.

* f32 step-0 gradients: every leaf within 1e-5 of the leaf's largest
  entry (measured worst: mamba2's ``D`` 2.5e-6).
* Three bf16 steps: each loss within LOSS_TOL, the state after them
  within STATE_TOL, the tolerances of ``test_torch_train_step.py``
  (measured: losses 1.3e-4, 1.1e-4, 1.6e-4 relative; state 1.95e-3, a
  bf16 ulp of a param).
* The SSD chunk's gradient where the masked decay exponent overflows
  f32. At full width (256-token chunks) the exponent ``cum[t] - cum[s]``
  of a pair s > t passes 88 and ``exp`` gives inf; the reference's
  ``where(causal, exp(seg), 0)`` then has the gradient 0 * inf = NaN,
  which made every stacked leaf's step-0 gradient NaN on the H100. The
  port masks the exponent before the exp: its gradient is finite and
  matches a float64 run, and where nothing overflows it equals JAX's.
"""
import numpy as np

from repro.models import mamba2 as jm2
from repro_torch.models import mamba2 as tm2

from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, HOPPER, check_step0_grads, check_three_steps, chunk_grads,
    one_torch_thread)

ARCH = "zamba2-1.2b"


def test_step0_grads_match_jax():
    check_step0_grads(ARCH, GRAD_TOL)


def test_three_bf16_steps_match_jax():
    check_three_steps(ARCH, "bf16", *HOPPER)


def _ssd_inputs(dt, Lc=64):
    """One chunk of 64 steps of ``dt`` each (A = -1): the masked
    exponents reach 63 * dt."""
    rng = np.random.default_rng(7)
    b, nh, hp, N = 1, 2, 4, 8

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)
    steps = np.full((b, Lc, nh), dt, np.float32)
    return (f32(b, Lc, nh, hp), steps, np.cumsum(-steps, axis=1),
            f32(b, Lc, N), f32(b, Lc, N), f32(b, nh, hp, N))


def test_ssd_chunk_gradient_where_the_masked_decay_overflows():
    """dt = 2: masked exponents up to 126, past f32's exp range."""
    p32, p64, jg = chunk_grads(tm2._ssd_chunk, jm2._ssd_chunk,
                               _ssd_inputs(2.0))
    assert any(np.isnan(g).any() for g in jg)     # the reference's fault
    for got, want in zip(p32, p64):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_ssd_chunk_gradient_unchanged_where_nothing_overflows():
    p32, _, jg = chunk_grads(tm2._ssd_chunk, jm2._ssd_chunk,
                             _ssd_inputs(0.1))
    for got, want in zip(p32, jg):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
