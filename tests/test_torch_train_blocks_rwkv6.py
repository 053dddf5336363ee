"""Training the rwkv6 block kind against JAX: step-0 gradients.

Reduced rwkv6-3b (the wkv chunk with its pairwise decay, the token
shift, the channel mix), f32, under ``bf16:dense:hopper`` against
``bf16:dense:pallas``, two scan chunks of 16 per sequence.

The other block kinds hold every leaf within 1e-5 of the leaf's largest
entry (``GRAD_TOL``). rwkv6 does not: its gap reaches
1.65e-5 (``w_k``), spread over many leaves (``w_w`` 1.61e-5, ``embed``
1.56e-5, ``w_ck`` 1.53e-5). ``test_rwkv6_gap_is_f32_summation_order``
settles why: a float64 gradient of the same loss through the port's own
code lies closer to the port's f32 gradient than to JAX's (measured:
``w_k`` port 9.0e-6, JAX 1.14e-5 of the leaf's largest entry; over every
leaf at most 9.6e-6 and 1.32e-5). Each package is as far from the exact
gradient as f32 sums in its own order put it, and the two gaps add up:
rwkv6's tolerance is their sum, 9.6e-6 + 1.32e-5 = 2.3e-5, rounded up to
2.5e-5.

The wkv chunk masks its pairwise decay exponent before the exp, as
mamba2's SSD chunk does (``test_torch_train_blocks_hybrid.py``): under
a decay strong enough that a masked exponent passes f32's exp range, the
reference's ``where(strict, exp(seg), 0)`` has a NaN gradient, the
port's a finite one that matches a float64 run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import rwkv6 as jrk
from repro_torch.core import execution as tex
from repro_torch.core import tree
from repro_torch.models import rwkv6 as trk
from repro_torch.runtime import train_loop as ttl

from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, HOPPER, batches, bridge, check_step0_grads, chunk_grads,
    get_reduced, init_params, one_torch_thread, rts, step0_grads, to_torch)

ARCH = "rwkv6-3b"
RWKV6_GRAD_TOL = 2.5e-5
# the port's f32 gradient may lie at most this factor farther from the
# float64 one than JAX's does, or the gap is the port's fault
F64_FACTOR = 2.0


def test_step0_grads_match_jax():
    check_step0_grads(ARCH, RWKV6_GRAD_TOL)


def _float64_grads(monkeypatch, arch):
    """The step-0 gradients of the port's loss with every float in
    float64: f64 params and activations, and the code's own casts to f32
    or bf16 (``.float()``, ``.to(f32)``, f32 zeros) kept in f64. The
    ``torch`` backend: the same function as ``hopper``'s plain twins."""
    real_float, real_to, real_zeros = (torch.Tensor.float, torch.Tensor.to,
                                       torch.zeros)
    lower = (torch.float32, torch.bfloat16)

    def as_float(self, *a, **k):
        return self if self.dtype == torch.float64 else real_float(self, *a,
                                                                   **k)

    def to(self, *a, **k):
        out = real_to(self, *a, **k)
        return self if (self.dtype == torch.float64
                        and out.dtype in lower) else out

    def zeros(*a, dtype=None, **k):
        return real_zeros(*a, dtype=torch.float64 if dtype == torch.float32
                          else dtype, **k)

    cfg = get_reduced(arch)
    params = jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    p64 = tree.map_tree(lambda t: t.double(),
                        bridge.params_from_numpy(params, cfg))
    _, trt = rts("f32")
    trt = dataclasses.replace(trt, act_dtype=torch.float64,
                              param_dtype=torch.float64)
    c64, r64 = tex.apply_policy(cfg, trt,
                                tex.parse_policy("bf16:dense:torch"))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", as_float)
        m.setattr(torch.Tensor, "to", to)
        m.setattr(torch, "zeros", zeros)
        _, g = ttl.value_and_grad(ttl.make_loss_fn(c64, r64))(
            p64, to_torch(batches(cfg, 1)[0]))
    assert {t.dtype for t in tree.leaves(g)} == {torch.float64}
    return jax.tree.leaves(bridge.params_to_numpy(g, cfg))


def test_rwkv6_gap_is_f32_summation_order(monkeypatch):
    """rwkv6's port-to-JAX gradient gap is the two packages' f32
    summation orders, not a fault of the port: against a float64
    gradient through the port's own code, the port's f32 gradient lies
    no farther than F64_FACTOR times JAX's, on ``w_k`` and over every
    leaf, and the port-to-JAX gap stays within the sum of the two."""
    pairs = step0_grads(ARCH, *HOPPER)
    exact = _float64_grads(monkeypatch, ARCH)
    rows = {}
    for (name, port, jx), g64 in zip(pairs, exact):
        scale = np.abs(g64).max()
        rows[name] = (np.abs(port - g64).max() / scale,
                      np.abs(jx - g64).max() / scale,
                      np.abs(port - jx).max() / scale)
    port_wk, jax_wk, _ = rows["['layers']['b0']['rwkv']['w_k']"]
    assert port_wk <= F64_FACTOR * jax_wk, rows
    port_all = max(r[0] for r in rows.values())
    jax_all = max(r[1] for r in rows.values())
    assert port_all <= F64_FACTOR * jax_all, rows
    assert max(r[2] for r in rows.values()) <= port_all + jax_all \
        <= RWKV6_GRAD_TOL, rows


def _wkv_inputs(log_decay, Lc=64):
    """One chunk of 64 steps, each decaying by exp(-log_decay): the
    masked exponents reach 64 * log_decay."""
    rng = np.random.default_rng(8)
    b, nh, hd = 1, 2, 8

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)
    w = np.full((b, Lc, nh, hd), np.exp(-log_decay), np.float32)
    return (f32(b, Lc, nh, hd), f32(b, Lc, nh, hd), f32(b, Lc, nh, hd), w,
            f32(nh, hd), f32(b, nh, hd, hd))


def test_wkv_chunk_gradient_where_the_masked_decay_overflows():
    """A decay of exp(-2) per step: masked exponents up to 128."""
    p32, p64, jg = chunk_grads(trk._wkv_chunk, jrk._wkv_chunk,
                               _wkv_inputs(2.0))
    assert any(np.isnan(g).any() for g in jg)     # the reference's fault
    for got, want in zip(p32, p64):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_wkv_chunk_gradient_unchanged_where_nothing_overflows():
    p32, _, jg = chunk_grads(trk._wkv_chunk, jrk._wkv_chunk,
                             _wkv_inputs(0.1))
    for got, want in zip(p32, jg):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
