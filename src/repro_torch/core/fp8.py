"""FP8 per-tensor scaling, serving half (OCP OFP8 E4M3 / E5M2).

The numerics follow the JAX package's ``core/fp8.py`` exactly: amax in f32
over the whole tensor, ``s = fmax / max(amax, 1e-12)``, ``q = (x.f32 * s)``
cast to fp8 (round to nearest even), ``inv = 1 / s`` in f32. The fp8 bytes
and the inverse scale are bit-equal to the reference on the same input.

The delayed-scaling training state (``TensorScale``, the fp8 autograd with
E5M2 gradients) belongs to the training slice and is not here.
"""
from __future__ import annotations

from typing import Tuple

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

# Max representable magnitudes (OCP OFP8).
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp8_max(dtype) -> float:
    if dtype == E4M3:
        return E4M3_MAX
    if dtype == E5M2:
        return E5M2_MAX
    raise ValueError(f"not an fp8 dtype: {dtype}")


def _amax(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.abs().amax().float(), 1e-12)   # abs, max exact


def quantize_weight_static(w: torch.Tensor, dtype=E4M3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor quantization for serving: returns (w_q, inv_scale)."""
    amax = _amax(w)
    # a true f32 division: ``float / tensor`` multiplies by the reciprocal
    s = amax.new_full((), fp8_max(dtype)) / amax
    return (w.float() * s).to(dtype), (1.0 / s).float()


def quantize_stack(w: torch.Tensor, dtype=E4M3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_weight_static` of each ``w[e]`` at once (the
    reference vmaps it over a MoE layer's experts): returns (w_q, inv_scale
    (E,)), each member's bytes and scale bit-equal to its own call. A
    member of zeros (an expert no token reached) takes the 1e-12 amax
    floor: its bytes are zeros and its scale finite."""
    amax = torch.clamp_min(w.abs().flatten(1).amax(dim=1).float(), 1e-12)
    s = torch.full_like(amax, fp8_max(dtype)) / amax
    lead = (-1,) + (1,) * (w.dim() - 1)
    return (w.float() * s.view(lead)).to(dtype), (1.0 / s).float()


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, K) × (K, N) with f32 operands and f32 accumulation."""
    return torch.matmul(a.float(), b.float())


def fp8_dot(x_q: torch.Tensor, w_q: torch.Tensor, x_inv_scale, w_inv_scale,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """(…, K) fp8 × (K, N) fp8 → (…, N), f32 accumulation, descaled
    (every fp8 value is exact in f32)."""
    acc = _f32_dot(x_q, w_q)
    return (acc * (x_inv_scale * w_inv_scale)).to(out_dtype)


def dynamic_fp8_matmul(x: torch.Tensor, w: torch.Tensor, dtype=E4M3,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Stateless dynamic scaling: the activation amax spans all of ``x``
    (every batch slot, idle ones included), as in the reference."""
    x_q, x_inv = quantize_weight_static(x, dtype)
    w_q, w_inv = quantize_weight_static(w, dtype)
    return fp8_dot(x_q, w_q, x_inv, w_inv, out_dtype=out_dtype)
