"""FP8 per-tensor scaling (OCP OFP8 E4M3 / E5M2): serving and training.

The numerics follow the JAX package's ``core/fp8.py`` exactly: amax in f32
over the whole tensor, ``s = fmax / max(amax, 1e-12)``, ``q = (x.f32 * s)``
cast to fp8 (round to nearest even), ``inv = 1 / s`` in f32. The fp8 bytes
and the inverse scale are bit-equal to the reference on the same input.

The training half is the reference's delayed scaling: a
:class:`TensorScale` per tensor (a rolling amax history and this step's
scale), :func:`fp8_linear` and :func:`fold_amaxes` to thread it through a
step, and :func:`fp8_matmul`, the differentiable fp8 GEMM: saturating E4M3
operands with the delayed scales forward (the backend's ``fp8_qdot``, so
kernel A under ``hopper``), E5M2 gradients with their current amax
backward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

# Max representable magnitudes (OCP OFP8).
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

# Keep a safety margin so stochastic spikes don't saturate (TE default 0).
DEFAULT_MARGIN = 0.0


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


# ---------------------------------------------------------------------------
# Delayed scaling (training)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TensorScale:
    """Delayed-scaling state for one logical tensor."""
    amax_history: torch.Tensor     # (history,) f32, rolling
    scale: torch.Tensor            # () f32: the quantization scale this step

    @staticmethod
    def init(history: int = 16, device=None) -> "TensorScale":
        return TensorScale(
            amax_history=torch.zeros((history,), dtype=torch.float32,
                                     device=device),
            scale=torch.ones((), dtype=torch.float32, device=device))


def _f32_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as an f32 division (``float / tensor`` multiplies by
    the reciprocal, one ulp off the reference's division)."""
    den = den.float()
    return den.new_full((), num) / den


def update_scale(ts: TensorScale, new_amax: torch.Tensor, dtype=E4M3,
                 margin: float = DEFAULT_MARGIN) -> TensorScale:
    """Roll the amax history and derive next step's scale."""
    hist = torch.cat([new_amax.reshape(1).float(), ts.amax_history[:-1]])
    amax = hist.max()
    scale = torch.where(amax > 0,
                        _f32_div(fp8_max(dtype) / (2.0 ** margin), amax),
                        torch.ones_like(amax))
    return TensorScale(amax_history=hist, scale=scale.float())


def quantize(x: torch.Tensor, ts: TensorScale, dtype=E4M3) -> torch.Tensor:
    """Quantize with the (delayed) scale; saturating cast."""
    return _saturate_cast(x.float(), ts.scale, dtype)


def dequantize_scale(ts: TensorScale) -> torch.Tensor:
    return _f32_div(1.0, ts.scale)


def current_amax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


def _saturate_cast(x32: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    fmax = fp8_max(dtype)
    return torch.clamp(x32 * scale, -fmax, fmax).to(dtype)


class _Fp8Matmul(torch.autograd.Function):
    """The reference's ``fp8_matmul`` custom_vjp. Forward: both operands
    cast to ``fwd_dtype`` with their delayed scales, the backend's
    ``fp8_qdot`` (kernel A under ``hopper``; grad mode is off here, so
    the kernel's refusal of gradients does not fire). Backward: ``g``
    quantized to ``grad_dtype`` with its current amax, then the two
    products of the reference's ``jnp`` dots, as ``torch.matmul`` on the
    f32 upcast of the fp8 operands (exact), in the primal dtypes; zero
    gradients for the scales."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, fwd_dtype, grad_dtype, backend):
        from repro_torch.kernels.registry import get_backend
        from repro_torch.core.execution import BACKEND_ALIASES
        x_q = _saturate_cast(x.float(), x_scale, fwd_dtype)
        w_q = _saturate_cast(w.float(), w_scale, fwd_dtype)
        ctx.save_for_backward(x_q, w_q, x_scale, w_scale)
        ctx.dtypes = (x.dtype, w.dtype, grad_dtype)
        be = get_backend(BACKEND_ALIASES.get(backend, backend))
        return be.fp8_qdot(x_q, w_q, _f32_div(1.0, x_scale),
                           _f32_div(1.0, w_scale), out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        x_q, w_q, x_s, w_s = ctx.saved_tensors
        x_dtype, w_dtype, grad_dtype = ctx.dtypes
        g32 = g.float()
        g_amax = torch.clamp_min(g32.abs().amax(), 1e-12)
        g_scale = _f32_div(fp8_max(grad_dtype), g_amax)
        g_q = _saturate_cast(g32, g_scale, grad_dtype).float()
        dx = torch.matmul(g_q, w_q.float().t()) / (g_scale * w_s)
        dw = torch.matmul(x_q.float().reshape(-1, x_q.shape[-1]).t(),
                          g_q.reshape(-1, g_q.shape[-1])) / (g_scale * x_s)
        return (dx.to(x_dtype), dw.to(w_dtype), torch.zeros_like(x_s),
                torch.zeros_like(w_s), None, None, None)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor, fwd_dtype=E4M3, grad_dtype=E5M2,
               backend: str = "torch") -> torch.Tensor:
    """Differentiable tensor-scaled FP8 matmul, (…, K) × (K, N) → (…, N)
    in ``x``'s dtype. ``x_scale``/``w_scale`` are 0-d (delayed)
    quantization scales; ``backend`` names the registry backend of the
    forward GEMM (a JAX name is taken through its alias)."""
    return _Fp8Matmul.apply(x, w, x_scale, w_scale, fwd_dtype, grad_dtype,
                            backend)


def fp8_linear(x: torch.Tensor, w: torch.Tensor,
               state: Dict[str, TensorScale], name: str, history: int = 16,
               collect: Optional[Dict[str, torch.Tensor]] = None,
               backend: str = "torch") -> torch.Tensor:
    """Linear layer in FP8 with delayed scaling: ``state[name + '/x']``
    and ``state[name + '/w']`` are :class:`TensorScale` entries. With
    ``collect`` the current amaxes are recorded, so the step can make the
    next state with :func:`fold_amaxes`."""
    xs = state[f"{name}/x"]
    ws = state[f"{name}/w"]
    out = fp8_matmul(x, w, xs.scale, ws.scale, E4M3, E5M2, backend)
    if collect is not None:
        collect[f"{name}/x"] = current_amax(x.detach())
        collect[f"{name}/w"] = current_amax(w.detach())
    return out


def init_fp8_state(names, history: int = 16,
                   device=None) -> Dict[str, TensorScale]:
    state: Dict[str, TensorScale] = {}
    for n in names:
        state[f"{n}/x"] = TensorScale.init(history, device)
        state[f"{n}/w"] = TensorScale.init(history, device)
    return state


def fold_amaxes(state: Dict[str, TensorScale],
                amaxes: Dict[str, torch.Tensor]) -> Dict[str, TensorScale]:
    """Next step's scaling state from this step's observed amaxes."""
    out = dict(state)
    for k, amax in amaxes.items():
        out[k] = update_scale(state[k], amax)
    return out
