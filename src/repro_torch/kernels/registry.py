"""Matmul backend registry — the one seam every GEMM of the port crosses.

Twin of ``repro/kernels/registry.py``. Each backend exposes the same four
entry points with the same signatures:

  ``dense(x, w)``                   — bf16/f32 GEMM, f32 accumulation
  ``fp8(x, w)``                     — dynamic per-tensor-scaled FP8 GEMM
  ``fp8_qdot(x_q, w_q, xs, ws)``    — pre-quantized FP8 GEMM + descale
  ``sparse24(x, values, meta)``     — packed 2:4 GEMM

Registered backends:

  ``ref``     plain f32 oracles
  ``torch``   ``torch.matmul`` on f32-upcast operands (twin of ``jnp``);
              its ``sparse24`` is the unpack-then-matmul oracle, as ``jnp``'s
  ``hopper``  the hand-written CUDA GEMMs (``csrc/gemm.cu``, and
              ``csrc/sparse24_gemm.cu`` for packed weights) for every CUDA
              tensor and every shape — there is no shape fallback; CPU
              tensors take the kernels' plain versions
  ``hopper_sparse24``  ``hopper`` with the packed 2:4 GEMM as the primary
              path: its ``dense`` entry prunes and packs a dense weight per
              call (twin of ``pallas_sparse24``)

``x`` may carry leading batch dims; they are flattened into M. ``bm/bn/bk``
are accepted for signature parity and ignored: the CUDA kernel picks its
own tile from M.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import concurrency as cc
from repro_torch.core import fp8 as fp8lib
from repro_torch.core import sparsity as sp
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import ref
from repro_torch.kernels import sparse24_matmul as sm

# The four matmul flavors every backend provides — also the valid ``kind``
# values for the async :meth:`MatmulBackend.dispatch` entry point.
KINDS = ("dense", "fp8", "fp8_qdot", "sparse24")


@dataclasses.dataclass(frozen=True)
class MatmulBackend:
    """One named execution substrate for the four matmul flavors."""
    name: str
    dense: Callable
    fp8: Callable
    fp8_qdot: Callable
    sparse24: Callable
    description: str = ""

    def entry(self, kind: str) -> Callable:
        if kind not in KINDS:
            raise KeyError(
                f"unknown matmul kind {kind!r}; one of {', '.join(KINDS)}")
        return getattr(self, kind)

    def dispatch(self, kind: str, *operands, lane=None, overlap_group=-1,
                 **kw) -> "cc.LaneHandle":
        """Async entry point: enqueue ``kind`` on ``lane``'s stream and
        return a joinable :class:`~repro_torch.core.concurrency.LaneHandle`
        (``join()`` waits on the event recorded after the call). Without a
        lane, a throwaway lane named after the backend is made on the
        first operand's device; a CPU operand runs synchronously."""
        fn = self.entry(kind)
        if lane is None:
            lane = cc.ExecutionLane(f"{self.name}:{kind}",
                                    device=operands[0].device)
        return lane.dispatch(functools.partial(fn, *operands, **kw),
                             label=f"{self.name}.{kind}",
                             overlap_group=overlap_group)


_REGISTRY: Dict[str, MatmulBackend] = {}


def register_backend(backend: MatmulBackend) -> MatmulBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> MatmulBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown matmul backend {name!r}; available: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _flatten_lead(x: torch.Tensor):
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


# ---------------------------------------------------------------------------
# ref — exact-f32 oracles
# ---------------------------------------------------------------------------

def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _ref_dense(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None, bk=None):
    x2, lead = _flatten_lead(x)
    return _f32_dot(x2, w).to(out_dtype).reshape(*lead, w.shape[-1])


def _ref_fp8(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None, bk=None):
    x2, lead = _flatten_lead(x)
    xq, xinv = fp8lib.quantize_weight_static(x2)
    wq, winv = fp8lib.quantize_weight_static(w)
    out = _f32_dot(xq, wq) * (xinv * winv)
    return out.to(out_dtype).reshape(*lead, w.shape[-1])


def _ref_fp8_qdot(x_q, w_q, x_inv_scale=1.0, w_inv_scale=1.0, *,
                  out_dtype=torch.float32, bm=None, bn=None, bk=None):
    x2, lead = _flatten_lead(x_q)
    out = _f32_dot(x2, w_q) * (x_inv_scale * w_inv_scale)
    return out.to(out_dtype).reshape(*lead, w_q.shape[-1])


def _ref_sparse24(x, values, meta, *, out_dtype=torch.bfloat16, bm=None,
                  bn=None, bk=None):
    return ref.sparse24_matmul_ref(x, values, meta, out_dtype=out_dtype)


register_backend(MatmulBackend(
    name="ref", dense=_ref_dense, fp8=_ref_fp8, fp8_qdot=_ref_fp8_qdot,
    sparse24=_ref_sparse24,
    description="plain f32 oracles (ground truth for allclose tests)"))


# ---------------------------------------------------------------------------
# torch — library matmul (twin of the JAX package's jnp backend)
# ---------------------------------------------------------------------------

def _torch_dense(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
                 bk=None):
    return _f32_dot(x, w).to(out_dtype)


def _torch_fp8(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None, bk=None):
    return fp8lib.dynamic_fp8_matmul(x, w, out_dtype=out_dtype)


def _torch_fp8_qdot(x_q, w_q, x_inv_scale=1.0, w_inv_scale=1.0, *,
                    out_dtype=torch.float32, bm=None, bn=None, bk=None):
    return fp8lib.fp8_dot(x_q, w_q, x_inv_scale, w_inv_scale,
                          out_dtype=out_dtype)


register_backend(MatmulBackend(
    name="torch", dense=_torch_dense, fp8=_torch_fp8,
    fp8_qdot=_torch_fp8_qdot, sparse24=_ref_sparse24,
    description="torch.matmul on f32-upcast operands (the non-kernel path)"))


# ---------------------------------------------------------------------------
# hopper — the hand-written CUDA GEMM.
#
# The kernel has no backward, so each entry runs it forward inside an
# autograd Function whose backward differentiates the numerically
# equivalent torch reference, as the JAX backend's custom_vjp does.
# ---------------------------------------------------------------------------

class _FwdWithRefGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel_fn, ref_fn, *operands):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*operands)
        return kernel_fn(*operands)

    @staticmethod
    def backward(ctx, g):
        ops = [o.detach().requires_grad_(o.requires_grad)
               for o in ctx.saved_tensors]
        wants = [o for o in ops if o.requires_grad]
        with torch.enable_grad():
            out = ctx.ref_fn(*ops)
        grads = iter(torch.autograd.grad(out, wants, g, allow_unused=True))
        return (None, None,
                *(next(grads) if o.requires_grad else None for o in ops))


def _fwd_with_ref_grad(kernel_fn: Callable, ref_fn: Callable, *operands):
    """Run ``kernel_fn`` forward; differentiate through ``ref_fn``."""
    if torch.is_grad_enabled() and any(o.requires_grad for o in operands):
        return _FwdWithRefGrad.apply(kernel_fn, ref_fn, *operands)
    return kernel_fn(*operands)


def _gemm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    return fm.fp8_matmul(a.contiguous(), b.contiguous(), out_dtype)


def _hopper_dense(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
                  bk=None):
    x2, lead = _flatten_lead(x)
    out = _fwd_with_ref_grad(
        lambda a, b: _gemm(a, b, out_dtype),
        lambda a, b: _torch_dense(a, b, out_dtype=out_dtype), x2, w)
    return out.reshape(*lead, w.shape[-1])


def _hopper_fp8(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
                bk=None):
    x2, lead = _flatten_lead(x)

    def kernel(a, b):
        aq, ainv = fp8lib.quantize_weight_static(a)
        bq, binv = fp8lib.quantize_weight_static(b)
        return (_gemm(aq, bq, torch.float32) * (ainv * binv)).to(out_dtype)

    out = _fwd_with_ref_grad(
        kernel, lambda a, b: _torch_fp8(a, b, out_dtype=out_dtype), x2, w)
    return out.reshape(*lead, w.shape[-1])


def _hopper_fp8_qdot(x_q, w_q, x_inv_scale=1.0, w_inv_scale=1.0, *,
                     out_dtype=torch.float32, bm=None, bn=None, bk=None):
    x2, lead = _flatten_lead(x_q)
    acc = _gemm(x2, w_q, torch.float32)
    return (acc * (x_inv_scale * w_inv_scale)).to(out_dtype).reshape(
        *lead, w_q.shape[-1])


def _hopper_sparse24(x, values, meta, *, out_dtype=torch.bfloat16, bm=None,
                     bn=None, bk=None):
    x2, lead = _flatten_lead(x)
    out = _fwd_with_ref_grad(
        lambda a, v, m: sm.sparse24_matmul(a.contiguous(), v.contiguous(),
                                           m.contiguous(), out_dtype),
        lambda a, v, m: _ref_sparse24(a, v, m, out_dtype=out_dtype),
        x2, values, meta)
    return out.reshape(*lead, values.shape[-1])


register_backend(MatmulBackend(
    name="hopper", dense=_hopper_dense, fp8=_hopper_fp8,
    fp8_qdot=_hopper_fp8_qdot, sparse24=_hopper_sparse24,
    description="hand-written CUDA GEMMs for sm_90a (plain twins on CPU)"))


# ---------------------------------------------------------------------------
# hopper_sparse24 — the packed 2:4 GEMM as the primary path: a dense weight
# is pruned and packed inside each call (serving-style, no STE). The
# prune+pack re-runs per call; steady-state serving packs once
# (``execution.pack_model_params``) and hands ``PackedWeight``s to the
# model, which route straight to ``sparse24``. A weight the packed format
# cannot hold (not 2-D, or K % 8) takes ``hopper.dense``, the reference's
# own routing.
# ---------------------------------------------------------------------------

def _sparse24_primary_dense(x, w, *, out_dtype=torch.bfloat16, bm=None,
                            bn=None, bk=None):
    if w.dim() != 2 or w.shape[0] % 8:
        return _hopper_dense(x, w, out_dtype=out_dtype)
    values, meta = sp.pack_24(sp.prune_24(w))
    return _hopper_sparse24(x, values, meta, out_dtype=out_dtype)


register_backend(MatmulBackend(
    name="hopper_sparse24", dense=_sparse24_primary_dense, fp8=_hopper_fp8,
    fp8_qdot=_hopper_fp8_qdot, sparse24=_hopper_sparse24,
    description="hopper with on-the-fly 2:4 prune+pack for dense weights"))
