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
are accepted for signature parity and ignored, so the block-shape cache
(``core/execution.BLOCK_CACHE``, seeded by the autotune store) is inert
under ``hopper``: the tile and K splits of kernels A and D come from
``kernels/gemm_plan.plan``, a pure function of (M, N, K, kind, SM count).
The reference hands the cached blocks to its Pallas kernel. The port does
not, because a plan read from a timing artifact would make a process's
logits depend on which artifact it loaded: other splits sum in another
order, and the dense and paged logits are bit-equal only under one plan.
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
# The kernels have no backward of their own. The bf16 linear and expert
# entries run kernel A forward inside :class:`_KernelLinear`, whose backward
# takes the two gradient products directly; the fp8 and 2:4 entries run
# their kernel forward inside :class:`_FwdWithRefGrad`, whose backward
# differentiates the numerically equivalent torch reference, as the JAX
# backend's custom_vjp does.
# ---------------------------------------------------------------------------

# Backward calls of the differentiable entries since the last reset, by
# path: "kernel" takes both gradient products on kernel A (cotangent and
# operands all bf16); "reference" on the torch reference's f32 products (an
# f32 cotangent or operand, and the fp8 and 2:4 entries). A traced training
# step puts its deltas in its backward phase (``runtime/train_loop``).
BACKWARD_PATHS = {"kernel": 0, "reference": 0}


class _FwdWithRefGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel_fn, ref_fn, *operands):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*operands)
        return kernel_fn(*operands)

    @staticmethod
    def backward(ctx, g):
        BACKWARD_PATHS["reference"] += 1
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


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def _f32_mm_grads(g, a, b, need_a: bool, need_b: bool):
    """The gradients of ``torch.matmul(a.float(), b.float())`` (2-D) at the
    cotangent ``g``, each in its operand's dtype: the f32 products autograd
    takes through that reference, call for call (a column-major operand
    gets its gradient column-major, as ``mm``'s backward gives it), so
    they are bit-equal to differentiating it, with no forward run again."""
    g, af, bf = g.float(), a.float(), b.float()
    da = db = None
    if need_a:
        da = (bf.mm(g.t()).t() if _col_major(af)
              else g.mm(bf.t())).to(a.dtype)
    if need_b:
        db = (g.t().mm(af).t() if _col_major(bf)
              else af.t().mm(g)).to(b.dtype)
    return da, db


def _kernel_grads(g, x, w, need_x: bool, need_w: bool):
    """dX = g · wᵀ and dW = xᵀ · g on kernel A in bf16, each one launch
    (one expert-batched launch for (E, M, K) × (E, K, N) operands); the
    transposed operands are made contiguous, as the kernel takes them."""
    g = g.contiguous()
    if x.dim() == 3:
        mm, t = fm.fp8_matmul_batched, lambda u: u.transpose(1, 2)
    else:
        mm, t = fm.fp8_matmul, torch.t
    dx = mm(g, t(w).contiguous(), torch.bfloat16) if need_x else None
    dw = mm(t(x).contiguous(), g, torch.bfloat16) if need_w else None
    return dx, dw


class _KernelLinear(torch.autograd.Function):
    """``x @ w`` on kernel A forward (2-D, or (E, M, K) × (E, K, N) with
    one product per expert), differentiated by the two gradient products
    themselves. With the cotangent and both operands in bf16 each product
    is kernel A's (every product of bf16 values is exact in f32 and every
    sum an f32 sum, as in the reference's f32 products; only the order of
    the sums differs, as in the forward). Otherwise (an f32 cotangent, as
    the LM head's f32 logits give, or an f32 operand) they are the f32
    reference's own products (:func:`_f32_mm_grads`), since rounding an f32
    cotangent to bf16 would lose what the reference keeps."""
    @staticmethod
    def forward(ctx, kernel_fn, x, w):
        ctx.save_for_backward(x, w)
        return kernel_fn(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[1:]
        if g.dtype == x.dtype == w.dtype == torch.bfloat16:
            BACKWARD_PATHS["kernel"] += 1
            return (None, *_kernel_grads(g, x, w, need_x, need_w))
        BACKWARD_PATHS["reference"] += 1
        if x.dim() == 2:
            return (None, *_f32_mm_grads(g, x, w, need_x, need_w))
        dx, dw = zip(*(_f32_mm_grads(g[e], x[e], w[e], need_x, need_w)
                       for e in range(x.shape[0])))
        return (None, torch.stack(dx) if need_x else None,
                torch.stack(dw) if need_w else None)


def _kernel_linear(kernel_fn: Callable, x, w):
    """Run ``kernel_fn(x, w)`` (= ``x @ w``); differentiate by
    :class:`_KernelLinear`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _KernelLinear.apply(kernel_fn, x, w)
    return kernel_fn(x, w)


def _gemm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    return fm.fp8_matmul(a.contiguous(), b.contiguous(), out_dtype)


def _hopper_dense(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
                  bk=None):
    x2, lead = _flatten_lead(x)
    out = _kernel_linear(lambda a, b: _gemm(a, b, out_dtype), x2, w)
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


def hopper_experts(x, w, *, precision: str = "bf16",
                   out_dtype=torch.bfloat16):
    """x (E, M, K) × w (E, K, N) → (E, M, N) on kernel A in one launch: a
    MoE layer's per-expert GEMMs, which the reference runs as its GEMM
    vmapped over the experts (one ``pallas_call`` with an extra grid axis).
    Under fp8 each expert's activation rows and weight get their own amax
    and scale, as ``hopper.fp8`` gives each expert called alone
    (:func:`fp8lib.quantize_stack`), and backward differentiates the
    per-expert reference. In bf16, backward is two more expert-batched
    launches (dX and dW, :class:`_KernelLinear`)."""
    if precision != "fp8":
        return _kernel_linear(lambda a, b: fm.fp8_matmul_batched(
            a.contiguous(), b.contiguous(), out_dtype), x, w)

    def kernel(a, b):
        aq, ainv = fp8lib.quantize_stack(a)
        bq, binv = fp8lib.quantize_stack(b)
        acc = fm.fp8_matmul_batched(aq, bq, torch.float32)
        return (acc * (ainv * binv)[:, None, None]).to(out_dtype)

    return _fwd_with_ref_grad(
        kernel, lambda a, b: torch.stack(
            [_torch_fp8(a[e], b[e], out_dtype=out_dtype)
             for e in range(a.shape[0])]),
        x, w)


def _hopper_fp8_qdot(x_q, w_q, x_inv_scale=1.0, w_inv_scale=1.0, *,
                     out_dtype=torch.float32, bm=None, bn=None, bk=None):
    x2, lead = _flatten_lead(x_q)
    acc = _gemm(x2, w_q, torch.float32)
    scale = x_inv_scale * w_inv_scale
    # unit scales given as numbers (execution.raw_matmul's) need no
    # descale pass over the output: acc * 1.0 is acc, bit for bit
    if not (isinstance(scale, (int, float)) and scale == 1.0):
        acc = acc * scale
    return acc.to(out_dtype).reshape(*lead, w_q.shape[-1])


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
