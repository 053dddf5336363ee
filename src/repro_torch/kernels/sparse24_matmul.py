"""Kernels D and E: the packed 2:4 GEMM (``csrc/sparse24_gemm.cu``) and the
block-2:4 tile-skipping GEMM (``csrc/block24_gemm.cu``).

Ports of ``repro/kernels/sparse24_matmul.py``:

* ``sparse24_matmul`` (kernel D, ``sparse24_matmul_pallas``): x (M, K) bf16
  times a packed 2:4 weight, values (K/2, N) in bf16, e4m3 or e5m2 and meta
  (K/8, N) uint8 (``core/sparsity.py``), f32 accumulation, output in f32 or
  bf16. The CUDA kernel masks ragged M, N and K (K % 8 == 0, which the
  packed format needs), so unlike the TPU kernel it takes every packable
  shape.
* ``block24_matmul`` (kernel E, ``block24_matmul_pallas``): x (M, K) bf16
  times ``w_packed`` (K/2, N) bf16, the kept K-blocks of a block-2:4 weight
  back to back; ``kept_idx`` names each one's dense K-block. M·N·K/2
  multiply-adds.

Each launches its kernel for CUDA tensors, with the tile and K splits of
:func:`gemm_plan.launch_plan`, and raises on what it does not take; for CPU
tensors it computes its plain PyTorch twin (:func:`sparse24_matmul_plain`,
:func:`block24_matmul_plain`). Under grad mode each refuses an operand
that requires grad, on either device (:func:`_build.refuse_grad`).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, gemm_plan, ref

# Launches of each CUDA kernel since the last reset (chip_smoke.py reads
# them): kernel D and kernel E.
LAUNCHES = 0
BLOCK24_LAUNCHES = 0

_VAL_TYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in _OUT_TYPES:
        raise TypeError(f"out_dtype {out_dtype}: want float32 or bfloat16")


def _on_one_cuda_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"operands on {[str(t.device) for t in ts]}: the "
                         "kernel needs all of them on one CUDA device")


# ---------------------------------------------------------------------------
# Kernel D: packed 2:4 GEMM
# ---------------------------------------------------------------------------

def sparse24_matmul_plain(x: torch.Tensor, values: torch.Tensor,
                          meta: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: unpack, then the exactly
    rounded f32 accumulation of the f32-upcast operands."""
    return ref.sparse24_matmul_ref(x, values, meta, out_dtype=out_dtype)


def sparse24_matmul(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) × packed (values (K/2, N), meta (K/8, N)) → (M, N)."""
    _build.refuse_grad("sparse24_matmul", x, values, meta)
    if all(t.device.type == "cpu" for t in (x, values, meta)):
        return sparse24_matmul_plain(x, values, meta, out_dtype)
    if _build.costing(x, values, meta):
        (M, K), N = x.shape, values.shape[1]
        return _build.meta_result(
            "sparse24_gemm", (M, N), out_dtype, 2.0 * M * N * (K // 2),
            M * K * x.dtype.itemsize + (K // 2) * N * values.dtype.itemsize
            + (K // 8) * N + M * N * out_dtype.itemsize, x)
    _on_one_cuda_device(x, values, meta)
    if x.dim() != 2 or values.dim() != 2 or meta.dim() != 2:
        raise ValueError(f"want x (M, K), values (K/2, N), meta (K/8, N); got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}, "
                         f"{tuple(meta.shape)}")
    (M, K), N = x.shape, values.shape[1]
    if K % 8:
        raise ValueError(f"K={K}: the packed 2:4 format needs K % 8 == 0")
    if values.shape != (K // 2, N) or meta.shape != (K // 8, N):
        raise ValueError(f"x {tuple(x.shape)} wants values {(K // 2, N)} and "
                         f"meta {(K // 8, N)}; got {tuple(values.shape)}, "
                         f"{tuple(meta.shape)}")
    if x.dtype != torch.bfloat16 or values.dtype not in _VAL_TYPES \
            or meta.dtype != torch.uint8:
        raise TypeError(f"types x {x.dtype}, values {values.dtype}, meta "
                        f"{meta.dtype}: the kernel takes bf16 x, bf16/e4m3/"
                        "e5m2 values and uint8 meta")
    _check_out_dtype(out_dtype)
    if not (x.is_contiguous() and values.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("the packed GEMM takes contiguous row-major operands")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load("sparse24_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_sparse24_gemm(
        x.data_ptr(), values.data_ptr(), meta.data_ptr(), out.data_ptr(),
        M, N, K, _VAL_TYPES[values.dtype], _OUT_TYPES[out_dtype],
        int(_aligned(x)), int(_aligned(values, meta) and N % 16 == 0),
        *gemm_plan.plan_args(
            gemm_plan.launch_plan(M, N, K, "sparse24", x.device), x.device,
            stream), stream)
    _build.check(status, "repro_sparse24_gemm")
    global LAUNCHES
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Kernel E: block-2:4 tile-skipping GEMM
# ---------------------------------------------------------------------------

def _check_block24(x, w_packed, kept: Tuple[int, ...], block: int) -> None:
    """The reference's checks (``block24_matmul_pallas``), without its
    divisibility of M and N, which the kernel masks."""
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"want x (M, K) and w_packed (K/2, N); got "
                         f"{tuple(x.shape)}, {tuple(w_packed.shape)}")
    K, Kh = x.shape[1], w_packed.shape[0]
    if K % 2 or Kh != K // 2:
        raise ValueError(f"w_packed has {Kh} rows, x has K={K}: want K/2")
    if block <= 0 or Kh % block or len(kept) != Kh // block:
        raise ValueError(f"{len(kept)} kept blocks of {block} rows do not "
                         f"make up the {Kh} packed rows")
    if any(not 0 <= i < K // block for i in kept):
        raise ValueError(f"kept_idx {kept} names a block outside "
                         f"[0, {K // block})")


def block24_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, kept_idx,
                         block: int = 128,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather the kept columns of
    x, then the f32 accumulation of the f32-upcast operands."""
    return ref.block24_matmul_ref(x, w_packed, kept_idx, block, out_dtype)


@functools.lru_cache(maxsize=64)
def _kept_tensor(kept: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``kept`` as a device int32 array, built once per tuple and device
    (the TPU kernel baked it into the compiled grid)."""
    return torch.tensor(kept, dtype=torch.int32, device=device)


def block24_matmul(x: torch.Tensor, w_packed: torch.Tensor, kept_idx,
                   block: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K) × w_packed (K/2, N) over the kept K-blocks → (M, N)."""
    _build.refuse_grad("block24_matmul", x, w_packed)
    kept = tuple(int(i) for i in kept_idx)
    _check_block24(x, w_packed, kept, block)
    if x.device.type == "cpu" and w_packed.device.type == "cpu":
        return block24_matmul_plain(x, w_packed, kept, block, out_dtype)
    _on_one_cuda_device(x, w_packed)
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.bfloat16:
        raise TypeError(f"types x {x.dtype}, w_packed {w_packed.dtype}: the "
                        "kernel takes bf16 x bf16")
    _check_out_dtype(out_dtype)
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("the block-2:4 GEMM takes contiguous row-major "
                         "operands")
    (M, K), N = x.shape, w_packed.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    kept_t = _kept_tensor(kept, x.device)
    lib = _build.load("block24_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_block24_gemm(
        x.data_ptr(), w_packed.data_ptr(), kept_t.data_ptr(), out.data_ptr(),
        M, N, K, block, _OUT_TYPES[out_dtype],
        int(_aligned(x) and K % 8 == 0 and block % 64 == 0),
        int(_aligned(w_packed) and N % 8 == 0),
        *gemm_plan.plan_args(
            gemm_plan.launch_plan(M, N, K // 2, "block24", x.device),
            x.device, stream), stream)
    _build.check(status, "repro_block24_gemm")
    global BLOCK24_LAUNCHES
    BLOCK24_LAUNCHES += 1
    return out
