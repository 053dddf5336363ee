"""Kernel A: the tiled GEMM behind every linear layer (``csrc/gemm.cu``).

Port of ``repro/kernels/fp8_matmul.py::fp8_matmul_pallas``: (M, K) × (K, N)
with f32 accumulation, undescaled output in f32 or bf16. Operands are both
bf16, both e4m3 or both e5m2. The CUDA kernel masks ragged M, N and K
itself, so unlike the TPU kernel it takes every shape.

``fp8_matmul`` launches the kernel for CUDA tensors, with the tile and K
splits of :func:`gemm_plan.launch_plan`, and raises on what it does not
take; for CPU tensors it computes :func:`fp8_matmul_plain`, the kernel's
plain PyTorch twin (f32 operands, f32 accumulation); inside the dry-run's
trace ``meta`` tensors are costed and answered empty
(``_build.meta_result``), and raise elsewhere. On either device it
refuses an operand that requires grad under grad mode
(:func:`_build.refuse_grad`).

``fp8_matmul_batched`` is the same GEMM over a stack of E products of one
shape, (E, M, K) × (E, K, N), in one launch: the reference vmaps its GEMM
over a MoE layer's experts, which for a Pallas kernel is one
``pallas_call`` with an extra grid axis. Its plain twin is the per-member
loop of the plain GEMM.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm_plan

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it).
LAUNCHES = 0
# The same launches by operand type (a speculative fp8 draft shows as e4m3).
TYPE_LAUNCHES = {"bf16": 0, "e4m3": 0, "e5m2": 0}
# Of LAUNCHES, those of the expert-batched entry (fp8_matmul_batched).
BATCHED_LAUNCHES = 0
# The same launches by output width N (a stack's LM head has its own N).
WIDTH_LAUNCHES: dict = {}

_IN_TYPES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_TYPE_NAMES = {torch.bfloat16: "bf16", torch.float8_e4m3fn: "e4m3",
               torch.float8_e5m2: "e5m2"}
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def fp8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: every bf16/fp8 value is
    exact in f32, so this is the exactly-rounded f32 accumulation."""
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def _aligned(t: torch.Tensor, row_elems: int) -> bool:
    return (t.data_ptr() % 16 == 0
            and (row_elems * t.element_size()) % 16 == 0)


def fp8_matmul_batched_plain(x: torch.Tensor, w: torch.Tensor,
                             out_dtype=torch.float32) -> torch.Tensor:
    """The batched kernel's function in plain PyTorch: the plain GEMM of
    each member, stacked."""
    return torch.stack([fp8_matmul_plain(x[e], w[e], out_dtype)
                        for e in range(x.shape[0])])


def _check_operands(x, w, out_dtype, nd: int, want: str) -> None:
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError(f"operands on {x.device} and {w.device}: the GEMM "
                         "kernel needs both on one CUDA device")
    if x.dim() != nd or w.dim() != nd or x.shape[-1] != w.shape[-2] \
            or x.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"want {want}, got {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _IN_TYPES:
        raise TypeError(f"operand types {x.dtype} x {w.dtype}: the kernel "
                        "takes bf16 x bf16, e4m3 x e4m3 or e5m2 x e5m2")
    if out_dtype not in _OUT_TYPES:
        raise TypeError(f"out_dtype {out_dtype}: want float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the GEMM kernel takes contiguous row-major operands")


def _count(x: torch.Tensor, n: int) -> None:
    global LAUNCHES
    LAUNCHES += 1
    TYPE_LAUNCHES[_TYPE_NAMES[x.dtype]] += 1
    WIDTH_LAUNCHES[n] = WIDTH_LAUNCHES.get(n, 0) + 1


def fp8_matmul(x: torch.Tensor, w: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """x (M, K) × w (K, N) → (M, N) in ``out_dtype`` (f32 or bf16)."""
    _build.refuse_grad("fp8_matmul", x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fp8_matmul_plain(x, w, out_dtype)
    if _build.costing(x, w):
        (M, K), N = x.shape, w.shape[1]
        return _build.meta_result(
            "gemm", (M, N), out_dtype, 2.0 * M * N * K,
            (M * K + K * N) * x.dtype.itemsize + M * N * out_dtype.itemsize,
            x)
    _check_operands(x, w, out_dtype, 2, "(M, K) x (K, N)")
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_gemm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
        _IN_TYPES[x.dtype], _OUT_TYPES[out_dtype],
        int(_aligned(x, K)), int(_aligned(w, N)),
        *gemm_plan.plan_args(
            gemm_plan.launch_plan(M, N, K, "gemm", x.device), x.device,
            stream), stream)
    _build.check(status, "repro_gemm")
    _count(x, N)
    return out


def fp8_matmul_batched(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=torch.float32) -> torch.Tensor:
    """x (E, M, K) × w (E, K, N) → (E, M, N) in ``out_dtype``: E products
    of one shape in one launch (one count), each member planned and summed
    as :func:`fp8_matmul` would plan and sum it alone."""
    _build.refuse_grad("fp8_matmul_batched", x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fp8_matmul_batched_plain(x, w, out_dtype)
    if _build.costing(x, w):
        (E, M, K), N = x.shape, w.shape[2]
        return _build.meta_result(
            "gemm", (E, M, N), out_dtype, 2.0 * E * M * N * K,
            E * ((M * K + K * N) * x.dtype.itemsize
                 + M * N * out_dtype.itemsize), x)
    _check_operands(x, w, out_dtype, 3, "(E, M, K) x (E, K, N)")
    (E, M, K), N = x.shape, w.shape[2]
    out = torch.empty((E, M, N), dtype=out_dtype, device=x.device)
    if E == 0 or M == 0 or N == 0:
        return out
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.repro_gemm_batched(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, N, K,
        _IN_TYPES[x.dtype], _OUT_TYPES[out_dtype],
        int(_aligned(x, K)), int(_aligned(w, N)),
        *gemm_plan.plan_args(
            gemm_plan.launch_plan(M, N, K, "gemm", x.device, E), x.device,
            stream), stream)
    _build.check(status, "repro_gemm_batched")
    _count(x, N)
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
