"""Public wrappers around the kernels, in the model's layouts.

Twin of ``repro/kernels/ops.py``. CUDA tensors go through the hand-written
kernels; CPU tensors through their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core import fp8 as fp8lib
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import sparse24_matmul as sm


def fp8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_inv_scale=1.0,
               w_inv_scale=1.0, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Pre-quantized fp8 GEMM with scalar descale."""
    acc = fm.fp8_matmul(x_q, w_q)
    return (acc * (x_inv_scale * w_inv_scale)).to(out_dtype)


def fp8_matmul_dynamic(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dynamic per-tensor scaling + the GEMM kernel. x: (..., K); w: (K, N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    x_q, x_inv = fp8lib.quantize_weight_static(x2)
    w_q, w_inv = fp8lib.quantize_weight_static(w)
    out = fp8_matmul(x_q, w_q, x_inv, w_inv, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[-1])


def sparse24_matmul(x: torch.Tensor, values: torch.Tensor, meta: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Packed 2:4 GEMM. x: (..., K); values (K/2, N); meta (K/8, N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = sm.sparse24_matmul(x2, values, meta, out_dtype=out_dtype)
    return out.reshape(*lead, values.shape[-1])


def block24_matmul(x: torch.Tensor, w_packed: torch.Tensor, kept_idx,
                   block: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Block-2:4 tile-skipping GEMM. x: (..., K); w_packed (K/2, N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = sm.block24_matmul(x2, w_packed, tuple(kept_idx), block=block,
                            out_dtype=out_dtype)
    return out.reshape(*lead, w_packed.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, h, hd) (model layout); k/v: (B, S, kvh, hd)."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    return fa.flash_attention(qt, kt, vt, causal=causal).transpose(1, 2)
