"""Plain PyTorch oracles, twins of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.core import sparsity as sp


def fp8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) × (K, N) → f32 accumulation of f32-upcast operands."""
    return torch.matmul(x_q.float(), w_q.float()).to(out_dtype)


def sparse24_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    return sp.sparse24_matmul_ref(x, values, meta, out_dtype=out_dtype)


def block24_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, kept_idx,
                       block: int = 128,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (M, K_dense) × packed (K_dense/2, N), kept dense-K block list."""
    cols = torch.cat([torch.arange(i * block, (i + 1) * block,
                                   device=x.device) for i in kept_idx])
    return (x[:, cols].float() @ w_packed.float()).to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Naive full-softmax attention. q: (B,h,Sq,hd); k/v: (B,kvh,Skv,hd).

    The causal mask is bottom-right aligned (``tril(k=Skv-Sq)``), as in the
    reference; the kernels' mask is top-left, equal when Sq == Skv."""
    h, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    kvh, skv = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
