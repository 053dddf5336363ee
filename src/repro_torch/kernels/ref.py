"""Plain PyTorch oracles, twins of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import torch


def fp8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) × (K, N) → f32 accumulation of f32-upcast operands."""
    return torch.matmul(x_q.float(), w_q.float()).to(out_dtype)


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
