"""Kernel B: forward flash attention (``csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
q (B, h, Sq, hd), k/v (B, kvh, Skv, hd), GQA by ``h // (h // kvh)``,
online softmax in f32, output in q's dtype. The causal mask is the TPU
kernel's top-left one (query i sees key j when i >= j); it agrees with the
bottom-right mask of ``ref.flash_attention_ref`` only when Sq == Skv, so a
causal call must have Sq == Skv (all that prefill uses). Any Sq and Skv run:
the kernel masks ragged tiles.

The kernel runs both products on the tensor cores (bf16 in, f32 sums; P
rounded to bf16 for P·V), one block per 32 query rows of one head, its kv
tiles shared out between four groups of warps (two at head_dim 256, whose
ring and accumulators are twice as large) and folded in a fixed order:
:func:`describe_grid` gives its launch shape.

``flash_attention`` launches the kernel for CUDA tensors and raises on what
it does not take; for CPU tensors it computes :func:`flash_attention_plain`;
inside the dry-run's trace ``meta`` tensors are costed and answered empty
(``_build.meta_result``), and raise elsewhere.
It is forward only, as the reference's kernel is: under grad mode an
operand that requires grad is refused on either device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it).
LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
NEG_INF = -1e30
# Query rows per block (csrc/flash_attention.cu BQ)
BLOCK_Q = 32


def block_threads(hd: int) -> int:
    """Threads per block (csrc/flash_attention.cu ``Shape<HD>::NT``): two
    row groups of four kv groups of warps, two kv groups above hd 128."""
    return 32 * 2 * (2 if hd > 128 else 4)


def describe_grid(batch: int, heads: int, sq: int, hd: int = 128) -> str:
    """The kernel's grid at this shape: (heads, batch, q tiles)."""
    tiles = -(-sq // BLOCK_Q)
    return (f"{BLOCK_Q}-row q tiles, grid {heads}x{batch}x{tiles} = "
            f"{heads * batch * tiles} blocks of {block_threads(hd)} threads")


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q (B,h,Sq,hd), k/v (B,kvh,Skv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, h, sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, h % kvh == 0)")
    if causal and sq != k.shape[2]:
        raise ValueError(f"causal attention needs Sq == Skv (top-left mask), "
                         f"got {sq} and {k.shape[2]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Full-softmax attention with the kernel's mask and f32 arithmetic."""
    _check_shapes(q, k, v, causal)
    h, sq, hd = q.shape[1], q.shape[2], q.shape[3]
    kvh, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, h, Sq, hd); k/v (B, kvh, Skv, hd) → (B, h, Sq, hd)."""
    _build.refuse_grad("flash_attention", q, k, v)
    devs = {q.device.type, k.device.type, v.device.type}
    if devs == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal)
    if _build.costing(q, k, v):
        _check_shapes(q, k, v, causal)
        B, h, sq, hd = q.shape
        kvh, skv = k.shape[1], k.shape[2]
        pairs = sq * (sq + 1) / 2 if causal else sq * skv
        return _build.meta_result(
            "flash_attention", q.shape, q.dtype, 4.0 * hd * B * h * pairs,
            2 * (B * h * sq + B * kvh * skv) * hd * q.dtype.itemsize, q)
    if devs != {"cuda"} or not (q.device == k.device == v.device):
        raise ValueError("the flash-attention kernel needs q, k and v on one "
                         "CUDA device")
    _check_shapes(q, k, v, causal)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"types {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes bf16")
    B, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash-attention kernel takes contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the flash-attention kernel copies 16-byte pieces: "
                         "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    status = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, h, kvh, sq, skv, hd, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "repro_flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out
