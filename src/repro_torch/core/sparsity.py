"""2:4 structured sparsity: pruning, packing and the plain oracles.

A copy, in PyTorch, of ``repro/core/sparsity.py``; the bytes it produces are
bit-equal to the reference's on the same input:

* ``prune_24`` keeps the two largest magnitudes of every group of four
  consecutive rows along K (axis 0 of a (K, N) weight); ties go to the lower
  index (stable sorts). The pruned entries carry the reference's signed
  zeros: it computes ``g * keep``, which XLA on the CPU turns into a select
  (+0.0) for the types it computes natively (f32, f16) and keeps as a
  multiply (-0.0 for a pruned negative value) for bf16 and fp8.
* ``pack_24`` stores each group's two kept values, nonzeros first and then
  zero-padding slots, each in position order, as values (K/2, N) and their
  2-bit in-group positions four to a byte as meta (K/8, N) uint8:
  ``p0 | p1 << 2 | p2 << 4 | p3 << 6`` for groups 2g and 2g+1.
* ``prune_block24`` keeps 2 of every 4 consecutive K-blocks by their
  absolute mass (the tile-skipping variant).

Sorts run on an f32 upcast: every bf16 and fp8 value is exact in f32, so the
order, ties included, is the one the working type gives. Products that set
values (``g * keep``, the one-hot unpack) run in f32 and are cast back,
which is exact, since PyTorch has no fp8 arithmetic on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch


# ---------------------------------------------------------------------------
# 2:4 pruning (element granularity, along K = axis 0 of a (K, N) weight)
# ---------------------------------------------------------------------------

# Types whose masked multiply the reference's XLA rewrites into a select.
_SELECT_TYPES = (torch.float32, torch.float16)


def _ranks(mag: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank of each entry along ``dim`` in a stable descending sort."""
    order = torch.argsort(-mag, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def prune_24(w: torch.Tensor) -> torch.Tensor:
    """Magnitude-prune to 2:4 along axis 0. ``w``: (K, N), K % 4 == 0."""
    K, N = w.shape
    if K % 4:
        raise ValueError(f"K={K} must be divisible by 4")
    g = w.reshape(K // 4, 4, N)
    keep = _ranks(g.float().abs(), 1) < 2
    if w.dtype in _SELECT_TYPES:
        out = torch.where(keep, g, torch.zeros_like(g))
    else:
        out = (g.float() * keep.float()).to(w.dtype)
    return out.reshape(K, N)


def check_24(w: torch.Tensor) -> torch.Tensor:
    """True iff every group of 4 along axis 0 has <= 2 nonzeros."""
    K, N = w.shape
    nnz = (w.reshape(K // 4, 4, N).float() != 0).sum(dim=1)
    return torch.all(nnz <= 2)


# ---------------------------------------------------------------------------
# Packing: values (K/2, N) + 2-bit indices packed 4/byte (K/8, N)
# ---------------------------------------------------------------------------

# Types ``torch.gather`` cannot take on the CPU: they move as raw bits.
_BIT_GATHER_TYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _gather_values(g: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather`` along dim 1. A gather copies, so the values move
    unchanged, signed zeros included. It runs in the values' own type,
    which keeps the gradient to them (the reference's ``pack_24`` is
    differentiable in its values); fp8 values, which the CPU cannot
    gather, move as uint8 bits and carry no gradient."""
    if g.dtype not in _BIT_GATHER_TYPES:
        return torch.gather(g, 1, index)
    return torch.gather(g.view(torch.uint8), 1, index).view(g.dtype)


def pack_24(w24: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a 2:4 weight. Returns (values (K/2, N), meta (K/8, N) uint8).

    Groups with fewer than 2 nonzeros are padded with zero slots."""
    K, N = w24.shape
    if K % 8:
        raise ValueError(f"K={K} must be divisible by 8 for byte packing")
    g = w24.reshape(K // 4, 4, N)
    nz = g.float() != 0
    pos = torch.arange(4, dtype=torch.int32, device=w24.device)[None, :, None]
    key = torch.where(nz, pos, pos + 4)       # nonzeros sort before zeros
    order = torch.argsort(key, dim=1, stable=True)[:, :2, :]   # (G, 2, N)
    values = _gather_values(g, order).reshape(K // 2, N)
    idx = order.to(torch.uint8).reshape(K // 8, 4, N)
    meta = (idx[:, 0] | (idx[:, 1] << 2) | (idx[:, 2] << 4)
            | (idx[:, 3] << 6))
    return values.contiguous(), meta.contiguous()


def unpack_meta(meta: torch.Tensor) -> torch.Tensor:
    """(K/8, N) uint8 -> (K/2, N) int32 in-group positions (0..3)."""
    K8, N = meta.shape
    parts = [(meta >> s) & 0x3 for s in (0, 2, 4, 6)]
    return torch.stack(parts, dim=1).reshape(K8 * 4, N).to(torch.int32)


def unpack_24(values: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Decompress packed 2:4 back to dense (K, N), by the reference's
    one-hot sum in f32."""
    K2, N = values.shape
    K = K2 * 2
    gidx = unpack_meta(meta).reshape(K // 4, 2, N)
    gvals = values.float().reshape(K // 4, 2, N)
    slots = torch.arange(4, dtype=torch.int32, device=values.device)
    onehot = gidx[:, :, None, :] == slots[None, None, :, None]
    dense = (gvals[:, :, None, :] * onehot.float()).sum(dim=1)
    return dense.reshape(K, N).to(values.dtype)


def sparse24_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                        meta: torch.Tensor,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Oracle: decompress, then a dense matmul with f32 accumulation.
    ``x``: (..., K)."""
    w = unpack_24(values, meta)
    return torch.matmul(x.float(), w.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# Block-2:4 (tile-skipping) variant
# ---------------------------------------------------------------------------

def prune_block24(w: torch.Tensor, block: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune 2 of every 4 consecutive K-blocks (by absolute mass).
    Returns (w_pruned dense (K, N), keep_mask (K/block,) bool)."""
    K, N = w.shape
    if K % (4 * block):
        raise ValueError(f"K={K} must divide 4*block={4 * block}")
    nb = K // block
    blocks = w.reshape(nb, block, N)
    mass = blocks.float().abs().sum(dim=(1, 2))
    keep = (_ranks(mass.reshape(nb // 4, 4), 1) < 2).reshape(nb)
    wp = (blocks.float() * keep[:, None, None].float()).reshape(K, N)
    return wp.to(w.dtype), keep


def block24_matmul_ref(x: torch.Tensor, w_pruned: torch.Tensor,
                       keep: torch.Tensor, block: int = 128,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Oracle for the tile-skipping kernel: gather kept blocks, half-K
    matmul."""
    K, N = w_pruned.shape
    nb = K // block
    kept_idx = torch.nonzero(keep).reshape(-1)[: nb // 2]
    wb = w_pruned.reshape(nb, block, N)[kept_idx]          # (nb/2, block, N)
    xb = x.reshape(*x.shape[:-1], nb, block)[..., kept_idx, :]
    acc = torch.einsum("...gk,gkn->...n", xb.float(), wb.float())
    return acc.to(out_dtype)


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def packed_bytes(K: int, N: int, value_dtype=torch.float8_e4m3fn) -> int:
    return (K // 2) * N * _itemsize(value_dtype) + (K // 8) * N


def dense_bytes(K: int, N: int, dtype=torch.bfloat16) -> int:
    return K * N * _itemsize(dtype)
