"""Kernel C: paged flash-decode attention (``csrc/paged_attention.cu``).

Twin of ``repro/kernels/paged_attention.py``. The paged serving cache
(:mod:`repro_torch.core.paging`) stores K/V in a pool of fixed-size pages;
each decode slot owns a logical→physical page table. The kernel reads one
query row per (slot, head) against the slot's pages: online softmax in f32,
page entries of ``-1`` and positions at or past ``lengths`` masked, GQA by
``h // (h // kvh)``, output ``(B, h, hd)`` f32.

Layout: q ``(B, h, hd)``; pools ``(P, page_size, kvh, hd)``; page table
``(B, max_pages)`` int32 with ``-1`` = unallocated; ``lengths (B,)`` =
written positions per slot.

The kernel splits each slot's page walk over several blocks and folds the
partials in a fixed order (flash decoding): :func:`split_plan` picks the
splits from the shape alone, so every call on one shape sums in the same
order and gives the same bits.

:func:`paged_flash_decode` launches the kernel for CUDA tensors and raises
on what it does not take (and, on either device, on an operand that
requires grad under grad mode: the kernel is forward only); for CPU tensors it computes
:func:`paged_flash_decode_plain`, which returns 0 on a row with no valid
position, as the TPU kernel does. :func:`paged_attention_reference` is the
reference's gather-then-softmax oracle, kept with its own behaviour on such
rows (the mean of the V rows it gathered). As in the reference, the serving
decode step (``models/transformer.py``) gathers the pages back into the
dense layout and never calls this kernel; its entry points are
:func:`paged_decode_attention` and the page-geometry sweep
:func:`sweep_paged_tilings`, which records into ``execution.BLOCK_CACHE``.

Importing this module registers the ``hopper_paged`` backend (GEMM entries
of ``hopper``; JAX name ``pallas_paged``).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.core import execution as ex
from repro_torch.core.characterization import Record
from repro_torch.kernels import _build
from repro_torch.kernels import gemm_plan
from repro_torch.kernels import registry

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it).
LAUNCHES = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
POOL_DTYPES = (torch.bfloat16, torch.float32)
MAX_GROUP = 16          # query heads per kv head: one warp each

# The kernel walks positions in chunks of CHUNK rows (one per lane) and
# aims at BLOCKS_PER_SM blocks per SM: about one wave at two blocks per SM,
# each holding a few chunks in flight.
CHUNK = 32
BLOCKS_PER_SM = 2.0

# Page geometries the tiling sweep measures: one (1, page_size, hd) tile
# per page step (one query row, one page of KV depth-``hd``).
SWEEP_PAGE_SIZES = (8, 16, 32)


def _check_shapes(q, k_pages, v_pages, page_map, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q (B,h,hd), pools (P,ps,kvh,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, h, hd = q.shape
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != hd or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)} do not match (head_dim, "
                         "h % kvh == 0)")
    if page_map.dim() != 2 or page_map.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"want page_map (B, mp) and lengths (B,) with "
                         f"B={B}; got {tuple(page_map.shape)}, "
                         f"{tuple(lengths.shape)}")


# ---------------------------------------------------------------------------
# The reference's oracle and the kernel's plain version
# ---------------------------------------------------------------------------

def _gather(q, k_pages, v_pages, page_map, lengths):
    """Gather each slot's pages into (B, mp*ps, kvh, hd) f32 with the
    validity mask of every gathered row."""
    B, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    mp = page_map.shape[1]
    pm = page_map.long()
    safe = pm.clamp(min=0)
    k = k_pages[safe].reshape(B, mp * ps, kvh, hd).float()
    v = v_pages[safe].reshape(B, mp * ps, kvh, hd).float()
    pos = torch.arange(mp * ps, device=q.device)
    valid = (pos[None, :] < lengths.long()[:, None]) \
        & (pm >= 0).repeat_interleave(ps, dim=1)            # (B, S)
    q4 = q.reshape(B, kvh, h // kvh, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", q4, k) * (hd ** -0.5)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s, v, valid


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_map: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Gather-then-attend oracle. q ``(B, h, hd)``; pools
    ``(P, ps, kvh, hd)``; page_map ``(B, mp)``; lengths ``(B,)`` →
    ``(B, h, hd)`` f32. A row with no valid position takes a uniform
    softmax over the rows it gathered, as the reference's does."""
    _check_shapes(q, k_pages, v_pages, page_map, lengths)
    s, v, _ = _gather(q, k_pages, v_pages, page_map, lengths)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v).reshape(q.shape)


def paged_flash_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_map: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, f32: softmax over the valid
    positions, and 0 on a row that has none (the kernel's ``acc /
    max(l, 1e-30)`` with nothing accumulated)."""
    _check_shapes(q, k_pages, v_pages, page_map, lengths)
    s, v, valid = _gather(q, k_pages, v_pages, page_map, lengths)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid[:, None, None, :]
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bkgs,bskd->bkgd", p, v) / den).reshape(q.shape)


# ---------------------------------------------------------------------------
# The split plan: how each slot's walk is cut over blocks
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class SplitPlan:
    """``splits`` ranges of ``chunks_per_split`` whole chunks each (the last
    may be shorter) over positions ``0 .. max_pos``."""
    splits: int
    chunks_per_split: int

    @property
    def span(self) -> int:
        return self.chunks_per_split * CHUNK

    def ranges(self, max_pos: int) -> List[Tuple[int, int]]:
        """[p0, p1) of each split, in the order the kernel folds them."""
        return [(z * self.span, min(max_pos, (z + 1) * self.span))
                for z in range(self.splits)]

    def describe(self, batch: int, kv_heads: int) -> str:
        return (f"S={self.splits} x {self.span} positions, grid "
                f"{kv_heads}x{batch}x{self.splits} = "
                f"{kv_heads * batch * self.splits} blocks")


@functools.lru_cache(maxsize=None)
def split_plan(batch: int, kv_heads: int, max_pos: int,
               sm_count: int) -> SplitPlan:
    """Splits for a (batch, kv_heads, max_pages * page_size) walk on a card
    of ``sm_count`` SMs: as many as reach ``BLOCKS_PER_SM * sm_count``
    blocks, none empty of table positions. A function of the shape only:
    the lengths live on the card, and the splits never depend on them."""
    if min(batch, kv_heads, max_pos, sm_count) < 1:
        raise ValueError(f"no split plan for batch={batch} "
                         f"kv_heads={kv_heads} max_pos={max_pos} on "
                         f"{sm_count} SMs")
    chunks = _cdiv(max_pos, CHUNK)
    want = min(chunks, max(1, _cdiv(int(BLOCKS_PER_SM * sm_count),
                                    batch * kv_heads)))
    per = _cdiv(chunks, want)
    return SplitPlan(_cdiv(chunks, per), per)


# Kernel C's workspace and counters, one set per stream (gemm_plan's).
SCRATCH = gemm_plan.StreamScratch()


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, heads: int, kv_heads: int, head_dim: int,
                max_pos: int, device: torch.device
                ) -> Tuple[SplitPlan, int, int]:
    """The split plan on a CUDA ``device`` and the scratch it needs: the
    workspace floats (each split's f32 partial m, l and acc per query head)
    and counters (one per slot and kv head); 0 and 0 with one split. One
    cached lookup per call; the set itself is the launching stream's
    (:data:`SCRATCH`)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = split_plan(batch, kv_heads, max_pos, sms)
    if p.splits == 1:
        return p, 0, 0
    group = heads // kv_heads
    part = group * head_dim + -(-2 * group // 4) * 4   # 16-byte pieces
    return p, batch * kv_heads * p.splits * part, batch * kv_heads


# ---------------------------------------------------------------------------
# The wrapper around the CUDA kernel
# ---------------------------------------------------------------------------

def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_map: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Fused page-walking flash decode → ``(B, h, hd)`` f32, one launch of
    the kernel (which folds its splits itself). Page ids are not checked
    against the pool size (that costs a device sync)."""
    tensors = (q, k_pages, v_pages, page_map, lengths)
    _build.refuse_grad("paged_flash_decode", q, k_pages, v_pages)
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return paged_flash_decode_plain(*tensors)
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("the paged decode kernel needs q, the pools, "
                         "page_map and lengths on one CUDA device")
    _check_shapes(*tensors)
    if k_pages.dtype not in POOL_DTYPES or not (
            q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"types {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: "
                        "the kernel takes bf16 or f32 pools and q in their "
                        "type")
    if page_map.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"page_map {page_map.dtype} and lengths "
                        f"{lengths.dtype}: the kernel takes int32")
    B, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    mp = page_map.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if h // kvh > MAX_GROUP:
        raise ValueError(f"{h // kvh} query heads per kv head > {MAX_GROUP}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged decode kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the paged decode kernel loads 16-byte vectors: "
                         "q and the pools must be 16-byte aligned")
    out = torch.empty((B, h, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or mp == 0 or ps == 0:
        return out.zero_()
    plan, n_floats, n_counters = launch_plan(B, h, kvh, hd, mp * ps,
                                             q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if plan.splits > 1:
        scratch = SCRATCH.get(q.device, stream, n_floats, n_counters)
        ws, counters = scratch.ws.data_ptr(), scratch.counters.data_ptr()
    lib = _build.load("paged_attention")
    status = lib.repro_paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_map.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws,
        counters, B, h, kvh, hd, ps, mp, plan.splits, plan.span,
        int(k_pages.dtype == torch.bfloat16), stream)
    _build.check(status, "repro_paged_flash_decode")
    global LAUNCHES
    LAUNCHES += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_map, lengths, *,
                           tracer=None) -> torch.Tensor:
    """Dispatch wrapper: the fused kernel, with a ``paged_attn`` event on
    ``tracer`` when one (duck-typed) is given."""
    B, h, hd = q.shape
    ps = k_pages.shape[1]
    if tracer is not None:
        tracer.record("paged_attn", m=B, k=hd, n=ps * page_map.shape[1],
                      backend="hopper_paged",
                      meta={"page_size": ps, "pages": int(k_pages.shape[0])})
    return paged_flash_decode(q, k_pages, v_pages, page_map, lengths)


# ---------------------------------------------------------------------------
# Backend registration — the paged substrate is nameable
# ---------------------------------------------------------------------------

_hopper = registry.get_backend("hopper")
registry.register_backend(registry.MatmulBackend(
    name="hopper_paged",
    dense=_hopper.dense,
    fp8=_hopper.fp8,
    fp8_qdot=_hopper.fp8_qdot,
    sparse24=_hopper.sparse24,
    description="hopper GEMMs + the hand-written paged flash-decode kernel "
                "(kernels/csrc/paged_attention.cu)",
))


# ---------------------------------------------------------------------------
# Tiling sweep → block-shape evidence
# ---------------------------------------------------------------------------

def sweep_paged_tilings(batch: int = 4, kv_heads: int = 2, heads: int = 4,
                        head_dim: int = 16, seq: int = 64,
                        page_sizes: Optional[List[int]] = None,
                        iters: int = 3, record_cache: bool = True,
                        device=None) -> List[Record]:
    """Measure the fused kernel across page geometries and return
    ``Record``s named ``pagedsweep/bf16/{B}x{S}x{hd}/1x{ps}x{hd}``. Each
    geometry gets full tables over a pool of ``batch * seq / ps + 1`` bf16
    pages and ``lengths = seq``. Time is the host clock around ``iters``
    calls, each ending in a device synchronise; with ``record_cache`` the
    best page size per shape goes into ``execution.BLOCK_CACHE``. Runs on
    ``cuda`` unless ``device`` names another device."""
    from repro_torch.runtime.serve_loop import resolve_device
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for ps in (page_sizes or list(SWEEP_PAGE_SIZES)):
        if seq % ps:
            continue
        mp = seq // ps
        n_pages = batch * mp + 1
        gen = torch.Generator(device=dev).manual_seed(ps)
        q = torch.randn((batch, heads, head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
        shape = (n_pages, ps, kv_heads, head_dim)
        k_pages = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
        v_pages = torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
        page_map = torch.arange(batch * mp, dtype=torch.int32,
                                device=dev).reshape(batch, mp)
        lengths = torch.full((batch,), seq, dtype=torch.int32, device=dev)

        def fn():
            return paged_flash_decode(q, k_pages, v_pages, page_map, lengths)

        fn()                                       # build / warm
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            sync()
        secs = (time.perf_counter() - t0) / iters
        name = (f"pagedsweep/bf16/{batch}x{seq}x{head_dim}/"
                f"1x{ps}x{head_dim}")
        out.append(Record(
            name=name, us_per_call=secs * 1e6,
            derived={"page_size": ps, "pages": batch * mp,
                     "m": batch, "n": seq, "k": head_dim,
                     "kernel": "paged_flash_decode"}))
        if record_cache:
            ex.BLOCK_CACHE.record(batch, head_dim, seq, "bf16",
                                  (1, ps, head_dim), secs)
    return out
