"""The launch plan of the tile GEMM behind kernels A, D and E
(``csrc/tile_gemm.cuh``): which tile, and how K is split over blocks.

:func:`plan` is a plain function of its key (M, N, K, kind, SM count) and
caches its result: the same shapes always get the same tile and splits, so
the kernels sum in the same order on every call. The exact dense == paged
logits of ``serve_paged`` and run-to-run repeatability rest on that; the
plan never looks at memory, the stream or a timing.

Rule: the Small tile for M <= 16 (decode), the Wide one above (kernel E:
Deep, the Wide tile with a deeper ring). If the output tiles alone give
fewer blocks than :data:`BLOCKS_PER_SM` asks for, K is cut into ``splits``
ranges of ``steps_per_split`` whole BK steps, none empty, so that tiles ×
splits reaches it where K has the steps for it (on the 132-SM H100: 264
decode blocks for kernel A, 528 for kernel D, 132 for kernel E, 66 wide
ones). ``K`` is the depth the kernel walks: K for kernels A and D, the K/2
packed rows for kernel E. A batched launch (kernel A over a MoE layer's
``batch`` experts) counts every member's tiles toward that aim, and each
member gets the same tile and splits.

:func:`launch_plan` adds what a wrapper needs on the card, looked up once per
shape and device: the plan and the size of its split-K scratch (an f32
workspace of splits × M × N partial sums and one int32 counter per output
tile). The scratch itself belongs to the stream a wrapper launches on
(:class:`StreamScratch`, one dict access per call): launches on one stream
run in order and share one set, grown to the largest plan seen there, and
two streams never share partial sums or counters. The kernels reset the
counters themselves.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

# Tile id -> (BM, BN, BK), as csrc/tile_gemm.cuh's Small, Wide and Deep
# (Wide's 128 x 128 tile over a ring of 6 stages, kernel E's own).
SMALL, WIDE, DEEP = 0, 1, 2
TILES = {SMALL: (16, 64, 64), WIDE: (128, 128, 64), DEEP: (128, 128, 64)}
KINDS = ("gemm", "sparse24", "block24")
# The tile above M = 16, by kind.
PREFILL_TILE = {"gemm": WIDE, "sparse24": WIDE, "block24": DEEP}
# Blocks to aim for, per SM, by (kind, tile). Measured on the H100
# (PERF.md): the decode tile of kernel A is fastest at two blocks per SM,
# that of kernel D, whose blocks also decompress, at four, and that of
# kernel E, whose K is halved, unsplit (one per SM is under its 224 tiles
# at N = 14336); the wide tiles (one block per SM fits) at one block for
# every two SMs, since their split-K epilogue costs more than the blocks it
# adds gain.
BLOCKS_PER_SM = {("gemm", SMALL): 2.0, ("sparse24", SMALL): 4.0,
                 ("block24", SMALL): 1.0, ("gemm", WIDE): 0.5,
                 ("sparse24", WIDE): 0.5, ("block24", DEEP): 0.5}

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Plan:
    tile: int
    bm: int
    bn: int
    bk: int
    splits: int
    steps_per_split: int
    m_tiles: int
    n_tiles: int
    batch: int = 1

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits * self.batch

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        """[k0, k1) of each split, in the order the kernel sums them."""
        span = self.steps_per_split * self.bk
        return [(z * span, min(K, (z + 1) * span))
                for z in range(self.splits)]

    def describe(self) -> str:
        name = {SMALL: "small", WIDE: "wide", DEEP: "deep"}[self.tile]
        members = f" x {self.batch} members" if self.batch > 1 else ""
        return (f"{name} {self.bm}x{self.bn}x{self.bk}, {self.m_tiles}x"
                f"{self.n_tiles} tiles{members}, S={self.splits} x "
                f"{self.steps_per_split} steps, {self.blocks} blocks")


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, kind: str, sm_count: int,
         batch: int = 1) -> Plan:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: want one of {KINDS}")
    if min(M, N, batch) < 1 or K < 0 or sm_count < 1:
        raise ValueError(f"no plan for {batch} x M={M} N={N} K={K} on "
                         f"{sm_count} SMs")
    tile = SMALL if M <= 16 else PREFILL_TILE[kind]
    bm, bn, bk = TILES[tile]
    m_tiles, n_tiles = _cdiv(M, bm), _cdiv(N, bn)
    tiles = m_tiles * n_tiles * batch
    steps = max(1, _cdiv(K, bk))
    target = int(BLOCKS_PER_SM[kind, tile] * sm_count)
    splits = 1 if tiles >= target else min(_cdiv(target, tiles), steps)
    per = _cdiv(steps, splits)
    return Plan(tile, bm, bn, bk, _cdiv(steps, per), per, m_tiles, n_tiles,
                batch)


class Scratch:
    """One stream's split workspace (f32) and counters (int32, 0 between
    launches), grown on demand."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ws = torch.empty(0, dtype=torch.float32, device=device)
        self.counters = torch.zeros(0, dtype=torch.int32, device=device)

    def reserve(self, n_floats: int, n_counters: int) -> None:
        """Grow to at least these sizes. The caller runs on the stream this
        set serves, so a grown buffer is allocated on that stream, and the
        caching allocator hands the old one out again only to work queued
        there after the kernels that may still read it."""
        if n_floats > self.ws.numel():
            self.ws = torch.empty(n_floats, dtype=torch.float32,
                                  device=self.device)
        if n_counters > self.counters.numel():
            self.counters = torch.zeros(n_counters, dtype=torch.int32,
                                        device=self.device)


class StreamScratch:
    """Scratch sets keyed by (device, CUDA stream). Kernels A, D and E share
    one table (:data:`SCRATCH`), kernel C keeps one of its own."""

    def __init__(self):
        self._sets: Dict[Tuple[torch.device, int], Scratch] = {}

    def get(self, device: torch.device, stream: int, n_floats: int,
            n_counters: int) -> Scratch:
        """The set of ``stream`` (a ``cuda_stream`` handle) on ``device``,
        grown to these sizes."""
        s = self._sets.get((device, stream))
        if s is None:
            s = self._sets[device, stream] = Scratch(device)
        s.reserve(n_floats, n_counters)
        return s


SCRATCH = StreamScratch()


@functools.lru_cache(maxsize=None)
def launch_plan(M: int, N: int, K: int, kind: str,
                device: torch.device, batch: int = 1
                ) -> Tuple[Plan, int, int]:
    """The plan for a CUDA ``device`` and the split-K scratch it needs:
    workspace floats and counters (0 and 0 with one split), for every
    member of a batched launch. One cached lookup per wrapper call."""
    props = torch.cuda.get_device_properties(device)
    p = plan(M, N, K, kind, props.multi_processor_count, batch)
    if p.splits == 1:
        return p, 0, 0
    return p, batch * p.splits * M * N, batch * p.m_tiles * p.n_tiles


def plan_args(launch: Tuple[Plan, int, int], device: torch.device,
              stream: int) -> tuple:
    """The plan's arguments of a C entry point launched on ``stream`` (a
    ``cuda_stream`` handle): tile, splits, steps per split, and that
    stream's workspace and counters (null with one split)."""
    p, n_floats, n_counters = launch
    if p.splits == 1:
        return p.tile, 1, p.steps_per_split, None, None
    s = SCRATCH.get(device, stream, n_floats, n_counters)
    return (p.tile, p.splits, p.steps_per_split, s.ws.data_ptr(),
            s.counters.data_ptr())
