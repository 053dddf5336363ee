"""Paged serving-cache allocator (the block table, host side).

Copy of ``repro/core/paging.py`` (pure numpy; the port keeps its own copy
rather than import the JAX package). A pool of fixed-size pages
(``page_size`` token positions each) is handed out from a LIFO free list,
with a per-slot page table mapping logical page index → physical page id.
The physical half (the pooled cache tensors and the page-walking
attention) lives in :mod:`repro_torch.models.transformer` and
:mod:`repro_torch.kernels.paged_attention`;
:class:`~repro_torch.runtime.serve_loop.ServeSession` keeps the two in
sync.

One page id is shared by every layer: physical page ``p`` names the same
``page_size`` rows in each layer's K, V and position pool, so the table is
per-slot, not per-layer. SSM/linear-attention state has no sequence axis;
the allocator accounts it as one fixed *state block* per occupied slot.

Invariants the serving tests pin:
* a slot's table is always a logical *prefix* (lazy append, never holes);
* a freed page returns to the free list only after the session scrubbed
  its pool rows (k/v zeroed, pos ``-1``) — free-list reuse can never leak
  a previous tenant's KV;
* allocation failure raises :class:`PagesExhausted` (admission is
  *refused*, the session does not crash) — callers gate on
  :meth:`PageAllocator.can_alloc` first.

:meth:`PageAllocator.record` forwards a stats snapshot to a duck-typed
tracer as a ``paging`` event, and does nothing without one (the port has
no telemetry yet).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["PagesExhausted", "PageAllocator", "SlotTable", "pages_for",
           "state_block_tokens"]


class PagesExhausted(RuntimeError):
    """The pool has fewer free pages than the request needs. Admission
    paths treat this as back-pressure (queue the request), never as a
    crash."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions (ceil division)."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(page_size))


@dataclasses.dataclass
class SlotTable:
    """One slot's logical→physical page list (a strict prefix) plus its
    written-token count (for utilization accounting)."""
    pages: List[int] = dataclasses.field(default_factory=list)
    tokens: int = 0


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages of
    ``page_size`` token positions, shared by every cache layer.

    ``max_pages_per_slot`` bounds each slot's table (``max_len //
    page_size`` in the session); :meth:`page_map` renders the tables as
    the dense ``(n_slots, max_pages_per_slot)`` int32 array (``-1`` =
    unallocated) the jitted decode step consumes.
    """

    def __init__(self, n_pages: int, page_size: int,
                 max_pages_per_slot: int, n_slots: int,
                 state_block_tokens: int = 0):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        if max_pages_per_slot <= 0 or n_slots <= 0:
            raise ValueError("max_pages_per_slot and n_slots must be "
                             "positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.n_slots = int(n_slots)
        # SSM/linear-attention state accounted per occupied slot (token-
        # position equivalents; 0 for pure-attention stacks).
        self.state_block_tokens = int(state_block_tokens)
        # LIFO free list: a just-freed page is the next one handed out,
        # which is exactly the reuse pattern the no-stale-KV test attacks.
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: List[SlotTable] = [SlotTable()
                                         for _ in range(self.n_slots)]
        # counters (monotonic; exposed via stats())
        self.alloc_count = 0
        self.free_count = 0
        self.extend_count = 0
        self.trim_count = 0
        self.oom_count = 0
        self.peak_pages_in_use = 0

    # -- queries -------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def occupied_slots(self) -> int:
        return sum(1 for t in self._tables if t.pages)

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's physical page ids, logical order (a copy)."""
        return list(self._tables[slot].pages)

    def slot_tokens(self, slot: int) -> int:
        return self._tables[slot].tokens

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def can_alloc(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Free-page headroom check for admission: could a fresh slot hold
        ``n_tokens`` positions right now?"""
        need = self.pages_for(n_tokens)
        return need <= self.max_pages_per_slot and self.can_alloc(need)

    # -- mutation ------------------------------------------------------------
    def _take(self, n: int) -> List[int]:
        if n > len(self._free):
            self.oom_count += 1
            raise PagesExhausted(
                f"need {n} page(s), {len(self._free)} free "
                f"(pool {self.n_pages} × {self.page_size} tokens)")
        taken = [self._free.pop() for _ in range(n)]
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)
        return taken

    def alloc_slot(self, slot: int, n_tokens: int) -> List[int]:
        """Give an empty slot its initial table: enough pages for
        ``n_tokens`` positions. Returns the physical page ids."""
        table = self._tables[slot]
        if table.pages:
            raise ValueError(f"slot {slot} already holds "
                             f"{len(table.pages)} page(s)")
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            raise PagesExhausted(
                f"{n_tokens} tokens need {need} pages > per-slot cap "
                f"{self.max_pages_per_slot}")
        pages = self._take(need)
        table.pages = pages
        table.tokens = int(n_tokens)
        self.alloc_count += 1
        return list(pages)

    def extend_slot(self, slot: int, n_tokens: int) -> List[int]:
        """Grow ``slot``'s table to cover ``n_tokens`` positions (lazy
        append on decode overflow). Returns the *new* physical page ids
        (possibly empty)."""
        table = self._tables[slot]
        if not table.pages:
            raise ValueError(f"slot {slot} has no table to extend")
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            raise PagesExhausted(
                f"{n_tokens} tokens need {need} pages > per-slot cap "
                f"{self.max_pages_per_slot}")
        grown: List[int] = []
        if need > len(table.pages):
            grown = self._take(need - len(table.pages))
            table.pages.extend(grown)
            self.extend_count += 1
        table.tokens = max(table.tokens, int(n_tokens))
        return grown

    def import_slot(self, slot: int, n_pages: int,
                    n_tokens: int) -> List[int]:
        """Allocate a table for a migrated-in slot: exactly ``n_pages``
        pages holding ``n_tokens`` already-written positions."""
        pages = self.alloc_slot(slot, n_pages * self.page_size)
        self._tables[slot].tokens = int(n_tokens)
        return pages

    def free_slot(self, slot: int) -> List[int]:
        """Return the slot's pages to the free list; the caller must have
        scrubbed (or be about to scrub) their pool rows. Returns the
        released page ids."""
        table = self._tables[slot]
        released = table.pages
        self._tables[slot] = SlotTable()
        self._free.extend(reversed(released))
        if released:
            self.free_count += 1
        return released

    def trim_slot(self, slot: int, n_tokens: int) -> List[int]:
        """Shrink ``slot``'s table back to what ``n_tokens`` committed
        positions need, releasing the surplus tail pages (the inverse of
        :meth:`extend_slot`; speculative decode over-grows for ``k``
        candidate positions and trims to the accepted count after the
        verify pass). The caller must already have scrubbed the released
        rows — the jitted verify step scrubs every rejected write before
        the host sees the accepted count, so the pages re-enter the free
        list clean. Returns the released page ids."""
        table = self._tables[slot]
        keep = max(1, self.pages_for(n_tokens)) if table.pages else 0
        if keep >= len(table.pages):
            table.tokens = min(table.tokens, int(n_tokens))
            return []
        released = table.pages[keep:]
        del table.pages[keep:]
        table.tokens = min(table.tokens, int(n_tokens))
        self._free.extend(reversed(released))
        self.trim_count += 1
        return released

    def note_tokens(self, slot: int, n_tokens: int) -> None:
        """Advance the slot's written-token count (utilization only)."""
        t = self._tables[slot]
        t.tokens = max(t.tokens, int(n_tokens))

    # -- rendering -----------------------------------------------------------
    def page_map(self) -> np.ndarray:
        """Dense ``(n_slots, max_pages_per_slot)`` int32 logical→physical
        table, ``-1`` where unallocated — the device-side operand of the
        paged decode step."""
        out = np.full((self.n_slots, self.max_pages_per_slot), -1, np.int32)
        for i, t in enumerate(self._tables):
            if t.pages:
                out[i, :len(t.pages)] = t.pages
        return out

    # -- stats ---------------------------------------------------------------
    def utilization(self) -> float:
        """Written token positions / allocated token capacity (1.0 = no
        internal fragmentation; 0.0 with nothing allocated)."""
        cap = self.pages_in_use * self.page_size
        if cap == 0:
            return 0.0
        used = sum(min(t.tokens, len(t.pages) * self.page_size)
                   for t in self._tables)
        return used / cap

    def fragmentation(self) -> float:
        """Allocated-but-unwritten fraction (1 - utilization when anything
        is allocated)."""
        return 1.0 - self.utilization() if self.pages_in_use else 0.0

    def stats(self) -> Dict[str, float]:
        occupied = self.occupied_slots()
        return {
            "pages": self.n_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "peak_pages_in_use": self.peak_pages_in_use,
            "occupied_slots": occupied,
            "utilization": round(self.utilization(), 4),
            "fragmentation": round(self.fragmentation(), 4),
            "state_block_tokens": self.state_block_tokens * occupied,
            "allocs": self.alloc_count,
            "extends": self.extend_count,
            "trims": self.trim_count,
            "frees": self.free_count,
            "oom_refusals": self.oom_count,
        }

    def record(self, tracer, *, phase: str, slot: int = -1,
               tenant: str = "", **meta) -> None:
        """Emit one ``paging`` event on ``tracer`` (no-op without one)."""
        if tracer is None:
            return
        tracer.record("paging", tenant=tenant,
                      meta={"phase": phase, "slot": slot,
                            **self.stats(), **meta})


def state_block_tokens(cfg) -> int:
    """Token-position equivalents of one slot's SSM/linear-attention
    state (0 for pure-attention stacks) — the allocator's accounting unit
    for the non-paged half of the cache."""
    if getattr(cfg, "ssm_kind", ""):
        # one state block ≈ d_inner × d_state values ≈ ssm_state "rows"
        return max(1, int(getattr(cfg, "ssm_state", 0)) or 1)
    return 0
