"""Serving: prefill/decode step builders + the continuous-batching session.

Twin of ``repro/runtime/serve_loop.py``. Requests join and leave fixed
slots between steps; each slot decodes at its own position; admission is one
bulk prefill written into the slot's cache rows, and its logits give the
request's first token. The decode step runs over every slot, idle ones
included (token 0 at position 0), as the reference's jitted step does: the
fp8 policies take one activation amax over all slots, so idle rows are part
of the numerics.

With ``paged=True`` the session keeps its K/V in a pool of ``page_size``-row
pages (``models.transformer.init_paged_cache``) with a per-slot page table
(:class:`~repro_torch.core.paging.PageAllocator`): admission reserves the
prompt plus one position, each decode step appends a page where a slot needs
one (a request the pool cannot grow finishes truncated), and freed pages are
scrubbed before reuse. Greedy paged decode equals dense decode token for
token. ``export_slot``/``import_slot`` hand one in-flight request, with its
cache state, to another session: the whole slot row on dense sessions, only
the pages in use on paged ones.

Under a sparse24 policy the session prunes and packs the eligible weights
once, at construction, after moving them to its device
(``execution.pack_model_params``), so every step streams packed bytes.

With ``speculative=`` (a :class:`~repro_torch.core.speculative.
SpecDecodeSpec`, a k, or a dict) each decode step drafts ``k - 1`` tokens
under the draft policy and verifies them under the session's: the session
commits the accepted prefix and the verify's own token, exactly the plain
greedy stream, finishing mid-commit where plain decode would stop. A paged
session grows each slot for the ``k`` candidate positions, falls back to
plain decode for the step when the pool cannot cover the whole batch, and
trims the pages the rejected writes grew into. ``k = 1`` is the plain path.

A decode step is split in two: :meth:`ServeSession.dispatch_decode`
enqueues it on an :class:`~repro_torch.core.concurrency.ExecutionLane`'s
CUDA stream and returns a :class:`DecodeTicket` without waiting, and
:meth:`ServeSession.join_decode` waits on the ticket's event and does the
host-side token accounting; ``decode_once`` is the two back to back. A
speculative step runs its draft chain on a second lane, and the verify's
stream waits on the draft's event (the draft writes the cache in place).
The stream rule: the session's slot work (admit's prefill and cache write,
the scrub on free, ``export_slot``/``import_slot``) runs on the caller's
current stream; a lane's stream first waits on the caller's stream, and
every tensor made on the caller's stream that a lane reads is marked in
use there (``record_stream``). Host state (tokens, positions, completions)
changes only in the join, after the host has waited on the lane, so the
token stream is the same whatever other lanes do in between. Nothing
between dispatch and join reads a device tensor on the host.

Where the reference donates the cache to its jitted helpers, the port
updates the cache tensors in place. Not ported: sampling (``temperature >
0``; the port serves greedy, the only mode whose tokens can be held
against the reference). ``seed`` is accepted for the reference's
signature; greedy decode draws nothing from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import concurrency as cc
from repro_torch.core import execution as ex
from repro_torch.core import paging
from repro_torch.core import speculative as spv
from repro_torch.kernels import paged_attention  # noqa: F401 (hopper_paged)
from repro_torch.models.layers import DEFAULT_RT, RuntimeCfg
from repro_torch.models.transformer import (
    Caches, decode_step, init_cache, init_paged_cache, paged_decode_step,
    prefill)

resolve_device = cc.resolve_device


def make_prefill_step(cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT,
                      policy: Optional[ex.ExecutionPolicy] = None):
    if policy is not None:
        cfg, rt = ex.apply_policy(cfg, rt, policy)

    def prefill_step(params, inputs):
        return prefill(params, inputs, cfg, rt)
    return prefill_step


def make_serve_step(cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT,
                    policy: Optional[ex.ExecutionPolicy] = None):
    """serve_step(params, tokens (B,1), caches, pos) -> (next_tokens (B,1),
    logits, caches), greedy. ``pos`` is a scalar (lockstep) or a (B,)
    vector (continuous batching: per-slot positions)."""
    if policy is not None:
        cfg, rt = ex.apply_policy(cfg, rt, policy)

    def serve_step(params, tokens, caches, pos):
        logits, caches = decode_step(params, tokens, caches, pos, cfg, rt)
        nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), logits, caches
    return serve_step


def make_paged_serve_step(cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT,
                          policy: Optional[ex.ExecutionPolicy] = None):
    """``make_serve_step`` over the paged cache layout: the step takes an
    extra ``page_map`` (B, max_pages) int32 operand (``-1`` =
    unallocated). Greedy, like the dense step, and equal to it."""
    if policy is not None:
        cfg, rt = ex.apply_policy(cfg, rt, policy)

    def paged_serve_step(params, tokens, caches, pos, page_map):
        logits, caches = paged_decode_step(params, tokens, caches, pos,
                                           page_map, cfg, rt)
        nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), logits, caches
    return paged_serve_step


# ---------------------------------------------------------------------------
# Continuous batching (host-side slot manager)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (Lp,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Telemetry (filled by ServeSession/StreamScheduler; wall-clock seconds
    # from perf_counter, step indices in scheduler virtual time).
    tenant: Optional[str] = None
    submit_t: float = 0.0
    admit_t: float = 0.0
    finish_t: float = 0.0
    submit_step: int = -1
    admit_step: int = -1
    finish_step: int = -1

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finish_t - self.submit_t)

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.admit_t - self.submit_t)


@dataclasses.dataclass
class SlotExport:
    """One in-flight request's complete per-slot serving state, detached
    from its session: the cache slice (per layer, the slot's row of each
    dense leaf, or on a paged session only the pages it wrote), the
    slot-local write position and the last token (the next decode input).
    Produced by :meth:`ServeSession.export_slot`, consumed by
    :meth:`ServeSession.import_slot`; greedy decode resumes exactly on a
    session with the same config, ``max_len`` and cache layout."""
    request: Request
    caches: Caches                   # per layer: {k, v, pos}
    pos: int
    token: int
    # Paged handoff metadata (0/0 on dense exports): paged leaves are
    # shaped (pages, page_size, ...), so handoff volume is O(pages in use).
    pages: int = 0
    page_size: int = 0


def export_nbytes(export: SlotExport) -> int:
    """Bytes of cache state a handoff moves."""
    return sum(t.numel() * t.element_size()
               for layer in export.caches for t in layer.values())


def _write_slot_cache(full: Caches, new: Caches, slot: int) -> None:
    """Insert a batch-1 prefill cache into ``slot``: k/v/pos write their
    first S rows (the prompt's positions)."""
    for f, n in zip(full, new):
        for key in ("k", "v", "pos"):
            row = n[key][0]
            f[key][slot, :row.shape[0]] = row.to(f[key].dtype)


def _restore_slot_cache(full: Caches, state: Caches, slot: int) -> None:
    """Write one exported slot's cache state (each leaf the slot's whole
    row) into ``slot``: the receiving half of a dense handoff."""
    for f, s in zip(full, state):
        for key in ("k", "v", "pos"):
            f[key][slot] = s[key].to(f[key].dtype)


def _clear_slot_cache(caches: Caches, slot: int) -> None:
    """Reset ``slot`` to its init state: k/v zeroed, pos rows -1 (unwritten
    to the decode mask). A freed slot keeps nothing of its occupant."""
    for c in caches:
        c["k"][slot] = 0
        c["v"][slot] = 0
        c["pos"][slot] = -1


# -- paged-cache twins of the slot helpers ----------------------------------
# ``phys`` vectors are padded to the per-slot table width with the trash
# page's index; trash writes only ever carry scrub values.

def _paged_write_prompt(full: Caches, new: Caches,
                        phys: torch.Tensor) -> None:
    """Paged ``_write_slot_cache``: the batch-1 prefill cache's rows are
    padded to ``max_len`` (k/v with zeros, pos with -1, the scrubbed-page
    values), split into pages and written to the slot's physical pages
    ``phys`` (max_pages,), unallocated entries naming the trash page."""
    mp = phys.shape[0]
    for f, n in zip(full, new):
        for key in ("k", "v", "pos"):
            pool, row = f[key], n[key][0]
            ps = pool.shape[1]
            slab = torch.full((mp * ps,) + row.shape[1:],
                              -1 if key == "pos" else 0, dtype=pool.dtype,
                              device=pool.device)
            slab[:row.shape[0]] = row.to(pool.dtype)
            pool[phys] = slab.reshape((mp, ps) + row.shape[1:])


def _paged_clear_slot(caches: Caches, phys: torch.Tensor) -> None:
    """Paged ``_clear_slot_cache``: scrub the slot's released physical
    pages back to their init state (k/v zeroed, pos -1) before the
    allocator reuses them, so free-list reuse never leaks a previous
    tenant's KV."""
    for c in caches:
        c["k"][phys] = 0
        c["v"][phys] = 0
        c["pos"][phys] = -1


def _paged_take_slot(caches: Caches, page_ids: List[int]) -> Caches:
    """One slot's pages in use, gathered for export: per layer, k/v/pos
    shaped (n_used, page_size, ...). Copies, not views."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=caches[0]["k"].device)
    return [{key: c[key][idx] for key in ("k", "v", "pos")} for c in caches]


def _paged_put_slot(caches: Caches, state: Caches,
                    page_ids: List[int]) -> None:
    """Scatter an exported slot's pages into freshly allocated ones: the
    receiving half of an O(pages) handoff."""
    idx = torch.as_tensor(page_ids, dtype=torch.long,
                          device=caches[0]["k"].device)
    for c, s in zip(caches, state):
        for key in ("k", "v", "pos"):
            c[key][idx] = s[key].to(device=c[key].device, dtype=c[key].dtype)


@dataclasses.dataclass
class DecodeTicket:
    """One in-flight decode step: dispatched on an ExecutionLane but not
    yet joined. ``handle`` is None when the session had no active slots
    (nothing was enqueued; only ``oom_done`` carries information).
    Produced by :meth:`ServeSession.dispatch_decode`, consumed exactly
    once by :meth:`ServeSession.join_decode`."""
    handle: Optional[cc.LaneHandle]
    oom_done: List[Request]
    lane: str = ""
    overlap_group: int = -1
    t0: float = 0.0
    # Speculative decode: the depth this step ran at (1 = plain decode)
    # and the draft chain's own lane handle.
    spec_k: int = 1
    draft_handle: Optional[cc.LaneHandle] = None


def _in_use_on(lane: cc.ExecutionLane, *tensors: torch.Tensor) -> None:
    """Mark tensors made on the caller's stream as in use on ``lane``'s
    stream, so the allocator does not hand their blocks out again before
    the lane is done with them (no-op on a CPU lane)."""
    if lane.stream is not None:
        for t in tensors:
            t.record_stream(lane.stream)


def _to_device(tree, device):
    if isinstance(tree, ex.PackedWeight):
        return ex.PackedWeight(tree.values.to(device), tree.meta.to(device))
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class ServeSession:
    """Fixed-slot continuous batching over one shared KV cache (dense, or
    paged with ``paged=True``).

    ``submit``/``step``/``run`` drive a single FIFO queue; the slot-level
    API is ``can_admit(req)`` → ``admit(req)`` → ``decode_once()`` (or
    ``dispatch_decode(lane)`` … ``join_decode(ticket)``). ``last_logits``
    holds the logits of the latest prefill (1, Vp), decode step (slots, Vp)
    or speculative verify (slots, k, Vp).

    ``policy`` is an :class:`~repro_torch.core.execution.ExecutionPolicy`,
    a policy spec string, ``"auto"`` (resolved by the occupancy advisor
    for the decode GEMM (slots, d_model, d_ff), latency-sensitive, one
    tenant per slot; ``auto_backend`` overrides the backend it picks) or
    None. ``telemetry`` is a
    :class:`~repro_torch.runtime.telemetry.Tracer` (duck-typed) that
    receives the session's ``prefill``, ``decode``, ``spec`` and
    ``paging`` events.
    """

    def __init__(self, params, cfg: ArchConfig, *, batch_slots: int,
                 max_len: int, rt: RuntimeCfg = DEFAULT_RT,
                 temperature: float = 0.0, eos_id: int = -1, seed: int = 0,
                 policy=None, auto_backend: Optional[str] = None,
                 verbose_policy: bool = False, telemetry=None,
                 paged: bool = False, page_size: int = 16,
                 pages: Optional[int] = None, speculative=None, device=None):
        # verify-by-argmax has no exact acceptance rule for sampled decode
        self.speculative = spv.SpecDecodeSpec.from_any(speculative)
        if self.speculative is not None and temperature > 0:
            raise ValueError(
                "speculative decoding is greedy-only (temperature == 0): "
                "verify-by-argmax has no exact acceptance rule for "
                f"sampled decode (temperature={temperature})")
        if temperature > 0:
            raise NotImplementedError(
                "sampled decode (temperature > 0) is not ported; the port "
                "serves greedy")
        self.device = resolve_device(device)
        if policy == "auto":
            # paper-§9.2 resolution at session construction: the dominant
            # decode GEMM is (slots, d_model, d_ff); decode is
            # latency-sensitive and each slot is a tenant.
            policy = ex.resolve_policy(
                batch_slots, cfg.d_model, cfg.d_ff,
                precision=cfg.precision, latency_sensitive=True,
                tenants=batch_slots, backend=auto_backend)
        elif isinstance(policy, str):
            policy = ex.parse_policy(policy)
        self.tracer = telemetry
        if policy is not None:
            cfg, rt = ex.apply_policy(cfg, rt, policy)
            if verbose_policy:
                print(f"[serve] policy: {policy.describe()}")
        self.policy = policy
        self.params = raw = _to_device(params, self.device)
        if policy is not None and policy.sparsity == "sparse24":
            self.params = ex.pack_model_params(self.params)
        self.cfg = cfg
        self.rt = rt
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.paged = bool(paged)
        if self.paged:
            if max_len % page_size:
                raise ValueError(f"max_len={max_len} must be a multiple of "
                                 f"page_size={page_size}")
            mp = max_len // page_size
            if pages is None:
                pages = batch_slots * mp      # dense-equivalent capacity
            self.page_size, self.pages = int(page_size), int(pages)
            self.pager = paging.PageAllocator(
                self.pages, self.page_size, mp, batch_slots,
                state_block_tokens=paging.state_block_tokens(cfg))
            self.caches = init_paged_cache(cfg, batch_slots, max_len,
                                           self.page_size, self.pages,
                                           device=self.device)
            self._sync_page_map()
            self.step_fn = make_paged_serve_step(cfg, rt)
        else:
            self.page_size, self.pages = 0, 0
            self.pager = None
            self.caches = init_cache(cfg, batch_slots, max_len,
                                     device=self.device)
            self.step_fn = make_serve_step(cfg, rt)
        self.prefill_fn = make_prefill_step(cfg, rt)
        # next write position per slot (slot-local: every request starts
        # at position 0 regardless of when it was admitted)
        self.slot_pos = np.zeros((batch_slots,), np.int32)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.last_logits: Optional[torch.Tensor] = None
        self._inflight: Optional[DecodeTicket] = None
        self._lane: Optional[cc.ExecutionLane] = None
        self._draft_lane: Optional[cc.ExecutionLane] = None
        # -- speculative decode state
        self._spec_fns: Dict[int, Tuple[Callable, Callable]] = {}
        self._spec_deltas: List[Tuple[str, int, int]] = []
        self.spec_totals: Dict[str, Dict[str, int]] = {}
        self.adaptive_k: Optional[spv.AdaptiveK] = None
        self._draft_params = None
        if self.speculative is not None:
            self._draft_params = self._draft_weights(raw)
            if self.speculative.adaptive:
                self.adaptive_k = spv.AdaptiveK(self.speculative)

    def _draft_weights(self, raw):
        """The weights the draft chain reads: packed 2:4 under a sparse24
        draft policy (the session's own packed tree when its policy is
        sparse24 too, else a copy packed once, here), else the unpacked
        tree on the device."""
        if self.speculative.resolved().sparsity != "sparse24":
            return raw
        if isinstance(self.policy, ex.ExecutionPolicy) \
                and self.policy.sparsity == "sparse24":
            return self.params
        return ex.pack_model_params(raw)

    # -- slot-level API ------------------------------------------------------
    def _policy_scope(self):
        if isinstance(self.policy, ex.ExecutionPolicy):
            return ex.policy_scope(self.policy)
        return contextlib.nullcontext()

    def _policy_tag(self) -> Dict[str, str]:
        """Event attribution for this session's serving ops."""
        if isinstance(self.policy, ex.ExecutionPolicy):
            return {"policy": self.policy.spec(),
                    "backend": self.policy.backend}
        return {}

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def can_admit(self, req: Request) -> bool:
        """Admission headroom: a free slot and (paged) enough free pages
        for the prompt plus its first decode write. Dense: exactly
        ``has_free_slot``."""
        if not self.has_free_slot():
            return False
        if not self.paged:
            return True
        return self.pager.can_admit_tokens(len(req.prompt) + 1)

    def _phys_padded(self, page_ids: List[int]) -> torch.Tensor:
        """(max_pages,) scatter vector: the slot's physical pages, padded
        with the trash page's index (the pool row past the last page)."""
        out = np.full((self.pager.max_pages_per_slot,), self.pages, np.int64)
        out[:len(page_ids)] = page_ids
        return torch.as_tensor(out, device=self.device)

    def _sync_page_map(self) -> None:
        """The allocator's tables as the step's device int32 operand."""
        self._page_map = torch.as_tensor(self.pager.page_map(),
                                         device=self.device)

    def admit(self, req: Request) -> int:
        """Bulk-prefill ``req`` into a free slot and take its first output
        token (greedy) from the prefill logits. Active slots do not step.
        Returns the slot index (the request may already be done if
        ``max_new == 1``). Paged: raises ``PagesExhausted`` if the pool
        cannot hold the prompt plus one position (gate on
        :meth:`can_admit`)."""
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("admit() with no free slot")
        lp = len(req.prompt)
        if not 0 < lp < self.max_len:
            raise ValueError(f"prompt length {lp} not in [1, {self.max_len})")
        if self.paged:
            # reserve pages BEFORE the prefill: lp prompt positions plus
            # the first decode write at position lp
            page_ids = self.pager.alloc_slot(slot, lp + 1)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        t0 = time.perf_counter()
        with self._policy_scope():
            logits, pcaches = self.prefill_fn(self.params, prompt)
        tok = int(torch.argmax(logits[0]))      # waits for the prefill
        if self.tracer is not None:
            self.tracer.record(
                "prefill", m=lp, k=self.cfg.d_model, n=self.cfg.d_ff,
                precision=self.cfg.precision, **self._policy_tag(),
                wall_s=time.perf_counter() - t0,
                tenant=req.tenant or "", meta={"uid": req.uid, "slot": slot})
        if self.paged:
            _paged_write_prompt(self.caches, pcaches,
                                self._phys_padded(page_ids))
            self._sync_page_map()
            self.pager.record(self.tracer, phase="admit", slot=slot,
                              tenant=req.tenant or "", uid=req.uid)
        else:
            _write_slot_cache(self.caches, pcaches, slot)
        self.last_logits = logits
        self.slots[slot] = req
        self.slot_pos[slot] = lp
        self.tokens[slot, 0] = tok
        req.admit_t = time.perf_counter()
        req.out.append(tok)
        self._maybe_finish(slot, tok)
        return slot

    def free_slot(self, slot: int):
        self.slots[slot] = None
        self.slot_pos[slot] = 0
        if self.paged:
            released = self.pager.free_slot(slot)
            # scrub the released pages BEFORE the free list hands them out
            _paged_clear_slot(self.caches, self._phys_padded(released))
            self._sync_page_map()
            self.pager.record(self.tracer, phase="free", slot=slot)
        else:
            _clear_slot_cache(self.caches, slot)
        self.tokens[slot, 0] = 0

    # -- live cache handoff ----------------------------------------------------
    def export_slot(self, slot: int) -> SlotExport:
        """Detach ``slot``'s in-flight request with its complete serving
        state and clear the slot as :meth:`free_slot` does. The request is
        not finished; it resumes wherever the export is imported."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        pos, token = int(self.slot_pos[slot]), int(self.tokens[slot, 0])
        if self.paged:
            page_ids = self.pager.slot_pages(slot)
            out = SlotExport(request=req,
                             caches=_paged_take_slot(self.caches, page_ids),
                             pos=pos, token=token, pages=len(page_ids),
                             page_size=self.page_size)
            if self.tracer is not None:
                self.pager.record(self.tracer, phase="export", slot=slot,
                                  tenant=req.tenant or "",
                                  pages_moved=len(page_ids),
                                  handoff_bytes=export_nbytes(out))
        else:
            state = [{key: c[key][slot].clone() for key in ("k", "v", "pos")}
                     for c in self.caches]
            out = SlotExport(request=req, caches=state, pos=pos, token=token)
        self.free_slot(slot)
        return out

    def handoff_pages(self, slot: int) -> int:
        """Pages a handoff of ``slot`` would move (0 on dense sessions,
        whose handoffs move the whole max_len row)."""
        return len(self.pager.slot_pages(slot)) if self.paged else 0

    def can_accept_pages(self, n_pages: int, page_size: int) -> bool:
        """Import-side headroom check before the exporter detaches a slot:
        a free slot and, paged, the same page size and enough free pages
        for the ``n_pages`` the handoff would move."""
        if not self.has_free_slot():
            return False
        if not self.paged:
            return True
        return (page_size == self.page_size
                and n_pages <= self.pager.max_pages_per_slot
                and self.pager.can_alloc(n_pages))

    def can_accept_handoff(self, export: SlotExport) -> bool:
        """Would :meth:`import_slot` succeed right now?"""
        return self.can_accept_pages(export.pages, export.page_size)

    def import_slot(self, export: SlotExport) -> int:
        """Resume an exported in-flight request in a free slot of this
        session. Both sessions must share the cache layout (same config and
        ``max_len``, and the same page size when paged; checked leaf by
        leaf). Returns the slot index."""
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("import_slot() with no free slot")
        if self.paged != bool(export.pages or export.page_size):
            raise ValueError(
                "cache layout mismatch: paged and dense sessions cannot "
                "hand off slots to each other")
        if self.paged and export.page_size != self.page_size:
            raise ValueError(f"page_size mismatch: export {export.page_size} "
                             f"vs session {self.page_size}")
        # paged leaves compare their page geometry (the export carries the
        # pages in use, not the pool); dense leaves the whole slot row
        ours = [(key, tuple(c[key].shape[1:]))
                for c in self.caches for key in ("k", "v", "pos")]
        theirs = [(key, tuple(s[key].shape[1:] if self.paged
                              else s[key].shape))
                  for s in export.caches for key in ("k", "v", "pos")]
        if ours != theirs:
            raise ValueError(
                "cache layout mismatch: the exporting session's slot state "
                "does not fit this session (same cfg, max_len and page_size "
                "required for a live handoff)")
        if self.paged:
            # may raise PagesExhausted: gate on can_accept_handoff() first
            page_ids = self.pager.import_slot(slot, export.pages,
                                              export.pos + 1)
            _paged_put_slot(self.caches, export.caches, page_ids)
            self._sync_page_map()
            self.pager.record(self.tracer, phase="import", slot=slot,
                              tenant=export.request.tenant or "",
                              pages_moved=export.pages)
        else:
            _restore_slot_cache(self.caches, export.caches, slot)
        self.slots[slot] = export.request
        self.slot_pos[slot] = export.pos
        self.tokens[slot, 0] = export.token
        return slot

    def _spec_pages_short(self, k: int) -> bool:
        """Whether the pool lacks the pages a k-deep step needs for the
        whole batch (each active slot up to ``min(pos + k, max_len)``
        positions)."""
        need = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tgt = min(int(self.slot_pos[i]) + k, self.max_len)
            need += max(0, self.pager.pages_for(tgt)
                        - len(self.pager.slot_pages(i)))
        if need > self.pager.free_pages:
            self.pager.record(self.tracer, phase="spec_downgrade",
                              need_pages=need)
            return True
        return False

    def _grow_pages(self, k: int = 1) -> List[Request]:
        """Lazy page append before a paged decode step: every active slot
        gets pages for the positions this step may write (``k`` candidates
        on a speculative step, positions past ``max_len`` going to the
        trash page). A slot the pool cannot grow finishes truncated
        (refused, never crashed). Returns the requests finished so."""
        done = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            need = min(int(self.slot_pos[i]) + k, self.max_len) if k > 1 \
                else int(self.slot_pos[i]) + 1
            if self.pager.pages_for(need) > len(self.pager.slot_pages(i)):
                try:
                    self.pager.extend_slot(i, need)
                    self._sync_page_map()
                except paging.PagesExhausted:
                    self.pager.record(self.tracer, phase="page_oom", slot=i,
                                      tenant=req.tenant or "", uid=req.uid)
                    req.done = True
                    req.finish_t = time.perf_counter()
                    self.completed.append(req)
                    self.free_slot(i)
                    done.append(req)
        return done

    # -- speculative decode ---------------------------------------------------
    def _next_spec_k(self) -> int:
        """Depth of the next decode step: the spec's k, or the adaptive
        controller's (1 = plain decode)."""
        if self.speculative is None:
            return 1
        if self.adaptive_k is not None:
            return max(1, min(self.adaptive_k.k, self.speculative.k))
        return self.speculative.k

    def _spec_fns_for(self, k: int) -> Tuple[Callable, Callable]:
        """The (draft, verify) pair for depth ``k``; the verify is shared
        by every k (it takes k from its input's width)."""
        fns = self._spec_fns.get(k)
        if fns is None:
            verify = next(iter(self._spec_fns.values()))[1] \
                if self._spec_fns else spv.make_verify_step(
                    self.cfg, self.rt, paged=self.paged)
            draft = spv.make_draft_step(self.cfg, self.rt,
                                        self.speculative.resolved(), k - 1,
                                        paged=self.paged)
            fns = self._spec_fns[k] = (draft, verify)
        return fns

    def drain_spec_deltas(self) -> List[Tuple[str, int, int]]:
        """The per-slot ``(tenant, drafted, accepted)`` samples since the
        last drain."""
        out, self._spec_deltas = self._spec_deltas, []
        return out

    def _default_lane(self) -> cc.ExecutionLane:
        if self._lane is None:
            self._lane = cc.ExecutionLane("session", device=self.device)
        return self._lane

    def _draft_lane_for(self) -> cc.ExecutionLane:
        """The draft chain's lane, reporting to the session's current
        tracer (a scheduler may hand the session another one)."""
        if self._draft_lane is None:
            self._draft_lane = cc.ExecutionLane("draft", device=self.device)
        self._draft_lane.tracer = self.tracer
        return self._draft_lane

    def dispatch_decode(self, lane: Optional[cc.ExecutionLane] = None, *,
                        overlap_group: int = -1) -> DecodeTicket:
        """Dispatch half of a decode step: page bookkeeping, then the step
        enqueued on ``lane``'s stream (the session's own lane by default)
        without waiting, and a :class:`DecodeTicket` back. The cache is
        written in place by the enqueued step; host state (tokens,
        positions, completions) is touched only by :meth:`join_decode`.
        A speculative step runs its draft chain on a second lane, and the
        verify's stream waits on the draft's event."""
        if self._inflight is not None:
            raise RuntimeError(
                "decode already in flight: join_decode the previous "
                "ticket before dispatching another step")
        if self.n_active == 0:
            return DecodeTicket(handle=None, oom_done=[])
        k = self._next_spec_k()
        oom_done: List[Request] = []
        if self.paged:
            if k > 1 and self._spec_pages_short(k):
                k = 1      # the pool cannot cover the batch: plain decode
            oom_done = self._grow_pages(k)
            if self.n_active == 0:
                return DecodeTicket(handle=None, oom_done=oom_done)
        lane = lane if lane is not None else self._default_lane()
        t0 = time.perf_counter()
        # staged from host memory at once; slot_pos changes only in the join
        posv = torch.as_tensor(self.slot_pos.astype(np.int64),
                               device=self.device)
        paged = (self._page_map,) if self.paged else ()
        if k > 1:
            active = torch.as_tensor([s is not None for s in self.slots],
                                     device=self.device)
            draft, verify = self._spec_fns_for(k)
            dlane = self._draft_lane_for()
            tokens, caches = self.tokens, self.caches
            _in_use_on(dlane, posv, tokens, *paged)
            _in_use_on(lane, posv, active, *paged)

            def verify_thunk():
                seq = dh.result
                _in_use_on(lane, seq)
                return verify(self.params, seq, caches, posv, active, *paged)

            with self._policy_scope():
                dh = dlane.dispatch(
                    lambda: draft(self._draft_params, tokens, caches, posv,
                                  *paged),
                    label="draft", overlap_group=overlap_group)
                handle = lane.dispatch(verify_thunk, label="decode",
                                       overlap_group=overlap_group,
                                       after=(dh,))
            ticket = DecodeTicket(handle=handle, oom_done=oom_done,
                                  lane=lane.name,
                                  overlap_group=overlap_group, t0=t0,
                                  spec_k=k, draft_handle=dh)
            self._inflight = ticket
            return ticket
        tokens, caches = self.tokens, self.caches
        _in_use_on(lane, posv, tokens, *paged)
        with self._policy_scope():
            handle = lane.dispatch(
                lambda: self.step_fn(self.params, tokens, caches, posv,
                                     *paged),
                label="decode", overlap_group=overlap_group)
        ticket = DecodeTicket(handle=handle, oom_done=oom_done,
                              lane=lane.name, overlap_group=overlap_group,
                              t0=t0)
        self._inflight = ticket
        return ticket

    def _record_decode(self, ticket: DecodeTicket, **meta) -> None:
        if self.tracer is None:
            return
        self.tracer.record(
            "decode", m=self.batch_slots, k=self.cfg.d_model,
            n=self.cfg.d_ff, precision=self.cfg.precision,
            **self._policy_tag(),
            wall_s=time.perf_counter() - ticket.t0,
            lane=ticket.lane, overlap_group=ticket.overlap_group,
            meta={"n_active": self.n_active, **meta,
                  "dispatch_to_ready_s": ticket.handle.dispatch_to_ready_s})

    def join_decode(self, ticket: DecodeTicket) -> List[Request]:
        """Join half of a decode step: wait on the ticket's event, then the
        host-side token accounting. Records the ``decode`` event with the
        lane and overlap group the step ran under. Returns the requests
        that completed (paged: those the pool truncated first)."""
        self._inflight = None
        if ticket.handle is None:
            return list(ticket.oom_done)
        if ticket.spec_k > 1:
            return self._join_spec(ticket)
        nxt, logits, self.caches = ticket.handle.join()
        nxt_np = nxt[:, 0].cpu().numpy()
        self._record_decode(ticket)
        self.last_logits = logits
        self.tokens = nxt
        done = list(ticket.oom_done)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            tok = int(nxt_np[i])
            req.out.append(tok)
            if self._maybe_finish(i, tok):
                done.append(req)
            elif self.paged:
                # utilization accounting: positions written so far plus
                # the pending next write
                self.pager.note_tokens(i, int(self.slot_pos[i]) + 1)
        if self.adaptive_k is not None:
            self.adaptive_k.on_step()
        return done

    def _join_spec(self, ticket: DecodeTicket) -> List[Request]:
        """Join half of a speculative step: commit each slot's accepted
        prefix and the verify's token, record the acceptance, and (paged)
        trim the candidate pages the verify already scrubbed. The caches
        were rolled back in place before the host reads the counts."""
        nxt, greedy, n_acc, self.caches, logits = ticket.handle.join()
        k = ticket.spec_k
        host = torch.cat([greedy, n_acc[:, None]], dim=1).cpu().numpy()
        self._record_decode(ticket, spec_k=k)
        self.last_logits = logits
        self.tokens = nxt
        done, trimmed = list(ticket.oom_done), False
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            acc = int(host[i, k])
            finished = False
            committed = 0
            # the accepted drafts and the verify's token, in order; a
            # finish mid-commit stops exactly where plain decode would
            for t in range(acc + 1):
                tok = int(host[i, t])
                self.slot_pos[i] += 1
                req.out.append(tok)
                committed += 1
                if self._maybe_finish(i, tok):
                    done.append(req)
                    finished = True
                    break
            tenant = req.tenant or ""
            self._spec_deltas.append((tenant, k - 1, acc))
            tot = self.spec_totals.setdefault(
                tenant, {"steps": 0, "drafted": 0, "accepted": 0,
                         "committed": 0})
            tot["steps"] += 1
            tot["drafted"] += k - 1
            tot["accepted"] += acc
            tot["committed"] += committed
            if self.adaptive_k is not None:
                self.adaptive_k.observe(tenant, k - 1, acc)
            if self.tracer is not None:
                self.tracer.record(
                    "spec", tenant=tenant,
                    meta={"k": k, "drafted": k - 1, "accepted": acc,
                          "committed": committed, "uid": req.uid})
            if not finished and self.paged:
                # release the candidate pages the rejected writes grew
                # into: the verify scrubbed them before n_acc was read
                if self.pager.trim_slot(i, int(self.slot_pos[i]) + 1):
                    trimmed = True
                self.pager.note_tokens(i, int(self.slot_pos[i]) + 1)
        if trimmed:
            self._sync_page_map()
        if self.adaptive_k is not None:
            self.adaptive_k.on_step()
        return done

    def decode_once(self, lane: Optional[cc.ExecutionLane] = None
                    ) -> List[Request]:
        """One decode step over every slot (a speculative one when the
        session has a spec and its depth is above 1); returns the requests
        that completed this step. Dispatch immediately followed by join."""
        return self.join_decode(self.dispatch_decode(lane))

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        req = self.slots[slot]
        if tok == self.eos_id or len(req.out) >= req.max_new \
                or self.slot_pos[slot] >= self.max_len:
            req.done = True
            req.finish_t = time.perf_counter()
            self.completed.append(req)
            self.free_slot(slot)
            return True
        return False

    # -- single-queue request lifecycle ----------------------------------------
    def submit(self, req: Request):
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _admit_from_queue(self):
        while self.queue and self.can_admit(self.queue[0]):
            self.admit(self.queue.pop(0))
        if (self.paged and self.queue and self.n_active == 0
                and self.pager.pages_in_use == 0
                and not self.can_admit(self.queue[0])):
            # nothing running, nothing allocated, and the head request
            # still does not fit: it never will
            req = self.queue[0]
            raise paging.PagesExhausted(
                f"request uid={req.uid} needs "
                f"{self.pager.pages_for(len(req.prompt) + 1)} pages but the "
                f"pool only has {self.pages}")

    def step(self):
        """Admit what fits, then one decode step for all active slots."""
        self._admit_from_queue()
        return self.decode_once()

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self.n_active) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
