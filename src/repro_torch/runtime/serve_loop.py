"""Serving: prefill/decode step builders + the continuous-batching session.

Twin of ``repro/runtime/serve_loop.py`` for the dense cache. Requests join
and leave fixed slots between steps; each slot decodes at its own position;
admission is one bulk prefill written into the slot's cache rows, and its
logits give the request's first token. The decode step runs over every slot,
idle ones included (token 0 at position 0), as the reference's jitted step
does: the fp8 policies take one activation amax over all slots, so idle rows
are part of the numerics.

Under a sparse24 policy the session prunes and packs the eligible weights
once, at construction, after moving them to its device
(``execution.pack_model_params``), so every step streams packed bytes.

Where the reference donates the cache to its jitted helpers, the port
updates the cache tensors in place. Not in this slice: sampling
(``temperature > 0``; the port serves greedy, the only mode whose tokens
can be held against the reference), the paged cache, speculative decoding,
slot export/import and the ``auto`` policy resolver.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.models.layers import DEFAULT_RT, RuntimeCfg
from repro_torch.models.transformer import (
    Caches, decode_step, init_cache, prefill)


def resolve_device(device=None) -> torch.device:
    """The device a session runs on: ``cuda`` unless the caller names one.
    Without a CUDA device the caller must ask for the CPU explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the card; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


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


def _write_slot_cache(full: Caches, new: Caches, slot: int) -> None:
    """Insert a batch-1 prefill cache into ``slot``: k/v/pos write their
    first S rows (the prompt's positions)."""
    for f, n in zip(full, new):
        for key in ("k", "v", "pos"):
            row = n[key][0]
            f[key][slot, :row.shape[0]] = row.to(f[key].dtype)


def _clear_slot_cache(caches: Caches, slot: int) -> None:
    """Reset ``slot`` to its init state: k/v zeroed, pos rows -1 (unwritten
    to the decode mask). A freed slot keeps nothing of its occupant."""
    for c in caches:
        c["k"][slot] = 0
        c["v"][slot] = 0
        c["pos"][slot] = -1


def _to_device(tree, device):
    if isinstance(tree, ex.PackedWeight):
        return ex.PackedWeight(tree.values.to(device), tree.meta.to(device))
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class ServeSession:
    """Fixed-slot continuous batching over one shared dense KV cache.

    ``submit``/``step``/``run`` drive a single FIFO queue; the slot-level
    API is ``has_free_slot`` → ``admit(req)`` → ``decode_once()``.
    ``last_logits`` holds the logits of the latest prefill (1, Vp) or
    decode step (slots, Vp).
    """

    def __init__(self, params, cfg: ArchConfig, *, batch_slots: int,
                 max_len: int, rt: RuntimeCfg = DEFAULT_RT,
                 temperature: float = 0.0, eos_id: int = -1,
                 policy=None, verbose_policy: bool = False,
                 paged: bool = False, speculative=None, device=None):
        if temperature > 0:
            raise NotImplementedError(
                "sampled decode (temperature > 0) is not ported; the port "
                "serves greedy")
        if paged:
            raise NotImplementedError(
                "the paged cache (and the paged flash-decode kernel) is "
                "ported in a later slice; serve with paged=False")
        if speculative is not None:
            raise NotImplementedError(
                "speculative decoding is ported in a later slice")
        if isinstance(policy, str):
            raise NotImplementedError(
                f"policy {policy!r}: the policy resolver is ported in a "
                "later slice; pass an ExecutionPolicy")
        self.device = resolve_device(device)
        if policy is not None:
            cfg, rt = ex.apply_policy(cfg, rt, policy)
            if verbose_policy:
                print(f"[serve] policy: {policy.describe()}")
        self.policy = policy
        self.params = _to_device(params, self.device)
        if policy is not None and policy.sparsity == "sparse24":
            self.params = ex.pack_model_params(self.params)
        self.cfg = cfg
        self.rt = rt
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.slots: List[Optional[Request]] = [None] * batch_slots
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

    # -- slot-level API ------------------------------------------------------
    def _policy_scope(self):
        if isinstance(self.policy, ex.ExecutionPolicy):
            return ex.policy_scope(self.policy)
        return contextlib.nullcontext()

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def admit(self, req: Request) -> int:
        """Bulk-prefill ``req`` into a free slot and take its first output
        token (greedy) from the prefill logits. Active slots do not step.
        Returns the slot index (the request may already be done if
        ``max_new == 1``)."""
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("admit() with no free slot")
        lp = len(req.prompt)
        if not 0 < lp < self.max_len:
            raise ValueError(f"prompt length {lp} not in [1, {self.max_len})")
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        with self._policy_scope():
            logits, pcaches = self.prefill_fn(self.params, prompt)
        _write_slot_cache(self.caches, pcaches, slot)
        self.last_logits = logits
        tok = int(torch.argmax(logits[0]))
        self.slots[slot] = req
        self.slot_pos[slot] = lp
        self.tokens[slot, 0] = tok
        req.out.append(tok)
        self._maybe_finish(slot, tok)
        return slot

    def free_slot(self, slot: int):
        self.slots[slot] = None
        self.slot_pos[slot] = 0
        _clear_slot_cache(self.caches, slot)
        self.tokens[slot, 0] = 0

    def export_slot(self, slot: int):
        raise NotImplementedError(
            "live slot handoff (export_slot/import_slot) is ported with "
            "the host runtime, a later slice")

    def import_slot(self, export):
        raise NotImplementedError(
            "live slot handoff (export_slot/import_slot) is ported with "
            "the host runtime, a later slice")

    def decode_once(self) -> List[Request]:
        """One decode step over every slot; returns the requests that
        completed this step."""
        if self.n_active == 0:
            return []
        posv = torch.as_tensor(self.slot_pos.astype(np.int64),
                               device=self.device)
        with self._policy_scope():
            nxt, logits, self.caches = self.step_fn(
                self.params, self.tokens, self.caches, posv)
        self.last_logits = logits
        nxt_np = nxt[:, 0].cpu().numpy()     # waits for the step
        self.tokens = nxt
        done = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            tok = int(nxt_np[i])
            req.out.append(tok)
            if self._maybe_finish(i, tok):
                done.append(req)
        return done

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        req = self.slots[slot]
        if tok == self.eos_id or len(req.out) >= req.max_new \
                or self.slot_pos[slot] >= self.max_len:
            req.done = True
            self.completed.append(req)
            self.free_slot(slot)
            return True
        return False

    # -- single-queue request lifecycle ----------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit_from_queue(self):
        while self.queue and self.has_free_slot():
            self.admit(self.queue.pop(0))

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
