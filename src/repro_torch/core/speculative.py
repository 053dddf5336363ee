"""Speculative multi-token decoding: a cheap draft, an exact verify.

Twin of ``repro/core/speculative.py``. A **draft** chain proposes ``k - 1``
tokens under its own :class:`~repro_torch.core.execution.ExecutionPolicy`
(``fp8`` on kernel A in e4m3, ``fp8:sparse24`` on kernel D), then the
session-policy **verify** (:func:`repro_torch.models.transformer.
multi_decode_step`) scores the ``k`` positions and accepts the longest
prefix of drafts that match its own argmaxes. Step ``j`` of the verify is
the plain ``decode_step`` at ``pos + j``, so the committed tokens are the
plain greedy stream; acceptance only sets how many land per step.

* this module: :class:`SpecDecodeSpec` (the knobs), :func:`make_draft_step`,
  :func:`make_verify_step` and the online depth controller
  :class:`AdaptiveK`;
* :mod:`repro_torch.models.transformer`: the multi-token verify and the
  rollback of rejected cache writes;
* :mod:`repro_torch.runtime.serve_loop`: the session's speculative step.
  The port's ``decode_once`` is synchronous: the draft runs, then the
  verify, on one stream (the reference overlaps draft(n+1) with verify(n)
  on execution lanes, which the port has not ported yet).

The reference's draft runs from the session's immutable cache and drops
its writes. The port's caches are updated in place, so the draft's writes
land in the session's cache; why the verify still commits exactly what
plain decode would is in :func:`make_draft_step`.

Greedy only: a session with ``temperature > 0`` refuses a spec, and
``k = 1`` is the plain decode path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core import execution as ex

__all__ = ["SpecDecodeSpec", "AdaptiveK", "make_draft_step",
           "make_verify_step"]


@dataclasses.dataclass(frozen=True)
class SpecDecodeSpec:
    """Speculative-decoding knobs (``ServeSession(speculative=...)``).

    ``k`` is the most tokens committed per decode step (one verify token
    plus ``k - 1`` drafts); ``k = 1`` is plain decode. ``draft_policy`` is
    the policy the draft chain runs under: a
    :func:`~repro_torch.core.execution.parse_policy` string, parsed with no
    base (so ``"fp8"`` alone takes the port's default ``torch`` backend),
    or an :class:`~repro_torch.core.execution.ExecutionPolicy`.

    ``adaptive=True`` enables :class:`AdaptiveK`: every ``interval``
    speculative steps each tenant's acceptance-rate EMA (smoothing
    ``ema_alpha``) moves its desired depth by one, up toward ``k`` at or
    above ``grow_above``, down toward 1 at or below ``shrink_below``; the
    session runs the minimum over tenants. ``reprobe_interval`` > 0 lifts
    a tenant parked at 1 for that many recalcs back to 2 for one probe.
    """
    k: int = 2
    draft_policy: Union[str, ex.ExecutionPolicy] = "fp8"
    adaptive: bool = False
    ema_alpha: float = 0.3
    interval: int = 8
    grow_above: float = 0.7
    shrink_below: float = 0.3
    reprobe_interval: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if self.interval <= 0:
            raise ValueError("adaptive interval must be positive")
        if self.reprobe_interval < 0:
            raise ValueError("reprobe_interval must be >= 0")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if not (0.0 <= self.shrink_below <= self.grow_above <= 1.0):
            raise ValueError("need 0 <= shrink_below <= grow_above <= 1")
        self.resolved()                      # validate the policy spec now

    def resolved(self) -> ex.ExecutionPolicy:
        """The draft policy as an :class:`ExecutionPolicy`."""
        if isinstance(self.draft_policy, ex.ExecutionPolicy):
            return self.draft_policy
        return ex.parse_policy(self.draft_policy)

    def spec_key(self) -> str:
        """Round-trippable draft-policy string."""
        return self.resolved().full_spec()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["draft_policy"] = self.spec_key()
        return d

    @classmethod
    def from_any(cls, v: Union[None, int, Dict[str, Any], "SpecDecodeSpec"]
                 ) -> Optional["SpecDecodeSpec"]:
        """``None`` / int (k shorthand) / dict / instance →
        ``Optional[SpecDecodeSpec]``."""
        if v is None or isinstance(v, SpecDecodeSpec):
            return v
        if isinstance(v, bool):
            raise TypeError("speculative must be a k (int), dict, or "
                            "SpecDecodeSpec — not a bool")
        if isinstance(v, int):
            return cls(k=v)
        if isinstance(v, dict):
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(v) - known
            if unknown:
                raise ValueError(f"unknown SpecDecodeSpec field(s) "
                                 f"{sorted(unknown)}; known: {sorted(known)}")
            return cls(**v)
        raise TypeError(f"speculative spec {v!r} is not None/int/dict/"
                        "SpecDecodeSpec")


# ---------------------------------------------------------------------------
# Draft and verify steps
# ---------------------------------------------------------------------------

def make_draft_step(cfg, rt, draft_policy: ex.ExecutionPolicy,
                    n_draft: int, *, paged: bool = False):
    """The draft chain: ``n_draft`` greedy ``decode_step``s under
    ``draft_policy`` (folded into ``rt.policy``, so it holds whatever
    policy scope the caller runs in). Returns ``draft(params, tokens (B,
    1), caches, pos[, page_map]) -> tokens_seq (B, n_draft + 1)``, the
    verify's input ``[t0, d1, ..., d_n]``; the tokens stay on the device.

    Draft step ``j`` writes its K/V at row ``pos + j`` of the session's
    cache, in place (the reference drops these writes with its immutable
    cache), so rows ``pos .. pos + k - 2`` hold draft values when the
    verify starts. The verify still computes exactly what plain decode
    would:

    * verify step ``j`` rewrites row ``pos + j`` before it reads the cache;
    * the rows above ``pos + j`` that the draft wrote carry positions above
      ``pos + j``, which the decode mask (``posc <= pos``) never attends;
    * the rollback then scrubs every row above ``pos + n_acc`` (pos -1,
      k/v 0), the draft's included, and the rows it keeps are the
      verify's own writes.

    Rows at or past ``max_len`` are dropped (dense) or go to the trash page
    (paged), as in the verify. A rolling window (``attn_local``) is
    different: draft step ``j`` overwrites row ``(pos + j) % window``, the
    position ``window`` before its own, which the verify's first steps
    still attend to. So the draft keeps the rows it overwrites there and
    puts them back, newest first, when its chain ends
    (``transformer.save_window_rows``). A recurrent state (mamba2, rwkv6)
    is replaced whole by every step, and the verify must start from the
    state before the draft: the draft keeps references to the state
    leaves it starts from (``transformer.snapshot_states``, no copy: a
    step replaces a leaf and leaves the old tensor as it was) and puts
    them back when its chain ends. So the cache after a speculative step
    is bit for bit the cache of the plain steps it committed
    (``tests/test_torch_speculative.py``), with no copy of the cache."""
    from repro_torch.models import transformer as tf
    cfg, rt = ex.apply_policy(cfg, rt, draft_policy)

    def draft(params, tokens, caches, pos, page_map=None):
        b = tokens.shape[0]
        posb = torch.as_tensor(pos, device=tokens.device).to(torch.long)
        posb = posb.expand(b) if posb.dim() == 0 else posb
        tok = tokens.to(torch.int32)
        seq = [tok]
        win = tf.window_layers(caches, cfg)
        states = tf.state_layers(caches, cfg)
        before = tf.snapshot_states(states)
        log = []
        for j in range(n_draft):
            log.append(tf.save_window_rows(win, posb + j))
            if paged:
                logits, caches = tf.paged_decode_step(
                    params, tok, caches, posb + j, page_map, cfg, rt)
            else:
                logits, caches = tf.decode_step(params, tok, caches,
                                                posb + j, cfg, rt)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            seq.append(tok)
        tf.restore_window_rows(win, log)
        tf.restore_states(states, before)
        return torch.cat(seq, dim=1)

    if paged:
        return lambda params, tokens, caches, pos, page_map: \
            draft(params, tokens, caches, pos, page_map)
    return lambda params, tokens, caches, pos: \
        draft(params, tokens, caches, pos)


def make_verify_step(cfg, rt, *, paged: bool = False):
    """The session-policy verify around the transformer's multi-token
    step. ``cfg``/``rt`` carry the session policy already, so each verify
    step is the session's plain decode step. Returns ``(next_tokens (B, 1),
    greedy (B, k), n_acc (B,), caches, logits (B, k, Vp))``: the
    reference's four values, and the logits of each verify step."""
    from repro_torch.models import transformer as tf
    if paged:
        def step(params, tokens_seq, caches, pos, active, page_map):
            return tf.verify_decode(params, tokens_seq, caches, pos, active,
                                    cfg, rt, page_map=page_map)
    else:
        def step(params, tokens_seq, caches, pos, active):
            return tf.verify_decode(params, tokens_seq, caches, pos, active,
                                    cfg, rt)
    return step


# ---------------------------------------------------------------------------
# Online depth control
# ---------------------------------------------------------------------------

class AdaptiveK:
    """Re-derive the speculation depth online from acceptance samples.

    The session feeds one sample per tenant per speculative step
    (:meth:`observe`); every ``interval`` ticks (:meth:`on_step`) each
    tenant's EMA moves its desired depth by at most one, toward ``spec.k``
    at or above ``grow_above`` and toward 1 at or below ``shrink_below``.
    The session runs the **minimum** desired depth over the tenants that
    share the batch, since the verify is batch-wide.

    At the floor (``k = 1``, plain decode) no new samples arrive, so the
    floor is sticky unless ``spec.reprobe_interval`` > 0: a tenant parked
    there for that many consecutive recalcs is lifted back to 2 for one
    probe.
    """

    def __init__(self, spec: SpecDecodeSpec):
        self.spec = spec
        self.max_k = spec.k
        self.ema: Dict[str, float] = {}
        self.desired: Dict[str, int] = {}
        self.k = spec.k
        self.steps = 0
        self.recalcs = 0
        self.reprobes = 0
        self._parked: Dict[str, int] = {}    # consecutive recalcs at floor

    def observe(self, tenant: str, drafted: int, accepted: int) -> None:
        """One tenant-step sample: ``accepted`` of ``drafted`` proposed
        tokens survived the verify."""
        if drafted <= 0:
            return
        r = accepted / drafted
        prev = self.ema.get(tenant)
        a = self.spec.ema_alpha
        self.ema[tenant] = r if prev is None else (1 - a) * prev + a * r
        self.desired.setdefault(tenant, self.k)

    def on_step(self) -> int:
        """Tick once per decode step; returns the depth to use next."""
        self.steps += 1
        if self.steps % self.spec.interval == 0 and self.ema:
            self.recalcs += 1
            for tenant, r in self.ema.items():
                d = self.desired.get(tenant, self.k)
                if r >= self.spec.grow_above:
                    d = min(self.max_k, d + 1)
                elif r <= self.spec.shrink_below:
                    d = max(1, d - 1)
                if d == 1 and self.spec.reprobe_interval > 0:
                    parked = self._parked.get(tenant, 0) + 1
                    if parked >= self.spec.reprobe_interval:
                        d = min(2, self.max_k)
                        self.reprobes += 1
                        parked = 0
                    self._parked[tenant] = parked
                else:
                    self._parked[tenant] = 0
                self.desired[tenant] = d
            self.k = min(self.desired.values())
        return self.k

    def forget(self, tenant: str) -> None:
        """Drop a departed tenant's record so it stops holding the batch's
        depth down."""
        self.ema.pop(tenant, None)
        self.desired.pop(tenant, None)
        self._parked.pop(tenant, None)
        if self.desired:
            self.k = min(self.desired.values())
