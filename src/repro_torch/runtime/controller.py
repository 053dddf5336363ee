"""SLO-enforcing closed loop: attainment signal in, scheduler actions out.

The reports and the metrics plane make SLO attainment *observable*;
nothing in the runtime acted on it. :class:`SLOController` closes the
loop: every ``interval`` global steps it re-derives a *recent* per-tenant
latency-class attainment from the scheduler's own records and, when a
latency tenant is missing (or trending toward a miss — queued/active
requests already past their turnaround target count as misses-in-
progress), pulls slots from batch-class co-tenants through the seams the
scheduler already has:

* ``freeze(tid)`` — the migration drain switch doubles as preemption:
  a frozen batch tenant admits nothing new, its in-flight requests
  finish, and its slots fall to the latency tenant. One freeze per
  control check (gradual actuation), biggest slot-holder first.
* ``cap_overrides`` — a :class:`~repro_torch.runtime.scheduler.StreamScheduler`
  per-tenant slot-cap override (wins over the QuotaPolicy) that boosts
  the missing latency tenant to the full slot budget for the duration
  of the episode.

Release is hysteretic: enforcement starts below ``low``, but thaw only
begins after every latency tenant has held at/above ``high`` for
``hold`` consecutive checks, and unwinds one tenant per check (LIFO).
The ``low < high`` deadband plus the hold streak is what prevents
freeze/thaw ping-pong — the same shape as the migration loop's
hysteresis, test-pinned here too.

Every action lands in three places: the in-memory ledger
(:class:`ControllerAction`), a ``controller`` Tracer event (which
``MetricsSink`` folds into ``repro_controller_actions_total{action}``),
and the runtime report.

Greedy decode is deterministic given admission order, and the
invariant (multi-tenant greedy == solo greedy, token-for-token) means
controller actions reshuffle WHEN requests run, never WHAT they decode.

The controller is duck-typed over the runtime (anything with
``step_count`` / ``schedulers`` / ``tracers``) so this module never
imports ``runtime.server`` — the server imports us.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

ACTIONS = ("freeze", "thaw", "boost", "unboost")
# Trend deadband: attainment deltas smaller than this are "steady".
TREND_EPS = 0.02


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Knobs for the closed loop (``ServingSpec(controller=...)``).

    ``low``/``high`` bound the hysteresis band on recent latency-class
    attainment: enforce below ``low``, release only after ``hold``
    consecutive checks at/above ``high``. ``window`` is the number of
    recent completions the attainment is computed over (the full-history
    report attainment is too sticky for control — early misses would
    keep a recovered tenant in the "missing" state forever).
    """
    enabled: bool = True
    interval: int = 4                # control period (global steps)
    low: float = 0.90                # enforce below this
    high: float = 0.97               # release at/above this (hysteresis)
    hold: int = 2                    # healthy checks before release
    window: int = 32                 # recent completions per tenant
    boost: bool = True               # slot-cap override for the victim
    max_frozen: int = 0              # frozen-tenant cap per partition
    #                                  (0: no cap)

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError("controller interval must be >= 1")
        if not 0.0 < self.low < self.high <= 1.0:
            raise ValueError(f"controller needs 0 < low < high <= 1, "
                             f"got low={self.low} high={self.high}")
        if self.hold < 1:
            raise ValueError("controller hold must be >= 1")
        if self.window < 1:
            raise ValueError("controller window must be >= 1")
        if self.max_frozen < 0:
            raise ValueError("controller max_frozen must be >= 0")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_any(cls, v: Union[None, bool, Dict, "ControllerSpec"]
                 ) -> Optional["ControllerSpec"]:
        """None/False → None (no controller); True → defaults; dict →
        kwargs (unknown fields rejected); instance passes through."""
        if v is None or v is False:
            return None
        if v is True:
            return cls()
        if isinstance(v, ControllerSpec):
            return v
        if isinstance(v, dict):
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(v) - known
            if unknown:
                raise ValueError(f"unknown ControllerSpec fields: "
                                 f"{sorted(unknown)}")
            return cls(**v)
        raise TypeError(f"controller spec {v!r} is not "
                        "None/bool/dict/ControllerSpec")

    @classmethod
    def parse(cls, s: Union[None, str]) -> Optional["ControllerSpec"]:
        """CLI form: ``"on"`` / ``""`` → defaults, else
        ``"interval=2,low=0.85,boost=0"`` key=value pairs."""
        if s is None:
            return None
        s = s.strip()
        if s in ("", "on", "true", "1"):
            return cls()
        if s in ("off", "false", "0"):
            return None
        kw: Dict[str, Any] = {}
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in s.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in fields or not v.strip():
                raise ValueError(f"controller spec token {part!r} "
                                 f"(known keys: {sorted(fields)})")
            if k in ("enabled", "boost"):
                kw[k] = v.strip().lower() in ("1", "true", "on", "yes")
            elif k in ("interval", "hold", "window", "max_frozen"):
                kw[k] = int(v)
            else:
                kw[k] = float(v)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ControllerAction:
    """One ledger entry: what the loop did, to whom, and why."""
    step: int
    partition: int
    action: str                      # one of ACTIONS
    tenant: str                      # the acted-on tenant
    victim: str = ""                 # the latency tenant being protected
    attainment: Optional[float] = None   # victim's recent attainment

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _is_batch_class(t) -> bool:
    """Preemptible: no SLO, or an explicit best-effort batch class.
    throughput-class tenants hold a rate floor and are left alone."""
    return t.slo is None or t.slo.kind == "batch"


class SLOController:
    """The closed loop. Hook :meth:`on_step` into the runtime's global
    step; it is a no-op except every ``spec.interval`` steps."""

    def __init__(self, spec: ControllerSpec):
        self.spec = spec
        self.actions: List[ControllerAction] = []
        self.checks = 0
        # Per-partition actuation state. _frozen is OUR freeze list
        # (LIFO) — never touches tenants frozen by the migration drain.
        self._frozen: Dict[int, List[str]] = {}
        self._boosted: Dict[int, List[str]] = {}
        self._healthy_streak: Dict[int, int] = {}
        # Latest recent-attainment and its delta, for trend arrows.
        self._att: Dict[str, Optional[float]] = {}
        self._trend: Dict[str, float] = {}

    # -- introspection (top.py / tests) --------------------------------------
    def counts(self) -> Dict[str, int]:
        out = {a: 0 for a in ACTIONS}
        for act in self.actions:
            out[act.action] += 1
        return out

    def frozen_now(self) -> int:
        return sum(len(v) for v in self._frozen.values())

    def attainment(self, tenant_id: str) -> Optional[float]:
        return self._att.get(tenant_id)

    def trend_arrow(self, tenant_id: str) -> str:
        """"^" improving / "v" degrading / "=" steady / "" untracked."""
        if tenant_id not in self._att:
            return ""
        d = self._trend.get(tenant_id, 0.0)
        if d > TREND_EPS:
            return "^"
        if d < -TREND_EPS:
            return "v"
        return "="

    # -- the signal ----------------------------------------------------------
    def _recent_attainment(self, sched, t, now: int) -> Optional[float]:
        """Latency-class attainment over the last ``window`` completions
        PLUS every queued/active request already past target (a miss in
        progress — this is the "trending toward a miss" signal). Demand
        with no samples is starvation: 0.0. No demand, no samples: None."""
        slo = t.slo
        samples = [float(r.finish_step - r.submit_step)
                   for r in t.completed[-self.spec.window:]]
        # Misses in progress, counted per queued request: PENDING (waited
        # a full control period without a slot — under a deep batch
        # convoy this is how a miss starts, long before the deadline) or
        # DOOMED (age plus remaining decode budget at 1 token/step
        # already exceeds the target, so no admission can save it).
        overdue = sum(1 for r in t.queue
                      if now - r.submit_step >= self.spec.interval
                      or now - r.submit_step + r.max_new > slo.target)
        for slot in sched.session.slots:
            if (slot is not None and slot.tenant == t.tenant_id
                    and now - slot.submit_step
                    + (slot.max_new - len(slot.out)) > slo.target):
                overdue += 1
        demand = bool(t.queue) or t.active > 0
        n = len(samples) + overdue
        if n == 0:
            return 0.0 if demand else None
        met = sum(1 for s in samples if s <= slo.target)
        return met / n

    # -- actuation -----------------------------------------------------------
    def _record(self, runtime, p: int, action: str, tenant: str,
                victim: str = "",
                attainment: Optional[float] = None) -> None:
        step = runtime.step_count
        self.actions.append(ControllerAction(
            step=step, partition=p, action=action, tenant=tenant,
            victim=victim, attainment=attainment))
        tracer = runtime.tracers[p] if runtime.tracers else None
        if tracer is not None:
            tracer.record("controller", tenant=tenant, step=step,
                          partition=p,
                          meta={"action": action, "victim": victim,
                                "attainment": attainment})

    def _enforce(self, runtime, p: int, sched,
                 missing: List[Any]) -> None:
        """One check's worth of pressure: boost every missing latency
        tenant's cap, freeze ONE more batch tenant (largest holder of
        slots+queue first)."""
        self._healthy_streak[p] = 0
        if self.spec.boost:
            boosted = self._boosted.setdefault(p, [])
            for t, att in missing:
                if t.tenant_id in boosted:
                    continue
                sched.cap_overrides[t.tenant_id] = \
                    sched.session.batch_slots
                boosted.append(t.tenant_id)
                self._record(runtime, p, "boost", t.tenant_id,
                             victim=t.tenant_id, attainment=att)
        frozen = self._frozen.setdefault(p, [])
        if self.spec.max_frozen and len(frozen) >= self.spec.max_frozen:
            return
        order = {tid: i for i, tid in enumerate(sched._order)}
        cands = [t for t in sched.tenants.values()
                 if _is_batch_class(t) and not t.frozen]
        if not cands:
            return
        victim_t, victim_att = missing[0]
        prey = max(cands, key=lambda t: (t.active + len(t.queue),
                                         -order[t.tenant_id]))
        sched.freeze(prey.tenant_id)
        frozen.append(prey.tenant_id)
        self._record(runtime, p, "freeze", prey.tenant_id,
                     victim=victim_t.tenant_id, attainment=victim_att)

    def _release(self, runtime, p: int, sched) -> None:
        """After ``hold`` healthy checks: unwind one freeze per check
        (LIFO); once nothing is frozen, drop the boosts too."""
        frozen = self._frozen.get(p) or []
        while frozen:
            tid = frozen.pop()
            if tid not in sched.tenants:
                continue            # migrated away; nothing to thaw here
            sched.thaw(tid)
            self._record(runtime, p, "thaw", tid)
            break
        if frozen:
            return
        for tid in self._boosted.get(p) or []:
            sched.cap_overrides.pop(tid, None)
            self._record(runtime, p, "unboost", tid)
        self._boosted[p] = []

    # -- the loop ------------------------------------------------------------
    def on_step(self, runtime) -> None:
        step = runtime.step_count
        if step == 0 or step % self.spec.interval:
            return
        self.checks += 1
        for p, sched in enumerate(runtime.schedulers):
            now = sched.step_count
            lat = [t for t in sched.tenants.values()
                   if t.slo is not None and t.slo.kind == "latency"]
            missing: List[Any] = []
            all_healthy = True
            for t in lat:
                att = self._recent_attainment(sched, t, now)
                prev = self._att.get(t.tenant_id)
                self._trend[t.tenant_id] = (
                    (att - prev) if att is not None and prev is not None
                    else 0.0)
                self._att[t.tenant_id] = att
                # A latency tenant with nothing left to serve is healthy
                # no matter what its history says: there is nothing to
                # protect, and holding batch tenants frozen for it would
                # deadlock the drain.
                if att is None or not (t.queue or t.active):
                    continue
                if att < self.spec.low:
                    missing.append((t, att))
                if att < self.spec.high:
                    all_healthy = False
            if missing:
                missing.sort(key=lambda ta: ta[1])
                self._enforce(runtime, p, sched, missing)
            elif all_healthy:
                streak = self._healthy_streak.get(p, 0) + 1
                self._healthy_streak[p] = streak
                if streak >= self.spec.hold and (
                        self._frozen.get(p) or self._boosted.get(p)):
                    self._release(runtime, p, sched)
            else:
                # Deadband (low <= att < high somewhere): hold position.
                self._healthy_streak[p] = 0
