"""Fairness-aware multi-tenant serving scheduler (paper §6/§9.2 at the
application layer).

The paper's concurrency pillar shows that *aggregate* speedup under
concurrent streams masks per-stream fairness collapse (Fig 5: 0.016–0.138
at 8 streams), and §9.2 turns that into scheduling guidance. This module
reproduces the result — and the fix — at the serving layer instead of raw
matmuls: N tenant queues share one model through a
:class:`~repro_torch.runtime.serve_loop.ServeSession`, and a pluggable admission
policy decides whose request takes the next free slot.

Admission policies
------------------
* ``fifo``         — global arrival order. The shared-queue throughput
  extreme: first tenants monopolize the slots, per-tenant fairness
  collapses exactly as the paper's shared-ACE-queue runs do.
* ``round_robin``  — cycle tenants with backlog; equal turns regardless of
  request cost.
* ``fair_quantum`` — credit-based (stride/deficit hybrid): each tenant
  accrues virtual time as ``served_work / weight`` and the lowest virtual
  time with backlog wins the slot, so heavier requests cost
  proportionally more of a tenant's turn. Per-tenant slot quotas come
  from the tenant's :class:`~repro_torch.core.execution.ExecutionPolicy` stream
  budget with the :class:`~repro_torch.core.concurrency.OccupancyAdvisor`
  cap as the default — the §9.2 "≤4 streams for latency-sensitive" rule
  as an admission constraint.

Quota resolution is a pluggable :class:`QuotaPolicy`:

* :class:`StaticQuota` — the stream-budget/advisor constants above.
* :class:`AdaptiveQuota` — re-derives per-tenant slot caps online every N
  steps from ``Tracer.tenant_percentiles()``: a tenant whose p99/p50
  turnaround ratio is an outlier (deep backlog bursting through the
  shared slots) gets its cap shrunk toward 1 and the freed share is
  granted to the best-behaved backlogged tenants, with the aggregate
  grant bounded by the partition's slot budget.

Telemetry: per-tenant fairness / CV / overlap efficiency and p50/p99
request latency, all through :mod:`repro_torch.core.concurrency` so the serving
report reads like the paper's stream characterization. Step-domain
metrics (turnaround in decode steps) are deterministic; wall-clock
latencies ride along for real deployments.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import concurrency as cc
from repro_torch.core import execution as ex
from repro_torch.runtime.serve_loop import Request, ServeSession

ADMISSION_POLICIES = ("fifo", "round_robin", "fair_quantum")
QUOTA_POLICIES = ("static", "adaptive")

# Arrival stamps are PROCESS-GLOBAL (not per-scheduler): a live migration
# moves queued requests between schedulers, and fifo's min-by-arrival
# tiebreak is only meaningful if every request's stamp comes from one
# ordered domain. Deterministic for a fixed submission sequence.
_ARRIVALS = itertools.count()


def request_cost(req: Request) -> int:
    """Admission cost of a request in token-positions: prefill work plus
    the decode budget it may hold a slot for."""
    return len(req.prompt) + req.max_new


# ---------------------------------------------------------------------------
# SLO classes (latency-bound / throughput-bound / batch tenants)
# ---------------------------------------------------------------------------

SLO_KINDS = ("latency", "throughput", "batch")


@dataclasses.dataclass(frozen=True)
class SLO:
    """A tenant's service-level objective, in one of three classes:

    * ``latency`` — ``target`` is a per-request turnaround bound;
      attainment is the fraction of completed requests that met it. The
      domain is ``metric``: ``"turnaround_steps"`` (deterministic
      scheduler steps — reproducible run-to-run, the default) or
      ``"wall_s"`` (wall-clock seconds, for real deployments). A tenant
      with demand but zero completions is *starved*: attainment 0.0, not
      undefined — starvation must read as the worst miss.
    * ``throughput`` — ``target`` is a delivered-rate floor in tokens
      per global scheduler step; attainment is
      ``min(1, observed / target)``.
    * ``batch`` — best-effort completion: ``target`` is the required
      completion ratio (default 1.0); attainment is
      ``min(1, (completed / submitted) / target)``.

    A tenant with no demand has no attainment (``None``) — idle is not a
    miss. Spec strings parse as ``kind:target[@metric]``
    (``"latency:8"``, ``"latency:0.05@wall_s"``, ``"throughput:2.5"``,
    ``"batch"``)."""
    kind: str
    target: float = 0.0
    metric: str = "turnaround_steps"

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"SLO kind {self.kind!r} not in {SLO_KINDS}")
        if self.kind == "batch" and self.target == 0.0:
            object.__setattr__(self, "target", 1.0)
        if self.target <= 0:
            raise ValueError(f"SLO target must be positive, got "
                             f"{self.target}")
        if self.metric not in ("turnaround_steps", "wall_s"):
            raise ValueError(f"SLO metric {self.metric!r} not in "
                             "('turnaround_steps', 'wall_s')")

    def spec(self) -> str:
        s = f"{self.kind}:{self.target:g}"
        if self.kind == "latency" and self.metric != "turnaround_steps":
            s += f"@{self.metric}"
        return s

    @classmethod
    def parse(cls, spec: Union[None, str, Dict, "SLO"]) -> Optional["SLO"]:
        """``None`` / spec-string / dict / instance → ``Optional[SLO]``."""
        if spec is None or isinstance(spec, SLO):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        if not isinstance(spec, str):
            raise TypeError(f"SLO spec {spec!r} is not None/str/dict/SLO")
        body, _, metric = spec.partition("@")
        kind, _, target = body.partition(":")
        kw: Dict[str, Any] = {"kind": kind.strip()}
        if target.strip():
            kw["target"] = float(target)
        elif kind.strip() != "batch":
            raise ValueError(f"SLO {spec!r}: {kind!r} needs a target "
                             "(\"kind:target\")")
        if metric.strip():
            kw["metric"] = metric.strip()
        return cls(**kw)

    def attainment(self, *, samples: Sequence[float] = (),
                   tokens_out: int = 0, steps: int = 0,
                   completed: int = 0, submitted: int = 0
                   ) -> Optional[float]:
        """Attainment ratio in [0, 1] from a tenant's observed record;
        ``samples`` is the per-request latency population in this SLO's
        ``metric`` domain (only consulted by the ``latency`` class).
        ``None`` with no demand."""
        if submitted <= 0:
            return None
        if self.kind == "latency":
            if completed <= 0:
                return 0.0           # starved: demand, nothing finished
            if not samples:
                return 0.0
            met = sum(1 for s in samples if s <= self.target)
            return met / len(samples)
        if self.kind == "throughput":
            rate = tokens_out / steps if steps > 0 else 0.0
            return min(1.0, rate / self.target)
        return min(1.0, (completed / submitted) / self.target)


def attainment_from_tracer(tracer, tenant_id: str, slo: Optional[SLO],
                           steps: int) -> Optional[float]:
    """SLO attainment from telemetry alone (the metrics plane's path —
    reports use the exact scheduler records instead): latency samples
    come from ``Tracer.tenant_latencies`` (the same window
    ``tenant_percentiles`` summarizes), demand/tokens from the monotonic
    per-tenant counters, so the ratio survives ring eviction."""
    if slo is None:
        return None
    completed = tracer.tenant_counts("request").get(tenant_id, 0)
    admitted = tracer.tenant_counts("admit").get(tenant_id, 0)
    samples = tracer.tenant_latencies(slo.metric).get(tenant_id, [])
    tokens = sum(ev.meta.get("tokens", 0)
                 for ev in tracer.events("request")
                 if ev.tenant == tenant_id)
    return slo.attainment(samples=samples, tokens_out=tokens, steps=steps,
                          completed=completed,
                          submitted=max(admitted, completed))


@dataclasses.dataclass
class Tenant:
    """One tenant's queue + accounting."""
    tenant_id: str
    weight: float = 1.0
    policy: Optional[ex.ExecutionPolicy] = None
    slo: Optional[SLO] = None
    queue: List[Request] = dataclasses.field(default_factory=list)
    completed: List[Request] = dataclasses.field(default_factory=list)
    submitted: int = 0
    tokens_out: int = 0
    active: int = 0                  # slots currently held
    service_steps: int = 0           # decode steps holding >= 1 slot
    vtime: float = 0.0               # fair_quantum: served_work / weight
    frozen: bool = False             # draining: no new admissions
    first_submit_step: int = -1      # earliest demand (starvation lower
    #                                  bound when nothing ever completes)
    spec_steps: int = 0              # speculative decode steps holding a slot
    spec_drafted: int = 0            # draft tokens proposed across those steps
    spec_accepted: int = 0           # drafts the bf16 verify accepted

    def slot_cap(self, default: int) -> int:
        """Concurrent-slot quota: the tenant policy's stream budget if it
        carries one, else the advisor default."""
        if self.policy is not None and self.policy.streams > 0:
            return self.policy.streams
        return default


@dataclasses.dataclass
class TenantReport:
    tenant_id: str
    completed: int
    tokens_out: int
    service_steps: int
    mean_turnaround_steps: float     # submit -> finish, scheduler steps
    mean_queue_wait_steps: float     # submit -> admit, scheduler steps
    p50_latency_s: float
    p99_latency_s: float
    submitted: int = 0               # demand (0: registered but idle)
    partition: int = -1              # serving partition (-1: unpartitioned)
    migrations: int = 0              # times this tenant was live-migrated
    slo: str = ""                    # SLO spec string ("": no SLO)
    slo_attainment: Optional[float] = None   # None: no SLO or no demand
    spec_steps: int = 0              # speculative decode steps
    spec_drafted: int = 0            # draft tokens proposed
    spec_accepted: int = 0           # drafts accepted by the verify
    acceptance_rate: Optional[float] = None  # accepted/drafted (None: no
    #                                          drafts proposed)
    effective_tokens_per_step: Optional[float] = None  # committed tokens
    #                                  per speculative step (>= 1.0; None
    #                                  without speculative steps)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def build_tenant_report(tid: str, records: Sequence[Tenant],
                        step_count: int, *, partition: int = -1,
                        migrations: int = 0
                        ) -> Tuple[TenantReport, Optional[float]]:
    """One fused :class:`TenantReport` over a tenant's records (a tenant
    mid-migration briefly has one per partition) plus its fairness-
    denominator contribution: the mean completed turnaround; the elapsed
    wait as a lower bound when STARVED (demand but nothing finished —
    starvation must drag fairness down, not vanish from it); ``None``
    with no demand. The single accounting rule shared by the scheduler
    and runtime reports, so the fused view cannot drift from the
    per-partition views it embeds."""
    completed = [r for t in records for r in t.completed]
    submitted = sum(t.submitted for t in records)
    ta = [float(r.finish_step - r.submit_step) for r in completed]
    waits = [float(r.admit_step - r.submit_step) for r in completed]
    lat = cc.latency_percentiles([r.latency_s for r in completed])
    mean_ta = float(np.mean(ta)) if ta else 0.0
    slo = next((t.slo for t in records if t.slo is not None), None)
    slo_att = None
    if slo is not None:
        samples = ta if slo.metric == "turnaround_steps" \
            else [r.latency_s for r in completed]
        slo_att = slo.attainment(
            samples=samples,
            tokens_out=sum(t.tokens_out for t in records),
            steps=step_count, completed=len(completed),
            submitted=submitted)
    spec_steps = sum(t.spec_steps for t in records)
    spec_drafted = sum(t.spec_drafted for t in records)
    spec_accepted = sum(t.spec_accepted for t in records)
    row = TenantReport(
        tenant_id=tid,
        completed=len(completed),
        tokens_out=sum(t.tokens_out for t in records),
        service_steps=sum(t.service_steps for t in records),
        mean_turnaround_steps=mean_ta,
        mean_queue_wait_steps=float(np.mean(waits)) if waits else 0.0,
        p50_latency_s=lat["p50"],
        p99_latency_s=lat["p99"],
        submitted=submitted,
        partition=partition,
        migrations=migrations,
        slo=slo.spec() if slo is not None else "",
        slo_attainment=slo_att,
        spec_steps=spec_steps,
        spec_drafted=spec_drafted,
        spec_accepted=spec_accepted,
        acceptance_rate=(spec_accepted / spec_drafted
                         if spec_drafted else None),
        effective_tokens_per_step=((spec_accepted + spec_steps) / spec_steps
                                   if spec_steps else None))
    if ta:
        contribution: Optional[float] = mean_ta
    elif submitted:
        first = min((t.first_submit_step for t in records
                     if t.first_submit_step >= 0), default=0)
        contribution = float(step_count - first)
    else:
        contribution = None
    return row, contribution


@dataclasses.dataclass
class SchedulerReport:
    """Paper-style per-tenant concurrency metrics for one serving run.

    ``fairness``/``cv`` are computed over per-tenant mean turnaround (in
    deterministic scheduler steps); ``overlap_efficiency`` compares the
    sum of per-tenant busy steps against the actual step count (1.0 when
    tenants fully share the decode batch, 0.0 when they serialize).
    """
    admission: str
    quota: str
    n_tenants: int
    steps: int
    wall_s: float
    tokens_out: int
    fairness: float
    fairness_min_max: float
    cv: float
    overlap_efficiency: float
    tenants: List[TenantReport]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        lines = [
            f"[sched] {self.admission}/{self.quota}: {self.n_tenants} "
            f"tenants, "
            f"{self.steps} steps, {self.tokens_out} tokens in "
            f"{self.wall_s:.2f}s | fairness={self.fairness:.3f} "
            f"cv={self.cv:.3f} overlap_eff={self.overlap_efficiency:.3f}"]
        for t in self.tenants:
            line = (
                f"  {t.tenant_id}: {t.completed} done, {t.tokens_out} tok, "
                f"turnaround={t.mean_turnaround_steps:.1f} steps, "
                f"wait={t.mean_queue_wait_steps:.1f} steps, "
                f"p50={t.p50_latency_s * 1e3:.1f}ms "
                f"p99={t.p99_latency_s * 1e3:.1f}ms")
            if t.slo:
                att = "n/a" if t.slo_attainment is None \
                    else f"{t.slo_attainment:.2f}"
                line += f" slo[{t.slo}]={att}"
            lines.append(line)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Quota policies (pluggable per-tenant slot-cap resolution)
# ---------------------------------------------------------------------------

class QuotaPolicy:
    """How many concurrent slots each tenant may hold.

    ``slot_cap`` is consulted on every admission attempt; ``on_step`` runs
    once per scheduler step *before* admission, which is where an online
    policy re-derives its caps."""

    name = "quota"

    def slot_cap(self, sched: "StreamScheduler", tenant: Tenant) -> int:
        raise NotImplementedError

    def on_step(self, sched: "StreamScheduler") -> None:
        pass


class StaticQuota(QuotaPolicy):
    """The original resolution: the tenant policy's stream budget if it
    carries one, else the advisor's §9.2 cap for this tenancy level."""

    name = "static"

    def slot_cap(self, sched: "StreamScheduler", tenant: Tenant) -> int:
        return tenant.slot_cap(sched._advisor_cap())


class AdaptiveQuota(QuotaPolicy):
    """Telemetry-driven slot caps (fair_quantum quotas driven
    online from ``Tracer.tenant_percentiles()``).

    Caps seed at each tenant's weighted share of the partition's slot
    budget (every tenant keeps a floor of 1). Every ``interval`` steps the
    scheduler's tracer is consulted: per tenant, the p99/p50 ratio of
    request turnaround (deterministic step domain by default) is compared
    against the tenant median — a ratio beyond ``outlier_factor`` × median
    marks a *hogging* tenant (a deep backlog whose tail is bursting
    through the shared slots), its cap shrinks by 1 (floor 1), and the
    freed share is granted to the best-behaved backlogged tenant. The
    aggregate grant never exceeds ``max(batch_slots, n_tenants)`` — the
    partition's budget with the per-tenant floor — so online re-derivation
    can redistribute but never oversubscribe.

    Second signal — occupancy (``fill_floor``): when the tracer's mean
    observed grid-tile fill (:meth:`~repro_torch.runtime.telemetry.Tracer.
    mean_fill`) drops below ``fill_floor``, the *aggregate* budget shrinks
    by one slot per interval (floor: one slot per tenant) and recovers one
    slot per interval once fill is back above the floor — the §5/§6
    finding that a collapsed grid cannot pay for wide concurrency, folded
    into admission. ``None`` (default) disables the signal: absolute fill
    is only meaningful against a calibrated core count, so deployments
    opt in with the measured floor (``launch/profile.py`` artifacts)."""

    name = "adaptive"

    def __init__(self, interval: int = 8, outlier_factor: float = 1.5,
                 metric: str = "turnaround_steps", min_samples: int = 2,
                 fill_floor: Optional[float] = None, n_cores: int = 256):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval
        self.outlier_factor = outlier_factor
        self.metric = metric
        self.min_samples = min_samples
        self.fill_floor = fill_floor
        self.n_cores = n_cores
        self.caps: Dict[str, int] = {}
        self.recalcs = 0
        self.shrunk: Dict[str, int] = {}   # tenant -> total cap reductions
        self.occupancy_shrinks = 0         # budget cuts from fill collapse
        self._fill_budget: Optional[int] = None   # None: signal never fired
        self._seeded_for: frozenset = frozenset()

    # -- seeding ------------------------------------------------------------
    def budget(self, sched: "StreamScheduler") -> int:
        full = max(sched.session.batch_slots, len(sched.tenants))
        if self._fill_budget is None:
            return full
        # occupancy-collapsed budget: never below one slot per tenant
        return max(max(1, len(sched.tenants)), min(full, self._fill_budget))

    def _seed(self, sched: "StreamScheduler") -> None:
        tenants = [sched.tenants[tid] for tid in sched._order]
        total_w = sum(t.weight for t in tenants) or 1.0
        budget = self.budget(sched)
        caps = {t.tenant_id: max(1, int(budget * t.weight / total_w))
                for t in tenants}
        # distribute any remaining share deterministically: heaviest
        # first, registration order breaking ties
        remaining = budget - sum(caps.values())
        for t in sorted(tenants, key=lambda t: (-t.weight,
                                                sched._order.index(
                                                    t.tenant_id))):
            if remaining <= 0:
                break
            caps[t.tenant_id] += 1
            remaining -= 1
        self.caps = caps
        self._seeded_for = frozenset(caps)

    def slot_cap(self, sched: "StreamScheduler", tenant: Tenant) -> int:
        if frozenset(sched.tenants) != self._seeded_for:
            self._seed(sched)
        return self.caps[tenant.tenant_id]

    # -- the occupancy signal ------------------------------------------------
    def _occupancy_step(self, sched: "StreamScheduler", tracer) -> None:
        """Shrink/recover the aggregate budget from the measured grid
        fill, then trim caps to fit (largest caps first, registration
        order breaking ties)."""
        fill = tracer.mean_fill(self.n_cores)
        if fill is None:
            return
        full = max(sched.session.batch_slots, len(sched.tenants))
        floor = max(1, len(sched.tenants))
        changed = False
        if fill < self.fill_floor:
            cur = full if self._fill_budget is None else self._fill_budget
            nxt = max(floor, cur - 1)
            if nxt < cur:
                self._fill_budget = nxt
                self.occupancy_shrinks += 1
                changed = True
        elif self._fill_budget is not None:
            self._fill_budget += 1
            changed = True
            if self._fill_budget >= full:
                self._fill_budget = None          # fully recovered
        if not changed:
            return
        budget = self.budget(sched)
        while sum(self.caps.values()) > budget:
            tid = max(self.caps, key=lambda t: (self.caps[t],
                                                -sched._order.index(t)))
            if self.caps[tid] <= 1:
                break
            self.caps[tid] -= 1
        # recovery must REGROW the trimmed caps, not just the budget —
        # smallest caps first (the reverse of the trim), registration
        # order breaking ties, up to the recovered budget
        while sum(self.caps.values()) < budget:
            tid = min(self.caps, key=lambda t: (self.caps[t],
                                                sched._order.index(t)))
            self.caps[tid] += 1
        tracer.record("quota", step=sched.step_count,
                      meta={"signal": "occupancy", "fill": fill,
                            "budget": budget, "caps": dict(self.caps)})

    # -- the online loop ----------------------------------------------------
    def on_step(self, sched: "StreamScheduler") -> None:
        if sched.step_count == 0 or sched.step_count % self.interval:
            return
        if frozenset(sched.tenants) != self._seeded_for:
            self._seed(sched)
        tracer = sched.tracer
        if tracer is None:
            return
        if self.fill_floor is not None and self.caps:
            self._occupancy_step(sched, tracer)
        lats = tracer.tenant_latencies(self.metric)
        ratios: Dict[str, float] = {}
        for tid, ls in lats.items():
            if tid not in self.caps or len(ls) < self.min_samples:
                continue
            p = cc.latency_percentiles(ls)
            if p["p50"] > 0:
                ratios[tid] = p["p99"] / p["p50"]
        if len(ratios) < 2:
            return                       # nothing to compare against
        median = float(np.median(list(ratios.values())))
        outliers = [tid for tid, r in ratios.items()
                    if r > self.outlier_factor * max(1.0, median)]
        if not outliers:
            return
        self.recalcs += 1
        freed = 0
        for tid in outliers:
            if self.caps[tid] > 1:
                self.caps[tid] -= 1
                self.shrunk[tid] = self.shrunk.get(tid, 0) + 1
                freed += 1
        if not freed:
            return
        # grant the freed share to the best-behaved tenants (backlogged
        # first, then idle — the budget must be conserved, not leak when
        # every victim's queue is momentarily empty), lowest tail ratio
        # first, registration order breaking ties, aggregate at/below the
        # budget
        budget = self.budget(sched)
        grantees = sorted(
            (tid for tid in sched._order if tid not in outliers),
            key=lambda tid: (not sched.tenants[tid].queue,
                             ratios.get(tid, float("inf")),
                             sched._order.index(tid)))
        for tid in grantees:
            if freed <= 0 or sum(self.caps.values()) >= budget:
                break
            if self.caps[tid] < budget:
                self.caps[tid] += 1
                freed -= 1
        tracer.record("quota", step=sched.step_count,
                      meta={"caps": dict(self.caps),
                            "outliers": list(outliers),
                            "median_ratio": median})


def make_quota(quota: Union[None, str, QuotaPolicy]) -> QuotaPolicy:
    """``None``/``"static"``/``"adaptive"``/instance → a QuotaPolicy."""
    if quota is None or quota == "static":
        return StaticQuota()
    if quota == "adaptive":
        return AdaptiveQuota()
    if isinstance(quota, QuotaPolicy):
        return quota
    raise ValueError(f"quota {quota!r} not in {QUOTA_POLICIES} and not a "
                     "QuotaPolicy instance")


class StreamScheduler:
    """Run N tenant queues against one :class:`ServeSession`.

    The scheduler owns admission (the session's own FIFO queue stays
    unused): each step it fills free slots according to the admission
    policy, then advances every active slot one decode step via
    ``session.decode_once()``.
    """

    def __init__(self, session: ServeSession, *,
                 admission: str = "fair_quantum",
                 advisor: Optional[cc.OccupancyAdvisor] = None,
                 tracer=None, quota: Union[None, str, QuotaPolicy] = None):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission {admission!r} not in "
                             f"{ADMISSION_POLICIES}")
        self.session = session
        self.admission = admission
        self.quota = make_quota(quota)
        if isinstance(self.quota, AdaptiveQuota) and tracer is None:
            # the adaptive loop needs the per-tenant percentiles: reuse
            # the session's tracer when it already has one (taking it
            # over below would otherwise silently starve it), else build
            # a private one
            tracer = session.tracer
            if tracer is None:
                from repro_torch.runtime import telemetry
                tracer = telemetry.Tracer()
        # Default quota advisor: the calibrated one when autotune.install()
        # has loaded a measured artifact, else the §9.2-constant advisor.
        self.advisor = advisor or ex.get_default_advisor()
        # tracer (repro_torch.runtime.telemetry.Tracer, duck-typed): receives
        # one "admit" event per slot grant and one "request" event per
        # completion, keyed by tenant — the observed per-tenant p99 that
        # fair_quantum quotas can consume instead of static budgets.
        # The session's serving-op events (prefill/decode) follow the
        # scheduler driving it: a scheduler with a tracer takes them over
        # (so a reused session's events don't keep flowing to a previous
        # run's tracer).
        self.tracer = tracer
        if tracer is not None:
            session.tracer = tracer
        self.tenants: Dict[str, Tenant] = {}
        self._order: List[str] = []      # registration order (rr pointer)
        self._rr_next = 0
        self.step_count = 0
        self.admitted_order: List[str] = []   # tenant id per admission
        # Per-tenant slot-cap overrides (tenant_id -> cap). Wins over the
        # QuotaPolicy: the SLO controller boosts a missing latency-class
        # tenant to the full budget for the enforcement episode.
        self.cap_overrides: Dict[str, int] = {}
        self._default_cap: Optional[int] = None
        self._t0: Optional[float] = None
        self._wall_s = 0.0

    # -- tenants / submission ----------------------------------------------
    def add_tenant(self, tenant_id: str, *, weight: float = 1.0,
                   policy: Optional[ex.ExecutionPolicy] = None,
                   slo: Union[None, str, Dict, SLO] = None) -> Tenant:
        if tenant_id in self.tenants:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        t = Tenant(tenant_id=tenant_id, weight=weight, policy=policy,
                   slo=SLO.parse(slo))
        self.tenants[tenant_id] = t
        self._order.append(tenant_id)
        self._default_cap = None         # advisor cap depends on tenancy
        if self.tracer is not None:
            # a registered-but-idle tenant must still be enumerable from
            # telemetry (it has no admit/request events of its own)
            self.tracer.record("register", tenant=tenant_id,
                               step=self.step_count,
                               meta={"weight": weight,
                                     "slo": t.slo.spec() if t.slo else ""})
        return t

    def freeze(self, tenant_id: str) -> None:
        """Stop admitting ``tenant_id`` (drain mode: in-flight requests
        keep decoding, queued/new requests wait). The serving runtime
        freezes a tenant on its source partition while migrating it."""
        self.tenants[tenant_id].frozen = True

    def thaw(self, tenant_id: str) -> None:
        self.tenants[tenant_id].frozen = False

    def remove_tenant(self, tenant_id: str) -> Tenant:
        """Detach a fully drained tenant (no queue, no active slots) and
        return its record — the migration path folds it into the target
        partition's record. Raises if the tenant still has work here."""
        t = self.tenants[tenant_id]
        if t.queue or t.active:
            raise ValueError(
                f"tenant {tenant_id!r} still has {len(t.queue)} queued / "
                f"{t.active} active requests on this scheduler")
        del self.tenants[tenant_id]
        self._order.remove(tenant_id)
        self._default_cap = None
        if self._order:
            self._rr_next %= len(self._order)
        else:
            self._rr_next = 0
        return t

    def submit(self, tenant_id: str, req: Request):
        t = self.tenants[tenant_id]
        req.tenant = tenant_id
        req.submit_t = time.perf_counter()
        req.submit_step = self.step_count
        req._arrival = next(_ARRIVALS)   # global deterministic fifo tiebreak
        t.submitted += 1
        if t.first_submit_step < 0:
            t.first_submit_step = self.step_count
        t.queue.append(req)

    def pending(self) -> int:
        return sum(len(t.queue) for t in self.tenants.values())

    def _advisor_cap(self) -> int:
        if self._default_cap is None:
            # §9.2 default quota: the advisor's stream cap for a
            # latency-sensitive workload with this many co-tenants.
            cfg = self.session.cfg
            advice = self.advisor.advise(cc.WorkloadProfile(
                precision=cfg.precision,
                grid_tiles=ex.grid_tiles(self.session.batch_slots, cfg.d_ff),
                latency_sensitive=True,
                concurrent_tenants=max(1, len(self.tenants))))
            self._default_cap = max(1, advice.max_streams)
        return self._default_cap

    def _slot_cap(self, t: Tenant) -> int:
        override = self.cap_overrides.get(t.tenant_id)
        if override is not None:
            return max(1, override)
        return self.quota.slot_cap(self, t)

    # -- admission policies -------------------------------------------------
    def _admissible(self) -> List[Tenant]:
        return [self.tenants[tid] for tid in self._order
                if self.tenants[tid].queue
                and not self.tenants[tid].frozen
                and self.tenants[tid].active
                < self._slot_cap(self.tenants[tid])]

    def _pick(self) -> Optional[Tenant]:
        cands = self._admissible()
        if not cands:
            return None
        if self.admission == "fifo":
            return min(cands, key=lambda t: t.queue[0]._arrival)
        if self.admission == "round_robin":
            n = len(self._order)
            for off in range(n):
                tid = self._order[(self._rr_next + off) % n]
                t = self.tenants[tid]
                if t in cands:
                    self._rr_next = (self._order.index(tid) + 1) % n
                    return t
            return None
        # fair_quantum: lowest virtual time wins; ties resolved by
        # registration order (stable because _admissible preserves it).
        return min(cands, key=lambda t: t.vtime)

    def _admit_free_slots(self):
        # Admission gates on the session's full headroom check — on paged
        # sessions that is free-*page* headroom for the candidate's prompt,
        # not just a free slot (dense can_admit ≡ has_free_slot).
        while self.session.has_free_slot():
            t = self._pick()
            if t is None:
                break
            if not self.session.can_admit(t.queue[0]):
                break
            req = t.queue.pop(0)
            self.session.admit(req)
            req.admit_step = self.step_count
            self.admitted_order.append(t.tenant_id)
            if self.tracer is not None:
                self.tracer.record("admit", tenant=t.tenant_id,
                                   step=self.step_count,
                                   meta={"uid": req.uid,
                                         "cost": request_cost(req)})
            if self.admission == "fair_quantum":
                t.vtime += request_cost(req) / t.weight
            if req.done:                 # completed at admission (max_new=1)
                self._finish(t, req)
            else:
                t.active += 1

    def _finish(self, t: Tenant, req: Request):
        req.finish_step = self.step_count
        t.completed.append(req)
        t.tokens_out += len(req.out)
        if self.tracer is not None:
            self.tracer.record_request(
                t.tenant_id, wall_s=req.latency_s, tokens=len(req.out),
                turnaround_steps=req.finish_step - req.submit_step,
                step=self.step_count, uid=req.uid)

    # -- driving ------------------------------------------------------------
    def dispatch_step(self, lane: Optional[cc.ExecutionLane] = None, *,
                      overlap_group: int = -1):
        """Dispatch half of one scheduler step: quota refresh + admission
        (host work, including any prefill), then the decode enqueued
        through ``lane``. Returns the session's
        :class:`~repro_torch.runtime.serve_loop.DecodeTicket`; pass it to
        :meth:`join_step` exactly once. The split lets the serving runtime
        co-dispatch heterogeneous partitions before joining any of them."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self.quota.on_step(self)
        self._admit_free_slots()
        return self.session.dispatch_decode(lane,
                                            overlap_group=overlap_group)

    def join_step(self, ticket) -> List[Request]:
        """Join half of one scheduler step: block on the ticket, then the
        same per-tenant accounting as the synchronous path."""
        done = self.session.join_decode(ticket)
        self.step_count += 1
        for t in self.tenants.values():
            if t.active:
                t.service_steps += 1
        drain = getattr(self.session, "drain_spec_deltas", None)
        if drain is not None:
            for tenant, drafted, accepted in drain():
                t = self.tenants.get(tenant)
                if t is None:
                    continue
                t.spec_steps += 1
                t.spec_drafted += drafted
                t.spec_accepted += accepted
        for req in done:
            t = self.tenants[req.tenant]
            t.active -= 1
            self._finish(t, req)
            if (t.active == 0 and not t.queue
                    and getattr(self.session, "adaptive_k", None)
                    is not None):
                # a drained tenant must stop constraining the batch-wide
                # adaptive speculation depth
                self.session.adaptive_k.forget(t.tenant_id)
        self._wall_s = time.perf_counter() - self._t0
        return done

    def step(self) -> List[Request]:
        """Fill free slots per the admission policy, then one decode step.
        Returns the requests that completed this step."""
        return self.join_step(self.dispatch_step())

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drive until every queue is drained and every slot is free."""
        while (self.pending() or self.session.n_active) \
                and self.step_count < max_steps:
            self.step()
        return [r for t in self.tenants.values() for r in t.completed]

    # -- telemetry ----------------------------------------------------------
    def report(self) -> SchedulerReport:
        per_tenant: List[TenantReport] = []
        turnarounds: List[float] = []
        for tid in self._order:
            row, contrib = build_tenant_report(
                tid, [self.tenants[tid]], self.step_count)
            per_tenant.append(row)
            if contrib is not None:
                turnarounds.append(contrib)
        busy = sum(t.service_steps for t in self.tenants.values())
        return SchedulerReport(
            admission=self.admission,
            quota=self.quota.name,
            n_tenants=len(self.tenants),
            steps=self.step_count,
            wall_s=self._wall_s,
            tokens_out=sum(t.tokens_out for t in self.tenants.values()),
            fairness=cc.fairness(turnarounds),
            fairness_min_max=cc.fairness_min_max(turnarounds),
            cv=cc.cv(turnarounds),
            overlap_efficiency=cc.overlap_efficiency(
                float(busy), float(self.step_count), len(self.tenants)),
            tenants=per_tenant)


def run_tenants(session: ServeSession, workloads: Dict[str, Sequence[Request]],
                *, admission: str = "fair_quantum",
                weights: Optional[Dict[str, float]] = None,
                policies: Optional[Dict[str, ex.ExecutionPolicy]] = None,
                max_steps: int = 100_000, tracer=None,
                quota: Union[None, str, QuotaPolicy] = None
                ) -> SchedulerReport:
    """One-shot helper: register tenants, submit their workloads up front,
    run to completion, return the report (benchmarks and the launcher)."""
    sched = StreamScheduler(session, admission=admission, tracer=tracer,
                            quota=quota)
    for tid in workloads:
        sched.add_tenant(tid, weight=(weights or {}).get(tid, 1.0),
                         policy=(policies or {}).get(tid))
    for tid, reqs in workloads.items():
        for req in reqs:
            sched.submit(tid, req)
    sched.run(max_steps=max_steps)
    return sched.report()
