"""Labeled metrics registry + the Tracer→metrics bridge.

The observability plane's *metric* surface (the event surface is
:mod:`repro_torch.runtime.telemetry`, the visual surface is
:mod:`repro_torch.runtime.traceview`). The paper's running argument is that
MI300A performance is only predictable when occupancy, concurrency, and
sparsity effects are continuously *measured* — this module turns the
Tracer's event stream into the continuously-scrapable form dashboards
and CI gates consume:

* :class:`Counter` / :class:`Gauge` / :class:`Histogram` — labeled
  instruments. Histograms use explicit bucket bounds (cumulative
  Prometheus semantics: each bucket counts observations ≤ its bound,
  ``+Inf`` implicit).
* :class:`MetricsRegistry` — get-or-create instrument registry with
  ``snapshot()`` (JSON-safe dict) and ``to_prometheus()`` (text
  exposition format) so one registry serves both the ``--metrics-out``
  artifact and a scrape endpoint.
* :class:`MetricsSink` — subscribes to one or more Tracers
  (:meth:`~repro_torch.runtime.telemetry.Tracer.add_sink`) and folds every
  event into the standard instrument set: decode/prefill latency
  histograms, per-tenant token/request counters, pages-in-use and
  fragmentation gauges, migration counters, overlap-efficiency gauges,
  and ring-eviction (dropped) counters. Counters are driven by the same
  per-event stream as the Tracer's monotonic counts, so the two stay
  exact together past ring eviction.
* :func:`observe_runtime` — fold a ``ServingRuntime`` report's derived
  signals (per-tenant SLO attainment, fairness, per-partition occupancy
  fill and backlog) into gauges; the live dashboard
  (:mod:`repro_torch.launch.top`) calls it each refresh.

Wiring: ``ServingSpec(metrics=True)`` builds a registry + sink attached
to every partition tracer; ``launch/serve.py --metrics-out`` writes the
snapshot (or Prometheus text for ``.prom``/``.txt`` paths) at exit.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import concurrency as cc

PREFIX = "repro_"

# Default latency buckets (seconds): serving decode/prefill steps on CPU
# CI land around 1-100ms; real-hardware steps land in the small-ms range.
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5)
# Turnaround buckets (deterministic scheduler steps).
STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
SPEC_COMMIT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _fmt(v: float) -> str:
    """Prometheus sample rendering: integers without a trailing ``.0`` so
    golden-text tests stay readable."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared labeled-series bookkeeping. Thread-safe: serving loops and
    lane joins record concurrently."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"metric name {name!r} must be [a-z0-9_]+")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Any] = {}

    def labels(self) -> List[LabelKey]:
        with self._lock:
            return sorted(self._series)

    def _expose(self) -> List[Tuple[str, str, float]]:
        """(suffix, label-string, value) rows for the text exposition."""
        with self._lock:
            return [("", _label_str(k), v)
                    for k, v in sorted(self._series.items())]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {(_label_str(k) or "total"): v
                    for k, v in sorted(self._series.items())}


class Counter(_Metric):
    """Monotonically increasing labeled counter."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Labeled gauge (set/inc/dec)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            v = self._series.get(_label_key(labels))
            return None if v is None else float(v)


class Histogram(_Metric):
    """Labeled histogram over explicit bucket upper bounds.

    Prometheus cumulative-bucket semantics: ``bucket_counts[i]`` counts
    observations ≤ ``buckets[i]`` and the implicit ``+Inf`` bucket equals
    ``count``. ``snapshot()`` additionally derives non-cumulative per-bin
    counts for human consumption."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help)
        bs = [float(b) for b in buckets]
        if not bs or sorted(bs) != bs or len(set(bs)) != len(bs):
            raise ValueError("buckets must be non-empty, sorted, unique")
        self.buckets = tuple(bs)

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"bucket_counts": [0] * len(self.buckets),
                     "count": 0, "sum": 0.0}
                self._series[key] = s
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    s["bucket_counts"][i] += 1
            s["count"] += 1
            s["sum"] += float(value)

    def value(self, **labels) -> Optional[Dict[str, Any]]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return None if s is None else {
                "bucket_counts": list(s["bucket_counts"]),
                "count": s["count"], "sum": s["sum"]}

    def _expose(self) -> List[Tuple[str, str, float]]:
        rows: List[Tuple[str, str, float]] = []
        with self._lock:
            for key, s in sorted(self._series.items()):
                for bound, n in zip(self.buckets, s["bucket_counts"]):
                    lab = dict(key) | {"le": _fmt(bound)}
                    rows.append(("_bucket", _label_str(_label_key(lab)),
                                 float(n)))
                lab = dict(key) | {"le": "+Inf"}
                rows.append(("_bucket", _label_str(_label_key(lab)),
                             float(s["count"])))
                rows.append(("_sum", _label_str(key), s["sum"]))
                rows.append(("_count", _label_str(key), float(s["count"])))
        return rows

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for key, s in sorted(self._series.items()):
                cum = s["bucket_counts"]
                out[_label_str(key) or "total"] = {
                    "buckets": list(self.buckets),
                    "bucket_counts": list(cum),
                    "per_bin": [c - p for c, p in zip(cum, [0] + cum[:-1])]
                    + [s["count"] - (cum[-1] if cum else 0)],
                    "count": s["count"],
                    "sum": round(s["sum"], 9),
                    "mean": round(s["sum"] / s["count"], 9)
                    if s["count"] else 0.0,
                }
            return out


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Re-requesting a name returns the existing instrument (and raises if
    the kind differs) so producers across modules share series without
    plumbing instrument handles around."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe view of every instrument: the ``--metrics-out``
        artifact and the dashboard's data source."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: {"kind": m.kind, "help": m.help,
                       "series": m.snapshot()}
                for name, m in sorted(metrics.items())}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE header per
        metric, deterministic series order)."""
        with self._lock:
            metrics = dict(self._metrics)
        lines: List[str] = []
        for name, m in sorted(metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for suffix, labels, value in m._expose():
                lines.append(f"{name}{suffix}{labels} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> str:
        text = self.to_prometheus() if path.endswith((".prom", ".txt")) \
            else self.to_json() + "\n"
        with open(path, "w") as f:
            f.write(text)
        return path


# ---------------------------------------------------------------------------
# The Tracer -> metrics bridge
# ---------------------------------------------------------------------------

class MetricsSink:
    """Subscribes to Tracer ``_ingest`` (via ``Tracer.add_sink``) and
    populates the standard serving instrument set.

    Every event increments ``repro_events_total{kind=...}`` — driven by
    the same stream as the Tracer's monotonic per-kind counters, so the
    two agree exactly even after ring eviction (the accounting contract
    ``tests/test_observability.py`` pins). Dropped (ring-evicted) events
    land in ``repro_events_dropped_total{kind=...}`` through the
    ``on_drop`` hook.

    ``migrate`` events are recorded on *both* endpoints' tracers for
    provenance; the sink counts each phase once (on the source
    partition's tracer) so migration counters don't double."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self.events = r.counter(PREFIX + "events_total",
                                "telemetry events by kind")
        self.dropped = r.counter(PREFIX + "events_dropped_total",
                                 "tracer ring evictions by kind")
        self.decode_lat = r.histogram(
            PREFIX + "decode_latency_seconds",
            "decode-step wall time", buckets=LATENCY_BUCKETS_S)
        self.prefill_lat = r.histogram(
            PREFIX + "prefill_latency_seconds",
            "prefill (admission) wall time", buckets=LATENCY_BUCKETS_S)
        self.turnaround = r.histogram(
            PREFIX + "request_turnaround_steps",
            "request submit->finish in scheduler steps",
            buckets=STEP_BUCKETS)
        self.requests = r.counter(PREFIX + "requests_total",
                                  "completed requests per tenant")
        self.tokens = r.counter(PREFIX + "tenant_tokens_total",
                                "generated tokens per tenant")
        self.admissions = r.counter(PREFIX + "admissions_total",
                                    "slot grants per tenant")
        self.migrations = r.counter(PREFIX + "migrations_total",
                                    "migration lifecycle events by phase")
        self.handoff_bytes = r.counter(
            PREFIX + "migration_handoff_bytes_total",
            "bytes moved by live slot handoffs")
        self.pages_in_use = r.gauge(PREFIX + "pages_in_use",
                                    "allocator pages currently allocated")
        self.page_util = r.gauge(PREFIX + "page_utilization",
                                 "written positions / allocated capacity")
        self.page_frag = r.gauge(PREFIX + "page_fragmentation",
                                 "1 - utilization of allocated pages")
        self.page_oom = r.counter(PREFIX + "page_oom_total",
                                  "pool-exhaustion refusals")
        self.overlap_groups = r.counter(PREFIX + "overlap_groups_total",
                                        "planner co-dispatch pairings")
        self.overlap_eff = r.gauge(
            PREFIX + "overlap_efficiency",
            "latest per-group overlap efficiency (sum/max walls)")
        self.overlap_speedup = r.gauge(
            PREFIX + "overlap_speedup",
            "latest per-group serial/concurrent wall ratio")
        self.spec_drafted = r.counter(
            PREFIX + "spec_drafted_total",
            "draft tokens proposed per tenant (speculative decode)")
        self.spec_accepted = r.counter(
            PREFIX + "spec_accepted_total",
            "draft tokens the bf16 verify accepted per tenant")
        self.spec_committed = r.histogram(
            PREFIX + "spec_committed_tokens",
            "tokens committed per speculative step per tenant",
            buckets=SPEC_COMMIT_BUCKETS)
        self.controller_actions = r.counter(
            PREFIX + "controller_actions_total",
            "SLO-controller actions (freeze/thaw/boost/unboost) by kind")
        self._group_walls: Dict[int, List[float]] = {}
        self._glock = threading.Lock()

    # -- subscription -------------------------------------------------------
    def attach(self, *tracers) -> "MetricsSink":
        for tr in tracers:
            tr.add_sink(self)
        return self

    # -- the event fold -----------------------------------------------------
    def on_drop(self, kind: str) -> None:
        self.dropped.inc(kind=kind)

    def on_event(self, ev) -> None:
        part = str(ev.partition)
        self.events.inc(kind=ev.kind)
        if ev.kind == "decode" and ev.wall_s > 0:
            self.decode_lat.observe(ev.wall_s, partition=part)
        elif ev.kind == "prefill" and ev.wall_s > 0:
            self.prefill_lat.observe(ev.wall_s, partition=part)
        elif ev.kind == "request":
            tenant = ev.tenant or "?"
            self.requests.inc(tenant=tenant)
            self.tokens.inc(int(ev.meta.get("tokens", 0)), tenant=tenant)
            ta = ev.meta.get("turnaround_steps", -1)
            if ta is not None and ta >= 0:
                self.turnaround.observe(float(ta), tenant=tenant)
        elif ev.kind == "admit":
            self.admissions.inc(tenant=ev.tenant or "?")
        elif ev.kind == "migrate":
            # recorded on both endpoint tracers: count once, at the source
            if ev.partition == ev.meta.get("src"):
                phase = ev.meta.get("phase", "?")
                self.migrations.inc(phase=phase,
                                    src=str(ev.meta.get("src")),
                                    dst=str(ev.meta.get("dst")))
                if phase == "handoff":
                    self.handoff_bytes.inc(
                        int(ev.meta.get("handoff_bytes", 0)))
        elif ev.kind == "spec":
            tenant = ev.tenant or "?"
            self.spec_drafted.inc(int(ev.meta.get("drafted", 0)),
                                  tenant=tenant)
            self.spec_accepted.inc(int(ev.meta.get("accepted", 0)),
                                   tenant=tenant)
            committed = ev.meta.get("committed")
            if committed:
                self.spec_committed.observe(float(committed), tenant=tenant)
        elif ev.kind == "controller":
            self.controller_actions.inc(
                action=str(ev.meta.get("action", "?")),
                tenant=ev.tenant or "?")
        elif ev.kind == "paging":
            if ev.meta.get("phase") == "page_oom":
                self.page_oom.inc(partition=part)
            if "pages_in_use" in ev.meta:
                self.pages_in_use.set(ev.meta["pages_in_use"],
                                      partition=part)
            if "utilization" in ev.meta:
                self.page_util.set(ev.meta["utilization"], partition=part)
            if "fragmentation" in ev.meta:
                self.page_frag.set(ev.meta["fragmentation"],
                                   partition=part)
        if ev.overlap_group >= 0 and ev.wall_s > 0:
            with self._glock:
                walls = self._group_walls.setdefault(ev.overlap_group, [])
                walls.append(ev.wall_s)
                if len(walls) == 2:
                    self.overlap_groups.inc()
                if len(walls) >= 2:
                    serial, conc = float(sum(walls)), float(max(walls))
                    self.overlap_eff.set(cc.overlap_efficiency(
                        serial, conc, len(walls)))
                    self.overlap_speedup.set(
                        serial / conc if conc > 0 else 0.0)


# ---------------------------------------------------------------------------
# Report-derived gauges (SLO attainment, fairness, occupancy)
# ---------------------------------------------------------------------------

def observe_runtime(registry: MetricsRegistry, runtime,
                    report=None) -> Dict[str, Any]:
    """Fold a ``ServingRuntime``'s current report into gauges: per-tenant
    SLO attainment (from ``Tracer.tenant_percentiles``-backed report
    rows), cross-partition fairness, tokens/steps, and per-partition
    occupancy fill + backlog. Returns the report's dict for callers that
    render both (the dashboard)."""
    rep = report if report is not None else runtime.report()
    g_att = registry.gauge(PREFIX + "slo_attainment",
                           "per-tenant SLO attainment ratio [0,1]")
    g_fair = registry.gauge(PREFIX + "tenant_fairness",
                            "cross-partition turnaround fairness index")
    g_tok = registry.gauge(PREFIX + "tokens_out",
                           "total generated tokens")
    g_steps = registry.gauge(PREFIX + "scheduler_steps",
                             "global lockstep step count")
    g_fill = registry.gauge(PREFIX + "occupancy_fill",
                            "mean observed grid-tile fill (x cores)")
    g_backlog = registry.gauge(PREFIX + "backlog_requests",
                               "queued + in-flight requests")
    g_acc = registry.gauge(PREFIX + "spec_acceptance_rate",
                           "per-tenant draft acceptance ratio [0,1]")
    g_eff = registry.gauge(PREFIX + "spec_effective_tokens_per_step",
                           "per-tenant committed tokens per speculative "
                           "step")
    g_fair.set(rep.fairness)
    g_tok.set(rep.tokens_out)
    g_steps.set(rep.steps)
    for row in rep.tenants:
        if row.slo_attainment is not None:
            g_att.set(row.slo_attainment, tenant=row.tenant_id,
                      slo=row.slo or "none")
        if row.acceptance_rate is not None:
            g_acc.set(row.acceptance_rate, tenant=row.tenant_id)
        if row.effective_tokens_per_step is not None:
            g_eff.set(row.effective_tokens_per_step, tenant=row.tenant_id)
    n_cores = cc.detect_core_count()
    for i, tr in enumerate(runtime.tracers):
        fill = tr.mean_fill(n_cores)
        if fill is not None:
            g_fill.set(fill, partition=str(i))
        sched = runtime.schedulers[i]
        g_backlog.set(sched.pending() + sched.session.n_active,
                      partition=str(i))
    return rep.to_dict()
