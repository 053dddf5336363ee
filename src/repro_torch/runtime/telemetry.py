"""Runtime telemetry: the "execution observatory" event layer.

The paper's techniques pay off only *context-dependently* (FP8 above an
occupancy threshold §5, concurrency below the fairness-collapse knee §6,
2:4 under memory-bound/multi-tenant execution §7), so the policy layer
needs to *see* execution, not just predict it. This module is the seeing
half of the closed loop (the acting half is
:mod:`repro_torch.core.autotune`):

* :class:`Event` — one observation: op kind, (M, K, N), policy/backend,
  wall / estimated seconds, stream id, tenant id, scheduler step.
* :class:`Tracer` — bounded ring buffer of events with monotonic per-kind
  counters and aggregate views: occupancy histogram (grid-tile fill of
  the observed GEMMs), per-shape latency EMAs, per-tenant request counts
  and p50/p99, fairness/overlap over tenants.

* :class:`Span` — a timed stretch of the program, opened by
  :meth:`Tracer.span` and recorded at its end as an ordinary
  :class:`Event` (``t`` its end, ``wall_s`` its length) whose meta holds
  its ``span`` id and its ``parent``'s (the innermost span open on the
  thread, or -1). A span may also be timed on the device
  (``device_time``): its meta then gains ``device_s``, read from two CUDA
  events once the device has passed both.

Producers: ``core/execution.matmul``/``resolve_policy`` (trace-time shape
and policy events), ``core/concurrency.characterize_streams`` (per-stream
wall times), ``runtime/scheduler.StreamScheduler`` (admission + request
completion per tenant), ``ServeSession`` (``prefill`` and ``decode``
spans), and ``runtime/train_loop`` (``train_step`` spans).

Phase spans — ``prefill.forward``/``.first_token``/``.cache_write``,
``decode.dispatch``/``.wait``/``.commit`` and
``train_step.forward``/``.backward``/``.optimizer`` (device-timed on a
card) — are recorded only by a tracer built with ``phases=True``
(:func:`phase`), so a tracer built as the reference builds it sees the
reference's event stream.

An *ambient* tracer can be installed with :func:`set_tracer` so deep call
sites (every ``dense()`` in the model stack) need no plumbing; harness
code that owns its tracer passes it explicitly instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import concurrency as cc

# One unit of grid parallelism (mirrors execution.MXU_TILE without the
# import cycle: execution lazily consults this module's ambient tracer).
MXU_TILE = 128


def _grid_tiles(m: int, n: int, tile: int = MXU_TILE) -> int:
    return max(1, -(-int(m) // tile)) * max(1, -(-int(n) // tile))


@dataclasses.dataclass
class Event:
    """One observed execution event. ``wall_s`` is a measured duration
    (0.0 for trace-time events, which observe shape/policy but run before
    any computation); ``est_s`` carries model-derived estimates when a
    producer has one (roofline terms)."""
    kind: str                        # matmul|resolve|stream|admit|request|...
    t: float = 0.0                   # perf_counter timestamp at record
    m: int = 0
    k: int = 0
    n: int = 0
    precision: str = ""
    backend: str = ""
    policy: str = ""
    wall_s: float = 0.0
    est_s: float = 0.0
    stream: int = -1
    tenant: str = ""
    step: int = -1
    partition: int = -1              # spatial sub-mesh id (-1: unpartitioned)
    lane: str = ""                   # ExecutionLane the op dispatched on
    overlap_group: int = -1          # co-dispatched group id (-1: serial)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def grid_tiles(self) -> int:
        return _grid_tiles(self.m, self.n) if self.m and self.n else 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Span:
    """One open span of a :class:`Tracer` (:meth:`Tracer.span`).

    Used as a context manager, it is the innermost open span of its
    thread until it exits, and is recorded then; an exception drops it
    unrecorded. Otherwise :meth:`end` records it, from any thread (a
    decode step opens in ``dispatch_decode`` and ends in
    ``join_decode``). A child opened with this span as its ``parent``
    takes its lane, so the Chrome trace draws it on the same track."""

    __slots__ = ("tracer", "kind", "fields", "id", "parent", "lane", "t0",
                 "cancelled", "_start")

    def __init__(self, tracer: "Tracer", kind: str, parent: Optional["Span"],
                 device_time: bool, fields: Dict[str, Any]):
        self.tracer = tracer
        self.kind = kind
        self.fields = fields
        self.id = next(tracer._ids)
        self.parent = -1 if parent is None else parent.id
        self.lane = fields.get("lane") or (parent.lane if parent else "")
        self.cancelled = False
        self._start = None
        if device_time:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self.t0 = time.perf_counter()

    def __enter__(self) -> "Span":
        self.tracer._open_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.tracer._open_stack().remove(self)
        if exc_type is None and not self.cancelled:
            self.end()
        return False

    def cancel(self) -> None:
        """Leave this span unrecorded when its ``with`` block exits."""
        self.cancelled = True

    def end(self, **fields) -> Event:
        """Record the span: ``fields`` (an ``Event``'s) join those it was
        opened with, ``meta`` merged into theirs."""
        t1 = time.perf_counter()
        stop = None
        if self._start is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
        tr = self.tracer
        meta = {**self.fields.get("meta", {}), **fields.pop("meta", {}),
                "span": self.id, "parent": self.parent}
        f = {**self.fields, **fields, "meta": meta}
        f.setdefault("partition", tr.partition)
        if self.lane:
            f["lane"] = self.lane
        ev = Event(kind=self.kind, t=t1, wall_s=t1 - self.t0, **f)
        tr._ingest(ev)
        if stop is not None:
            with tr._lock:
                tr._timed.append((ev, self._start, stop))
            tr._resolve_device(wait=False)
        return ev


class Tracer:
    """Bounded event recorder with aggregate views.

    Events land in a ring buffer of ``capacity`` (old events evicted).
    The counting views — :meth:`counts`, :meth:`tenant_counts` — and the
    per-shape latency EMAs are maintained as monotonic counters that
    survive eviction, so they stay exact on long runs; the sample views
    (:meth:`events`, :meth:`tenant_latencies`/:meth:`tenant_percentiles`,
    :meth:`occupancy_histogram`) cover the retained window only.
    Thread-safe: the serving loop, stream runners, and host callbacks may
    record concurrently. ``phases`` turns on the phase spans inside
    prefill, decode and the training step (:func:`phase`).
    """

    def __init__(self, capacity: int = 4096, ema_alpha: float = 0.25,
                 partition: int = -1, phases: bool = False):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.ema_alpha = ema_alpha
        # Default partition tag stamped onto every event recorded here that
        # doesn't carry one (a per-partition tracer inside PartitionedServer
        # tags its whole stream so Tracer.merge keeps provenance).
        self.partition = partition
        self.phases = phases
        self._ring: deque = deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._tenant_counts: Dict[Tuple[str, str], int] = {}
        self._ema: Dict[Tuple[int, int, int, str], float] = {}
        self._dropped: Dict[str, int] = {}   # kind -> ring evictions
        self._warned_drop = False
        self._sinks: List[Any] = []          # duck-typed: on_event/on_drop
        self._lock = threading.Lock()
        self._ids = itertools.count()        # span ids
        self._local = threading.local()      # each thread's open spans
        # device-timed spans whose CUDA events are not read yet, in the
        # order of their ends: (event, start, stop)
        self._timed: List[Tuple[Event, Any, Any]] = []

    # -- sinks (the metrics plane subscribes here) --------------------------
    def add_sink(self, sink) -> "Tracer":
        """Subscribe a sink (duck-typed: ``on_event(ev)``, optionally
        ``on_drop(kind)``) to every event folded into this tracer — the
        seam :class:`repro_torch.runtime.metrics.MetricsSink` attaches through.
        Sinks run on the recording thread, outside the tracer lock."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
        return self

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, **fields) -> Event:
        fields.setdefault("partition", self.partition)
        ev = Event(kind=kind, t=time.perf_counter(), **fields)
        self._ingest(ev)
        return ev

    def _ingest(self, ev: Event) -> None:
        """Fold one already-built event in: ring append + every counter,
        all under the lock (concurrent emitters — multi-partition steps,
        ``run_async_dispatch`` threads — may interleave). Eviction past
        ``capacity`` is *counted* (per evicted kind) and warned about once:
        the sample views silently narrowing to a truncated window while
        the monotonic counters keep the true totals is exactly the
        observability gap the dropped counters close."""
        with self._lock:
            evicted = self._ring[0] if len(self._ring) == self.capacity \
                else None
            self._ring.append(ev)
            if evicted is not None:
                self._dropped[evicted.kind] = \
                    self._dropped.get(evicted.kind, 0) + 1
            first_drop = evicted is not None and not self._warned_drop
            if first_drop:
                self._warned_drop = True
            self._counts[ev.kind] = self._counts.get(ev.kind, 0) + 1
            if ev.tenant:
                tkey = (ev.kind, ev.tenant)
                self._tenant_counts[tkey] = self._tenant_counts.get(
                    tkey, 0) + 1
            if ev.wall_s > 0 and ev.m and ev.k and ev.n:
                key = (ev.m, ev.k, ev.n, ev.precision)
                prev = self._ema.get(key)
                self._ema[key] = ev.wall_s if prev is None else \
                    (1 - self.ema_alpha) * prev + self.ema_alpha * ev.wall_s
            sinks = list(self._sinks)
        if first_drop:
            warnings.warn(
                f"Tracer(capacity={self.capacity}) began evicting events: "
                "sample views (tenant_latencies/percentiles, occupancy "
                "histogram, overlap_groups) now cover a truncated window; "
                "monotonic counts stay exact — see Tracer.dropped()",
                RuntimeWarning, stacklevel=4)
        for sink in sinks:
            if evicted is not None and hasattr(sink, "on_drop"):
                sink.on_drop(evicted.kind)
            sink.on_event(ev)

    def record_matmul(self, m: int, k: int, n: int, *, precision: str = "",
                      backend: str = "", policy: str = "",
                      wall_s: float = 0.0, **meta) -> Event:
        return self.record("matmul", m=m, k=k, n=n, precision=precision,
                           backend=backend, policy=policy, wall_s=wall_s,
                           meta=meta)

    def record_resolve(self, m: int, k: int, n: int, *, policy: str,
                       precision: str = "", backend: str = "",
                       **meta) -> Event:
        return self.record("resolve", m=m, k=k, n=n, precision=precision,
                           backend=backend, policy=policy, meta=meta)

    def record_stream(self, stream: int, wall_s: float, *, mode: str = "",
                      n_streams: int = 0, **meta) -> Event:
        meta.update(mode=mode, n_streams=n_streams)
        return self.record("stream", stream=stream, wall_s=wall_s, meta=meta)

    def record_request(self, tenant: str, *, wall_s: float = 0.0,
                       tokens: int = 0, turnaround_steps: int = -1,
                       step: int = -1, **meta) -> Event:
        meta.update(tokens=tokens, turnaround_steps=turnaround_steps)
        return self.record("request", tenant=tenant, wall_s=wall_s,
                           step=step, meta=meta)

    def record_migrate(self, tenant: str, *, src: int, dst: int,
                       phase: str, step: int = -1, **meta) -> Event:
        """One live-migration lifecycle event (``phase`` ∈ start / handoff
        / done). Recorded on *both* endpoints' tracers by the serving
        runtime so the fused view keeps provenance, and consumed by the
        fairness accounting tests: a migrated tenant's request events stay
        keyed by the same tenant id across partitions, so per-tenant
        percentiles remain exact across the move."""
        meta.update(src=src, dst=dst, phase=phase)
        return self.record("migrate", tenant=tenant, step=step, meta=meta)

    # -- spans ----------------------------------------------------------------
    def span(self, kind: str, *, parent: Optional[Span] = None,
             device_time: bool = False, **fields) -> Span:
        """Open a span of ``kind`` now. ``fields`` are an ``Event``'s
        (more may be given to :meth:`Span.end`). Its parent is ``parent``,
        else the innermost span open on this thread. ``device_time``
        (a CUDA run) records a CUDA event on the current stream at each
        end; the device's time between them becomes ``meta["device_s"]``
        once both have passed, read without waiting as later spans end,
        and waited for when the tracer's events are read."""
        if parent is None:
            stack = self._open_stack()
            parent = stack[-1] if stack else None
        return Span(self, kind, parent, device_time, fields)

    def _open_stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _resolve_device(self, wait: bool) -> None:
        """Write ``device_s`` into each device-timed span whose stop event
        the device has passed (``wait``: every one, waiting for it). One
        stream passes its events in order, so the first not yet passed
        ends a pass that does not wait."""
        while True:
            with self._lock:
                if not self._timed:
                    return
                ev, start, stop = self._timed[0]
            if wait:
                stop.synchronize()
            elif not stop.query():
                return
            ev.meta["device_s"] = start.elapsed_time(stop) / 1e3
            with self._lock:
                if self._timed and self._timed[0][0] is ev:
                    self._timed.pop(0)

    # -- raw views ----------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Event]:
        if self._timed:
            self._resolve_device(wait=True)
        with self._lock:
            evs = list(self._ring)
        return evs if kind is None else [e for e in evs if e.kind == kind]

    def counts(self, include_dropped: bool = False) -> Dict[str, int]:
        """Monotonic per-kind totals (exact even after ring eviction).
        With ``include_dropped`` the per-kind ring-eviction counters ride
        along under ``"dropped.<kind>"`` keys, so one call exposes both
        the true totals and how much of each kind the sample window has
        lost."""
        with self._lock:
            out = dict(self._counts)
            if include_dropped:
                for kind, n in self._dropped.items():
                    out[f"dropped.{kind}"] = n
            return out

    def dropped(self) -> Dict[str, int]:
        """Per-kind count of events evicted from the ring (the gap
        between :meth:`counts` and what the sample views can still see).
        Empty until the tracer overflows ``capacity``."""
        with self._lock:
            return dict(self._dropped)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- aggregate views ----------------------------------------------------
    def shape_latency_ema(self) -> Dict[Tuple[int, int, int, str], float]:
        """(M, K, N, precision) → EMA of measured wall seconds."""
        with self._lock:
            return dict(self._ema)

    def occupancy_histogram(self, n_cores: Optional[int] = None,
                            bins: Sequence[float] = (0.25, 0.5, 1.0, 2.0,
                                                     4.0, 8.0)
                            ) -> Dict[str, int]:
        """Histogram of grid-tile *fill* (tiles / cores) over the observed
        matmul/resolve events — the §5 occupancy axis as seen at runtime.
        ``n_cores`` defaults to the *detected* hardware core count
        (:func:`repro_torch.core.concurrency.detect_core_count`), so fills are
        hardware-correct without every caller remembering to pass it."""
        if n_cores is None:
            n_cores = cc.detect_core_count()
        edges = list(bins)
        labels = [f"<{edges[0]}"] + \
            [f"{lo}-{hi}" for lo, hi in zip(edges, edges[1:])] + \
            [f">={edges[-1]}"]
        hist = {lab: 0 for lab in labels}
        for ev in self.events():
            if ev.kind not in ("matmul", "resolve") or not ev.grid_tiles:
                continue
            fill = ev.grid_tiles / max(1, n_cores)
            idx = int(np.searchsorted(edges, fill, side="right"))
            hist[labels[idx]] += 1
        return hist

    def mean_fill(self, n_cores: Optional[int] = None) -> Optional[float]:
        """Mean grid-tile fill (tiles / cores) over the retained
        matmul/resolve events; ``None`` with no samples. The scalar form
        of :meth:`occupancy_histogram` that :class:`~repro_torch.runtime.
        scheduler.AdaptiveQuota` consumes as its second signal: when the
        observed fill collapses, the §6 guidance is to *shrink* the
        concurrency budget, not just rebalance it. ``n_cores`` defaults
        to the detected hardware core count."""
        if n_cores is None:
            n_cores = cc.detect_core_count()
        fills = [ev.grid_tiles / max(1, n_cores) for ev in self.events()
                 if ev.kind in ("matmul", "resolve") and ev.grid_tiles]
        return float(np.mean(fills)) if fills else None

    def tenant_counts(self, kind: str = "request") -> Dict[str, int]:
        """Monotonic per-tenant event totals — exact on long runs (kept as
        counters, not derived from the evicting ring)."""
        with self._lock:
            return {tenant: c for (k, tenant), c
                    in self._tenant_counts.items() if k == kind}

    def known_tenants(self) -> List[str]:
        """Every tenant id that ever produced *any* event (register /
        route / admit / request / migrate …), sorted. Backed by the
        monotonic counters, so a tenant that was registered but never
        submitted a request still shows up — the fairness-report views
        must enumerate the full tenant population, not just the tenants
        with traffic."""
        with self._lock:
            return sorted({tenant for (_, tenant) in self._tenant_counts})

    def tenant_latencies(self, metric: str = "wall_s"
                         ) -> Dict[str, List[float]]:
        """Per-tenant request-latency samples over the *retained window*
        (the newest ``capacity`` events): a sliding view by design — the
        quota loop wants recent behavior, not all-time history.

        ``metric`` selects the latency domain: ``"wall_s"`` (wall-clock
        seconds) or ``"turnaround_steps"`` (deterministic scheduler steps,
        carried in the request event's meta — what :class:`~repro_torch.runtime.
        scheduler.AdaptiveQuota` consumes so quota decisions are
        reproducible run-to-run)."""
        out: Dict[str, List[float]] = {}
        for ev in self.events("request"):
            if not ev.tenant:
                continue
            if metric == "wall_s":
                out.setdefault(ev.tenant, []).append(ev.wall_s)
            else:
                v = ev.meta.get(metric)
                if v is not None and v >= 0:
                    out.setdefault(ev.tenant, []).append(float(v))
        return out

    def tenant_percentiles(self, metric: str = "wall_s"
                           ) -> Dict[str, Dict[str, float]]:
        """Per-tenant p50/p99 of request latency over the retained window
        — the signal the fair_quantum quota loop consumes instead of
        static stream budgets."""
        return {t: cc.latency_percentiles(ls)
                for t, ls in self.tenant_latencies(metric).items()}

    def tenant_fairness(self) -> float:
        """Paper fairness index over per-tenant mean request latency
        (retained window)."""
        means = [float(np.mean(ls)) for ls in self.tenant_latencies().values()
                 if ls]
        return cc.fairness(means)

    def partition_counts(self, kind: Optional[str] = None) -> Dict[int, int]:
        """Events per partition tag over the retained window (fused-report
        provenance view: which sub-mesh produced what)."""
        out: Dict[int, int] = {}
        for ev in self.events(kind):
            out[ev.partition] = out.get(ev.partition, 0) + 1
        return out

    def mean_wall(self, kind: str) -> float:
        """Mean measured wall seconds of a kind over the retained window
        (0.0 with no measured samples). ``load_aware`` placement reads the
        per-partition ``decode`` mean as its congestion signal."""
        walls = [e.wall_s for e in self.events(kind) if e.wall_s > 0]
        return float(np.mean(walls)) if walls else 0.0

    # -- merging (fused multi-partition view) -------------------------------
    @classmethod
    def merge(cls, *tracers: "Tracer") -> "Tracer":
        """Fuse several tracers (one per spatial partition) into one view.

        The merged ring replays every retained event in timestamp order
        (capacity = sum of the sources', so nothing retained is dropped);
        monotonic counters are *summed from the sources' counters* — they
        stay exact even where the source rings have already evicted.
        Partition tags on the events are preserved, so per-partition
        provenance survives the merge."""
        if not tracers:
            return cls()
        merged = cls(capacity=sum(t.capacity for t in tracers),
                     ema_alpha=tracers[0].ema_alpha)
        events: List[Event] = []
        for tr in tracers:
            events.extend(tr.events())
        for ev in sorted(events, key=lambda e: e.t):
            merged._ring.append(ev)
            if ev.wall_s > 0 and ev.m and ev.k and ev.n:
                key = (ev.m, ev.k, ev.n, ev.precision)
                prev = merged._ema.get(key)
                merged._ema[key] = ev.wall_s if prev is None else \
                    (1 - merged.ema_alpha) * prev \
                    + merged.ema_alpha * ev.wall_s
        for tr in tracers:
            with tr._lock:
                counts = dict(tr._counts)
                tcounts = dict(tr._tenant_counts)
                dropped = dict(tr._dropped)
            for k, v in counts.items():
                merged._counts[k] = merged._counts.get(k, 0) + v
            for k, v in tcounts.items():
                merged._tenant_counts[k] = \
                    merged._tenant_counts.get(k, 0) + v
            for k, v in dropped.items():
                merged._dropped[k] = merged._dropped.get(k, 0) + v
        merged._warned_drop = True       # sources already warned
        return merged

    def overlap_groups(self) -> Dict[int, List[Event]]:
        """Wall-bearing events per overlap group over the retained window.
        A group is a set of ops the :class:`~repro_torch.core.execution.
        OverlapPlanner` co-dispatched (same ``overlap_group`` id across
        lanes); serial events (``overlap_group == -1``) are excluded."""
        groups: Dict[int, List[Event]] = {}
        for ev in self.events():
            if ev.overlap_group >= 0 and ev.wall_s > 0:
                groups.setdefault(ev.overlap_group, []).append(ev)
        return groups

    def overlap_summary(self) -> Dict[str, float]:
        """Overlap efficiency achieved by the recorded overlap groups.

        Per group the serial estimate is the sum of member dispatch→ready
        walls and the concurrent estimate is their max (each member's wall
        already spans the co-dispatched region), mirroring
        :meth:`stream_overlap` but attributed to planner decisions.
        Groups need ≥2 wall-bearing members to count."""
        groups = [evs for evs in self.overlap_groups().values()
                  if len(evs) >= 2]
        if not groups:
            return {"groups": 0, "events": 0,
                    "mean_efficiency": 0.0, "mean_speedup": 0.0}
        effs, spds = [], []
        for evs in groups:
            walls = [e.wall_s for e in evs]
            serial, conc = float(sum(walls)), float(max(walls))
            effs.append(cc.overlap_efficiency(serial, conc, len(walls)))
            spds.append(serial / conc if conc > 0 else 0.0)
        return {"groups": len(groups),
                "events": int(sum(len(evs) for evs in groups)),
                "mean_efficiency": float(np.mean(effs)),
                "mean_speedup": float(np.mean(spds))}

    def stream_overlap(self) -> float:
        """Overlap efficiency implied by the recorded stream events (serial
        estimate = sum of per-stream times; wall = max)."""
        per_stream = [e.wall_s for e in self.events("stream")]
        if len(per_stream) < 2:
            return 0.0
        return cc.overlap_efficiency(float(sum(per_stream)),
                                     float(max(per_stream)),
                                     len(per_stream))

    # -- reporting / serialization -----------------------------------------
    def to_dicts(self) -> List[Dict[str, Any]]:
        return [e.to_dict() for e in self.events()]

    def summary(self, n_cores: Optional[int] = None) -> str:
        if n_cores is None:
            n_cores = cc.detect_core_count()
        counts = self.counts()
        lines = ["[telemetry] events: " + (", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())) or "none")]
        dropped = self.dropped()
        if dropped:
            lines.append("  dropped (ring evictions): " + ", ".join(
                f"{k}={v}" for k, v in sorted(dropped.items())))
        hist = self.occupancy_histogram(n_cores=n_cores)
        if any(hist.values()):
            lines.append("  occupancy fill (×cores): " + " ".join(
                f"{lab}:{c}" for lab, c in hist.items() if c))
        ema = self.shape_latency_ema()
        if ema:
            worst = sorted(ema.items(), key=lambda kv: -kv[1])[:5]
            lines.append("  slowest shapes (EMA): " + "; ".join(
                f"{m}x{k}x{n}/{p or '?'}={s * 1e3:.2f}ms"
                for (m, k, n, p), s in worst))
        known = self.known_tenants()
        if known:
            tcounts = self.tenant_counts()
            pcts = self.tenant_percentiles()
            # enumerate EVERY known tenant: one that registered but never
            # submitted still appears (0 req) instead of silently
            # vanishing from the report
            lines.append("  tenants: " + "; ".join(
                (f"{t}: {tcounts[t]} req "
                 f"p50={pcts.get(t, {}).get('p50', 0.0) * 1e3:.1f}ms "
                 f"p99={pcts.get(t, {}).get('p99', 0.0) * 1e3:.1f}ms")
                if t in tcounts else f"{t}: 0 req"
                for t in known))
            lines.append(f"  tenant fairness={self.tenant_fairness():.3f}")
        migs = self.counts().get("migrate", 0)
        if migs:
            lines.append(f"  migrations: {migs} events")
        ov = self.overlap_summary()
        if ov["groups"]:
            lines.append(
                f"  overlap: {ov['groups']} group(s) / {ov['events']} ops, "
                f"mean efficiency={ov['mean_efficiency']:.3f} "
                f"speedup={ov['mean_speedup']:.2f}x")
        parts = {p: c for p, c in self.partition_counts().items() if p >= 0}
        if parts:
            lines.append("  partitions: " + " ".join(
                f"p{p}:{c}" for p, c in sorted(parts.items())))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Ambient tracer (deep call sites observe without plumbing)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the ambient tracer consulted by
    ``execution.matmul``/``resolve_policy``. Returns the previous one so
    callers can restore it."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _GLOBAL


# What :func:`phase` returns where nothing is recorded: one shared null
# context, so an untraced call site allocates nothing.
NO_SPAN = contextlib.nullcontext()


def phase(tracer: Optional[Tracer], kind: str, parent: Optional[Span] = None,
          **kw):
    """A phase span of ``tracer`` to use with ``with``, or
    :data:`NO_SPAN` when there is no tracer or it records no phases."""
    if tracer is None or not tracer.phases:
        return NO_SPAN
    return tracer.span(kind, parent=parent, **kw)
