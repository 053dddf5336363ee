"""Concurrent-execution layer — the ACE analogue on CUDA streams (paper §6).

Twin of ``repro/core/concurrency.py``. MI300A exposes hardware ACE queues
that time/space-share one GPU; the H100's counterpart is CUDA streams: work
enqueued on different streams may run on the card at the same time, and
the host orders them only through events. The module instruments both
mechanisms with the paper's metrics (overlap efficiency, fairness,
per-stream CV):

* ``run_async_dispatch``  — N workloads enqueued before any is joined:
  time-multiplexing, the moral equivalent of N HSA queues feeding one
  ACE. With one lane per workload each runs on its own stream.
* ``run_spatial``         — one workload per device subset. On one card
  the partitions are logical only (they share the card's SMs); spatial
  isolation on one H100 (MIG) is not modelled.

:class:`ExecutionLane` owns a ``torch.cuda.Stream`` on its device and
runs each dispatched thunk on it; a :class:`LaneHandle` holds the result
and an event recorded after it. A lane on the CPU has no stream and runs
its thunk synchronously. ``OccupancyAdvisor`` encodes the paper's §9.2
guidance as executable policy (used by the serving layer).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# Grid-parallelism capacity used whenever no CUDA device is attached (CPU
# runs): the reference's table value, so CPU decisions match the
# reference's decision for decision.
DEFAULT_N_CORES = 256


def resolve_device(device=None) -> torch.device:
    """The device a session or lane runs on: ``cuda`` unless the caller
    names one. Without a CUDA device the caller must ask for the CPU
    explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the card; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def detect_core_count(default: int = DEFAULT_N_CORES) -> int:
    """Grid-parallelism capacity of the attached card(s).

    Precedence: ``REPRO_N_CORES`` env override > the summed streaming-
    multiprocessor count of every visible CUDA device > ``default``. A
    machine without a CUDA device keeps the table value, so CPU test
    decisions are stable."""
    env = os.environ.get("REPRO_N_CORES")
    if env:
        try:
            val = int(env)
        except ValueError:
            warnings.warn(
                f"REPRO_N_CORES={env!r} is not an integer; ignoring the "
                f"override and falling back to detection/default",
                RuntimeWarning, stacklevel=2)
        else:
            if val > 0:
                return val
            warnings.warn(
                f"REPRO_N_CORES={env!r} is not a positive core count; "
                f"ignoring the override and falling back to "
                f"detection/default",
                RuntimeWarning, stacklevel=2)
    if not torch.cuda.is_available():
        return default
    return sum(torch.cuda.get_device_properties(i).multi_processor_count
               for i in range(torch.cuda.device_count()))


# ---------------------------------------------------------------------------
# Metrics (paper §4.2)
# ---------------------------------------------------------------------------

def fairness_raw(times: Sequence[float]) -> float:
    """Unclamped 1 - (t_max - t_min)/t_mean ∈ (-inf, 1]. Diagnostic only:
    below 0 the spread exceeds the mean and the magnitude is not
    interpretable as a fairness level."""
    t = np.asarray(times, dtype=np.float64)
    if t.size == 0 or t.mean() == 0:
        return 1.0
    return float(1.0 - (t.max() - t.min()) / t.mean())


def fairness(times: Sequence[float]) -> float:
    """1 - (t_max - t_min)/t_mean clamped to [0, 1].

    Paper convention: the fairness index is reported in [0, 1] (Fig 5:
    0.016–0.138 at 8 streams), 1.0 = perfectly balanced, 0.0 = fully
    collapsed. Use :func:`fairness_raw` when the unbounded value is
    wanted."""
    return max(0.0, fairness_raw(times))


def fairness_min_max(times: Sequence[float]) -> float:
    """min/max per-stream time ratio (paper §7.2 variant); 1.0 = balanced."""
    t = np.asarray(times, dtype=np.float64)
    if t.size == 0 or t.max() == 0:
        return 1.0
    return float(t.min() / t.max())


def cv(times: Sequence[float]) -> float:
    t = np.asarray(times, dtype=np.float64)
    if t.size == 0 or t.mean() == 0:
        return 0.0
    return float(t.std() / t.mean())


def latency_percentiles(times: Sequence[float],
                        ps: Sequence[int] = (50, 99)) -> Dict[str, float]:
    """{"p50": ..., "p99": ...} over a latency sample (paper Fig 8's
    per-stream distribution view); zeros when the sample is empty."""
    t = np.asarray(times, dtype=np.float64)
    if t.size == 0:
        return {f"p{p}": 0.0 for p in ps}
    return {f"p{p}": float(np.percentile(t, p)) for p in ps}


def overlap_efficiency(serial_total: float, concurrent_total: float,
                       n_streams: int) -> float:
    """Fraction of ideal overlap achieved: 1.0 when concurrent time equals
    serial/n (perfect overlap), 0.0 when no faster than serial."""
    if serial_total <= 0 or n_streams <= 1:
        return 0.0
    ideal = serial_total / n_streams
    if concurrent_total <= ideal:
        return 1.0
    return float((serial_total - concurrent_total)
                 / (serial_total - ideal))


@dataclasses.dataclass
class StreamReport:
    n_streams: int
    mode: str                        # serial | async | spatial
    per_stream_s: List[float]
    wall_s: float
    serial_wall_s: float
    speedup: float
    overlap_efficiency: float
    fairness: float
    fairness_min_max: float
    cv: float
    # How per_stream_s was measured: each stream's time runs from ITS OWN
    # dispatch to its result being ready (the lane-handle clock).
    timing: str = "dispatch_to_ready"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 9)
            elif isinstance(v, list):
                d[k] = [round(x, 9) if isinstance(x, float) else x
                        for x in v]
        # the reference's key, kept so reports compare field for field
        d["legacy_timing"] = ("pre-lane per_stream_s ran from a global t0"
                              " — not per-dispatch")
        return d

    def to_record(self, name: str, **extra: Any):
        """Serialize as a :class:`repro_torch.core.characterization.Record`;
        ``extra`` keys are merged into ``derived``."""
        from repro_torch.core.characterization import Record
        derived = dict(self.to_dict())
        derived.update(extra)
        return Record(name=name, us_per_call=self.wall_s * 1e6,
                      derived=derived)


# ---------------------------------------------------------------------------
# Execution lanes (dispatch-and-join seam)
# ---------------------------------------------------------------------------

def _cuda_devices(x, found: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def _block(x) -> None:
    """Wait until every CUDA tensor in ``x`` (nested lists, tuples and
    dicts) is computed: synchronizes their devices."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class LaneHandle:
    """A joinable in-flight dispatch.

    ``result`` holds whatever the thunk returned: tensors whose kernels are
    enqueued on the lane's stream, not yet waited for. ``join()`` waits on
    ``event`` (recorded on the stream after the thunk) and stamps
    ``ready_t``; ``dispatch_to_ready_s`` is then the stream's own
    dispatch→ready time (not measured from a global start, so it excludes
    other streams' completion waits)."""
    lane: str
    label: str
    result: Any
    dispatch_t: float
    overlap_group: int = -1
    ready_t: Optional[float] = None
    event: Optional[Any] = None      # torch.cuda.Event; None on the CPU

    def join(self) -> Any:
        if self.ready_t is None:
            if self.event is not None:
                self.event.synchronize()
            self.ready_t = time.perf_counter()
        return self.result

    @property
    def done(self) -> bool:
        return self.ready_t is not None

    @property
    def dispatch_to_ready_s(self) -> float:
        end = self.ready_t if self.ready_t is not None else time.perf_counter()
        return max(0.0, end - self.dispatch_t)


class ExecutionLane:
    """A named async dispatch context on its own CUDA stream — the
    ACE-queue analogue the rest of the stack programs against.

    ``dispatch(thunk)`` makes the lane's stream wait on the caller's
    current stream (and on the events of ``after`` handles), runs the
    thunk with the lane's stream current, records an event after it and
    returns a :class:`LaneHandle`. Callers join handles when, and only
    when, they need the values on the host, which is what lets two lanes'
    work overlap on the card. A lane on the CPU has no stream and runs its
    thunk synchronously. ``device`` defaults to the current CUDA device
    (see :func:`resolve_device`). ``handles`` holds the dispatches not yet
    joined (a joined one is dropped at the next dispatch, so a lane that
    serves for hours does not keep every step's tensors alive). A lane
    given a ``tracer`` (duck-typed
    :class:`repro_torch.runtime.telemetry.Tracer`) records one
    ``dispatch`` event per dispatch."""

    def __init__(self, name: str = "lane0", *, index: int = 0, tracer=None,
                 device=None):
        self.name = name
        self.index = index
        self.tracer = tracer
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self.handles: List[LaneHandle] = []

    def dispatch(self, thunk: Callable[[], Any], *, label: str = "",
                 overlap_group: int = -1,
                 after: Sequence[LaneHandle] = ()) -> LaneHandle:
        t0 = time.perf_counter()
        event = None
        if self.stream is None:
            result = thunk()
        else:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for h in after:
                if h.event is not None:
                    self.stream.wait_event(h.event)
            with torch.cuda.stream(self.stream):
                result = thunk()
            event = torch.cuda.Event()
            event.record(self.stream)
        h = LaneHandle(lane=self.name,
                       label=label or getattr(thunk, "__name__", "thunk"),
                       result=result, dispatch_t=t0,
                       overlap_group=overlap_group, event=event)
        self.handles = [old for old in self.handles if not old.done]
        self.handles.append(h)
        if self.tracer is not None:
            self.tracer.record("dispatch", lane=self.name,
                               overlap_group=overlap_group,
                               meta={"label": h.label})
        return h

    def join_all(self) -> List[Any]:
        return [h.join() for h in self.handles]

    def reset(self) -> None:
        self.handles.clear()

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"ExecutionLane({self.name!r}, index={self.index}, "
                f"device={self.device}, "
                f"inflight={sum(not h.done for h in self.handles)})")


# ---------------------------------------------------------------------------
# Stream runners (on lanes)
# ---------------------------------------------------------------------------

def run_serial(thunks: Sequence[Callable[[], Any]],
               lane: Optional[ExecutionLane] = None, *,
               device=None) -> List[float]:
    """Execute each workload to completion before the next; returns
    per-stream durations."""
    lane = lane if lane is not None else ExecutionLane("serial",
                                                       device=device)
    times = []
    for fn in thunks:
        h = lane.dispatch(fn)
        h.join()
        times.append(h.dispatch_to_ready_s)
    return times


def run_async_dispatch(thunks: Sequence[Callable[[], Any]],
                       lane=None, *, device=None) -> List[float]:
    """Enqueue all workloads, then join in dispatch order — the ACE
    multi-queue analogue. ``lane`` is one :class:`ExecutionLane` (every
    workload on its stream, in order), a sequence of lanes (workload i on
    lane i: N streams at once), or None (one new lane per workload).
    Returns each stream's own dispatch→ready time (see
    :class:`LaneHandle`)."""
    if lane is None:
        lanes = [ExecutionLane(f"async{i}", index=i, device=device)
                 for i in range(len(thunks))]
    elif isinstance(lane, ExecutionLane):
        lanes = [lane] * len(thunks)
    else:
        lanes = list(lane)
    handles = [ln.dispatch(fn) for ln, fn in zip(lanes, thunks)]
    times = []
    for h in handles:
        h.join()
        times.append(h.dispatch_to_ready_s)
    return times


def run_spatial(fns_and_args: Sequence[tuple], devices: Sequence) -> List[float]:
    """One workload per device (subset): spatial multi-tenancy.

    ``fns_and_args[i] = (fn_on_device_i, args)``; returns per-stream
    completion times from the common start. With fewer cards than
    workloads (one H100) the partitions are logical only: every workload
    runs on the same card's SMs, one after another on the caller's
    stream, so nothing here isolates them (MIG is out of scope)."""
    t0 = time.perf_counter()
    results = [fn(*args) for fn, args in fns_and_args]
    times = []
    for r in results:
        _block(r)
        times.append(time.perf_counter() - t0)
    return times


def characterize_streams(make_thunk: Callable[[int], Callable[[], Any]],
                         n_streams: int, *, warmup: int = 1,
                         mode: str = "async", tracer=None,
                         device=None) -> StreamReport:
    """Run the paper's Fig-4/5 experiment for one stream count.

    Serial reference: every thunk on one lane, each joined before the
    next. ``async``: every thunk on a lane (stream) of its own, all
    dispatched before any join. ``tracer`` (duck-typed
    :class:`repro_torch.runtime.telemetry.Tracer`) receives one ``stream``
    event per stream plus a ``stream_report`` aggregate."""
    device = resolve_device(device)
    thunks = [make_thunk(i) for i in range(n_streams)]
    lanes = [ExecutionLane(f"stream{i}", index=i, device=device)
             for i in range(n_streams)]
    # warm every thunk on every lane it runs on below: a build, a first
    # call or a stream's first launch (the kernels keep their split scratch
    # per stream) left for the timed region would inflate its times
    for _ in range(warmup):
        run_serial(thunks, lanes[0])
        if mode == "async":
            run_async_dispatch(thunks, lanes)

    serial_times = run_serial(thunks, lanes[0])
    serial_total = sum(serial_times)

    t0 = time.perf_counter()
    if mode == "async":
        per_stream = run_async_dispatch(thunks, lanes)
    else:
        per_stream = run_serial(thunks, lanes[0])
    wall = time.perf_counter() - t0

    report = StreamReport(
        n_streams=n_streams,
        mode=mode,
        per_stream_s=per_stream,
        wall_s=wall,
        serial_wall_s=serial_total,
        speedup=serial_total / wall if wall > 0 else 0.0,
        overlap_efficiency=overlap_efficiency(serial_total, wall, n_streams),
        fairness=fairness(per_stream),
        fairness_min_max=fairness_min_max(per_stream),
        cv=cv(per_stream),
    )
    if tracer is not None:
        for i, s in enumerate(per_stream):
            tracer.record_stream(i, s, mode=mode, n_streams=n_streams)
        tracer.record("stream_report", wall_s=wall, meta={
            "mode": mode, "n_streams": n_streams,
            "fairness": report.fairness, "cv": report.cv,
            "overlap_efficiency": report.overlap_efficiency})
    return report


# ---------------------------------------------------------------------------
# Occupancy advisor (paper §9.2 as executable policy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkloadProfile:
    precision: str                  # fp8 | fp16 | bf16 | fp32
    grid_tiles: int                 # parallelism available (output tiles)
    latency_sensitive: bool = False
    concurrent_tenants: int = 1


@dataclasses.dataclass
class Advice:
    use_sparsity: bool
    max_streams: int
    suggested_precision: str
    batch_multiplier: int
    rationale: List[str]


class OccupancyAdvisor:
    """Paper §9.2 decision rules:

    * FP8 needs ~2× the grid parallelism of bf16 to hide HBM latency
      (paper: 256+ wavefronts vs 192/128) — below the threshold, prefer
      bf16 or batch up.
    * concurrency: ≤4 streams for latency-sensitive (fairness > 0.5),
      6–8 for throughput; hard isolation → spatial partitions.
    * sparsity: enable when the workload is memory-bound/multi-tenant
      (decode, small batch); disable for isolated compute-bound work.

    ``n_cores`` defaults to :func:`detect_core_count` (the SM count on the
    card), so the same workload may be advised differently on the card
    than on the CPU.
    """

    # Priors, carried over unchanged from the reference (its Table-3/§9.2
    # values, in units of cores). They are not H100 measurements.
    FP8_TILE_THRESHOLD = 2.0        # ×cores
    BF16_TILE_THRESHOLD = 1.0

    def __init__(self, n_cores: Optional[int] = None, *,
                 fp8_fill_target: Optional[float] = None,
                 demote_below_fill: Optional[float] = None,
                 calibrated: bool = False):
        self.n_cores = n_cores if n_cores is not None else detect_core_count()
        self.fp8_fill_target = self.FP8_TILE_THRESHOLD \
            if fp8_fill_target is None else float(fp8_fill_target)
        self.demote_below_fill = self.BF16_TILE_THRESHOLD \
            if demote_below_fill is None else float(demote_below_fill)
        self.calibrated = calibrated

    def advise(self, w: WorkloadProfile) -> Advice:
        rationale = []
        precision = w.precision
        batch_mult = 1
        src = "measured" if self.calibrated else "paper §9.2"
        fill = w.grid_tiles / self.n_cores
        if w.precision in ("fp8",) and fill < self.fp8_fill_target:
            if fill < self.demote_below_fill:
                precision = "bf16"
                rationale.append(
                    f"grid fill {fill:.2f}× cores < "
                    f"{self.demote_below_fill:g}"
                    f"× ({src}) needed for FP8 to hide HBM latency; bf16 "
                    "is faster at this occupancy ('FP16 at 128 wavefronts "
                    "outperforms underutilized FP8')")
            else:
                batch_mult = int(np.ceil(self.fp8_fill_target / fill))
                rationale.append(
                    f"batch ×{batch_mult} to reach FP8 occupancy threshold "
                    f"({src})")
        max_streams = 4 if w.latency_sensitive else 8
        if w.latency_sensitive and w.concurrent_tenants > 4:
            rationale.append(
                "latency-sensitive with >4 tenants: prefer spatial "
                "isolation over queue concurrency (fairness collapses at 8 "
                "streams: 0.016–0.138 in the paper)")
        use_sparsity = w.concurrent_tenants > 1 or w.latency_sensitive is False
        if w.concurrent_tenants == 1 and w.grid_tiles >= self.n_cores:
            use_sparsity = False
            rationale.append(
                "isolated compute-bound workload: 2:4 sparsity is break-even "
                "(paper §7.1) — disabled")
        else:
            rationale.append(
                "memory-bound/multi-tenant context: 2:4 packed weights cut "
                "HBM weight traffic (paper §7.2's concurrency-dependent "
                "win)")
        return Advice(use_sparsity=use_sparsity, max_streams=max_streams,
                      suggested_precision=precision,
                      batch_multiplier=batch_mult, rationale=rationale)
