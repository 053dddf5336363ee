"""Production traffic simulator: seed-deterministic workloads + traces.

The serving stack grew admission classes, quotas, migration,
overlap, speculative depth, and SLO attainment — but every one of those
mechanisms was exercised by hand-built toy workloads. This module is the
workload plane: a generator that turns a compact :class:`WorkloadSpec`
into a concrete arrival sequence, and a :class:`WorkloadTrace`
record/replay harness so that any generated (or captured) workload is
replayable *bit-for-bit* through ``ServingRuntime.submit``.

Design rules:

* **Millions of users is a rate parameter, not a tenant count.** The
  generator samples an *aggregate* arrival process (requests per
  scheduler step); the user population only ever appears as that rate.
  Tenants are the runtime's logical isolation domains (N small), and
  per-arrival tenant attribution follows a truncated Zipf popularity
  law over tenant ranks — rank 0 is the head tenant, the tail shares
  the remainder, which is how real multi-tenant traffic concentrates.
* **Arrival processes are modulated Poisson.** ``poisson`` is
  homogeneous; ``bursty`` alternates ON/OFF phases (geometric phase
  lengths, rate x burst_factor vs rate / burst_factor); ``diurnal``
  modulates the rate sinusoidally with a fixed period — a compressed
  day. All three draw from one ``numpy`` Generator in a documented
  order, so a (spec, seed) pair always yields the same trace.
* **Traces are self-contained.** Every event stores its prompt tokens
  and output budget inline. Replay never re-samples anything, so a
  saved JSON trace reproduces the exact same submit sequence even if
  the generator's sampling order changes in a future PR.
* **Lengths are mixtures.** Prompt and output lengths draw from a
  short uniform range with an optional long-range mixture component
  (``long_frac``) — the bimodal short-interactive / long-batch shape
  that makes slot-occupancy decisions interesting.

``run_trace`` drives a trace through anything with the scheduler facade
(``add_tenant`` / ``submit`` / ``step``; ``ServingRuntime`` and
``StreamScheduler`` both qualify) in the global lockstep step domain:
arrivals for step s are submitted before step s executes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.serve_loop import Request

ARRIVALS = ("poisson", "bursty", "diurnal")
TRACE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Uniform [lo, hi] length draw with an optional long-range mixture:
    with probability ``long_frac`` the draw comes from
    [long_lo, long_hi] instead — short interactive turns beside long
    batch generations in one stream."""
    lo: int
    hi: int
    long_lo: int = 0
    long_hi: int = 0
    long_frac: float = 0.0

    def __post_init__(self):
        if self.lo < 1 or self.hi < self.lo:
            raise ValueError(f"LengthDist needs 1 <= lo <= hi, got "
                             f"[{self.lo}, {self.hi}]")
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError(f"long_frac must be in [0, 1], got "
                             f"{self.long_frac}")
        if self.long_frac > 0.0 and (self.long_lo < 1
                                     or self.long_hi < self.long_lo):
            raise ValueError(f"LengthDist long range needs 1 <= long_lo "
                             f"<= long_hi, got [{self.long_lo}, "
                             f"{self.long_hi}]")

    def sample(self, rng: np.random.Generator) -> int:
        # Draw order is part of the determinism contract: one uniform
        # for the mixture gate (only when a long component exists), then
        # one integer for the length.
        if self.long_frac > 0.0 and rng.random() < self.long_frac:
            return int(rng.integers(self.long_lo, self.long_hi + 1))
        return int(rng.integers(self.lo, self.hi + 1))

    def to_dict(self) -> Dict[str, Any]:
        d = {"lo": self.lo, "hi": self.hi}
        if self.long_frac > 0.0:
            d.update(long_lo=self.long_lo, long_hi=self.long_hi,
                     long_frac=self.long_frac)
        return d

    @classmethod
    def from_any(cls, v: Union["LengthDist", int, Sequence[int], Dict]
                 ) -> "LengthDist":
        """int → fixed length; (lo, hi) → uniform; dict → kwargs."""
        if isinstance(v, LengthDist):
            return v
        if isinstance(v, int):
            return cls(lo=v, hi=v)
        if isinstance(v, dict):
            return cls(**v)
        if isinstance(v, (tuple, list)) and len(v) == 2:
            return cls(lo=int(v[0]), hi=int(v[1]))
        raise TypeError(f"LengthDist spec {v!r} is not "
                        "LengthDist/int/(lo, hi)/dict")


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Truncated-Zipf popularity over ranks 0..n-1: p(i) ∝ (i+1)^-s.
    s=0 is uniform; s≈1 is classic web-traffic skew."""
    if n < 1:
        raise ValueError("zipf_weights needs n >= 1")
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-float(s))
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Declarative workload: (spec, seed) → one deterministic trace.

    ``rate`` is aggregate mean arrivals per scheduler step — the only
    place the size of the user population appears. ``slos`` /
    ``weights``, when given, are per-tenant-rank (length ``tenants``)
    and ride along into ``run_trace`` registration.
    """
    tenants: int = 4
    zipf_s: float = 1.1              # tenant popularity skew (0: uniform)
    arrival: str = "poisson"
    rate: float = 1.0                # mean arrivals / scheduler step
    burst_factor: float = 4.0        # bursty: ON-phase rate multiplier
    burst_len: int = 8               # bursty: mean phase length (steps)
    period: int = 64                 # diurnal: steps per cycle
    amplitude: float = 0.8           # diurnal: rate swing fraction
    steps: int = 64                  # arrival horizon (scheduler steps)
    prompt_len: Any = (4, 8)         # LengthDist.from_any forms
    max_new: Any = (4, 8)
    # Per-rank max_new overrides (None: the global dist). Interactive
    # tenants answer short while batch tenants generate long — the shape
    # that makes slot occupancy contended.
    max_new_overrides: Tuple[Any, ...] = ()
    vocab: int = 256                 # prompt token id range
    slos: Tuple[Optional[str], ...] = ()    # per-rank SLO spec strings
    weights: Tuple[float, ...] = ()         # per-rank scheduler weights
    seed: int = 0

    def __post_init__(self):
        if self.tenants < 1:
            raise ValueError("WorkloadSpec needs tenants >= 1")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival {self.arrival!r} not in {ARRIVALS}")
        if self.rate <= 0:
            raise ValueError("rate must be positive")
        if self.burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1")
        if self.burst_len < 1:
            raise ValueError("burst_len must be >= 1")
        if self.period < 2:
            raise ValueError("period must be >= 2")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.vocab < 2:
            raise ValueError("vocab must be >= 2")
        object.__setattr__(self, "prompt_len",
                           LengthDist.from_any(self.prompt_len))
        object.__setattr__(self, "max_new",
                           LengthDist.from_any(self.max_new))
        object.__setattr__(
            self, "max_new_overrides",
            tuple(None if v is None else LengthDist.from_any(v)
                  for v in self.max_new_overrides))
        if self.max_new_overrides \
                and len(self.max_new_overrides) != self.tenants:
            raise ValueError(
                f"max_new_overrides has {len(self.max_new_overrides)} "
                f"entries for {self.tenants} tenants")
        object.__setattr__(self, "slos", tuple(self.slos))
        object.__setattr__(self, "weights",
                           tuple(float(w) for w in self.weights))
        if self.slos and len(self.slos) != self.tenants:
            raise ValueError(f"slos has {len(self.slos)} entries for "
                             f"{self.tenants} tenants")
        if self.weights and len(self.weights) != self.tenants:
            raise ValueError(f"weights has {len(self.weights)} entries "
                             f"for {self.tenants} tenants")

    def tenant_ids(self) -> List[str]:
        return [f"tenant{i}" for i in range(self.tenants)]

    def slo_for(self, rank: int) -> Optional[str]:
        return self.slos[rank] if self.slos else None

    def weight_for(self, rank: int) -> float:
        return self.weights[rank] if self.weights else 1.0

    def max_new_for(self, rank: int) -> LengthDist:
        if self.max_new_overrides \
                and self.max_new_overrides[rank] is not None:
            return self.max_new_overrides[rank]
        return self.max_new

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["prompt_len"] = self.prompt_len.to_dict()
        d["max_new"] = self.max_new.to_dict()
        d["max_new_overrides"] = [None if v is None else v.to_dict()
                                  for v in self.max_new_overrides]
        d["slos"] = list(self.slos)
        d["weights"] = list(self.weights)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown WorkloadSpec fields: "
                             f"{sorted(unknown)}")
        d = dict(d)
        if "slos" in d:
            d["slos"] = tuple(d["slos"])
        if "weights" in d:
            d["weights"] = tuple(d["weights"])
        if "max_new_overrides" in d:
            d["max_new_overrides"] = tuple(d["max_new_overrides"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkloadEvent:
    """One arrival, fully materialized: replay needs no generator."""
    step: int
    tenant: str
    uid: int
    prompt: Tuple[int, ...]
    max_new: int

    def to_request(self) -> Request:
        # A FRESH Request per call: the runtime mutates Request in
        # place, so replays must never share instances.
        return Request(uid=self.uid,
                       prompt=np.asarray(self.prompt, dtype=np.int32),
                       max_new=self.max_new)

    def to_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "tenant": self.tenant,
                "uid": self.uid, "prompt": list(self.prompt),
                "max_new": self.max_new}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadEvent":
        return cls(step=int(d["step"]), tenant=str(d["tenant"]),
                   uid=int(d["uid"]),
                   prompt=tuple(int(x) for x in d["prompt"]),
                   max_new=int(d["max_new"]))


@dataclasses.dataclass
class WorkloadTrace:
    """An ordered arrival sequence + the spec that produced it (None
    for captured/hand-built traces). JSON round-trips exactly."""
    events: List[WorkloadEvent]
    spec: Optional[WorkloadSpec] = None

    @property
    def steps(self) -> int:
        """Arrival horizon: the spec's if present, else last event + 1."""
        if self.spec is not None:
            return self.spec.steps
        return max((e.step for e in self.events), default=-1) + 1

    def by_step(self) -> Dict[int, List[WorkloadEvent]]:
        out: Dict[int, List[WorkloadEvent]] = {}
        for e in self.events:
            out.setdefault(e.step, []).append(e)
        return out

    def tenant_ids(self) -> List[str]:
        if self.spec is not None:
            return self.spec.tenant_ids()
        seen: List[str] = []
        for e in self.events:
            if e.tenant not in seen:
                seen.append(e.tenant)
        return seen

    def arrivals_per_tenant(self) -> Dict[str, int]:
        out = {tid: 0 for tid in self.tenant_ids()}
        for e in self.events:
            out[e.tenant] = out.get(e.tenant, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": TRACE_SCHEMA,
                "spec": self.spec.to_dict() if self.spec else None,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadTrace":
        if d.get("schema") != TRACE_SCHEMA:
            raise ValueError(f"trace schema {d.get('schema')!r} != "
                             f"{TRACE_SCHEMA}")
        spec = (WorkloadSpec.from_dict(d["spec"])
                if d.get("spec") is not None else None)
        return cls(events=[WorkloadEvent.from_dict(e)
                           for e in d["events"]], spec=spec)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "WorkloadTrace":
        return cls.from_dict(json.loads(s))

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: Union[str, Path]) -> "WorkloadTrace":
        return cls.from_json(Path(path).read_text())


def _rates(spec: WorkloadSpec, rng: np.random.Generator) -> List[float]:
    """Per-step arrival rates. Bursty phase lengths draw from ``rng``
    FIRST (before any per-arrival sampling) so the modulation sequence
    is deterministic and independent of how many arrivals land."""
    if spec.arrival == "poisson":
        return [spec.rate] * spec.steps
    if spec.arrival == "diurnal":
        return [spec.rate * (1.0 + spec.amplitude
                             * math.sin(2.0 * math.pi * s / spec.period))
                for s in range(spec.steps)]
    # bursty: ON/OFF alternation, geometric phase lengths, mean
    # preserved-ish around rate (ON multiplies, OFF divides).
    rates: List[float] = []
    on = True
    remaining = 0
    while len(rates) < spec.steps:
        if remaining == 0:
            on = not on
            remaining = int(rng.geometric(1.0 / spec.burst_len))
        rates.append(spec.rate * spec.burst_factor if on
                     else spec.rate / spec.burst_factor)
        remaining -= 1
    return rates


def generate(spec: WorkloadSpec) -> "WorkloadTrace":
    """(spec, spec.seed) → deterministic trace. Sampling order per step:
    arrival count, then per arrival: tenant rank, prompt length, output
    length, prompt tokens."""
    rng = np.random.default_rng(spec.seed)
    probs = zipf_weights(spec.tenants, spec.zipf_s)
    tids = spec.tenant_ids()
    rates = _rates(spec, rng)
    events: List[WorkloadEvent] = []
    uid = 0
    for step in range(spec.steps):
        n = int(rng.poisson(rates[step]))
        for _ in range(n):
            rank = int(rng.choice(spec.tenants, p=probs))
            plen = spec.prompt_len.sample(rng)
            mnew = spec.max_new_for(rank).sample(rng)
            prompt = rng.integers(0, spec.vocab, plen)
            events.append(WorkloadEvent(
                step=step, tenant=tids[rank], uid=uid,
                prompt=tuple(int(t) for t in prompt), max_new=mnew))
            uid += 1
    return WorkloadTrace(events=events, spec=spec)


def run_trace(runtime, trace: WorkloadTrace, *, register: bool = True,
              drain: bool = True, max_steps: int = 100_000,
              on_step=None) -> List[Request]:
    """Drive a trace through a scheduler facade (``ServingRuntime`` or
    ``StreamScheduler``) in lockstep: arrivals stamped for step s are
    submitted before step s runs, so ``submit_step`` matches the trace.
    Returns the completed requests (ALL of them when ``drain``)."""
    if register:
        ranks = {tid: i for i, tid in enumerate(trace.tenant_ids())}
        registered = getattr(runtime, "tenant_partition", None)
        if registered is None:                       # StreamScheduler
            registered = runtime.tenants
        spec = trace.spec
        for tid, rank in ranks.items():
            if tid in registered:
                continue
            kw: Dict[str, Any] = {}
            if spec is not None:
                kw["weight"] = spec.weight_for(rank)
                kw["slo"] = spec.slo_for(rank)
            runtime.add_tenant(tid, **kw)
    by_step = trace.by_step()
    done: List[Request] = []
    for step in range(trace.steps):
        for ev in by_step.get(step, ()):
            runtime.submit(ev.tenant, ev.to_request())
        done.extend(runtime.step())
        if on_step is not None:
            on_step(runtime, step)
    if drain:
        # drain()/run() return the FULL completion list (including the
        # requests finished during the arrival phase above).
        if hasattr(runtime, "drain"):
            return runtime.drain(max_steps)
        return runtime.run(max_steps)
    return done


def tokens_by_uid(completed: Sequence[Request]) -> Dict[int, List[int]]:
    """uid → committed tokens, the equality unit for replay/controller
    exactness asserts."""
    return {r.uid: list(r.out) for r in completed}


def token_checksum(completed: Sequence[Request]) -> str:
    """Order-independent digest of every committed token stream — the
    loadgen CLI prints it so CI can compare a generate-run against a
    replay-run without shipping token dumps around."""
    h = hashlib.sha256()
    for r in sorted(completed, key=lambda r: r.uid):
        h.update(f"{r.uid}:{','.join(map(str, r.out))};".encode())
    return h.hexdigest()[:16]
