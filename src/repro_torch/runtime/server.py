"""The serving control plane: one ``ServingRuntime`` behind one spec.

Three overlapping serving entry points accreted over time — the
:class:`~repro_torch.runtime.serve_loop.ServeSession` slot API, the
:class:`~repro_torch.runtime.scheduler.StreamScheduler` tenant loop, and the
:class:`~repro_torch.runtime.partition.PartitionedServer` sub-mesh router. The
paper's core finding is that the right execution decision is *context
dependent* (FP8 above the occupancy knee §5, bounded concurrency §6, 2:4
under memory-bound multi-tenancy §7), and the Infinity-Fabric placement
study plus AsyncSparse (PAPERS.md) both argue the serving layer needs a
control plane that can SPECIALIZE partitions and MOVE tenants — not a
static router with one ambient policy. This module is that control plane:

* :class:`ServingSpec` — a declarative, JSON-serializable description of
  the whole runtime: partitions (each with its own
  :class:`~repro_torch.core.execution.ExecutionPolicy`, admission and quota
  policy), tenant placement, slot geometry, and the live-migration
  policy. One spec, one runtime; the legacy classes are internal
  components behind it.
* :class:`ServingRuntime` — the single facade: ``add_tenant`` /
  ``submit`` / ``step`` / ``drain`` / ``report``. Partitions step in
  LOCKSTEP (one global step domain), so per-request step accounting —
  and therefore fairness/turnaround — stays exact even when a request
  crosses partitions mid-flight.
* **Live tenant migration** — the ``load_aware`` re-route path: when a
  partition's decode-EMA-weighted outstanding work diverges past
  ``MigrationSpec.threshold`` × the least-loaded partition, one tenant is
  drained (frozen on the source: in-flight requests keep decoding, no
  new admissions) and moved: queued requests transfer immediately,
  in-flight requests hand their per-slot KV/SSM cache state to the
  target partition as slots free up
  (:meth:`~repro_torch.runtime.serve_loop.ServeSession.export_slot` /
  ``import_slot``). Greedy decode is bit-exact across the move; the
  per-partition tracers record ``migrate`` events (start / handoff /
  done) so the fused accounting keeps full provenance.

Live handoff requires the two partitions to run *execution-compatible*
policies (same resolved policy spec): a request's arithmetic cannot
change mid-stream. Queued (not yet admitted) requests may migrate across
heterogeneous policies freely — they simply execute under the target's
policy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import concurrency as cc
from repro_torch.core import execution as ex
from repro_torch.core.speculative import SpecDecodeSpec
from repro_torch.runtime import telemetry
from repro_torch.runtime.controller import ControllerSpec, SLOController
from repro_torch.runtime.scheduler import (
    ADMISSION_POLICIES, QuotaPolicy, SLO, SchedulerReport, StreamScheduler,
    Tenant, TenantReport, build_tenant_report, request_cost)
from repro_torch.runtime.serve_loop import (
    Request, ServeSession, _to_device, export_nbytes)

PLACEMENTS = ("packed", "spread", "load_aware")


# ---------------------------------------------------------------------------
# Device partitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DevicePartition:
    """One spatial partition: a disjoint device subset (possibly shared
    with other partitions only in the single-device logical fallback)."""
    index: int
    devices: tuple = ()
    logical: bool = False            # True: single-device fallback

    @property
    def label(self) -> str:
        kind = "logical" if self.logical else "devices"
        return f"partition{self.index}({kind}:{len(self.devices)})"


def runtime_devices(device: torch.device) -> Tuple[torch.device, ...]:
    """The devices a runtime on ``device`` may place partitions on: every
    visible CUDA device for a bare ``cuda``, else ``device`` alone."""
    if device.type == "cuda" and device.index is None:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (device,)


def make_partitions(n: int, devices: Optional[Sequence] = None
                    ) -> List[DevicePartition]:
    """Split ``devices`` (torch devices; default every visible CUDA
    device) into ``n`` disjoint partitions.

    With at least ``n`` devices each partition gets ``len(devices)//n`` of
    them (remainder devices go to the leading partitions, mirroring
    ``run_spatial``'s subset semantics). With fewer — one H100, or the CPU
    — every partition is *logical*: it references the same device set and
    shares the card (and the parameters), but the serving state (session,
    lane, scheduler, tracer) is fully per-partition. Nothing here picks
    the CPU: a runtime asks for it with ``device="cpu"``."""
    if n <= 0:
        raise ValueError("need at least one partition")
    if devices is None:
        devices = runtime_devices(torch.device("cuda")) \
            if torch.cuda.is_available() else ()
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) < n:
        return [DevicePartition(index=i, devices=devices, logical=True)
                for i in range(n)]
    per, extra = divmod(len(devices), n)
    parts, at = [], 0
    for i in range(n):
        take = per + (1 if i < extra else 0)
        parts.append(DevicePartition(index=i,
                                     devices=devices[at:at + take]))
        at += take
    return parts


# ---------------------------------------------------------------------------
# The declarative spec
# ---------------------------------------------------------------------------

def _policy_str(policy) -> Optional[str]:
    if policy is None or isinstance(policy, str):
        return policy
    if isinstance(policy, ex.ExecutionPolicy):
        return policy.full_spec()
    raise TypeError(f"policy {policy!r} is not None/str/ExecutionPolicy")


def _spec_dict(speculative) -> Optional[Dict[str, Any]]:
    spec = SpecDecodeSpec.from_any(speculative)
    return spec.to_dict() if spec is not None else None


def _controller_dict(controller) -> Optional[Dict[str, Any]]:
    spec = ControllerSpec.from_any(controller)
    return spec.to_dict() if spec is not None else None


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """One partition's declarative config. ``policy`` is an execution-
    policy spec string (``"fp8:sparse24:torch"``), ``"auto"`` (resolve via
    the occupancy advisor at session setup), an
    :class:`~repro_torch.core.execution.ExecutionPolicy` instance
    (programmatic use), or ``None`` — inherit the runtime-wide default.
    ``batch_slots`` overrides the spec-wide slot count for this
    partition."""
    policy: Any = None
    admission: str = "fair_quantum"
    quota: Optional[str] = None      # None | "static" | "adaptive"
    batch_slots: Optional[int] = None
    # Paged-cache overrides (None = inherit the spec-wide setting). NOTE:
    # migration can only hand slots between partitions with the SAME cache
    # layout (paged-ness and page_size).
    paged: Optional[bool] = None
    page_size: Optional[int] = None
    pages: Optional[int] = None
    # Speculative decoding override (core/speculative.SpecDecodeSpec as an
    # int k / dict / instance; None = inherit the spec-wide setting).
    # Deliberately EXCLUDED from policy_key(): the committed cache is
    # bit-identical with or without speculation, so live migration between
    # partitions with different speculative settings stays legal — there
    # is no draft state to carry, the target simply re-drafts.
    speculative: Any = None

    def __post_init__(self):
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission {self.admission!r} not in "
                             f"{ADMISSION_POLICIES}")
        if self.quota not in (None, "static", "adaptive"):
            raise ValueError(f"quota {self.quota!r} not in "
                             "(None, 'static', 'adaptive')")
        if self.batch_slots is not None and self.batch_slots <= 0:
            raise ValueError("batch_slots must be positive")
        if self.page_size is not None and self.page_size <= 0:
            raise ValueError("page_size must be positive")
        if self.pages is not None and self.pages <= 0:
            raise ValueError("pages must be positive")
        SpecDecodeSpec.from_any(self.speculative)   # validate now

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["policy"] = _policy_str(self.policy)
        d["speculative"] = _spec_dict(self.speculative)
        return d


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """The live-migration policy (the ``load_aware`` re-route path).

    Every ``interval`` steps (and at least ``cooldown`` steps after the
    previous migration) the runtime compares per-partition loads — the
    decode-EMA-weighted outstanding work — and when the busiest exceeds
    ``threshold`` × the least-loaded, one tenant is migrated. At most
    ``max_migrations`` over the runtime's lifetime (an oscillation
    backstop)."""
    enabled: bool = False
    interval: int = 8
    threshold: float = 2.0
    cooldown: int = 16
    max_migrations: int = 8

    def __post_init__(self):
        if self.interval <= 0 or self.cooldown < 0:
            raise ValueError("interval must be positive, cooldown >= 0")
        if self.threshold <= 1.0:
            raise ValueError("threshold must exceed 1.0 (a ratio)")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """A declaratively pre-registered tenant (optional — tenants can also
    be added at runtime via :meth:`ServingRuntime.add_tenant`).

    ``slo`` is an optional service-level objective — an
    :class:`~repro_torch.runtime.scheduler.SLO`, a spec string
    (``"latency:8"``, ``"latency:0.05@wall_s"``, ``"throughput:2.5"``,
    ``"batch:0.9"``), or a dict — whose attainment ratio the reports and
    the metrics plane surface per tenant."""
    id: str
    weight: float = 1.0
    partition: Optional[int] = None  # None: router-placed
    slo: Any = None                  # None | str | dict | SLO

    def __post_init__(self):
        object.__setattr__(self, "slo", SLO.parse(self.slo))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["slo"] = self.slo.spec() if self.slo is not None else None
        return d


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """The whole serving runtime, declaratively. JSON-serializable
    (``launch/serve.py --spec``); the legacy flag cluster builds one of
    these."""
    partitions: Tuple[PartitionSpec, ...] = (PartitionSpec(),)
    placement: str = "load_aware"
    batch_slots: int = 4
    max_len: int = 128
    temperature: float = 0.0
    seed: int = 0
    policy: Any = None               # runtime-wide default partition policy
    migration: MigrationSpec = dataclasses.field(
        default_factory=MigrationSpec)
    tenants: Tuple[TenantSpec, ...] = ()
    # Paged serving cache (core/paging.py): per-slot page tables over a
    # shared pool instead of dense (slots × max_len) buffers. ``pages``
    # None sizes the pool to dense-equivalent capacity.
    paged: bool = False
    page_size: int = 16
    pages: Optional[int] = None
    # Speculative multi-token decoding (core/speculative.SpecDecodeSpec as
    # an int k / dict / instance; None = off). Greedy-only — a spec with
    # temperature > 0 and speculation refuses at construction. Partitions
    # override via PartitionSpec.speculative.
    speculative: Any = None
    # Lane overlap: when True (and >1 partition), the runtime co-dispatches
    # partitions the OverlapPlanner pairs from measured decode latencies
    # instead of stepping them through a serial Python loop. Token streams
    # are identical either way; only wall-clock overlap changes. Partitions
    # whose policy says ``no_overlap`` stay serial individually.
    overlap: bool = True
    # Metrics plane (runtime/metrics.py): when True the runtime builds a
    # MetricsRegistry and attaches a MetricsSink to every partition
    # tracer; the registry is reachable as ``runtime.metrics`` and every
    # ``report()`` folds SLO attainment / fairness / occupancy gauges in.
    metrics: bool = False
    # SLO closed loop (runtime/controller.ControllerSpec as None / bool /
    # dict / instance). When set, the runtime runs an SLOController every
    # ``interval`` global steps that freezes batch-class tenants and
    # boosts slot caps while a latency-class tenant misses its SLO.
    # None (the default) is byte-identical to the pre-controller runtime.
    controller: Any = None

    def __post_init__(self):
        if not self.partitions:
            raise ValueError("spec needs at least one partition")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")
        if self.batch_slots <= 0 or self.max_len <= 1:
            raise ValueError("batch_slots must be positive, max_len > 1")
        if self.page_size <= 0:
            raise ValueError("page_size must be positive")
        if self.pages is not None and self.pages <= 0:
            raise ValueError("pages must be positive")
        for p in (self,) + self.partitions:
            on = self.paged if p is self or p.paged is None else p.paged
            ps = p.page_size if p.page_size is not None else self.page_size
            if on and self.max_len % ps:
                raise ValueError(f"max_len={self.max_len} must be a "
                                 f"multiple of page_size={ps}")
            sv = self.speculative if p is self or p.speculative is None \
                else p.speculative
            if SpecDecodeSpec.from_any(sv) is not None \
                    and self.temperature > 0:
                raise ValueError(
                    "speculative decoding is greedy-only: a spec with "
                    f"temperature={self.temperature} cannot enable "
                    "speculation (drop the speculative field or set "
                    "temperature=0)")
        ControllerSpec.from_any(self.controller)   # validate now
        ids = [t.id for t in self.tenants]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate tenant ids in spec")
        for t in self.tenants:
            if t.partition is not None \
                    and not 0 <= t.partition < len(self.partitions):
                raise ValueError(f"tenant {t.id!r} pinned to partition "
                                 f"{t.partition} of {len(self.partitions)}")

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "partitions": [p.to_dict() for p in self.partitions],
            "placement": self.placement,
            "batch_slots": self.batch_slots,
            "max_len": self.max_len,
            "temperature": self.temperature,
            "seed": self.seed,
            "policy": _policy_str(self.policy),
            "migration": self.migration.to_dict(),
            "tenants": [t.to_dict() for t in self.tenants],
            "paged": self.paged,
            "page_size": self.page_size,
            "pages": self.pages,
            "speculative": _spec_dict(self.speculative),
            "overlap": self.overlap,
            "metrics": self.metrics,
            "controller": _controller_dict(self.controller),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingSpec":
        d = dict(d)
        parts = d.get("partitions", 1)
        if isinstance(parts, int):           # shorthand: N default partitions
            parts = [{} for _ in range(parts)]
        d["partitions"] = tuple(
            p if isinstance(p, PartitionSpec) else PartitionSpec(**p)
            for p in parts)
        mig = d.get("migration", MigrationSpec())
        if isinstance(mig, dict):
            mig = MigrationSpec(**mig)
        d["migration"] = mig
        d["tenants"] = tuple(
            t if isinstance(t, TenantSpec) else TenantSpec(**t)
            for t in d.get("tenants", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServingSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ServingSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ServingSpec":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MigrationRecord:
    """One tenant move, start to drain completion."""
    tenant: str
    src: int
    dst: int
    start_step: int
    reason: str = "manual"
    queued_moved: int = 0
    slots_handed_off: int = 0
    done_step: int = -1              # -1: still draining

    @property
    def done(self) -> bool:
        return self.done_step >= 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PartitionedReport:
    """One fused view over all partitions.

    ``fairness``/``cv`` are the paper indices over *every* tenant with
    demand — a tenant that submitted requests but never completed any
    (starved) contributes its elapsed wait as a turnaround lower bound
    instead of silently vanishing from the denominator, and a registered
    tenant that never submitted still appears in ``tenants`` (zeros).
    ``steps`` is the runtime's global lockstep step count, ``tokens_out``
    the sum over partitions."""
    placement: str
    admission: str
    quota: str
    n_partitions: int
    n_tenants: int
    steps: int
    wall_s: float
    tokens_out: int
    fairness: float
    cv: float
    tenant_partition: Dict[str, int]
    partitions: List[SchedulerReport]
    tenants: List[TenantReport] = dataclasses.field(default_factory=list)
    migrations: int = 0
    policies: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        lines = [
            f"[partitioned] {self.n_partitions} partitions "
            f"({self.placement}), {self.admission}/{self.quota}: "
            f"{self.n_tenants} tenants, {self.steps} steps, "
            f"{self.tokens_out} tokens in {self.wall_s:.2f}s | "
            f"fairness={self.fairness:.3f} cv={self.cv:.3f}"]
        if self.migrations:
            lines.append(f"  migrations: {self.migrations}")
        if any(self.policies):
            lines.append("  policies: " + " ".join(
                f"p{i}:{p or 'ambient'}"
                for i, p in enumerate(self.policies)))
        for t in self.tenants:
            extra = f" (migrated x{t.migrations})" if t.migrations else ""
            if t.slo:
                att = "n/a" if t.slo_attainment is None \
                    else f"{t.slo_attainment:.2f}"
                extra += f" slo[{t.slo}]={att}"
            lines.append(
                f"  {t.tenant_id}@p{t.partition}: {t.completed}/"
                f"{t.submitted} done, {t.tokens_out} tok, "
                f"turnaround={t.mean_turnaround_steps:.1f} steps{extra}")
        for rep in self.partitions:
            for line in rep.summary().splitlines():
                lines.append("  " + line)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class ServingRuntime:
    """Every partition, one facade, one step domain.

    One :class:`ServeSession` + :class:`StreamScheduler` + partition-
    tagged :class:`~repro_torch.runtime.telemetry.Tracer` per partition, all
    built from one :class:`ServingSpec`. Partitions step in lockstep —
    ``step()`` advances every scheduler exactly once — so request step
    accounting lives in a single global domain and stays exact across
    live migrations.

    Every partition's session is built from the same params/config/seed,
    so under greedy decoding a tenant's token stream is independent of
    *which* partition serves it and of who shares the node — including
    across a live migration between execution-compatible partitions
    (tested token-for-token).

    ``policy=`` / ``quota=`` are legacy programmatic overrides (uniform
    policy object, quota instance or per-partition sequence) used by the
    deprecated facades; new callers put policies in the spec.

    ``device`` is where the runtime serves: ``cuda`` unless the caller
    names one (``device="cpu"`` on a machine without a card). Each
    partition runs its decode on a lane (CUDA stream) of its own.
    ``packed_params`` are the sparse24 partitions' weights already pruned
    and packed (``execution.pack_model_params`` of ``params``), for a
    caller that holds them; else they are packed here, once."""

    def __init__(self, params, cfg, spec: Union[None, ServingSpec, Dict]
                 = None, *, rt=None, policy=None,
                 quota: Union[None, str, QuotaPolicy, Sequence] = None,
                 partitions: Optional[Sequence[DevicePartition]] = None,
                 tracer_capacity: int = 4096, session_kw=None, device=None,
                 packed_params=None):
        if spec is None:
            spec = ServingSpec()
        elif isinstance(spec, dict):
            spec = ServingSpec.from_dict(spec)
        self.spec = spec
        self.cfg = cfg
        self.placement = spec.placement
        self.batch_slots = spec.batch_slots
        self.device = cc.resolve_device(device)
        self.partitions = list(partitions) if partitions is not None \
            else make_partitions(spec.n_partitions,
                                 runtime_devices(self.device))
        if len(self.partitions) != spec.n_partitions:
            raise ValueError(
                f"{len(self.partitions)} device partitions for "
                f"{spec.n_partitions} partition specs")
        self._validate_quota_override(quota)

        resolved = [self._resolve_policy(ps.policy, policy or spec.policy)
                    for ps in spec.partitions]
        # prune+pack the shared weights ONCE for every sparse24 partition;
        # each session's own pack pass then finds only PackedWeight leaves
        # (no-op walk) instead of re-packing the full model per partition
        params = _to_device(params, self.device)
        if packed_params is None and any(
                isinstance(p, ex.ExecutionPolicy) and p.sparsity == "sparse24"
                for p in resolved):
            packed_params = ex.pack_model_params(params)

        self.tracers: List[telemetry.Tracer] = []
        self.sessions: List[ServeSession] = []
        self.schedulers: List[StreamScheduler] = []
        self.tenant_partition: Dict[str, int] = {}
        self._tenant_order: List[str] = []
        self.step_count = 0
        self.migrations: List[MigrationRecord] = []
        self._draining: Dict[str, MigrationRecord] = {}
        self._migrated_counts: Dict[str, int] = {}
        self._last_migration_step = -(10 ** 9)

        kw = dict(session_kw or {})
        if rt is not None:
            kw["rt"] = rt
        for i, (part, pspec) in enumerate(zip(self.partitions,
                                              spec.partitions)):
            pol = resolved[i]
            use_params = packed_params if (
                isinstance(pol, ex.ExecutionPolicy)
                and pol.sparsity == "sparse24") else params
            tr = telemetry.Tracer(capacity=tracer_capacity,
                                  partition=part.index)
            p_paged = spec.paged if pspec.paged is None else pspec.paged
            p_psize = pspec.page_size if pspec.page_size is not None \
                else spec.page_size
            p_pages = pspec.pages if pspec.pages is not None else spec.pages
            p_spec = spec.speculative if pspec.speculative is None \
                else pspec.speculative
            sess = ServeSession(
                self._place_params(use_params, part), cfg,
                device=self._partition_device(part),
                batch_slots=pspec.batch_slots or spec.batch_slots,
                max_len=spec.max_len, temperature=spec.temperature,
                seed=spec.seed, policy=pol, telemetry=tr,
                paged=p_paged, page_size=p_psize, pages=p_pages,
                speculative=p_spec, **kw)
            sched = StreamScheduler(
                sess, admission=pspec.admission, tracer=tr,
                quota=self._quota_for(quota, pspec, i))
            self.tracers.append(tr)
            self.sessions.append(sess)
            self.schedulers.append(sched)
        # one dispatch lane per partition — the ACE-queue analogue the
        # overlap step routes through — plus the planner that pairs them
        # from measured decode EMAs (core/execution.OverlapPlanner)
        self.lanes = [cc.ExecutionLane(f"lane{i}", index=i,
                                       device=sess.device)
                      for i, sess in enumerate(self.sessions)]
        self.planner = ex.OverlapPlanner()
        self._next_overlap_group = 0
        # Metrics plane: one registry + one sink over every partition
        # tracer (events carry partition tags, so one sink suffices).
        self.metrics = None
        self.metrics_sink = None
        if spec.metrics:
            from repro_torch.runtime.metrics import MetricsRegistry, MetricsSink
            self.metrics = MetricsRegistry()
            self.metrics_sink = MetricsSink(self.metrics).attach(
                *self.tracers)
        # SLO closed loop (runtime/controller.py): acts on attainment
        # every ``interval`` steps. None → byte-identical legacy behavior.
        cspec = ControllerSpec.from_any(spec.controller)
        self.controller = (SLOController(cspec)
                           if cspec is not None and cspec.enabled else None)
        for tspec in spec.tenants:
            self.add_tenant(tspec.id, weight=tspec.weight,
                            partition=tspec.partition, slo=tspec.slo)

    # -- construction helpers -----------------------------------------------
    @staticmethod
    def _resolve_policy(policy, default):
        pol = policy if policy is not None else default
        if pol is None or pol == "auto" \
                or isinstance(pol, ex.ExecutionPolicy):
            return pol
        if isinstance(pol, str):
            return ex.parse_policy(pol)
        raise TypeError(f"policy {pol!r} is not None/'auto'/spec-string/"
                        "ExecutionPolicy")

    def _validate_quota_override(self, quota) -> None:
        n = len(self.partitions)
        if isinstance(quota, (list, tuple)):
            if len(quota) != n:
                raise ValueError(f"quota sequence has {len(quota)} entries "
                                 f"for {n} partitions")
            # string/None specs are instantiated fresh per partition and
            # may repeat; only *instances* carry per-scheduler state
            insts = [q for q in quota if isinstance(q, QuotaPolicy)]
            if len(set(map(id, insts))) != len(insts):
                raise ValueError(
                    "the quota sequence repeats a QuotaPolicy instance "
                    "across partitions; online policies keep per-scheduler "
                    "state — pass one instance per partition")
        elif isinstance(quota, QuotaPolicy) and n > 1:
            raise ValueError(
                "a single QuotaPolicy instance cannot be shared across "
                "partitions (it keeps per-scheduler state); pass a string "
                "spec or one instance per partition")

    @staticmethod
    def _quota_for(quota, pspec: PartitionSpec, index: int):
        """Per-partition quota: the legacy override wins (sequence
        indexed, uniform spec repeated), else the partition spec's."""
        if isinstance(quota, (list, tuple)):
            return quota[index]
        if quota is not None:
            return quota
        return pspec.quota

    def _partition_device(self, part: DevicePartition) -> torch.device:
        if part.logical or not part.devices:
            return self.device
        return part.devices[0]

    def _place_params(self, params, part: DevicePartition):
        """Pin the model replica to the partition's lead device. Logical
        partitions (fewer devices than partitions) share the runtime's
        params — duplicating them would only waste the one device's
        memory."""
        return _to_device(params, self._partition_device(part))

    def policy_key(self, i: int) -> str:
        """The partition's *resolved* execution-policy identity — live
        handoff is allowed only between partitions with equal keys."""
        pol = self.sessions[i].policy
        return pol.full_spec() if isinstance(pol, ex.ExecutionPolicy) else ""

    # -- routing ------------------------------------------------------------
    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def _load(self, i: int) -> float:
        """Observed load of partition ``i``: registered tenant weight plus
        the tracer's measured decode signal (mean decode wall × outstanding
        work). Zero-traffic partitions score by weight alone. (Placement-
        time signal; the migration loop uses :meth:`_partition_work`.)"""
        sched = self.schedulers[i]
        weight = sum(t.weight for t in sched.tenants.values())
        backlog = sched.pending() + sched.session.n_active
        return weight + self.tracers[i].mean_wall("decode") * backlog

    def _route(self, weight: float) -> int:
        if self.placement == "packed":
            # first partition whose registered tenancy has not yet filled
            # its slot budget; once every budget is full, overflow goes to
            # the least-populated partition (ties to the lowest index)
            for i, sched in enumerate(self.schedulers):
                if len(sched.tenants) < self.sessions[i].batch_slots:
                    return i
            return min(range(self.n_partitions),
                       key=lambda i: (len(self.schedulers[i].tenants), i))
        if self.placement == "spread":
            return min(range(self.n_partitions),
                       key=lambda i: (sum(t.weight for t in
                                          self.schedulers[i]
                                          .tenants.values()), i))
        # load_aware: least measured load, ties by index
        return min(range(self.n_partitions),
                   key=lambda i: (self._load(i), i))

    def add_tenant(self, tenant_id: str, *, weight: float = 1.0,
                   policy=None, partition: Optional[int] = None,
                   slo=None) -> int:
        """Register a tenant on a partition (router-chosen unless
        ``partition`` pins one). Unlike a static router, registration is
        no longer forever: the migration loop may re-route the tenant
        later. ``slo`` is an optional SLO class (spec string / dict /
        :class:`~repro_torch.runtime.scheduler.SLO`). Returns the partition
        index."""
        if tenant_id in self.tenant_partition:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        idx = self._route(weight) if partition is None else partition
        self.schedulers[idx].add_tenant(tenant_id, weight=weight,
                                        policy=policy, slo=slo)
        self.tenant_partition[tenant_id] = idx
        self._tenant_order.append(tenant_id)
        self.tracers[idx].record("route", tenant=tenant_id,
                                 meta={"weight": weight,
                                       "placement": self.placement})
        return idx

    # -- the facade ----------------------------------------------------------
    def submit(self, tenant_id: str, req: Request) -> None:
        """Queue a request on the tenant's CURRENT partition (follows the
        tenant across migrations)."""
        self.schedulers[self.tenant_partition[tenant_id]].submit(
            tenant_id, req)

    def pending(self) -> int:
        return sum(s.pending() for s in self.schedulers)

    @property
    def n_active(self) -> int:
        return sum(s.session.n_active for s in self.schedulers)

    def step(self) -> List[Request]:
        """One lockstep round: EVERY partition advances one scheduler
        step (idle partitions tick too — one global step domain is what
        keeps turnaround accounting exact across migrations), then the
        migration loop hands off draining tenants and re-checks partition
        loads. Returns all requests completed this round.

        With ``spec.overlap`` (and >1 partition) the round goes through
        :meth:`_step_lanes`: planner-paired partitions dispatch through
        their lanes before any join, so heterogeneous partitions genuinely
        execute concurrently. Per-partition state transitions are
        identical either way — only wall-clock overlap differs."""
        if self.spec.overlap and self.n_partitions > 1:
            done = self._step_lanes()
        else:
            done = []
            for sched in self.schedulers:
                done.extend(sched.step())
        self.step_count += 1
        self._advance_migrations()
        if self.spec.migration.enabled:
            self._maybe_migrate()
        if self.controller is not None:
            self.controller.on_step(self)
        return done

    def _overlap_candidates(self) -> List[ex.OverlapCandidate]:
        """One candidate per partition: its policy's sparsity and overlap
        gate, plus the measured decode-latency EMA for its dominant decode
        shape (the key ``join_decode`` records under). A partition without
        a measurement stays serial this round — measure first, overlap
        second."""
        cands = []
        for i, sess in enumerate(self.sessions):
            pol = sess.policy if isinstance(sess.policy, ex.ExecutionPolicy) \
                else None
            shape = (sess.batch_slots, sess.cfg.d_model, sess.cfg.d_ff,
                     sess.cfg.precision)
            cands.append(self.planner.candidate(
                i, sparsity=pol.sparsity if pol is not None else "dense",
                shape=shape, tracer=self.tracers[i],
                allowed=pol.overlap if pol is not None else True))
        return cands

    def _step_lanes(self) -> List[Request]:
        """One planner-scheduled round: every paired partition dispatches
        through its lane before *any* of them joins — the widest overlap
        window the plan allows, so one partition's host work (admission,
        prefill dispatch, token accounting) hides under another's in-flight
        decode. Serial partitions then step synchronously. Each group's
        pairing decision is recorded as an ``overlap`` event on every
        member's tracer so the choice is attributable after the fact."""
        plan = self.planner.plan(self._overlap_candidates())
        done: List[Request] = []
        tickets = []
        for group in plan.groups:
            gid = self._next_overlap_group
            self._next_overlap_group += 1
            for i in group:
                tickets.append((i, group, gid, self.schedulers[i]
                                .dispatch_step(self.lanes[i],
                                               overlap_group=gid)))
        for i, group, gid, ticket in tickets:
            done.extend(self.schedulers[i].join_step(ticket))
            self.tracers[i].record(
                "overlap", lane=self.lanes[i].name, overlap_group=gid,
                step=self.step_count,
                meta={"group": [int(g) for g in group]})
        for i in plan.serial:
            done.extend(self.schedulers[i].step())
        return done

    def drain(self, max_steps: int = 100_000) -> List[Request]:
        """Run until every queue is empty, every slot is free, and every
        migration has completed (or ``max_steps``). Returns every
        completed request."""
        steps = 0
        while (self.pending() or self.n_active or self._draining) \
                and steps < max_steps:
            self.step()
            steps += 1
        return [r for sched in self.schedulers
                for t in sched.tenants.values() for r in t.completed]

    # -- live migration -------------------------------------------------------
    def _partition_work(self, i: int) -> float:
        """Deterministic outstanding work on partition ``i`` in token
        positions: queued request costs plus the remaining decode budget
        of every active slot."""
        w = float(sum(request_cost(r) for t in
                      self.schedulers[i].tenants.values() for r in t.queue))
        for r in self.sessions[i].slots:
            if r is not None:
                w += max(0, r.max_new - len(r.out))
        return w

    def _tenant_work(self, i: int, tenant_id: str) -> float:
        t = self.schedulers[i].tenants[tenant_id]
        w = float(sum(request_cost(r) for r in t.queue))
        for r in self.sessions[i].slots:
            if r is not None and r.tenant == tenant_id:
                w += max(0, r.max_new - len(r.out))
        return w

    def _loads(self) -> List[float]:
        """Per-partition migration signal: outstanding work weighted by
        the measured decode-wall EMA. The EMA factor applies only once
        every partition has a measurement (comparisons must stay in one
        domain); until then the signal is pure step-domain work — which
        also keeps the re-route decision deterministic in tests."""
        works = [self._partition_work(i) for i in range(self.n_partitions)]
        emas = [self.tracers[i].mean_wall("decode")
                for i in range(self.n_partitions)]
        if all(e > 0 for e in emas):
            return [w * e for w, e in zip(works, emas)]
        return works

    def _maybe_migrate(self) -> None:
        mig = self.spec.migration
        if self._draining or self.n_partitions < 2:
            return
        if len(self.migrations) >= mig.max_migrations:
            return
        if self.step_count % mig.interval:
            return
        if self.step_count - self._last_migration_step < mig.cooldown:
            return
        loads = self._loads()
        src = max(range(self.n_partitions), key=lambda i: (loads[i], -i))
        if loads[src] <= 0:
            return
        works = [self._partition_work(i) for i in range(self.n_partitions)]
        for dst in sorted(range(self.n_partitions),
                          key=lambda i: (loads[i], i)):
            if dst == src:
                continue
            if loads[src] < mig.threshold * max(loads[dst], 1e-9):
                break                 # ascending: no further dst can pass
            victim = self._pick_victim(src, dst, works)
            if victim is not None:
                self.migrate(victim, dst, reason="load_aware")
                return

    def _pick_victim(self, src: int, dst: int,
                     works: List[float]) -> Optional[str]:
        """The tenant whose move best equalizes the two partitions'
        outstanding work — and strictly improves it (no oscillation).
        Tenants with in-flight requests are eligible only when the two
        partitions run execution-compatible policies."""
        compat = self.policy_key(src) == self.policy_key(dst)
        cur = abs(works[src] - works[dst])
        best, best_score = None, None
        for tid in self.schedulers[src]._order:
            t = self.schedulers[src].tenants[tid]
            if t.frozen or tid in self._draining:
                continue
            if t.active and not compat:
                continue
            w = self._tenant_work(src, tid)
            if w <= 0:
                continue
            score = abs((works[src] - w) - (works[dst] + w))
            if score >= cur:
                continue
            if best_score is None or score < best_score:
                best, best_score = tid, score
        return best

    def migrate(self, tenant_id: str, dst: Optional[int] = None, *,
                reason: str = "manual") -> MigrationRecord:
        """Start a live migration of ``tenant_id`` to partition ``dst``
        (default: the least-loaded other partition).

        The tenant is frozen on its source partition (no new admissions),
        its queued requests transfer immediately, new submissions route to
        the target at once, and each in-flight request hands its per-slot
        cache state over as the target frees a slot — or simply finishes
        on the source if that happens first. The returned record's
        ``done_step`` is set once the source is fully drained and the
        tenant's accounting has been folded onto the target."""
        if tenant_id in self._draining:
            raise ValueError(f"tenant {tenant_id!r} is already migrating")
        src = self.tenant_partition[tenant_id]
        if dst is None:
            loads = self._loads()
            dst = min((i for i in range(self.n_partitions) if i != src),
                      key=lambda i: (loads[i], i))
        if dst == src:
            raise ValueError(f"tenant {tenant_id!r} is already on "
                             f"partition {dst}")
        if not 0 <= dst < self.n_partitions:
            raise ValueError(f"no partition {dst}")
        src_sched, dst_sched = self.schedulers[src], self.schedulers[dst]
        src_t = src_sched.tenants[tenant_id]
        if tenant_id in dst_sched.tenants:
            raise ValueError(f"tenant {tenant_id!r} already has state on "
                             f"partition {dst}")
        if src_t.active and self.policy_key(src) != self.policy_key(dst):
            raise ValueError(
                f"tenant {tenant_id!r} has {src_t.active} in-flight "
                f"request(s) and partitions {src}->{dst} run different "
                f"execution policies ({self.policy_key(src) or 'ambient'} "
                f"vs {self.policy_key(dst) or 'ambient'}); a request's "
                "arithmetic cannot change mid-stream — drain it first or "
                "pick a policy-compatible target")

        src_sched.freeze(tenant_id)
        dst_t = dst_sched.add_tenant(tenant_id, weight=src_t.weight,
                                     policy=src_t.policy, slo=src_t.slo)
        # fair_quantum join rule: resume at no less than the target's
        # current virtual-time floor so the newcomer cannot monopolize
        # admissions, but keep its own served-work history
        others = [t.vtime for t in dst_sched.tenants.values()
                  if t.tenant_id != tenant_id]
        dst_t.vtime = max(src_t.vtime, min(others, default=0.0))

        moved = list(src_t.queue)
        src_t.queue.clear()
        dst_t.queue.extend(moved)
        dst_t.submitted += len(moved)
        src_t.submitted -= len(moved)
        if moved:
            first = min(r.submit_step for r in moved)
            dst_t.first_submit_step = first if dst_t.first_submit_step < 0 \
                else min(dst_t.first_submit_step, first)
        self.tenant_partition[tenant_id] = dst

        rec = MigrationRecord(tenant=tenant_id, src=src, dst=dst,
                              start_step=self.step_count, reason=reason,
                              queued_moved=len(moved))
        self.migrations.append(rec)
        self._draining[tenant_id] = rec
        self._last_migration_step = self.step_count
        for tr in (self.tracers[src], self.tracers[dst]):
            tr.record_migrate(tenant_id, src=src, dst=dst, phase="start",
                              step=self.step_count, reason=reason,
                              queued=len(moved))
        self._advance_migration(rec)     # hand off what fits right now
        return rec

    def _advance_migrations(self) -> None:
        for rec in list(self._draining.values()):
            self._advance_migration(rec)

    def _advance_migration(self, rec: MigrationRecord) -> None:
        tid, src, dst = rec.tenant, rec.src, rec.dst
        src_sched, dst_sched = self.schedulers[src], self.schedulers[dst]
        src_sess, dst_sess = self.sessions[src], self.sessions[dst]
        src_t, dst_t = src_sched.tenants[tid], dst_sched.tenants[tid]
        for slot, req in enumerate(src_sess.slots):
            if req is None or req.tenant != tid:
                continue
            # admission-by-headroom: on paged targets this checks free
            # PAGES for the slot's pages-in-use, not just a free slot
            if not dst_sess.can_accept_pages(src_sess.handoff_pages(slot),
                                             src_sess.page_size):
                break                 # keep decoding on src; retry next step
            export = src_sess.export_slot(slot)
            dst_slot = dst_sess.import_slot(export)
            src_t.active -= 1
            dst_t.active += 1
            rec.slots_handed_off += 1
            for tr in (self.tracers[src], self.tracers[dst]):
                tr.record_migrate(tid, src=src, dst=dst, phase="handoff",
                                  step=self.step_count, uid=req.uid,
                                  src_slot=slot, dst_slot=dst_slot,
                                  pos=export.pos, pages=export.pages,
                                  handoff_bytes=export_nbytes(export))
        if src_t.queue or src_t.active:
            return
        # source fully drained: fold the tenant's history onto the target
        # (chronologically: source completions happened first) and detach
        dst_t.completed[:0] = src_t.completed
        dst_t.tokens_out += src_t.tokens_out
        dst_t.submitted += src_t.submitted
        dst_t.service_steps += src_t.service_steps
        dst_t.spec_steps += src_t.spec_steps
        dst_t.spec_drafted += src_t.spec_drafted
        dst_t.spec_accepted += src_t.spec_accepted
        if src_t.first_submit_step >= 0:
            dst_t.first_submit_step = src_t.first_submit_step \
                if dst_t.first_submit_step < 0 \
                else min(dst_t.first_submit_step, src_t.first_submit_step)
        if src_sess.adaptive_k is not None:
            # the departed tenant must stop constraining the source's
            # batch-wide adaptive speculation depth
            src_sess.adaptive_k.forget(tid)
        src_sched.remove_tenant(tid)
        rec.done_step = self.step_count
        del self._draining[tid]
        self._migrated_counts[tid] = self._migrated_counts.get(tid, 0) + 1
        for tr in (self.tracers[src], self.tracers[dst]):
            tr.record_migrate(tid, src=src, dst=dst, phase="done",
                              step=self.step_count,
                              handoffs=rec.slots_handed_off)

    # -- fused telemetry ----------------------------------------------------
    def merged_tracer(self) -> telemetry.Tracer:
        """One fused event view over all partitions
        (:meth:`telemetry.Tracer.merge`; partition tags preserved)."""
        return telemetry.Tracer.merge(*self.tracers)

    def _tenant_groups(self) -> Dict[str, List[Tuple[int, Tenant]]]:
        groups: Dict[str, List[Tuple[int, Tenant]]] = {}
        for i, sched in enumerate(self.schedulers):
            for tid, t in sched.tenants.items():
                groups.setdefault(tid, []).append((i, t))
        return groups

    def report(self) -> PartitionedReport:
        reps = [s.report() for s in self.schedulers]
        groups = self._tenant_groups()
        rows: List[TenantReport] = []
        turnarounds: List[float] = []
        for tid in self._tenant_order:
            row, contrib = build_tenant_report(
                tid, [t for _, t in groups.get(tid, [])], self.step_count,
                partition=self.tenant_partition.get(tid, -1),
                migrations=self._migrated_counts.get(tid, 0))
            rows.append(row)
            if contrib is not None:
                turnarounds.append(contrib)
        rep = PartitionedReport(
            placement=self.placement,
            admission="/".join(sorted({s.admission
                                       for s in self.schedulers})),
            quota="/".join(sorted({s.quota.name for s in self.schedulers})),
            n_partitions=self.n_partitions,
            n_tenants=len(self._tenant_order),
            steps=self.step_count,
            wall_s=max((rep.wall_s for rep in reps), default=0.0),
            tokens_out=sum(rep.tokens_out for rep in reps),
            fairness=cc.fairness(turnarounds),
            cv=cc.cv(turnarounds),
            tenant_partition=dict(self.tenant_partition),
            partitions=reps,
            tenants=rows,
            migrations=sum(1 for m in self.migrations if m.done),
            policies=[self.policy_key(i)
                      for i in range(self.n_partitions)])
        if self.metrics is not None:
            from repro_torch.runtime.metrics import observe_runtime
            observe_runtime(self.metrics, self, rep)
        return rep


def run_serving(params, cfg, spec: Union[ServingSpec, Dict],
                workloads: Dict[str, Sequence[Request]], *,
                weights: Optional[Dict[str, float]] = None,
                max_steps: int = 100_000,
                **runtime_kw) -> PartitionedReport:
    """One-shot helper: build the runtime from a spec, register + submit
    every tenant's workload, drain, return the fused report."""
    runtime = ServingRuntime(params, cfg, spec, **runtime_kw)
    for tid in workloads:
        if tid not in runtime.tenant_partition:
            runtime.add_tenant(tid, weight=(weights or {}).get(tid, 1.0))
    for tid, reqs in workloads.items():
        for req in reqs:
            runtime.submit(tid, req)
    runtime.drain(max_steps=max_steps)
    return runtime.report()
