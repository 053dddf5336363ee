"""Execution policy and the matmul dispatcher (main-path part).

Twin of ``repro/core/execution.py``: :class:`ExecutionPolicy` (precision ×
sparsity × backend × block shapes × stream budget), :func:`parse_policy`,
the policy scope, :func:`policy_from`, :func:`apply_policy`, the packed
2:4 weight (:class:`PackedWeight`, :func:`pack_model_params`) and
:func:`matmul`, the dispatcher every linear layer routes through.

It also holds the block-shape cache (:class:`BlockShapeCache`, seeded
from Table 3, and the module-level :data:`BLOCK_CACHE` that
``sweep_paged_tilings`` and :func:`seed_cache_from_records` record into),
the sweep-name parsers (:func:`parse_blocksweep_name`,
:func:`parse_pagedsweep_name`), the module default policy and backend
(:func:`set_default_policy`, :func:`set_default_backend`) and
:func:`raw_matmul`, the characterization sweeps' dispatch.

The block cache is inert under the ``hopper`` backends: their GEMM
kernels take ``bm/bn/bk`` and drop them, and tile and K splits come from
``kernels/gemm_plan.plan``, a pure function of (M, N, K, kind, SM count)
(see ``kernels/registry.py``). Cached blocks reach a policy's
``block_m/n/k`` and change nothing the kernels compute.

The runtime half: :func:`resolve_policy` (the occupancy advisor at
session set-up, with :func:`set_default_advisor`), :func:`dispatch_matmul`
(the lane-dispatched form of :func:`matmul`) and the
:class:`OverlapPlanner` that pairs partitions for lane overlap from
measured decode latencies.

Policy strings written for the JAX package parse unchanged: ``pallas``
names the ``hopper`` backend, ``pallas_sparse24`` the ``hopper_sparse24``
backend, ``pallas_paged`` the ``hopper_paged`` backend and ``jnp`` the
``torch`` backend.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import concurrency as cc
from repro_torch.core import sparsity as sp
from repro_torch.kernels import registry

PRECISIONS = ("bf16", "fp8")
SPARSITIES = ("dense", "sparse24")

# One unit of grid parallelism for the occupancy advisor: the reference's
# prior (an output tile of 128 × 128), kept so the advisor decides as the
# reference does. It is not the tile of the port's kernels.
MXU_TILE = 128

# JAX backend names → the port's backends.
BACKEND_ALIASES = {"pallas": "hopper", "pallas_sparse24": "hopper_sparse24",
                   "pallas_paged": "hopper_paged", "jnp": "torch"}


# ---------------------------------------------------------------------------
# Packed 2:4 weight (serving representation, consumed by backend.sparse24)
# ---------------------------------------------------------------------------

class PackedWeight(NamedTuple):
    """2:4-compressed linear weight: values (K/2, N) + meta (K/8, N) uint8."""
    values: torch.Tensor
    meta: torch.Tensor

    @property
    def k(self) -> int:
        return self.values.shape[0] * 2

    @property
    def n(self) -> int:
        return self.values.shape[1]


def pack_weight(w: torch.Tensor) -> PackedWeight:
    return PackedWeight(*sp.pack_24(sp.prune_24(w)))


def pack_model_params(params):
    """Pre-pack every eligible linear weight to :class:`PackedWeight`.

    The serving form of a sparse24 policy: prune and pack once at session
    set-up, so decode streams packed bytes. Eligible leaves are the
    ``dense()``-consumed projections (``w_*`` / ``out_proj``), 2-D, floating,
    with K % 8 == 0. Embeddings, the LM head and norms stay dense, and so
    does a leaf that is already packed. The port's tree keeps one dict per
    layer in a list, so there is no stacked 3-D case."""
    def maybe(key: str, v):
        if isinstance(v, dict):
            return {k: maybe(k, vv) for k, vv in v.items()}
        if isinstance(v, list):
            return [maybe(key, vv) for vv in v]
        if not (key.startswith("w_") or key == "out_proj"):
            return v
        if not isinstance(v, torch.Tensor) or v.dim() != 2:
            return v
        if v.shape[0] % 8 or not v.is_floating_point():
            return v
        return pack_weight(v)

    return {k: maybe(k, v) for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How a matmul (and the workload around it) should execute."""
    precision: str = "bf16"             # bf16 | fp8
    sparsity: str = "dense"             # dense | sparse24
    backend: str = "torch"              # registry name
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    block_k: Optional[int] = None
    streams: int = 1
    overlap: bool = True
    rationale: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision {self.precision!r} not in "
                             f"{PRECISIONS}")
        if self.sparsity not in SPARSITIES:
            raise ValueError(f"sparsity {self.sparsity!r} not in "
                             f"{SPARSITIES}")

    @property
    def blocks(self) -> Dict[str, Optional[int]]:
        return {"bm": self.block_m, "bn": self.block_n, "bk": self.block_k}

    def spec(self) -> str:
        """Compact string form, parseable by :func:`parse_policy`."""
        return f"{self.precision}:{self.sparsity}:{self.backend}"

    def full_spec(self) -> str:
        """Round-trippable string form: :meth:`spec` plus block shapes and
        stream budget when set."""
        parts = [self.spec()]
        if all(b is not None
               for b in (self.block_m, self.block_n, self.block_k)):
            parts.append(f"{self.block_m}x{self.block_n}x{self.block_k}")
        if self.streams != 1:
            parts.append(f"streams={self.streams}")
        if not self.overlap:
            parts.append("no_overlap")
        return ":".join(parts)

    def describe(self) -> str:
        base = self.spec() + f" streams={self.streams}"
        if not self.overlap:
            base += " no_overlap"
        if self.rationale:
            base += "\n  - " + "\n  - ".join(self.rationale)
        return base


def parse_policy(spec: str, base: Optional[ExecutionPolicy] = None
                 ) -> ExecutionPolicy:
    """Parse ``"fp8:dense:hopper"``-style specs (parts in any order, any
    subset): precision, sparsity, backend name (or its JAX alias),
    ``NxNxN`` blocks, ``streams=N``, ``overlap``/``no_overlap``."""
    pol = base or ExecutionPolicy()
    updates: Dict[str, Any] = {}
    for tok in filter(None, (t.strip() for t in spec.split(":"))):
        tok = BACKEND_ALIASES.get(tok, tok)
        if tok in PRECISIONS:
            updates["precision"] = tok
        elif tok in SPARSITIES:
            updates["sparsity"] = tok
        elif tok in registry.available_backends():
            updates["backend"] = tok
        elif tok.startswith("streams="):
            updates["streams"] = int(tok.split("=", 1)[1])
        elif tok in ("overlap", "no_overlap"):
            updates["overlap"] = tok == "overlap"
        elif "x" in tok:
            bm, bn, bk = (int(v) for v in tok.split("x"))
            updates.update(block_m=bm, block_n=bn, block_k=bk)
        else:
            raise ValueError(
                f"unrecognized policy token {tok!r} in {spec!r} (want one of "
                f"{PRECISIONS + SPARSITIES}, a backend "
                f"{registry.available_backends()}, MxNxK blocks, or "
                f"streams=N)")
    return dataclasses.replace(pol, **updates)


# The initial module default backend: the backend of a call site with no
# policy and ``use_pallas`` off (the reference's is ``jnp``).
DEFAULT_BACKEND = "torch"

# Module-level defaults: benchmarks and launchers flip these once instead
# of threading a policy through every call site.
_default_policy: Optional[ExecutionPolicy] = None
_default_backend: str = DEFAULT_BACKEND

# Partition-local policy scope (context-var based, as in the reference).
_scope_policy: "contextvars.ContextVar[Optional[ExecutionPolicy]]" = \
    contextvars.ContextVar("repro_torch_policy_scope", default=None)


@contextlib.contextmanager
def policy_scope(policy: Optional[ExecutionPolicy]):
    """Make ``policy`` the contextual default for the enclosed block.
    Precedence: explicit ``rt.policy`` > this scope > the module default
    policy (:func:`set_default_policy`) > derived switches."""
    tok = _scope_policy.set(policy)
    try:
        yield policy
    finally:
        _scope_policy.reset(tok)


def get_scope_policy() -> Optional[ExecutionPolicy]:
    return _scope_policy.get()


def set_default_policy(policy: Optional[ExecutionPolicy]) -> None:
    global _default_policy
    _default_policy = policy


def get_default_policy() -> ExecutionPolicy:
    scoped = _scope_policy.get()
    if scoped is not None:
        return scoped
    return _default_policy if _default_policy is not None \
        else ExecutionPolicy(backend=_default_backend)


def set_default_backend(name: str) -> None:
    """Make ``name`` (a registry backend, or its JAX name) the module
    default backend."""
    name = BACKEND_ALIASES.get(name, name)
    registry.get_backend(name)          # validate eagerly
    global _default_backend
    _default_backend = name


def default_backend() -> str:
    return _default_backend


def policy_from(cfg, rt) -> ExecutionPolicy:
    """Effective policy for a model call site: explicit ``rt.policy`` >
    :func:`policy_scope` > the module default policy > derived from
    ``cfg.precision``, ``cfg.sparsity_24`` and ``rt.use_pallas`` with the
    module default backend."""
    pol = getattr(rt, "policy", None)
    if pol is not None:
        return pol
    scoped = _scope_policy.get()
    if scoped is not None:
        return scoped
    if _default_policy is not None:
        return _default_policy
    return ExecutionPolicy(
        precision=cfg.precision,
        sparsity="sparse24" if cfg.sparsity_24 else "dense",
        backend="hopper" if rt.use_pallas else _default_backend)


def apply_policy(cfg, rt, policy: ExecutionPolicy):
    """Fold a policy back into (cfg, rt). ``rt.use_pallas`` is left alone:
    it also gates the flash-attention kernel."""
    cfg = dataclasses.replace(
        cfg, precision=policy.precision,
        sparsity_24=policy.sparsity == "sparse24")
    rt = dataclasses.replace(rt, policy=policy)
    return cfg, rt


def matmul(x: torch.Tensor, w: torch.Tensor,
           policy: Optional[ExecutionPolicy] = None, *,
           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` through the policy's backend. A :class:`PackedWeight` goes
    to the backend's packed 2:4 GEMM whatever the precision, as in the
    reference; FP8 applies to 2-D dense weights; leading dims of ``x`` are
    preserved."""
    pol = policy or get_default_policy()
    be = registry.get_backend(pol.backend)
    if isinstance(w, PackedWeight):
        return be.sparse24(x, w.values, w.meta, out_dtype=out_dtype,
                           **pol.blocks)
    if pol.precision == "fp8" and w.dim() == 2:
        return be.fp8(x, w, out_dtype=out_dtype, **pol.blocks)
    return be.dense(x, w, out_dtype=out_dtype, **pol.blocks)


def raw_matmul(a: torch.Tensor, b: torch.Tensor, *,
               backend: Optional[str] = None,
               out_dtype=torch.float32) -> torch.Tensor:
    """The characterization sweeps' dispatch on already-cast operands: fp8
    operands go through the pre-quantized GEMM entry (unit scales), every
    other type through ``dense``, so one default backend re-targets every
    sweep. Under ``hopper`` on the card both reach kernel A, which takes
    bf16 and fp8 operands only: f32 operands raise there."""
    name = backend or get_default_policy().backend
    be = registry.get_backend(BACKEND_ALIASES.get(name, name))
    is_fp8 = a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
    tr = _ambient_tracer()
    if tr is not None:
        tr.record_matmul(int(a.shape[0]), int(a.shape[-1]),
                         int(b.shape[-1]), precision=_dtype_key(a.dtype),
                         backend=name, op="fp8_qdot" if is_fp8 else "dense")
    if is_fp8:
        return be.fp8_qdot(a, b, 1.0, 1.0, out_dtype=out_dtype)
    return be.dense(a, b, out_dtype=out_dtype)


# The backends whose expert GEMMs run batched on kernel A (the reference's
# ``backend.startswith("pallas")``).
KERNEL_BACKENDS = ("hopper", "hopper_sparse24")


def matmul_experts(x: torch.Tensor, w: torch.Tensor,
                   policy: Optional[ExecutionPolicy] = None, *,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-expert ``x[e] @ w[e]``: x (E, M, K), w (E, K, N) → (E, M, N),
    each expert's product as :func:`matmul` computes it alone. On kernel A
    (fp8, or bf16 on ``hopper``) the E products are one launch
    (``registry.hopper_experts``). Elsewhere each expert goes through
    :func:`matmul`, as the reference's unrolled per-expert loop does:
    under ``hopper_sparse24`` that is the dense entry, which prunes and
    packs each expert's weight per call, as ``pallas_sparse24``'s does."""
    pol = policy or get_default_policy()
    if pol.backend == "hopper" or (pol.backend in KERNEL_BACKENDS
                                   and pol.precision == "fp8"):
        return registry.hopper_experts(x, w, precision=pol.precision,
                                       out_dtype=out_dtype)
    return torch.stack([matmul(x[e], w[e], pol, out_dtype=out_dtype)
                        for e in range(w.shape[0])])


# ---------------------------------------------------------------------------
# Block-shape autotune cache (Table 3: preferred tile is precision-dependent)
# ---------------------------------------------------------------------------

_DTYPE_KEYS = {torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8",
               torch.bfloat16: "bf16", torch.float32: "fp32"}


def _dtype_key(dtype) -> str:
    if isinstance(dtype, str):      # already a precision key ("fp8", ...)
        return dtype
    return _DTYPE_KEYS.get(dtype, str(dtype).split(".")[-1])


class BlockShapeCache:
    """(M, K, N, dtype) → (bm, bn, bk) with best observed latency.

    Seeded with the Table-3 finding — larger tiles pay a per-issue latency
    premium and the preferred shape is precision-dependent — and refined
    by :meth:`record` whenever a harness measures a (shape, blocks) pair.
    """

    # Per-precision preferred blocks, from table3_tile_latency.
    TABLE3_PREFERRED: Dict[str, Tuple[int, int, int]] = {
        "fp8": (256, 256, 512),
        "bf16": (256, 256, 256),
        "fp32": (128, 128, 256),
    }
    # The Table-3 probe grid itself (m, n, k): candidates for autotuning.
    TABLE3_SHAPES: Tuple[Tuple[int, int, int], ...] = (
        (128, 128, 128), (256, 256, 128), (128, 128, 256), (256, 256, 256))

    def __init__(self, seed: bool = True):
        self._best: Dict[Tuple[int, int, int, str],
                         Tuple[Tuple[int, int, int], float]] = {}
        if seed:
            self.seed_from_table3()

    def seed_from_table3(self) -> None:
        for prec, blocks in self.TABLE3_PREFERRED.items():
            for (m, n, k) in self.TABLE3_SHAPES:
                bm, bn, bk = (min(b, d) for b, d in zip(blocks, (m, n, k)))
                self._best[(m, k, n, prec)] = ((bm, bn, bk), math.inf)

    def record(self, m: int, k: int, n: int, dtype,
               blocks: Tuple[int, int, int], seconds: float) -> None:
        key = (m, k, n, _dtype_key(dtype))
        cur = self._best.get(key)
        if cur is None or seconds < cur[1]:
            self._best[key] = (tuple(blocks), seconds)

    def lookup(self, m: int, k: int, n: int, dtype
               ) -> Optional[Tuple[Optional[int], ...]]:
        prec = _dtype_key(dtype)
        hit = self._best.get((m, k, n, prec))
        if hit is not None:
            return hit[0]
        pref = self.TABLE3_PREFERRED.get(prec)
        if pref is None:
            return None
        # Clamp the precision-preferred blocks to the problem; a dim below
        # 8 gets no hint (None → kernel default).
        clamped = tuple(min(b, d) for b, d in zip(pref, (m, n, k)))
        return tuple((c if c >= 8 else None) for c in clamped)

    def entries(self) -> Dict[Tuple[int, int, int, str],
                              Tuple[Tuple[int, int, int], float]]:
        """Snapshot of {(m, k, n, prec): (blocks, best seconds)}."""
        return dict(self._best)

    def __len__(self) -> int:
        return len(self._best)


BLOCK_CACHE = BlockShapeCache()


# Precisions the block-evidence ingestion paths understand (dtype-mapped).
SWEEP_DTYPES = {"fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16,
                "fp16": torch.float16, "fp32": torch.float32}


def parse_blocksweep_name(name: str
                          ) -> Optional[Tuple[int, int, int, str,
                                              Tuple[int, int, int]]]:
    """Parse a ``blocksweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}`` record
    name into ``(m, n, k, prec, (bm, bn, bk))``; None if it isn't one or
    names a precision outside :data:`SWEEP_DTYPES`. The one parser of both
    ingestion paths (:func:`seed_cache_from_records` and
    :meth:`repro_torch.core.autotune.AutotuneStore.add_records`)."""
    parts = name.split("/")
    if len(parts) != 4 or parts[0] != "blocksweep" \
            or parts[1] not in SWEEP_DTYPES:
        return None
    try:
        m, n, k = (int(v) for v in parts[2].split("x"))
        blocks = tuple(int(v) for v in parts[3].split("x"))
    except ValueError:
        return None
    if len(blocks) != 3:
        return None
    return m, n, k, parts[1], blocks


def parse_pagedsweep_name(name: str
                          ) -> Optional[Tuple[int, int, int, str,
                                              Tuple[int, int, int]]]:
    """Parse a ``pagedsweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}`` record
    name (the paged flash-decode tiling sweep) into
    ``(m, n, k, prec, (bm, bn, bk))`` — m = query rows (slots), n = total
    KV length, k = head_dim, blocks = (1, page_size, head_dim); None if it
    isn't one or names a precision outside :data:`SWEEP_DTYPES`."""
    parts = name.split("/")
    if len(parts) != 4 or parts[0] != "pagedsweep" \
            or parts[1] not in SWEEP_DTYPES:
        return None
    try:
        m, n, k = (int(v) for v in parts[2].split("x"))
        blocks = tuple(int(v) for v in parts[3].split("x"))
    except ValueError:
        return None
    if len(blocks) != 3:
        return None
    return m, n, k, parts[1], blocks


def seed_cache_from_records(records: Sequence[Any],
                            cache: Optional[BlockShapeCache] = None) -> int:
    """Ingest probe Records into the block cache; returns how many were
    folded in.

    ``latency/{prec}/{m}x{n}x{k}`` rows (the shape probe) keep the
    precision-preferred blocks clamped to the shape: the probe measures a
    shape, not a tiling. ``blocksweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}``
    rows carry the blocks that were measured, so the cache's per-key
    best-latency rule promotes the sweep's winner. Under ``hopper`` those
    blocks are inert (module docstring)."""
    # not `cache or BLOCK_CACHE`: an empty cache is falsy (len 0)
    cache = cache if cache is not None else BLOCK_CACHE
    n_in = 0
    for r in records:
        sweep = parse_blocksweep_name(r.name)
        if sweep is not None:
            m, n, k, prec, blocks = sweep
            cache.record(m, k, n, SWEEP_DTYPES[prec], blocks,
                         r.us_per_call * 1e-6)
            n_in += 1
            continue
        parts = r.name.split("/")
        if len(parts) != 3 or parts[0] != "latency":
            continue
        prec = parts[1]
        m, n, k = (int(v) for v in parts[2].split("x"))
        dtype = SWEEP_DTYPES.get(prec)
        pref = BlockShapeCache.TABLE3_PREFERRED.get(prec)
        if dtype is None or pref is None:
            continue
        blocks = tuple(min(b, d) for b, d in zip(pref, (m, n, k)))
        cache.record(m, k, n, dtype, blocks, r.us_per_call * 1e-6)
        n_in += 1
    return n_in


# ---------------------------------------------------------------------------
# Policy resolver (OccupancyAdvisor at session set-up)
# ---------------------------------------------------------------------------

def grid_tiles(m: int, n: int, tile: int = MXU_TILE) -> int:
    """Tile fill of an (M, N) output — the advisor's 'active wavefronts'."""
    return max(1, -(-m // tile)) * max(1, -(-n // tile))


# Advisor installed by a calibration step: when set, resolve_policy
# decides from its thresholds instead of the §9.2 priors.
_default_advisor: Optional[cc.OccupancyAdvisor] = None


def set_default_advisor(advisor: Optional[cc.OccupancyAdvisor]) -> None:
    global _default_advisor
    _default_advisor = advisor


def get_default_advisor() -> cc.OccupancyAdvisor:
    return _default_advisor if _default_advisor is not None \
        else cc.OccupancyAdvisor()


def _ambient_tracer():
    from repro_torch.runtime import telemetry
    return telemetry.get_tracer()


def resolve_policy(m: int, k: int, n: int, *,
                   precision: str = "fp8",
                   backend: Optional[str] = None,
                   latency_sensitive: bool = False,
                   tenants: int = 1,
                   streams: Optional[int] = None,
                   advisor: Optional[cc.OccupancyAdvisor] = None,
                   cache: Optional[BlockShapeCache] = None,
                   tracer=None) -> ExecutionPolicy:
    """Pick the execution policy the paper's §9.2 rules would pick.

    ``(m, k, n)`` is the dominant GEMM of the workload (tokens × d_model ×
    d_ff for an LLM step); the advisor sees its grid-tile fill and may
    demote FP8 below the occupancy threshold, enable/disable 2:4, and cap
    the stream count. An explicit ``backend`` (or its JAX name) wins;
    otherwise a packed-2:4 policy on a ``hopper`` default takes
    ``hopper_sparse24``, else the module default. The advisor's core count
    is the card's SM count on the card, so the card may resolve another
    policy than the CPU for the same shape. With no explicit ``advisor``
    the module default applies: a calibrated one once
    :func:`repro_torch.core.autotune.install` has loaded a measured
    artifact, the prior one otherwise. The policy's blocks come from the
    block cache, as in the reference; under ``hopper`` they are inert
    (module docstring). The decision is recorded to ``tracer`` (or the
    ambient telemetry tracer)."""
    advisor = advisor or get_default_advisor()
    profile = cc.WorkloadProfile(
        precision=precision,
        grid_tiles=grid_tiles(m, n),
        latency_sensitive=latency_sensitive,
        concurrent_tenants=tenants)
    advice = advisor.advise(profile)

    sparsity = "sparse24" if advice.use_sparsity and k % 8 == 0 else "dense"
    chosen_backend = BACKEND_ALIASES.get(backend, backend) \
        if backend is not None else (
            "hopper_sparse24" if sparsity == "sparse24"
            and _default_backend.startswith("hopper") else _default_backend)
    registry.get_backend(chosen_backend)

    dtype = torch.float8_e4m3fn if advice.suggested_precision == "fp8" \
        else torch.bfloat16
    blocks = (cache if cache is not None else BLOCK_CACHE).lookup(
        m, k, n, dtype) or (None,) * 3

    n_streams = advice.max_streams if streams is None \
        else min(streams, advice.max_streams)
    pol = ExecutionPolicy(
        precision=advice.suggested_precision,
        sparsity=sparsity,
        backend=chosen_backend,
        block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
        streams=max(1, n_streams),
        rationale=tuple(advice.rationale))
    tr = tracer if tracer is not None else _ambient_tracer()
    if tr is not None:
        tr.record_resolve(m, k, n, policy=pol.spec(),
                          precision=pol.precision, backend=pol.backend,
                          fill=profile.grid_tiles / advisor.n_cores,
                          calibrated=advisor.calibrated,
                          streams=pol.streams)
    return pol


# ---------------------------------------------------------------------------
# The lane-dispatched matmul
# ---------------------------------------------------------------------------

def dispatch_matmul(x: torch.Tensor, w,
                    policy: Optional[ExecutionPolicy] = None, *,
                    out_dtype=torch.bfloat16, lane=None, overlap_group=-1,
                    tracer=None) -> "cc.LaneHandle":
    """Async form of :func:`matmul`: enqueue the GEMM on ``lane``'s stream
    through the policy's backend :meth:`~repro_torch.kernels.registry.
    MatmulBackend.dispatch` entry and return a joinable
    :class:`~repro_torch.core.concurrency.LaneHandle`. Same routing as
    :func:`matmul` (PackedWeight → sparse24, fp8 2-D dense → fp8, else
    dense); the dispatch is recorded with its lane and overlap group."""
    pol = policy or get_default_policy()
    be = registry.get_backend(pol.backend)
    packed = isinstance(w, PackedWeight)
    tr = tracer if tracer is not None else _ambient_tracer()
    if tr is not None:
        kk, nn = (w.k, w.n) if packed else (w.shape[-2], w.shape[-1])
        mm = 1
        for d in x.shape[:-1]:
            mm *= int(d)
        tr.record_matmul(mm, int(kk), int(nn),
                         precision=pol.precision, backend=pol.backend,
                         policy=pol.spec(),
                         lane=getattr(lane, "name", ""),
                         overlap_group=overlap_group,
                         op="sparse24" if packed else
                         ("fp8" if pol.precision == "fp8"
                          and w.dim() == 2 else "dense"))
    if packed:
        return be.dispatch("sparse24", x, w.values, w.meta, lane=lane,
                           overlap_group=overlap_group,
                           out_dtype=out_dtype, **pol.blocks)
    if pol.precision == "fp8" and w.dim() == 2:
        return be.dispatch("fp8", x, w, lane=lane,
                           overlap_group=overlap_group,
                           out_dtype=out_dtype, **pol.blocks)
    return be.dispatch("dense", x, w, lane=lane,
                       overlap_group=overlap_group,
                       out_dtype=out_dtype, **pol.blocks)


# ---------------------------------------------------------------------------
# Overlap planning (measured online pairing — AsyncSparse / paper §6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OverlapCandidate:
    """One unit of dispatchable work the planner may co-schedule.

    ``ema_s`` is the Tracer's measured per-shape latency EMA for the
    work's dominant GEMM (``None`` = never measured → stays serial this
    round); ``allowed`` carries the owning policy's ``overlap`` gate."""
    index: int
    sparsity: str = "dense"
    shape: Optional[Tuple[int, int, int, str]] = None
    ema_s: Optional[float] = None
    allowed: bool = True


@dataclasses.dataclass
class OverlapPlan:
    """The planner's verdict for one dispatch round: ``groups`` are tuples
    of candidate indices to co-dispatch (one overlap-group id each);
    ``serial`` indices run alone. Every candidate index appears exactly
    once across the two."""
    groups: Tuple[Tuple[int, ...], ...]
    serial: Tuple[int, ...]

    @property
    def n_overlapped(self) -> int:
        return sum(len(g) for g in self.groups)


class OverlapPlanner:
    """Measured online pairing of sparse24/dense work for lane overlap.

    Work is dispatched serial until the Tracer has a measured latency EMA
    for its shape, then sparse24 candidates are paired with the dense
    candidate of closest measured latency — a balanced pair overlaps
    fully, while a lopsided one (ratio above ``max_imbalance``) would just
    serialize behind its slow member, so it stays serial. Leftover
    same-kind candidates are paired by adjacent measured latency when
    ``pair_homogeneous`` (two dense partitions still overlap host work
    with device work). The EMAs are wall times, so the pairing may differ
    from run to run; the token streams do not.
    """

    def __init__(self, *, max_imbalance: float = 8.0,
                 pair_homogeneous: bool = True):
        if max_imbalance < 1.0:
            raise ValueError("max_imbalance must be >= 1.0")
        self.max_imbalance = max_imbalance
        self.pair_homogeneous = pair_homogeneous

    def _ratio(self, a: OverlapCandidate, b: OverlapCandidate) -> float:
        hi = max(a.ema_s, b.ema_s)
        lo = max(min(a.ema_s, b.ema_s), 1e-12)
        return hi / lo

    def candidate(self, index: int, *, sparsity: str = "dense",
                  shape: Optional[Tuple[int, int, int, str]] = None,
                  tracer=None, allowed: bool = True) -> OverlapCandidate:
        """Build a candidate, looking its shape's measured EMA up in the
        tracer (``None`` EMA when unmeasured — "measure first, overlap
        second")."""
        ema = None
        if tracer is not None and shape is not None:
            ema = tracer.shape_latency_ema().get(tuple(shape))
        return OverlapCandidate(index=index, sparsity=sparsity,
                                shape=shape, ema_s=ema, allowed=allowed)

    def plan(self, candidates: Sequence[OverlapCandidate]) -> OverlapPlan:
        serial = [c.index for c in candidates
                  if not c.allowed or c.ema_s is None]
        live = [c for c in candidates if c.allowed and c.ema_s is not None]
        sparse = [c for c in live if c.sparsity == "sparse24"]
        dense = [c for c in live if c.sparsity != "sparse24"]
        groups = []
        used = set()
        # 1) each sparse24 candidate takes the closest-latency dense one
        for s in sparse:
            best, best_ratio = None, None
            for d in dense:
                if d.index in used:
                    continue
                ratio = self._ratio(s, d)
                if ratio > self.max_imbalance:
                    continue
                if best_ratio is None or ratio < best_ratio:
                    best, best_ratio = d, ratio
            if best is not None:
                used.add(s.index)
                used.add(best.index)
                groups.append((s.index, best.index))
        # 2) leftovers pair by adjacent measured latency
        left = sorted((c for c in live if c.index not in used),
                      key=lambda c: (c.ema_s, c.index))
        if self.pair_homogeneous:
            i = 0
            while i + 1 < len(left):
                a, b = left[i], left[i + 1]
                if self._ratio(a, b) <= self.max_imbalance:
                    groups.append((a.index, b.index))
                    used.add(a.index)
                    used.add(b.index)
                    i += 2
                else:
                    i += 1
        serial.extend(c.index for c in left if c.index not in used)
        return OverlapPlan(groups=tuple(tuple(g) for g in groups),
                           serial=tuple(sorted(serial)))
