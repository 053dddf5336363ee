"""Execution policy and the matmul dispatcher (main-path part).

Twin of ``repro/core/execution.py``: :class:`ExecutionPolicy` (precision ×
sparsity × backend × block shapes × stream budget), :func:`parse_policy`,
the policy scope, :func:`policy_from`, :func:`apply_policy`, the packed
2:4 weight (:class:`PackedWeight`, :func:`pack_model_params`) and
:func:`matmul`, the dispatcher every linear layer routes through.

It also holds the block-shape cache (:class:`BlockShapeCache`, seeded
from Table 3, and the module-level :data:`BLOCK_CACHE` that
``sweep_paged_tilings`` records into) and :func:`parse_pagedsweep_name`.

Policy strings written for the JAX package parse unchanged: ``pallas``
names the ``hopper`` backend, ``pallas_sparse24`` the ``hopper_sparse24``
backend, ``pallas_paged`` the ``hopper_paged`` backend and ``jnp`` the
``torch`` backend. Not ported yet: ``resolve_policy`` (the occupancy
advisor), ``seed_cache_from_records``, the overlap planner and the
module-level default setters.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import sparsity as sp
from repro_torch.kernels import registry

PRECISIONS = ("bf16", "fp8")
SPARSITIES = ("dense", "sparse24")

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


# the backend of a call site with no policy and ``use_pallas`` off
DEFAULT_BACKEND = "torch"

# Partition-local policy scope (context-var based, as in the reference).
_scope_policy: "contextvars.ContextVar[Optional[ExecutionPolicy]]" = \
    contextvars.ContextVar("repro_torch_policy_scope", default=None)


@contextlib.contextmanager
def policy_scope(policy: Optional[ExecutionPolicy]):
    """Make ``policy`` the contextual default for the enclosed block.
    Precedence: explicit ``rt.policy`` > this scope > derived switches."""
    tok = _scope_policy.set(policy)
    try:
        yield policy
    finally:
        _scope_policy.reset(tok)


def get_default_policy() -> ExecutionPolicy:
    scoped = _scope_policy.get()
    return scoped if scoped is not None \
        else ExecutionPolicy(backend=DEFAULT_BACKEND)


def policy_from(cfg, rt) -> ExecutionPolicy:
    """Effective policy for a model call site: explicit ``rt.policy`` >
    :func:`policy_scope` > derived from ``cfg.precision``,
    ``cfg.sparsity_24`` and ``rt.use_pallas``."""
    pol = getattr(rt, "policy", None)
    if pol is not None:
        return pol
    scoped = _scope_policy.get()
    if scoped is not None:
        return scoped
    return ExecutionPolicy(
        precision=cfg.precision,
        sparsity="sparse24" if cfg.sparsity_24 else "dense",
        backend="hopper" if rt.use_pallas else DEFAULT_BACKEND)


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
