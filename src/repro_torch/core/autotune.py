"""Persistent autotune store + online policy calibration.

Twin of ``repro/core/autotune.py``, with its names and its artifact's
JSON schema, so that each package loads the other's ``autotune.json``.
What the policy layer otherwise decides from hard-coded Table-3/§9.2
constants — preferred block shapes, the FP8-demotion occupancy threshold
— becomes a measured quantity persisted to a JSON artifact, so one
calibration run (``launch/profile.py``) informs every later
``resolve_policy`` lookup.

* :class:`AutotuneStore` — serializes/loads block-shape cache entries
  (:class:`repro_torch.core.execution.BlockShapeCache`), raw occupancy
  samples (per-precision throughput vs grid-tile count), and the
  thresholds calibrated from them, to ``<artifact_dir>/autotune.json``.
* :meth:`AutotuneStore.calibrate` — re-derives the FP8 occupancy knee
  from recorded samples: the smallest observed tile count where measured
  FP8 throughput matches the bf16 baseline. Below the knee the advisor
  demotes to bf16 because measurement said so.
* :func:`install` — loads the artifact, folds its block entries into the
  global ``BLOCK_CACHE``, and installs a calibrated
  :class:`~repro_torch.core.concurrency.OccupancyAdvisor` as the
  ``resolve_policy`` default. Under the ``hopper`` backends the block
  entries are inert: the port's GEMM kernels take their tile from
  ``kernels/gemm_plan.plan``, never from the cache
  (``kernels/registry.py``).

Artifact location: ``$REPRO_AUTOTUNE_DIR`` or ``build/repro_torch_autotune``
(relative to the working directory). The default differs from the
reference's ``benchmarks/artifacts/autotune`` on purpose: a calibration
the JAX package wrote on the CPU is never installed into the port by
default, and the port writes nothing under ``benchmarks/``. Reset by
deleting the directory or ``AutotuneStore.reset()`` /
``launch/profile.py --reset``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import concurrency as cc

ENV_DIR = "REPRO_AUTOTUNE_DIR"
DEFAULT_DIR = os.path.join("build", "repro_torch_autotune")
ARTIFACT_NAME = "autotune.json"
SCHEMA_VERSION = 1

# Calibration baseline precision: FP8 is judged against this (§5's
# "FP16 at 128 wavefronts outperforms underutilized FP8", bf16 on TPU).
BASELINE_PRECISION = "bf16"


def artifact_dir() -> str:
    return os.environ.get(ENV_DIR) or DEFAULT_DIR


@dataclasses.dataclass
class Sample:
    """One occupancy observation: throughput of a GEMM at a grid-tile
    count, per precision (the Fig-2 axis as raw evidence)."""
    precision: str
    tiles: int
    gflops: float
    m: int = 0
    k: int = 0
    n: int = 0
    source: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Record serialization
# ---------------------------------------------------------------------------

def json_safe(v: Any) -> Any:
    """Coerce one derived value to a JSON-serializable form: scalars pass
    through, lists/tuples of scalars recurse (``StreamReport.per_stream_s``
    survives a dump/load round trip), anything else stringifies."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return str(v)


def record_to_dict(rec) -> Dict[str, Any]:
    """``characterization.Record`` → plain dict (JSON-safe derived).

    The one Record schema: ``StreamReport.to_record`` produces these,
    ``dump_records``/``load_records`` persist them, and
    :meth:`AutotuneStore.add_records` ingests them."""
    return {"name": rec.name, "us_per_call": float(rec.us_per_call),
            "derived": {k: json_safe(v) for k, v in rec.derived.items()}}


def dump_records(records: Sequence[Any], path: str) -> str:
    """Write benchmark Records as a JSON list (machine-readable bench
    trajectories across PRs); returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_write(path, json.dumps([record_to_dict(r) for r in records],
                                   indent=1))
    return path


def load_records(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return json.load(f)


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

class AutotuneStore:
    """Measured policy inputs, persisted.

    ``blocks``: {(m, k, n, prec): (blocks, seconds)} — the
    ``BlockShapeCache`` entry format.
    ``samples``: occupancy evidence (:class:`Sample`).
    ``thresholds``: output of :meth:`calibrate` (empty until calibrated).
    """

    def __init__(self, art_dir: Optional[str] = None):
        self.dir = art_dir or artifact_dir()
        self.blocks: Dict[Tuple[int, int, int, str],
                          Tuple[Tuple[int, int, int], float]] = {}
        self.samples: List[Sample] = []
        self.thresholds: Dict[str, float] = {}

    @property
    def path(self) -> str:
        return os.path.join(self.dir, ARTIFACT_NAME)

    # -- recording ----------------------------------------------------------
    def record_block(self, m: int, k: int, n: int, prec: str,
                     blocks: Sequence[int], seconds: float) -> None:
        key = (int(m), int(k), int(n), str(prec))
        cur = self.blocks.get(key)
        if cur is None or seconds < cur[1]:
            self.blocks[key] = (tuple(int(b) for b in blocks),
                                float(seconds))

    def record_sample(self, precision: str, tiles: int, gflops: float,
                      m: int = 0, k: int = 0, n: int = 0,
                      source: str = "") -> None:
        self.samples.append(Sample(precision=str(precision),
                                   tiles=int(tiles), gflops=float(gflops),
                                   m=int(m), k=int(k), n=int(n),
                                   source=source))

    def ingest_cache(self, cache) -> int:
        """Fold a :class:`BlockShapeCache`'s *measured* entries in (seeded
        entries carry seconds=inf and stay out: the artifact records
        evidence, not priors). Returns how many entries were taken."""
        n = 0
        for (m, k, n_, prec), (blocks, seconds) in cache.entries().items():
            if seconds == float("inf"):
                continue
            self.record_block(m, k, n_, prec, blocks, seconds)
            n += 1
        return n

    def add_records(self, records: Sequence[Any],
                    backend: Optional[str] = None) -> int:
        """Ingest benchmark Records: ``occupancy/{prec}/tiles={t}`` rows
        become samples (``source`` the record's name, with ``@{backend}``
        when the caller names the backend the sweep ran under),
        ``latency/{prec}/{m}x{n}x{k}`` rows become block entries
        (precision-preferred blocks clamped to the shape, matching
        ``execution.seed_cache_from_records``), and
        ``blocksweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}`` rows become block
        entries carrying the tiling that was *actually measured* — the
        per-key min keeps the sweep's winner. Returns rows ingested."""
        from repro_torch.core import execution as ex
        n_in = 0
        for r in records:
            parts = r.name.split("/")
            # blocksweep (GEMM tilings) and pagedsweep (paged flash-decode
            # page geometries) share the shape grammar and the per-key-min
            # block store.
            sweep = ex.parse_blocksweep_name(r.name) \
                or ex.parse_pagedsweep_name(r.name)
            if sweep is not None:
                m, n, k, prec, blocks = sweep
                self.record_block(m, k, n, prec, blocks,
                                  r.us_per_call * 1e-6)
                n_in += 1
            elif len(parts) == 3 and parts[0] == "occupancy":
                d = r.derived
                if "tiles" in d and "gflops" in d:
                    # Store tiles in the advisor's unit — M×N grid tiles
                    # (occupancy_sweep's "tiles" counts M tiles only; its
                    # fixed N adds a ceil(n/128) factor to the fill).
                    if d.get("m") and d.get("n"):
                        tiles = ex.grid_tiles(int(d["m"]), int(d["n"]))
                    else:
                        tiles = int(d["tiles"])
                    self.record_sample(
                        d.get("precision", parts[1]), tiles,
                        float(d["gflops"]), m=int(d.get("m", 0)),
                        k=int(d.get("k", 0)), n=int(d.get("n", 0)),
                        source=r.name if backend is None
                        else f"{r.name}@{backend}")
                    n_in += 1
            elif len(parts) == 3 and parts[0] == "latency":
                prec = parts[1]
                pref = ex.BlockShapeCache.TABLE3_PREFERRED.get(prec)
                if pref is None:
                    continue
                try:
                    m, n, k = (int(v) for v in parts[2].split("x"))
                except ValueError:
                    continue
                blocks = tuple(min(b, d) for b, d in zip(pref, (m, n, k)))
                self.record_block(m, k, n, prec, blocks,
                                  r.us_per_call * 1e-6)
                n_in += 1
        return n_in

    # -- calibration --------------------------------------------------------
    def calibrate(self, n_cores: Optional[int] = None,
                  win_ratio: float = 1.0) -> Dict[str, float]:
        """Re-derive the FP8 occupancy knee from the recorded samples.

        Per tile-count bucket, mean FP8 throughput is compared against the
        bf16 baseline; the knee is the smallest bucket where FP8 reaches
        ``win_ratio`` of bf16. The demotion threshold is the knee
        expressed as grid fill (tiles / cores); adding more samples at or
        above the knee where FP8 wins can only keep or *lower* it (the
        knee is a min over winning buckets), never raise it. Where the
        samples name the backends they were measured under
        (:meth:`backends`), ``thresholds["backend"]`` names them too,
        joined by ``+``: the reference's loader ignores the key.
        """
        n_cores = n_cores or cc.detect_core_count()
        by: Dict[str, Dict[int, List[float]]] = {}
        for s in self.samples:
            by.setdefault(s.precision, {}).setdefault(
                s.tiles, []).append(s.gflops)

        def mean(prec: str, tiles: int) -> Optional[float]:
            vals = by.get(prec, {}).get(tiles)
            return sum(vals) / len(vals) if vals else None

        fp8_tiles = sorted(by.get("fp8", {}))
        winning = []
        comparable = []
        for t in fp8_tiles:
            base = mean(BASELINE_PRECISION, t)
            f8 = mean("fp8", t)
            if base is None or f8 is None or base <= 0:
                continue
            comparable.append(t)
            if f8 >= win_ratio * base:
                winning.append(t)

        thresholds: Dict[str, float] = {"n_cores": float(n_cores),
                                        "samples": float(len(self.samples))}
        if winning:
            knee = min(winning)
            thresholds["knee_tiles"] = float(knee)
            thresholds["demote_below_fill"] = knee / n_cores
            thresholds["fp8_fill_target"] = max(
                cc.OccupancyAdvisor.FP8_TILE_THRESHOLD, knee / n_cores)
        elif comparable:
            # FP8 never won in the measured range: demote everywhere we
            # have evidence for (conservative, still measurement-driven).
            top = max(comparable)
            thresholds["knee_tiles"] = float(top)
            thresholds["demote_below_fill"] = top / n_cores
            thresholds["fp8_fill_target"] = max(
                cc.OccupancyAdvisor.FP8_TILE_THRESHOLD, top / n_cores)
        if self.backends():
            thresholds["backend"] = "+".join(sorted(self.backends()))
        self.thresholds = thresholds
        return thresholds

    def backends(self) -> set:
        """The backends the samples were measured under, as
        :meth:`add_records` tags them; untagged samples (the reference's)
        name none."""
        return {s.source.rpartition("@")[2] for s in self.samples
                if "@" in s.source}

    def backend_note(self, backend: str) -> Optional[str]:
        """Why this artifact's knee does not hold for policies resolved
        under ``backend``, or None: a knee measured under another backend
        is another GEMM's (the ``torch`` backend upcasts to f32; ``hopper``
        runs kernel A)."""
        cal = self.thresholds.get("backend")
        if cal is None or cal == backend:
            return None
        return (f"autotune artifact calibrated under backend {cal!r}; "
                f"policies here resolve under {backend!r}, whose FP8 knee "
                "it did not measure (calibrate with launch/profile.py "
                f"--backend {backend})")

    def make_advisor(self, n_cores: Optional[int] = None
                     ) -> cc.OccupancyAdvisor:
        """An :class:`OccupancyAdvisor` running on the calibrated
        thresholds (falls back to the Table-3 defaults for anything not
        measured). ``calibrated`` is claimed only when a knee was actually
        derived — a store without comparable fp8/bf16 evidence hands back
        a prior-threshold advisor that says so."""
        thr = self.thresholds
        return cc.OccupancyAdvisor(
            n_cores=n_cores if n_cores is not None else (
                int(thr["n_cores"]) if "n_cores" in thr else None),
            fp8_fill_target=thr.get("fp8_fill_target"),
            demote_below_fill=thr.get("demote_below_fill"),
            calibrated=thr.get("demote_below_fill") is not None)

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "blocks": [{"m": m, "k": k, "n": n, "prec": prec,
                        "blocks": list(blocks), "seconds": seconds}
                       for (m, k, n, prec), (blocks, seconds)
                       in sorted(self.blocks.items())],
            "samples": [s.to_dict() for s in self.samples],
            "thresholds": self.thresholds,
        }

    def save(self) -> str:
        os.makedirs(self.dir, exist_ok=True)
        _atomic_write(self.path, json.dumps(self.to_dict(), indent=1))
        return self.path

    def load(self) -> bool:
        """Merge the on-disk artifact in (keeps anything recorded since
        construction). Returns False when no artifact exists."""
        if not os.path.exists(self.path):
            return False
        with open(self.path) as f:
            data = json.load(f)
        for b in data.get("blocks", ()):
            self.record_block(b["m"], b["k"], b["n"], b["prec"],
                              b["blocks"], b["seconds"])
        for s in data.get("samples", ()):
            self.samples.append(Sample(**s))
        if data.get("thresholds"):
            self.thresholds = dict(data["thresholds"])
        return True

    def reset(self) -> None:
        self.blocks.clear()
        self.samples.clear()
        self.thresholds.clear()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # -- application --------------------------------------------------------
    def apply(self, cache=None) -> int:
        """Fold the stored block entries into a :class:`BlockShapeCache`
        (the global ``BLOCK_CACHE`` by default); returns entries applied."""
        from repro_torch.core import execution as ex
        cache = cache if cache is not None else ex.BLOCK_CACHE
        n = 0
        for (m, k, n_, prec), (blocks, seconds) in self.blocks.items():
            cache.record(m, k, n_, prec, blocks, seconds)
            n += 1
        return n


def install(store: Optional[AutotuneStore] = None,
            art_dir: Optional[str] = None) -> Optional[AutotuneStore]:
    """Close the loop for this process: load the persisted artifact, seed
    the global ``BLOCK_CACHE`` with its measured block entries, and make
    the calibrated advisor the ``resolve_policy`` default. Returns the
    store, or None when no artifact exists (nothing installed)."""
    from repro_torch.core import execution as ex
    if store is None:
        store = AutotuneStore(art_dir)
        if not store.load():
            return None
    store.apply()
    if store.thresholds.get("demote_below_fill") is not None:
        ex.set_default_advisor(store.make_advisor())
    return store
