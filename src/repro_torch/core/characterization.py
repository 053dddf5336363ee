"""Execution-centric microbenchmark engine (paper §4–§7 methodology).

Twin of ``repro/core/characterization.py``: each sweep isolates one
execution behaviour with minimal kernels, warm-up, repetition and
controlled scaling, and returns :class:`Record` rows whose names and
``derived`` keys are the reference's, so the autotune store
(:mod:`repro_torch.core.autotune`) ingests them alike.

Sweeps:
  occupancy_sweep   — Fig 2: throughput vs grid parallelism per precision
  shape_sweep       — Fig 3: throughput vs aspect ratio at fixed FLOPs
  latency_probe     — Table 3: dependency-chained per-tile-shape latency
  block_sweep_probe — Table 3 extension: alternative tilings per shape
  contention_sweep  — Fig 6–8: per-stream dilation vs stream count/size

Every GEMM goes through :func:`repro_torch.core.execution.raw_matmul` (or
``execution.matmul`` for the block sweep) under the module default
backend, so ``execution.set_default_backend("hopper")`` sends every sweep
to kernel A on the card. Kernel A takes bf16 and fp8 operands only: an
``fp32`` point raises there (the ``torch`` backend, the default, runs it).
The ``torch`` backend upcasts to f32 and does not use the tensor cores,
so its curve is not the card's bf16/fp8 yardstick.

Each sweep takes ``device`` (the card unless the caller names another)
and a ``seed`` for the :class:`torch.Generator` its operands come from.
Operand values differ from the reference's; only times depend on them.
On the CPU :func:`_time_fn` times a loop on the host clock, as the
reference does; on the card it times the device (see there). Sweep points
reuse their operands, so they are L2-warm.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import concurrency as cc

PRECISIONS: Dict[str, Any] = {
    "fp8": torch.float8_e4m3fn,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp32": torch.float32,
}

# Calls of a timed function made by _time_fn since the last reset, warm-up
# included (chip_smoke.py holds the kernel launch counters to it).
CALLS = 0

# The device timer's first sleep: GPU cycles per microsecond of host issue
# time it must cover (the H100's SM clock peaks near 2 GHz), times a margin
# of two; doubled on each failed try, up to this many tries.
_CYCLES_PER_US = 2000
_SLEEP_TRIES = 6


@dataclasses.dataclass
class Record:
    name: str
    us_per_call: float
    derived: Dict[str, Any]

    def csv(self) -> str:
        extra = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us_per_call:.2f},{extra}"


def _call(fn: Callable, args) -> Any:
    global CALLS
    CALLS += 1
    return fn(*args)


def _device_s(fn: Callable, args, iters: int, device: torch.device) -> float:
    """Seconds of device time per call of ``fn(*args)`` on the card.

    A CUDA-event pair around a loop of calls times the host's issue of
    the calls as well whenever the device runs them faster than the host
    issues them. So the events are queued behind a ``torch.cuda._sleep``
    long enough to cover the host issue of all ``iters`` calls: the start
    event must still be pending once the end event is recorded, which
    shows the host got ahead and the events bracket queued device work
    only. If it has completed, the sleep is doubled and the loop taken
    again; after :data:`_SLEEP_TRIES` tries this raises."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    _call(fn, args)
    issue_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize(device)
    cycles = int(2 * _CYCLES_PER_US * max(1.0, issue_us) * iters)
    for _ in range(_SLEEP_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            _call(fn, args)
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize(device)
        if ahead:
            return start.elapsed_time(end) * 1e-3 / iters
        cycles *= 2
    raise RuntimeError(
        f"the host issued {iters} calls more slowly than a sleep of "
        f"{cycles // 2} cycles ran on the card: the events would time the "
        "host, not the device")


def _device_of(args) -> torch.device:
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def _time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls: the host
    clock around ``iters`` calls on the CPU, as the reference; the device
    time (:func:`_device_s`) where the operands lie on the card."""
    out = None
    for _ in range(warmup):
        out = _call(fn, args)
    device = _device_of(args)
    if device.type == "cuda":
        return _device_s(fn, args, iters, device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = _call(fn, args)
    del out
    return (time.perf_counter() - t0) / iters


def _lane_s(fn: Callable, args, iters: int, device: torch.device,
            warmup: int = 2) -> float:
    """Mean dispatch→ready seconds of ``fn(*args)`` on one lane, each call
    joined before the next: host issue and device time together, the
    clock of :func:`repro_torch.core.concurrency.characterize_streams`."""
    lane = cc.ExecutionLane("isolated", device=device)
    thunk = lambda: fn(*args)  # noqa: E731
    cc.run_serial([thunk] * warmup, lane)
    return float(np.mean(cc.run_serial([thunk] * iters, lane)))


def _matmul_fn(dtype):
    """GEMM under test, routed through the default execution-policy backend
    (``execution.set_default_backend`` re-targets every sweep through
    here). ``dtype`` is the operands' type, as in the reference."""
    from repro_torch.core import execution

    def f(a, b):
        return execution.raw_matmul(a, b, out_dtype=torch.float32)
    return f


def _mk(shape, dtype, generator: torch.Generator) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * 4).to(dtype) if dtype == torch.float8_e4m3fn \
        else x.to(dtype)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=cc.resolve_device(device)).manual_seed(
        seed)


# ---------------------------------------------------------------------------
# Fig 2 — occupancy (grid parallelism) sweep
# ---------------------------------------------------------------------------

def occupancy_sweep(tile_counts: Sequence[int] = (1, 2, 4, 8, 16, 32),
                    tile_m: int = 128, k: int = 256, n: int = 256,
                    precisions: Sequence[str] = ("fp32", "bf16", "fp8"),
                    iters: int = 5, *, device=None,
                    seed: int = 0) -> List[Record]:
    """Throughput vs #tiles: M = tiles × tile_m at fixed (K, N).

    Each ``tile_m``-row M tile is one unit of grid parallelism. Throughput
    is normalized per precision to its own best (exposes the occupancy
    threshold, the paper's Fig 2 signature, independent of the absolute
    peak). Kernel A splits K when the output tiles are few, so on the card
    the blocks that run are not ``tiles``: ``gemm_plan.plan`` says which.
    """
    gen = _generator(device, seed)
    out: List[Record] = []
    for prec in precisions:
        dtype = PRECISIONS[prec]
        raw: List[Tuple[int, float]] = []
        for t in tile_counts:
            m = t * tile_m
            a, b = _mk((m, k), dtype, gen), _mk((k, n), dtype, gen)
            dt = _time_fn(_matmul_fn(dtype), a, b, iters=iters)
            flops = 2.0 * m * k * n
            raw.append((t, flops / dt))
        best = max(r[1] for r in raw)
        for t, gf in raw:
            out.append(Record(
                name=f"occupancy/{prec}/tiles={t}",
                us_per_call=2.0 * t * tile_m * k * n / gf * 1e6,
                derived={"gflops": round(gf / 1e9, 2),
                         "norm_to_best": round(gf / best, 4),
                         "tiles": t, "precision": prec,
                         # the full GEMM shape: the autotune store turns
                         # M-tile counts into the advisor's M×N grid tiles
                         "m": t * tile_m, "k": k, "n": n}))
    return out


def occupancy_threshold(records: List[Record], frac: float = 0.9
                        ) -> Dict[str, int]:
    """Smallest tile count reaching ``frac`` of best throughput, per
    precision — the paper's '256+ wavefronts' statistic."""
    by_prec: Dict[str, List[Tuple[int, float]]] = {}
    for r in records:
        p = r.derived["precision"]
        by_prec.setdefault(p, []).append(
            (r.derived["tiles"], r.derived["norm_to_best"]))
    out = {}
    for p, pts in by_prec.items():
        pts.sort()
        out[p] = next((t for t, v in pts if v >= frac), pts[-1][0])
    return out


# ---------------------------------------------------------------------------
# Fig 3 — aspect-ratio (shape) sweep at fixed total work
# ---------------------------------------------------------------------------

def shape_sweep(total_mn: int = 512 * 512, k: int = 256,
                ratios: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0),
                precisions: Sequence[str] = ("fp32", "bf16", "fp8"),
                iters: int = 5, *, device=None,
                seed: int = 0) -> List[Record]:
    """Fixed M·N (total work), vary M/N. 128-alignment preserved."""
    gen = _generator(device, seed)
    out: List[Record] = []
    for prec in precisions:
        dtype = PRECISIONS[prec]
        for r in ratios:
            m = int(round((total_mn * r) ** 0.5 / 128)) * 128
            m = max(m, 128)
            n = max(total_mn // m // 128 * 128, 128)
            a, b = _mk((m, k), dtype, gen), _mk((k, n), dtype, gen)
            dt = _time_fn(_matmul_fn(dtype), a, b, iters=iters)
            gf = 2.0 * m * k * n / dt / 1e9
            out.append(Record(
                name=f"shape/{prec}/ratio={r}",
                us_per_call=dt * 1e6,
                derived={"gflops": round(gf, 2), "m": m, "n": n,
                         "ratio": r, "precision": prec}))
    return out


# ---------------------------------------------------------------------------
# Table 3 — dependency-chained tile latency
# ---------------------------------------------------------------------------

def latency_probe(tile_shapes: Sequence[Tuple[int, int, int]] = (
        (128, 128, 128), (256, 256, 128), (128, 128, 256),
        (256, 256, 256), (512, 512, 128)),
        precisions: Sequence[str] = ("fp32", "bf16", "fp8"),
        chain: int = 16, iters: int = 5, *, device=None,
        seed: int = 0) -> List[Record]:
    """Chained matmuls (output feeds the next input) isolate per-tile-shape
    issue latency, the paper's Table-3 methodology. Each link is one GEMM
    and its renormalize-and-recast."""
    from repro_torch.core import execution
    gen = _generator(device, seed)
    out: List[Record] = []
    for prec in precisions:
        dtype = PRECISIONS[prec]
        for (m, n, k) in tile_shapes:

            def chained(a, b, k=k, dtype=dtype):
                x = a
                for _ in range(chain):
                    y = execution.raw_matmul(x, b, out_dtype=torch.float32)
                    # renormalize + recast: keeps the chain stable and the
                    # dependency real
                    x = (y / float(k)).to(dtype)[:, :k]
                return x

            a = _mk((m, k), dtype, gen)
            b = _mk((k, max(n, k)), dtype, gen)
            dt = _time_fn(chained, a, b, iters=iters)
            out.append(Record(
                name=f"latency/{prec}/{m}x{n}x{k}",
                us_per_call=dt / chain * 1e6,
                derived={"per_tile_us": round(dt / chain * 1e6, 2),
                         "tile": f"{m}x{n}x{k}", "precision": prec}))
    return out


# ---------------------------------------------------------------------------
# Table 3 extension — block-shape sweep (alternative tilings per shape)
# ---------------------------------------------------------------------------

def block_candidates(m: int, n: int, k: int, precision: str,
                     max_candidates: int = 3
                     ) -> List[Tuple[int, int, int]]:
    """2–3 alternative (bm, bn, bk) tilings for one (m, n, k) GEMM: the
    precision-preferred Table-3 blocks, the square 128 tile, and the
    single-block (whole-problem) tiling — each clamped to the problem,
    deduplicated, in a fixed order."""
    from repro_torch.core import execution as ex
    pref = ex.BlockShapeCache.TABLE3_PREFERRED.get(
        precision, (128, 128, 128))
    raw = [pref, (128, 128, 128), (m, n, k)]
    out: List[Tuple[int, int, int]] = []
    for bm, bn, bk in raw:
        cand = (min(bm, m), min(bn, n), min(bk, k))
        if cand not in out:
            out.append(cand)
    return out[:max_candidates]


def block_sweep_probe(shapes: Sequence[Tuple[int, int, int]] = (
        (256, 256, 256), (128, 256, 512)),
        precisions: Sequence[str] = ("bf16", "fp8"),
        backend: str = "hopper", iters: int = 3, *, device=None,
        seed: int = 0) -> List[Record]:
    """Time each shape under alternative block tilings, through
    ``execution.matmul`` with the blocks pinned on an explicit policy.
    Record names are ``blocksweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}``, the
    format the autotune store ingests as block evidence (its per-key min
    keeps the winner); the fastest tiling per (shape, precision) is
    flagged ``winner=True``. ``backend`` may be a JAX name and is recorded
    as given.

    Under ``hopper`` this is an A/A test: kernel A drops the blocks and
    runs one ``gemm_plan`` plan for every candidate, so the candidates
    compute the same bits, the spread of their times is the timer's noise
    floor, and the ``winner`` is noise. The records still ingest exactly
    as the reference's do."""
    from repro_torch.core import execution as ex
    bad = set(precisions) - set(ex.PRECISIONS)
    if bad:
        # a silent fallback would mislabel another precision's latency
        # as block evidence for this one in the autotune artifact
        raise ValueError(f"block_sweep_probe precisions {sorted(bad)} not "
                         f"in policy precisions {ex.PRECISIONS}")
    gen = _generator(device, seed)
    be = ex.BACKEND_ALIASES.get(backend, backend)
    out: List[Record] = []
    for prec in precisions:
        for (m, n, k) in shapes:
            x = _mk((m, k), torch.bfloat16, gen)
            w = _mk((k, n), torch.bfloat16, gen)
            group: List[Record] = []
            for (bm, bn, bk) in block_candidates(m, n, k, prec):
                pol = ex.ExecutionPolicy(
                    precision=prec, backend=be,
                    block_m=bm, block_n=bn, block_k=bk)
                dt = _time_fn(lambda a, b, pol=pol: ex.matmul(
                    a, b, pol, out_dtype=torch.float32), x, w, iters=iters)
                group.append(Record(
                    name=f"blocksweep/{prec}/{m}x{n}x{k}/{bm}x{bn}x{bk}",
                    us_per_call=dt * 1e6,
                    derived={"m": m, "n": n, "k": k, "precision": prec,
                             "blocks": f"{bm}x{bn}x{bk}",
                             "backend": backend, "winner": False}))
            best = min(group, key=lambda r: r.us_per_call)
            best.derived["winner"] = True
            out.extend(group)
    return out


# ---------------------------------------------------------------------------
# Fig 6–8 — contention sweep (stream count × working-set size)
# ---------------------------------------------------------------------------

def contention_sweep(sizes: Dict[str, int] = None,
                     stream_counts: Sequence[int] = (1, 2, 4),
                     iters: int = 3, *, device=None,
                     seed: int = 0) -> List[Record]:
    """Per-stream dilation under concurrency for thin/medium/thick kernels.

    The paper reads L2-miss counters; without hardware counters the
    dilation (concurrent time / isolated time) is the observable its Fig 8
    reports. Both times are read on one clock: the isolated time is the
    mean dispatch→ready time of the GEMM on a lane of its own
    (:func:`_lane_s`), the clock of ``characterize_streams``' per-stream
    times, so one stream reads a dilation near 1. (:func:`_time_fn`'s
    device time would leave out the host issue the numerator holds.) The
    operands are f32, as in the reference, so under ``hopper`` on the
    card this raises (kernel A takes no f32).
    """
    sizes = sizes or {"thin": 128, "medium": 256, "thick": 512}
    dev = cc.resolve_device(device)
    gen = _generator(dev, seed)
    out: List[Record] = []
    for label, s in sizes.items():
        dtype = torch.float32
        fn = _matmul_fn(dtype)
        a, b = _mk((s, s), dtype, gen), _mk((s, s), dtype, gen)
        iso = _lane_s(fn, (a, b), iters, dev)
        for ns in stream_counts:
            operands = [_mk((s, s), dtype, gen) for _ in range(ns)]

            def mk(i):
                ai = operands[i]
                return lambda: fn(ai, b)
            rep = cc.characterize_streams(mk, ns, mode="async", device=dev)
            dilation = (np.mean(rep.per_stream_s) / iso) if iso else 0.0
            out.append(Record(
                name=f"contention/{label}/streams={ns}",
                us_per_call=float(np.mean(rep.per_stream_s)) * 1e6,
                derived={"dilation": round(float(dilation), 3),
                         "fairness": round(rep.fairness, 4),
                         "cv": round(rep.cv, 4),
                         "overlap_eff": round(rep.overlap_efficiency, 4),
                         "size": s, "streams": ns}))
    return out
