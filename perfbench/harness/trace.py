"""Spans on the host's clock, and the profiler's record of a stretch.

Every run keeps its spans (name, start, end, facts) in memory, by
``time.perf_counter``. A traced run also wraps one short stretch of the
window in ``torch.profiler``, recording the device's activity alone (the
host's own ops unrecorded, so the host runs at nearly its untraced pace).
The stretch opens with a one-cycle ``torch.cuda._sleep`` launched right
after the host's clock is read: its record puts the host's spans on the
device's clock. A stretch whose record of the port's GEMM or attention
kernels falls short of the launches the program counted lost records and
is taken again on a later stretch (the pattern of ``chip_smoke.py``'s
``traced`` and ``kernel_records``, commit 87e2085).
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"     # torch.cuda._sleep's kernel
KERNEL_CLASSES = Path(__file__).resolve().parents[1] / "kernels" \
    / "classes.json"


def kernel_classes() -> Dict[str, Dict[str, List[str]]]:
    """class -> owner ("port" or "library") -> substrings of kernel names,
    from ``perfbench/kernels/classes.json``."""
    return json.loads(KERNEL_CLASSES.read_text())["classes"]


def classify(name: str, classes) -> Tuple[Optional[str], Optional[str]]:
    """(class, owner) of a device record's name; the first class in file
    order that names it, the port's names before the library's."""
    for cls, owners in classes.items():
        for owner in ("port", "library"):
            if any(s in name for s in owners.get(owner, ())):
                return cls, owner
    return None, None


class Spans:
    """The run's spans; those taken while a stretch is profiled say so."""

    def __init__(self):
        self.items: List[dict] = []
        self.profiling = False
        self.traced_s = 0.0   # host time held by profiled stretches

    @contextlib.contextmanager
    def span(self, name: str, **facts):
        rec = {"name": name, "t0": time.perf_counter(),
               "profiled": self.profiling, **facts}
        yield rec
        rec["t1"] = time.perf_counter()
        self.items.append(rec)


def port_launches() -> Dict[str, int]:
    """The program's own launch counters of its GEMM and attention
    kernels."""
    from repro_torch.kernels import (flash_attention, fp8_matmul,
                                     paged_attention, sparse24_matmul)
    return {"gemm": fp8_matmul.LAUNCHES + sparse24_matmul.LAUNCHES
            + sparse24_matmul.BLOCK24_LAUNCHES,
            "attention": flash_attention.LAUNCHES
            + paged_attention.LAUNCHES}


class Stretch:
    """One profiled stretch: start with :meth:`start`, end with
    :meth:`stop`, which reads the record and says whether it is whole."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.before = None
        self.t0 = self.t1 = self.opened = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.opened = time.perf_counter()
        torch.cuda.synchronize()
        self.before = port_launches()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.spans.profiling = True
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1)

    def stop(self) -> Optional[dict]:
        """The stretch's record, or None when it lost device records."""
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.profiling = False
        self.prof.stop()
        after = port_launches()
        launched = {k: after[k] - self.before[k] for k in after}
        marks = [(s["name"], s["t0"], s["t1"]) for s in self.spans.items
                 if s["t0"] >= self.t0]
        events = [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
                  for e in self.prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")]
        self.prof = None
        rec = read_profile(events, launched, self.t0, self.t1, marks)
        if rec is not None:
            rec["host_t0"], rec["host_t1"] = self.t0, self.t1
        self.spans.traced_s += time.perf_counter() - self.opened
        return rec


def read_profile(events, launched: Dict[str, int], host_t0: float,
                 host_t1: float, marks) -> Optional[dict]:
    """The stretch on the device's clock: its device records (name, start
    s, end s), its bounds (from the marker kernel's start, as long as the
    host measured it) and the host's spans moved onto that clock; None
    when the port's kernels have fewer records than ``launched`` says
    they ran."""
    classes = kernel_classes()
    dev = [e for e in events if MARKER not in e[0]]
    starts = [a for n, a, _ in events if MARKER in n] \
        or [a for _, a, _ in events]
    if not dev or not starts:
        return None
    counted = {"gemm": 0, "attention": 0}
    for name, _, _ in dev:
        cls, owner = classify(name, classes)
        if owner == "port" and cls in counted:
            counted[cls] += 1
    if any(counted[k] < launched.get(k, 0) for k in counted):
        return None
    lo = min(starts)
    hi = lo + host_t1 - host_t0
    shift = lo - host_t0
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev
           if b > lo and a < hi]
    return {"t0": lo, "t1": hi, "wall_s": hi - lo, "kernels": dev,
            "marks": [(n, a + shift, b + shift) for n, a, b in marks],
            "launched": launched}


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def class_seconds(stretch: dict, cls: str, owner: Optional[str] = None
                  ) -> float:
    """Device seconds of the stretch's records of class ``cls`` (of one
    owner, or both): the union of their intervals."""
    classes = kernel_classes()
    spans = []
    for name, a, b in stretch["kernels"]:
        c, o = classify(name, classes)
        if c == cls and (owner is None or o == owner):
            spans.append((a, b))
    return union_s(spans)


def short_name(name: str) -> str:
    """A kernel's name without its arguments and template parameters."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    s = s.split(" ")[-1] if " " in s else s
    return s[:90] or name[:90]


def breakdown(stretch: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each labelled by the benchmark span the host was in."""
    per: Dict[str, float] = {}
    for name, a, b in stretch["kernels"]:
        key = short_name(name)
        per[key] = per.get(key, 0.0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    busy, end = [], None
    for a, b in sorted((a, b) for _, a, b in stretch["kernels"]):
        if end is None or a > end:
            busy.append([a, b])
            end = b
        elif b > end:
            busy[-1][1] = end = b
    edges = [stretch["t0"]] + [x for ab in busy for x in ab] \
        + [stretch["t1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    marks = sorted(stretch["marks"], key=lambda m: m[1])

    def label(t):
        inside = [m for m in marks if m[1] <= t < m[2]]
        return inside[-1][0] if inside else "between spans"
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(a), b - a] for a, b in longest]}
