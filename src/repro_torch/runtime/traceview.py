"""Chrome/Perfetto ``trace_event`` export for Tracer event streams.

The observability plane's *visual* surface: any :class:`Tracer` (or a
``Tracer.merge`` fused view — partition tags are preserved, so a full
``ServingRuntime.merged_tracer()`` exports in one call) renders to the
Chrome trace-event JSON format that ``chrome://tracing``, Perfetto UI
(https://ui.perfetto.dev) and ``about:tracing`` all open directly.

Mapping:

* one *process* per partition (``pid = partition + 1``; the
  unpartitioned ``-1`` tag becomes pid 0), one *thread* per execution
  lane within it (``tid 0`` is the partition's control/scheduler track)
  — so the fig21 question "did those two lanes actually overlap?" is
  answered by looking;
* ``decode`` / ``prefill`` / ``matmul`` / ``stream`` events and spans
  (events whose meta holds a ``span`` id) with a measured ``wall_s``
  become complete duration slices (``ph="X"``). Events are recorded at
  *join* time, so a slice starts at ``ev.t - ev.wall_s`` ≈ its dispatch
  — two planner-paired decode steps therefore appear as temporally
  overlapping slices on their two lane tracks, which is the whole point.
  A span's phases take its lane, so they nest under it on its track;
* ``migrate`` handoffs become flow (arrow) events between the source
  and destination partition tracks (the runtime records each phase on
  *both* endpoint tracers, which is exactly what lets one export bind
  the arrow's ends); start/done phases render as instants;
* completed per-tenant requests become async ``b``/``e`` spans keyed by
  request uid (submit→finish wall), grouped under the tenant name;
* ``admit`` / ``paging`` / ``overlap`` events become thread-scoped
  instants carrying their meta as args.

:func:`overlapping_groups` and :func:`migration_flow_pairs` re-read an
exported trace and verify those structural claims — CI asserts the
fig21 artifact through them, and ``tests/test_observability.py`` pins
the geometry.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

# Event kinds that render as duration slices when they carry a measured
# wall time. Recorded at completion/join, so start = t - wall_s.
SLICE_KINDS = ("decode", "prefill", "matmul", "stream")
# Kinds that render as thread-scoped instants.
INSTANT_KINDS = ("admit", "paging", "overlap", "quota", "route")

_ARG_FIELDS = ("m", "k", "n", "precision", "backend", "policy", "stream",
               "tenant", "step", "lane", "overlap_group")


def _pid(partition: int) -> int:
    return int(partition) + 1


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def _args(ev) -> Dict[str, Any]:
    out = {}
    for f in _ARG_FIELDS:
        v = getattr(ev, f)
        if f == "overlap_group":
            if v is not None and v >= 0:     # 0 is a real group id
                out[f] = v
        elif v not in ("", -1, 0, None) or f in ("m", "k", "n"):
            out[f] = v
    for k, v in ev.meta.items():
        if isinstance(v, (int, float, str, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def to_chrome_trace(tracer, *, include_instants: bool = True) -> Dict[str, Any]:
    """Render a Tracer's retained window as a Chrome ``trace_event``
    document (the ``{"traceEvents": [...]}`` object form).

    Timestamps are rebased so the earliest slice start is 0 µs — the
    absolute ``perf_counter`` epoch is meaningless across processes.
    """
    events = tracer.events()
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"note": "empty tracer"}}

    # Rebase: earliest start across everything we will draw.
    t0 = min(min(ev.t - max(ev.wall_s, 0.0) for ev in events),
             min(ev.t for ev in events))

    # Track discovery: pid per partition, tid per lane within it.
    lanes: Dict[int, Dict[str, int]] = {}    # pid -> lane name -> tid
    for ev in events:
        tids = lanes.setdefault(_pid(ev.partition), {"": 0})
        if ev.lane and ev.lane not in tids:
            tids[ev.lane] = 0                # numbered below, sorted
    for pid, tids in lanes.items():
        for i, name in enumerate(sorted(n for n in tids if n)):
            tids[name] = i + 1

    out: List[Dict[str, Any]] = []
    for pid in sorted(lanes):
        pname = f"partition {pid - 1}" if pid > 0 else "unpartitioned"
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": pname}})
        for lname, tid in sorted(lanes[pid].items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"lane {lname}" if lname
                                 else "control"}})

    flow_n = 0
    for ev in events:
        pid = _pid(ev.partition)
        tid = lanes[pid].get(ev.lane, 0)
        if ev.wall_s > 0 and (ev.kind in SLICE_KINDS or "span" in ev.meta):
            name = ev.kind
            if ev.kind in ("decode", "prefill", "matmul") and ev.m:
                name = f"{ev.kind} {ev.m}x{ev.k}x{ev.n}"
            out.append({"ph": "X", "pid": pid, "tid": tid,
                        "ts": _us(ev.t - ev.wall_s - t0),
                        "dur": _us(ev.wall_s),
                        "cat": ev.kind, "name": name, "args": _args(ev)})
        elif ev.kind == "migrate":
            phase = ev.meta.get("phase", "?")
            src, dst = ev.meta.get("src"), ev.meta.get("dst")
            name = f"migrate {ev.tenant} p{src}->p{dst} [{phase}]"
            ts = _us(ev.t - t0)
            out.append({"ph": "i", "pid": pid, "tid": tid, "ts": ts,
                        "s": "t", "cat": "migrate", "name": name,
                        "args": _args(ev)})
            if phase == "handoff":
                # Recorded on both endpoint tracers with identical meta:
                # the source copy opens the arrow, the destination copy
                # closes it, and the shared id binds the two.
                fid = (f"mig:{ev.tenant}:{ev.meta.get('uid', '?')}"
                       f":{src}->{dst}")
                if ev.partition == src:
                    out.append({"ph": "s", "pid": pid, "tid": tid,
                                "ts": ts, "cat": "migrate",
                                "name": "handoff", "id": fid})
                    flow_n += 1
                elif ev.partition == dst:
                    out.append({"ph": "f", "pid": pid, "tid": tid,
                                "ts": ts, "bp": "e", "cat": "migrate",
                                "name": "handoff", "id": fid})
        elif ev.kind == "request" and ev.wall_s > 0:
            span_id = f"req:{ev.meta.get('uid', id(ev))}"
            base = {"pid": pid, "tid": tid, "cat": "request",
                    "name": f"request {ev.tenant}", "id": span_id}
            out.append({**base, "ph": "b", "ts": _us(ev.t - ev.wall_s - t0),
                        "args": _args(ev)})
            out.append({**base, "ph": "e", "ts": _us(ev.t - t0)})
        elif include_instants and ev.kind in INSTANT_KINDS:
            out.append({"ph": "i", "pid": pid, "tid": tid,
                        "ts": _us(ev.t - t0), "s": "t", "cat": ev.kind,
                        "name": ev.kind, "args": _args(ev)})

    counts = tracer.counts(include_dropped=True) \
        if hasattr(tracer, "counts") else {}
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"retained_events": len(events),
                          "flows": flow_n, "counts": counts}}


def export_chrome_trace(tracer, path: str, **kw) -> str:
    """Write :func:`to_chrome_trace` to ``path``; open the file in
    Perfetto UI or ``chrome://tracing`` as-is."""
    doc = to_chrome_trace(tracer, **kw)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# Structural validators (CI + tests re-read exported traces through these)
# ---------------------------------------------------------------------------

def _slices(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def overlapping_groups(doc: Dict[str, Any]) -> Dict[int, bool]:
    """For every ``overlap_group`` id appearing on duration slices:
    ``True`` iff the group renders as ≥2 *temporally overlapping* slices
    on *distinct* (pid, tid) tracks — i.e. the planner pairing actually
    shows up as concurrent execution in the trace."""
    groups: Dict[int, List[Tuple[Tuple[int, int], float, float]]] = {}
    for e in _slices(doc):
        gid = e.get("args", {}).get("overlap_group", -1)
        if gid is None or int(gid) < 0:
            continue
        groups.setdefault(int(gid), []).append(
            ((e["pid"], e["tid"]), float(e["ts"]),
             float(e["ts"]) + float(e["dur"])))
    out: Dict[int, bool] = {}
    for gid, spans in groups.items():
        ok = False
        for i in range(len(spans)):
            for j in range(i + 1, len(spans)):
                (ta, sa, ea), (tb, sb, eb) = spans[i], spans[j]
                if ta != tb and max(sa, sb) < min(ea, eb):
                    ok = True
        out[gid] = ok
    return out


def migration_flow_pairs(doc: Dict[str, Any]) -> List[Tuple[int, int]]:
    """(src_pid, dst_pid) for every migration flow whose start (``s``)
    and finish (``f``) events both exist and share an id — unbound
    arrows don't count."""
    starts: Dict[str, int] = {}
    ends: Dict[str, int] = {}
    for e in doc.get("traceEvents", []):
        if e.get("cat") != "migrate":
            continue
        if e.get("ph") == "s":
            starts[e["id"]] = e["pid"]
        elif e.get("ph") == "f":
            ends[e["id"]] = e["pid"]
    return sorted((starts[i], ends[i]) for i in starts if i in ends)


def validate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """One-call structural summary used by the CI smoke asserts."""
    og = overlapping_groups(doc)
    return {
        "n_events": len(doc.get("traceEvents", [])),
        "n_slices": len(_slices(doc)),
        "overlap_groups": len(og),
        "overlap_groups_overlapping": sum(1 for v in og.values() if v),
        "migration_flows": migration_flow_pairs(doc),
    }


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
