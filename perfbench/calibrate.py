"""Readings that the limits of a cell's correctness check are set from.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--control-seeds 3] [--faults half]

In one process on the card: the program, as the configuration states it,
on every seed (the lower readings); the control, the whole cell with the
configuration's ``control_policy`` in place of its ``policy``, on the
first ``--control-seeds`` of them (the upper readings); each fault
planted under the timed path on as many seeds. Every run prints one JSON
line; the last line sums them up: per number, the largest reading of the
program and the smallest of the control and of each fault.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def drive(cell, seed, seconds, control=False, fault=None):
    """One run's outcome; a run that raises reads infinitely far off (a
    control that crashes has failed and sets no upper reading)."""
    try:
        return _drive(cell, seed, seconds, control, fault)
    except Exception as e:              # noqa: BLE001  (reported, not hidden)
        import traceback
        traceback.print_exc()
        from perfbench.harness import bench
        bench.free_memory()
        return {"checks": {"error": {"value": float("inf")}},
                "e2e": {"error": repr(e)[:300]}}


def _drive(cell, seed, seconds, control, fault):
    import torch
    from perfbench.harness import bench
    ctx = bench.make_ctx(cell, seed, seconds, False, torch.device("cuda", 0),
                         fault=fault)
    if control:
        ctx.conf = dict(ctx.conf, policy=ctx.conf["control_policy"])
    out = bench.drive(ctx)
    bench.free_memory()
    return out


def emit(lines, seed, side, out):
    line = {"seed": seed, "side": side, "e2e": out["e2e"],
            "readings": {k: v["value"] for k, v in out["checks"].items()}}
    print(json.dumps(line), flush=True)
    lines.append(line)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    a = p.parse_args()
    from perfbench.harness import bench
    bench.cache_dirs()
    seeds = [int(s) for s in a.seeds.split(",")]
    lines = []
    for i, seed in enumerate(seeds):
        emit(lines, seed, "program", drive(a.workload, seed, a.seconds))
        if i < a.control_seeds:
            emit(lines, seed, "control",
                 drive(a.workload, seed, a.seconds, control=True))
    for fault in filter(None, a.faults.split(",")):
        for seed in seeds[:a.control_seeds]:
            emit(lines, seed, fault,
                 drive(a.workload, seed, a.seconds, fault=fault))
    summary = {}
    for ln in lines:
        agg = max if ln["side"] == "program" else min
        for k, v in ln["readings"].items():
            key = f"{ln['side']}:{k}"
            summary[key] = v if key not in summary else agg(summary[key], v)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
