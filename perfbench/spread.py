"""Run sets of one cell and read the spread that its bounds are set from.

    python3 perfbench/spread.py --workload <cell> --seconds <s> \
        --seeds a,b,c,d,e,f [--sets 2] [--traced x,y,z] --out runs.jsonl

Runs ``perfbench/run.py`` once per seed and set (each run its own
process, the sets one after the other with the same seeds), then once
per traced seed with ``--trace 1``, appending every result line to
``--out``. The summary gives, per end-to-end metric and set, the median
and the spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(cell, seed, seconds, trace):
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    out = {"seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0,
           "stderr_tail": p.stderr[-3000:]}
    if p.returncode == 0 and lines:
        out["result"] = json.loads(lines[-1])
    return out


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def summary(rows):
    sets = {}
    for r in rows:
        if r.get("trace") or "result" not in r:
            continue
        for name, m in r["result"]["metrics"].items():
            sets.setdefault(name, {}).setdefault(r["set"], []).append(
                m["value"])
    out = {}
    for name, by_set in sets.items():
        out[name] = {s: dict(zip(("median", "spread"), spread(v)))
                     for s, v in by_set.items() if len(v) >= 2}
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--traced", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    rows = []
    with open(a.out, "a") as f:
        jobs = [(s, int(seed), 0) for s in range(1, a.sets + 1)
                for seed in a.seeds.split(",")]
        jobs += [(0, int(seed), 1) for seed in a.traced.split(",") if seed]
        for set_no, seed, trace in jobs:
            r = run(a.workload, seed, a.seconds, trace)
            r["set"], r["workload"] = set_no, a.workload
            rows.append(r)
            f.write(json.dumps(r) + "\n")
            f.flush()
            res = r.get("result", {})
            print(json.dumps({"set": set_no, "seed": seed, "trace": trace,
                              "rc": r["rc"], "wall_s": round(r["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "checks": res.get("checks")}), flush=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)


if __name__ == "__main__":
    main()
