"""One run of one cell: find its files by name, set up, measure, check,
print one result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
configuration is ``perfbench/configs/<config>.json``, the mix
``perfbench/traffic/<traffic>.json`` (its ``kind`` names the driver,
``perfbench/drivers/<kind>.py``), the limits of the correctness check
``perfbench/limits/<cell>.json``, and each per-layer metric
``perfbench/metrics/<metric>.py``. A new cell of an existing configuration
and mix needs only its entry in ``BENCHMARK.json`` and its limits file.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the port's field for each key of a configuration file
ARCH_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "intermediate_size": "d_ff", "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "vocab_size": "vocab_size", "rope_theta": "rope_theta",
             "rms_norm_eps": "norm_eps", "num_local_experts": "num_experts",
             "num_experts_per_tok": "experts_top_k"}


def process_age_s() -> float:
    """Seconds since this process started (its start time in clock ticks
    after boot, from ``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into ``build/repro_torch_kernels``)."""
    base = ROOT / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that this benchmark must never
    load, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    """``perfbench/metrics/<name>.py`` as a module."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, section: str, cell: str) -> list:
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def arch_config(conf: dict, cfg=None):
    """The port's ArchConfig for a configuration file: the arch it names
    (or ``cfg``, a test's small preset of it), checked against every size
    the file states, with the file's cuts."""
    from repro_torch.configs import get_arch
    cfg = get_arch(conf["arch"]) if cfg is None else cfg
    for key, field in ARCH_KEYS.items():
        if key in conf and getattr(cfg, field) != conf[key]:
            raise SystemExit(f"{conf['name']}: {key} is {conf[key]} in the "
                             f"file, {getattr(cfg, field)} in the port")
    cuts = {ARCH_KEYS[k]: v["value"] for k, v in conf["reduced"].items()}
    return dataclasses.replace(cfg, **cuts)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, the
    spans and the set-up clock."""
    cell: str
    conf: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    cfg: Any = None
    ref: Any = None
    spans: Any = None
    fault: Optional[str] = None
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                flush=True)
    _mark: float = dataclasses.field(default_factory=time.perf_counter)

    def part(self, name: str) -> None:
        """Close the set-up part ``name`` at this moment."""
        now = time.perf_counter()
        self.setup[name] = self.setup.get(name, 0.0) + now - self._mark
        self._mark = now


def make_ctx(cell: str, seed: int, seconds: float, trace: bool, device,
             spec: Optional[dict] = None, conf: Optional[dict] = None,
             mix: Optional[dict] = None, limits: Optional[dict] = None,
             fault: Optional[str] = None, cfg=None) -> Ctx:
    """The context of one run; ``conf``, ``mix``, ``limits`` and the
    port's ``cfg`` replace the cell's (the tests run small stand-ins on
    the CPU)."""
    from perfbench.harness.trace import Spans
    from perfbench.reference.model import RefCfg
    if conf is None or mix is None:
        spec = benchmark() if spec is None else spec
        entry = cell_entry(spec, cell)
        conf = conf or config_file(spec, entry["config"])
        mix = mix or load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    if limits is None:
        limits = load_json(BENCH / "limits" / f"{cell}.json")
    ctx = Ctx(cell, conf, mix, limits, seed, seconds, trace, device,
              spans=Spans(), fault=fault)
    ctx.cfg = arch_config(conf, cfg)
    ctx.ref = RefCfg.from_config(conf)
    return ctx


def drive(ctx: Ctx) -> dict:
    """Run the mix's driver: the outcome of set-up, window and check."""
    mod = importlib.import_module(f"perfbench.drivers.{ctx.mix['kind']}")
    return mod.run(ctx)


def free_memory() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(args) -> int:
    t_enter = time.perf_counter()
    age0 = process_age_s()
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = benchmark()
    entry = cell_entry(spec, args.workload)
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{entry['chips']} devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    ctx = make_ctx(args.workload, args.seed, float(args.seconds),
                   bool(args.trace), torch.device("cuda", 0), spec=spec)
    ctx.setup["process start"] = age0
    ctx.setup["torch import"] = time.perf_counter() - t_enter
    ctx._mark = time.perf_counter()
    out = drive(ctx)
    found = loaded_forbidden()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    metrics = {}
    if not args.trace:
        for m in metrics_for(spec, "end_to_end", args.workload):
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in metrics_for(spec, "per_layer", args.workload):
            value = metric_reader(m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    stretch = out["record"].get("stretch")
    if args.trace and stretch is not None:
        from perfbench.harness.trace import breakdown, union_s
        device["busy_s"] = union_s((a, b) for _, a, b in stretch["kernels"])
        device["window_s"] = stretch["wall_s"]
        result["breakdown"] = breakdown(stretch)
    ctx.log("setup parts (s): " + json.dumps(out["setup_parts"]))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}"
              f"{'' if c['limit'] is not None else ', not compared'})",
              file=sys.stderr, flush=True)
    result["checks"] = out["checks"]
    print(json.dumps(result), flush=True)
    return 0
