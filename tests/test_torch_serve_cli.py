"""The port's multi-tenant serving CLI and load generator, run as
subprocesses on the CPU (``--device cpu``; without it they need a card).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
BASE = ["--arch", "llama3-8b", "--reduced", "--device", "cpu"]


def _run(module, *args, cwd=None, check=True):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    if check:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def _checksum(stdout):
    (line,) = [ln for ln in stdout.splitlines()
               if ln.startswith("[loadgen] tokens_checksum=")]
    return line.split("=", 1)[1]


def test_serve_multi_partition_runtime_writes_its_artifacts(tmp_path):
    out = _run("repro_torch.launch.serve", *BASE, "--tenants", "3",
               "--partitions", "2", "--migrate", "--slo", "latency:12",
               "--requests", "6", "--max-new", "4",
               "--policy", "bf16:dense:hopper", "--telemetry",
               "--metrics-out", "m.prom", "--trace-out", "t.json",
               "--save-spec", "s.json", cwd=tmp_path).stdout
    assert "[partitioned] 2 partitions (spread)" in out
    assert "[serve] 6/6 requests" in out and "on cpu" in out
    assert "slo[latency:12]=" in out
    assert "repro_" in (tmp_path / "m.prom").read_text()
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["traceEvents"]
    spec = json.loads((tmp_path / "s.json").read_text())
    assert len(spec["partitions"]) == 2 and spec["migration"]["enabled"]
    assert spec["policy"] == "bf16:dense:hopper"
    # the saved spec drives the same run again
    again = _run("repro_torch.launch.serve", *BASE, "--spec", "s.json",
                 "--requests", "6", "--max-new", "4", "--no-overlap",
                 cwd=tmp_path).stdout
    assert "[serve] spec loaded: s.json (2 partitions" in again
    assert "[serve] 6/6 requests, 24 tokens" in again


def test_serve_tenants_on_one_session_use_the_scheduler():
    out = _run("repro_torch.launch.serve", *BASE, "--tenants", "3",
               "--admission", "round_robin", "--policy", "auto",
               "--backend", "pallas", "--requests", "5",
               "--max-new", "3").stdout
    assert "[sched] round_robin/static: 3 tenants" in out
    assert "[serve] policy: bf16:sparse24:hopper streams=4" in out
    assert "[serve] 5/5 requests" in out


def test_loadgen_generate_save_and_replay_agree(tmp_path):
    gen = _run("repro_torch.launch.loadgen", *BASE, "--tenants", "3",
               "--arrival", "bursty", "--steps", "8", "--partitions", "2",
               "--slos", "batch,,latency:20", "--controller",
               "--save-trace", "w.json", cwd=tmp_path).stdout
    assert "[loadgen] trace written: w.json" in gen
    assert "[loadgen] controller: checks" in gen
    rep = _run("repro_torch.launch.loadgen", *BASE, "--replay", "w.json",
               "--partitions", "2", "--no-overlap", cwd=tmp_path).stdout
    assert "[loadgen] trace loaded: w.json" in rep
    assert _checksum(rep) == _checksum(gen)
    served = _run("repro_torch.launch.serve", *BASE, "--workload", "w.json",
                  "--partitions", "2", cwd=tmp_path).stdout
    assert "[serve] workload trace: w.json" in served
    only = _run("repro_torch.launch.loadgen", "--arch", "llama3-8b",
                "--gen-only", "--steps", "4", "--save-trace", "g.json",
                cwd=tmp_path).stdout
    assert "[loadgen] trace written: g.json" in only


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.launch.loadgen"])
def test_clis_need_a_device_on_a_cpu_only_machine(module):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLIs default to it")
    out = _run(module, "--arch", "llama3-8b", "--reduced", "--steps", "2",
               check=False) if module.endswith("loadgen") else \
        _run(module, "--arch", "llama3-8b", "--reduced", check=False)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
