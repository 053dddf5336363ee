"""On the card: one short run of a cell through the command the driver
uses, its result line as the contract reads it."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell_runs_and_is_correct(card, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "chameleon-34b.train", "--seed", str(2**33 + 7), "--seconds", "5",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "breakdown" in res
    else:
        assert set(res["metrics"]) == {"train_tok_s", "setup_s"}
