"""The correctness check: a sound run passes it, the control and a run
with the timed path broken underneath fail it. Each drives the whole
harness but its look for a card, on the CPU at the small stand-ins, each
under limits set from its own readings (two layers at width 128 read gaps
unlike the cells')."""
import json
from pathlib import Path

import pytest
import torch

import small
from perfbench.harness import bench

BENCH = Path(__file__).parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NUMBERS = {"serve_closed": {"widest_gap"},
           "train": {"loss_gap", "grad_norm_gap", "change_norm_gap"}}
CPU = torch.device("cpu")


def serve(fault=None, control=False, seed=31):
    conf = small.DENSE
    if control:
        conf = dict(conf, policy=conf["control_policy"])
    ctx = small.ctx("chameleon-34b.chat", seed, 4.0, CPU, conf,
                    small.mix("chat", **small.CHAT),
                    small.CHAT_LIMITS, fault=fault)
    return bench.drive(ctx)


def train(which, fault=None, control=False, seed=41):
    cell = "granite-moe-3b-a800m.train" if which == "moe" \
        else "chameleon-34b.train"
    conf = small.MOE if which == "moe" else dict(small.DENSE,
                                                   input="embeddings")
    if control:
        conf = dict(conf, policy=conf["control_policy"])
    ctx = small.ctx(cell, seed, 0.5, CPU, conf,
                    small.mix("train", **small.TRAIN),
                    small.TRAIN_LIMITS[which], fault=fault)
    return bench.drive(ctx)


def test_sound_serving_passes():
    out = serve()
    assert out["correct"], out["checks"]
    assert out["e2e"]["output_tok_s"] > 0


@pytest.mark.parametrize("fault", ["token", "state"])
def test_broken_serving_fails(fault):
    out = serve(fault)
    assert not out["correct"], out["checks"]


def test_serving_control_fails():
    sound = serve()["checks"]
    out = serve(control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["widest_gap"]["value"] \
        > sound["widest_gap"]["value"]


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_sound_training_passes(which):
    out = train(which)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


@pytest.mark.parametrize("which,fault", [
    ("dense", "unchanged"), ("dense", "half"),
    ("moe", "unchanged"), ("moe", "half")])
def test_broken_training_fails(which, fault):
    out = train(which, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_training_control_reads_above_the_program(which):
    sound = train(which)["checks"]
    ctl = train(which, control=True)["checks"]
    assert any(ctl[k]["value"] > sound[k]["value"] for k in sound)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_limits_on_its_numbers(cell):
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json")
                        .read_text())
    kind = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                      .read_text())["kind"]
    assert limits and set(limits) <= NUMBERS[kind]
    assert all(v > 0 for v in limits.values())
