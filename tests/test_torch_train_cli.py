"""The port's training CLI, data pipeline, checkpoints and fault
tolerance, on the CPU at reduced size.

``launch/train.py`` trains (the loss falls), resumes bit for bit from a
checkpoint (six steps straight equal three, a checkpoint and three more),
and recovers under ``supervise`` from an injected failure; the data
pipeline is the reference's (``SyntheticLM``/``TokenFileDataset`` batches
bit-equal to JAX's); the checkpoint keeps every dtype's bits.
"""
import argparse
import contextlib
import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import tree
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import build_argparser, main, run_once
from repro_torch.runtime import fault_tolerance as tft

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _args(**kw):
    base = build_argparser().parse_args(
        ["--arch", kw.pop("arch", "llama3-8b"), "--reduced", "--device",
         "cpu", "--batch", "2", "--seq", "32", "--log-every", "100"])
    for k, v in kw.items():
        setattr(base, k, v)
    return base


def _final_params(directory):
    """The leaves of the last checkpoint's state, as saved (bits)."""
    ck = CheckpointManager(directory)
    path = os.path.join(directory, f"step_{ck.latest_step()}")
    n = len([f for f in os.listdir(path) if f.endswith(".npy")])
    return [np.load(os.path.join(path, f"arr_{i}.npy")) for i in range(n)]


def test_synthetic_and_file_batches_equal_jax(tmp_path):
    for args in ((512, 32, 4, 0), (50000, 16, 8, 3)):
        j, t = jpipe.SyntheticLM(*args), tpipe.SyntheticLM(*args)
        for step in (0, 1, 7, 1000):
            jb, tb = j.batch_at(step), t.batch_at(step)
            for k in ("inputs", "labels"):
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
    path = tmp_path / "toks.bin"
    np.arange(4000, dtype=np.int32).tofile(path)
    j = jpipe.TokenFileDataset(str(path), 16, 4, vocab_size=1000)
    t = tpipe.TokenFileDataset(str(path), 16, 4, vocab_size=1000)
    for step in (0, 5, 70):
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(j.batch_at(step)[k],
                                          t.batch_at(step)[k])
    pf = tpipe.Prefetcher(tpipe.SyntheticLM(512, 8, 2), depth=2)
    try:
        first = next(pf)
    finally:
        pf.close()
    np.testing.assert_array_equal(
        first["inputs"], jpipe.SyntheticLM(512, 8, 2).batch_at(0)["inputs"])


def test_step_monitor_flags_as_jax_does():
    durations = [0.1] * 8 + [0.5, 0.1, 0.1, 0.3]
    jm, tm = jft.StepMonitor(), tft.StepMonitor()
    for i, d in enumerate(durations):
        a, b = jm.record(i, d), tm.record(i, d)
        assert (a.is_straggler, a.ewma_s) == (b.is_straggler, b.ewma_s)
    assert any(s.is_straggler for s in tm.history)


def test_checkpoint_round_trip_keeps_bits(tmp_path):
    state = {"bf16": torch.randn(4, 3).to(torch.bfloat16),
             "f32": [torch.randn(5), torch.zeros((), dtype=torch.int32)],
             "e4m3": torch.randn(8).to(torch.float8_e4m3fn),
             "none": None}
    ck = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, state, extra={"data_step": step})
    ck.wait()
    assert ck.all_steps() == [2, 3]
    os.makedirs(tmp_path / "step_9.tmp")             # an unfinished save
    template = tree.map_tree(torch.zeros_like, state)
    step, got, extra = ck.restore_latest(template)
    assert step == 3 and extra == {"data_step": 3} and got["none"] is None
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8) if a.element_size() == 1 else a,
            b.view(torch.uint8) if b.element_size() == 1 else b)
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(3, {"only": torch.zeros(1)})


def test_async_save_keeps_the_state_it_was_given(tmp_path, monkeypatch):
    """A save returns before its thread writes; an in-place update made
    meanwhile (AdamW's, on the next step) must not reach the checkpoint.
    The thread is held until the update is done."""
    release = threading.Event()
    np_save = np.save

    def held_save(*a, **k):
        release.wait(30)
        return np_save(*a, **k)
    monkeypatch.setattr(ckpt_manager.np, "save", held_save)
    state = {"bf16": torch.ones(4, 3, dtype=torch.bfloat16),
             "f32": torch.ones(5), "e5m2": torch.ones(8).to(
                 torch.float8_e5m2)}
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state)
    for leaf in state.values():
        leaf.copy_(torch.full(leaf.shape, 2.0))
    release.set()
    ck.wait()
    _, got, _ = ck.restore_latest(tree.map_tree(torch.zeros_like, state))
    for name, leaf in got.items():
        assert bool((leaf.float() == 1.0).all()), name


def test_train_loss_decreases():
    """Synthetic random tokens at lr 1e-3: the CE falls (JAX's
    ``test_train_loss_decreases``), through the CLI."""
    losses = []
    args = _args(steps=30, batch=4, seq=64, lr=1e-3, total_steps=1000,
                 log_every=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_once(args) == 0
    for line in buf.getvalue().splitlines():
        if line.startswith("[train] step="):
            losses.append(float(line.split("loss=")[1].split()[0]))
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Six steps straight == three, a checkpoint, three more resumed."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    assert run_once(_args(steps=6, checkpoint_dir=d1,
                          checkpoint_every=100)) == 0
    assert run_once(_args(steps=3, checkpoint_dir=d2,
                          checkpoint_every=100)) == 0
    assert run_once(_args(steps=6, checkpoint_dir=d2, resume=True,
                          checkpoint_every=100)) == 0
    a, b = _final_params(d1), _final_params(d2)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_resume_from_a_periodic_checkpoint_is_bitwise(tmp_path):
    """A run that saves every two steps and crashes at step 4 resumes from
    its last periodic checkpoint (the state after batch 2, labelled 3) and
    ends bit-equal to six steps straight: no batch runs twice."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    assert run_once(_args(steps=6, checkpoint_dir=d1,
                          checkpoint_every=100)) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        run_once(_args(steps=6, checkpoint_dir=d2, checkpoint_every=2,
                       fail_at_step=4))
    assert CheckpointManager(d2).all_steps() == [3]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_once(_args(steps=6, checkpoint_dir=d2, resume=True,
                              checkpoint_every=2)) == 0
    assert "[train] resumed from step 3" in buf.getvalue()
    a, b = _final_params(d1), _final_params(d2)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_supervised_restart_after_injected_failure(tmp_path):
    args = _args(steps=8, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=3)
    attempts = []

    def attempt():
        a = argparse.Namespace(**vars(args))
        a.resume = len(attempts) > 0
        a.fail_at_step = 0 if attempts else 5
        attempts.append(1)
        try:
            return run_once(a)
        except RuntimeError:
            return 1
    assert tft.supervise(attempt, max_restarts=2, backoff_s=0.0,
                         log=lambda *a: None) == 0
    assert len(attempts) == 2
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 8
    # the CLI's own --supervise path recovers too (the reference's
    # re-injects the failure on every attempt, ROADMAP §3)
    ck2 = str(tmp_path / "ck2")
    assert main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                 "--steps", "5", "--batch", "2", "--seq", "32",
                 "--checkpoint-dir", ck2, "--checkpoint-every", "2",
                 "--fail-at-step", "3", "--supervise", "--max-restarts",
                 "1", "--log-every", "100"]) == 0
    assert CheckpointManager(ck2).latest_step() == 5


def test_cli_runs_on_cpu_and_refuses_without_a_device():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3-8b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32"]
    ok = subprocess.run(base + ["--device", "cpu", "--log-every", "1"],
                        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.count("[train] step=") == 3
    assert "[train] done: 3 steps" in ok.stdout
    if not torch.cuda.is_available():
        bad = subprocess.run(base, env=env, capture_output=True, text=True,
                             timeout=120)
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr
