"""Checkpointing: atomic and asynchronous.

Twin of ``repro/checkpoint/manager.py``. Layout per step:
  <dir>/step_<n>.tmp/          — written first
      meta.json                — step, extra (the data cursor), dtype tags
      arr_<i>.npy              — one file per leaf of the state tree
  <dir>/step_<n>/              — atomic rename once fully written

Leaves are saved in the tree's leaf order (``core/tree.leaves``). numpy
has no bf16 or fp8, so those leaves are saved as their raw bits (uint16 /
uint8, the bridge's bit view) with the reference's dtype tag in
``meta.json``; restore views them back, bit for bit. Saves run on a
background thread; the host copies of the leaves are taken first, on the
caller's thread, so a step that updates the state in place (AdamW does)
while the thread writes cannot reach the checkpoint. The manager keeps
the last ``keep`` checkpoints. The
reference also re-lays a restore out onto another mesh; one card has
none, so a restore goes to each template leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import tree

# torch dtype → the reference's dtype tag (its ml_dtypes name)
_TAGS = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
         torch.float8_e5m2: "float8_e5m2"}
_TAG_TYPES = {tag: dt for dt, tag in _TAGS.items()}


def _to_savable(t: torch.Tensor):
    a = bridge.to_numpy_bits(t)
    # a CPU tensor's bit view shares the live tensor's memory; a device
    # tensor's is already a host copy
    return (a.copy() if t.device.type == "cpu" else a), _TAGS.get(t.dtype)


def _from_saved(raw: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    t = torch.from_numpy(np.array(raw, order="C"))   # 0-d stays 0-d
    if tag is None:
        return t
    carrier = torch.int16 if raw.dtype == np.uint16 else torch.uint8
    return t.view(carrier).view(_TAG_TYPES[tag])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = False):
        """Snapshot ``state`` at ``step``. Every leaf is copied to the
        host here; disk IO happens on a thread."""
        self.wait()                     # one in-flight save at a time
        host_leaves = []
        dtype_tags = []
        for leaf in tree.leaves(state):
            a, tag = _to_savable(leaf)
            host_leaves.append(a)
            dtype_tags.append(tag)
        meta = {
            "step": int(step),
            "n_leaves": len(host_leaves),
            "dtype_tags": dtype_tags,
            "extra": extra or {},
            "time": time.time(),
        }

        def work():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, a in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)   # atomic commit
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any):
        """Load ``step`` into the structure of ``target`` (a state tree of
        tensors): each leaf takes its template's shape check, dtype and
        device. Returns (state, extra)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        refs = tree.leaves(target)
        if meta["n_leaves"] != len(refs):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, target has "
                f"{len(refs)} — structure mismatch")
        tags = meta.get("dtype_tags") or [None] * len(refs)
        out = []
        for i, ref in enumerate(refs):
            t = _from_saved(np.load(os.path.join(path, f"arr_{i}.npy")),
                            tags[i])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(t.shape)} != "
                    f"target {tuple(ref.shape)}")
            out.append(t.to(device=ref.device, dtype=ref.dtype))
        it = iter(out)
        return tree.map_tree(lambda _: next(it), target), meta["extra"]

    def restore_latest(self, target: Any):
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, target)
        return step, state, extra
