"""Token data pipeline: synthetic + file-backed, sharded, prefetching.

A copy of ``repro/data/pipeline.py`` (numpy only): the same seed gives the
same batches, bit for bit, in both packages.

Production requirements covered:
* deterministic, seekable cursor (part of the checkpoint -> exact restart)
* per-host sharding (`host_id`/`host_count`) for multi-host launches
* background prefetch thread keeping `depth` batches in flight
* next-token LM batches: {"inputs": (B, S) int32, "labels": (B, S) int32}
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataCursor:
    """Checkpointable pipeline position."""
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @staticmethod
    def from_dict(d):
        return DataCursor(step=int(d["step"]))


class SyntheticLM:
    """Deterministic synthetic token stream (counter-based PRNG: batch i is
    always the same regardless of order -> bitwise-reproducible restarts)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, host_count: int = 1):
        assert global_batch % host_count == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_id = host_id
        self.cursor = DataCursor()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Philox(key=self.seed + (step << 16) + self.host_id)
        gen = np.random.Generator(rng)
        toks = gen.integers(0, self.vocab,
                            size=(self.local_batch, self.seq + 1),
                            dtype=np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.cursor.step)
            self.cursor.step += 1
            yield b


class TokenFileDataset:
    """Flat binary token file (int32/uint16), strided into sequences.

    The file is memory-mapped; batch n is a deterministic function of the
    cursor, so restart-from-checkpoint replays exactly.
    """

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.int32, host_id: int = 0, host_count: int = 1,
                 vocab_size: Optional[int] = None):
        assert global_batch % host_count == 0
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.global_batch = global_batch
        self.host_id = host_id
        self.vocab = vocab_size
        self.n_seqs = (len(self.tokens) - 1) // seq_len
        if self.n_seqs < global_batch:
            raise ValueError(
                f"{path}: only {self.n_seqs} sequences of len {seq_len}; "
                f"need >= {global_batch}")
        self.cursor = DataCursor()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        out_in = np.empty((self.local_batch, self.seq), np.int32)
        out_lb = np.empty((self.local_batch, self.seq), np.int32)
        base = step * self.global_batch + self.host_id * self.local_batch
        for i in range(self.local_batch):
            s = ((base + i) % self.n_seqs) * self.seq
            chunk = self.tokens[s:s + self.seq + 1].astype(np.int32)
            out_in[i] = chunk[:-1]
            out_lb[i] = chunk[1:]
        if self.vocab:
            np.clip(out_in, 0, self.vocab - 1, out=out_in)
            np.clip(out_lb, 0, self.vocab - 1, out=out_lb)
        return {"inputs": out_in, "labels": out_lb}

    def __iter__(self):
        while True:
            b = self.batch_at(self.cursor.step)
            self.cursor.step += 1
            yield b


class Prefetcher:
    """Background-thread prefetch of `depth` batches ahead."""

    def __init__(self, dataset, depth: int = 2, put_fn=None):
        self.dataset = dataset
        self.depth = depth
        self.put_fn = put_fn or (lambda x: x)   # e.g. device_put w/ shardings
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        it = iter(self.dataset)
        while not self._stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                self._q.put(None)
                return
            self._q.put(self.put_fn(batch))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
