"""Traffic generation: lengths from a mix's own seed, order and tokens from
the run's.

``LengthDist`` is a frozen copy of ``repro_torch/runtime/workload.py``'s
(commit 87e2085): one uniform gate for the long component, then one
integer. A mix draws its lengths once from its own ``length_seed``, so
every run sees the same multiset of sizes; the run's ``--seed`` shuffles
them within consecutive blocks of one request per client (the first
blocks of any two seeds hold the same sizes) and draws every token id.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from perfbench.harness.weights import sub_seed


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Uniform [lo, hi] with probability ``1 - long_frac``, else uniform
    [long_lo, long_hi]."""
    lo: int
    hi: int
    long_lo: int = 0
    long_hi: int = 0
    long_frac: float = 0.0

    def __post_init__(self):
        if self.lo < 1 or self.hi < self.lo:
            raise ValueError(f"LengthDist needs 1 <= lo <= hi, got "
                             f"[{self.lo}, {self.hi}]")
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError(f"long_frac must be in [0, 1], got "
                             f"{self.long_frac}")
        if self.long_frac > 0.0 and (self.long_lo < 1
                                     or self.long_hi < self.long_lo):
            raise ValueError(f"LengthDist long range needs 1 <= long_lo "
                             f"<= long_hi, got [{self.long_lo}, "
                             f"{self.long_hi}]")

    def sample(self, rng: np.random.Generator) -> int:
        if self.long_frac > 0.0 and rng.random() < self.long_frac:
            return int(rng.integers(self.long_lo, self.long_hi + 1))
        return int(rng.integers(self.lo, self.hi + 1))

    @property
    def max(self) -> int:
        return max(self.hi, self.long_hi if self.long_frac else 0)


@dataclasses.dataclass
class Spec:
    """One request as the mix makes it: its place in the order, prompt
    ids and number of output tokens."""
    index: int
    prompt: np.ndarray
    max_new: int


def lengths(mix: Dict[str, Any]) -> List[tuple]:
    """The mix's (prompt, output) lengths, in the order its own seed
    draws them: ``pool`` pairs, the same for every run."""
    rng = np.random.default_rng(mix["length_seed"])
    pd, od = LengthDist(**mix["prompt"]), LengthDist(**mix["output"])
    return [(pd.sample(rng), od.sample(rng)) for _ in range(mix["pool"])]


def requests(mix: Dict[str, Any], seed: int, vocab: int) -> List[Spec]:
    """The run's requests: the mix's lengths shuffled by ``seed`` within
    blocks of ``mix["clients"]``, each prompt's ids uniform over the vocab,
    drawn from ``seed``."""
    pairs = lengths(mix)
    rng = np.random.default_rng(sub_seed(seed, 1))
    block = mix["clients"]
    order = []
    for lo in range(0, len(pairs), block):
        idx = np.arange(lo, min(lo + block, len(pairs)))
        order.extend(rng.permutation(idx).tolist())
    out = []
    for i, j in enumerate(order):
        lp, lo_ = pairs[j]
        ids = rng.integers(0, vocab, size=(lp,), dtype=np.int64)
        out.append(Spec(i, ids.astype(np.int32), lo_))
    return out
