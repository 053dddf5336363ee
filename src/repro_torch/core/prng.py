"""The port's copy of the part of ``jax.random`` that serving draws from.

``jax.random`` with its default ``threefry2x32`` implementation and
``jax_threefry_partitionable`` on (as JAX 0.9 runs it by default) is a
counter-based generator made of 32-bit adds, rotates and xors, so the same
keys give the same bits here, bit for bit, on any device:

* a key is two uint32 words, kept on the host as a ``(2,)`` numpy uint32
  array, so ``split`` costs no device launch and no synchronisation;
* ``split(key, num)`` hashes the counters ``0 .. num-1`` under the key
  (the fold-like split): row ``i`` is the two output words of counter
  ``i``;
* ``random_bits(key, shape)`` hashes the flat index of every element (a
  64-bit counter split into its high and low words) and xors the two
  output words;
* ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
  1 and scales (bit-equal over unit-wide ranges); ``gumbel`` is
  ``-log(-log(u))`` over ``u`` uniform in ``[tiny, 1)`` (JAX's mode
  "low"); ``categorical`` is the argmax of the logits plus a Gumbel draw
  of their shape.

The bits are made on the requested device (the logits' in sampling), in
int64 words masked to 32 bits after every add and left shift (torch has
no add or shift for ``uint32``). Keys, splits, bits and uniforms equal
JAX's bit for bit; ``gumbel`` differs from JAX's by the gap between
``torch.log`` and XLA's ``log`` (under 1e-6 at these magnitudes), so
``categorical`` returns JAX's index except where the two best perturbed
logits lie that close. Nothing here uses ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "random_bits", "uniform", "gumbel",
           "categorical"]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed: int) -> np.ndarray:
    """The key ``jax.random.PRNGKey(seed)`` gives with 64-bit types off:
    the seed is taken as a 32-bit integer, its high word (0 then) and its
    low word."""
    seed = int(seed)
    if not -2**63 <= seed < 2**64:
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    return np.array([0, seed & _MASK], np.uint32)


def _threefry(k0: int, k1: int, x0, x1):
    """threefry2x32 of the counter words ``x0``, ``x1`` under the key
    words ``k0``, ``k1``: int64 numpy arrays or torch tensors holding
    uint32 values, masked to 32 bits after every add and left shift."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0, x1


def _words(key):
    return tuple(int(w) for w in np.asarray(key, np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``num`` new keys, a (num, 2) uint32 array,
    hashed on the host: row ``i`` is the hash of counter ``i``."""
    count = np.arange(num, dtype=np.int64)
    b0, b1 = _threefry(*_words(key), count >> 32, count & _MASK)
    return np.stack([b0, b1], axis=-1).astype(np.uint32)


def random_bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: uint32 words as int64
    values in ``[0, 2**32)``, made on ``device``: the xor of the two words
    of each element's flat index hashed."""
    shape = tuple(shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = _threefry(*_words(key), count >> 32, count & _MASK)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in ``[1, 2)``, minus 1, times ``maxval - minval`` plus
    ``minval`` (each rounded to f32, the difference too), then at least
    ``minval``. Bit-equal to JAX's where the product is exact (``maxval -
    minval`` 1, as in ``[0, 1)`` and Gumbel's ``[tiny, 1)``); elsewhere
    XLA's CPU rounds the product and the sum once, as a fused
    multiply-add, and the last bit can differ."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    out = floats.sub_(1.0).mul_(float(hi - lo)).add_(float(lo))
    return out.clamp_min_(float(lo))


def gumbel(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low"."""
    u = uniform(key, shape, _F32_TINY, 1.0, device)
    return u.log_().neg_().log_().neg_()


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` over float32 ``logits``: the index of
    the largest of them plus a Gumbel draw of their shape, made on their
    device (the first such index on a tie)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws float32 Gumbel noise; got "
                        f"{logits.dtype} logits")
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g.add_(logits), dim=axis)
