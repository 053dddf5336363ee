"""Seeded weights, made on the device in a few large draws.

The benchmark, not the program, makes the weights: every drawn leaf of the
program's parameter tree is a view into one flat buffer of its dtype, and
each buffer is filled with standard normals from one generator seeded by
``--seed``, in chunks of ``CHUNK`` elements. Each leaf is then scaled by
``fan_in ** -0.5`` (its input width: ``shape[-2]``; the token table by 1);
norm scales are zeros (the port's norm multiplies by ``1 + gamma``).

:func:`leaf_init` draws the same numbers again, chunk by chunk, so a check
can compare a leaf with its initial value without keeping a copy of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 27          # elements per draw (512 MiB of f32 normals)
ALIGN = 256              # leaf offsets in elements: 512 B for bf16


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[Any, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    scale: float          # 0.0: zeros, not drawn
    offset: int = 0       # into its dtype's buffer


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for ``stream`` under the run's seed
    (which may exceed 32 bits)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def layout(shape_tree) -> List[Leaf]:
    """Every leaf of a (meta) parameter tree with its scale and its offset
    in the flat buffer of its dtype, in the tree's leaf order."""
    out, ends = [], {}
    for path, t in _walk(shape_tree):
        shape = tuple(t.shape)
        if len(shape) == 1:
            scale = 0.0
        elif path[-1] == "embed":
            scale = 1.0
        else:
            scale = float(shape[-2]) ** -0.5
        off = 0
        if scale:
            off = ends.get(t.dtype, 0)
            ends[t.dtype] = off + -(-int(np.prod(shape)) // ALIGN) * ALIGN
        out.append(Leaf(path, shape, t.dtype, scale, off))
    return out


def _sizes(leaves: List[Leaf]) -> Dict[torch.dtype, int]:
    sizes = {}
    for lf in leaves:
        if lf.scale:
            n = -(-int(np.prod(lf.shape)) // ALIGN) * ALIGN
            sizes[lf.dtype] = max(sizes.get(lf.dtype, 0), lf.offset + n)
    return sizes


def _draws(leaves, seed, device) -> Iterator[Tuple[torch.dtype, int,
                                                   torch.Tensor]]:
    """(dtype, start, f32 normals) for every chunk of every buffer, in
    the one order both :func:`make` and :func:`leaf_init` replay."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    for dtype, n in sorted(_sizes(leaves).items(), key=lambda kv: str(kv[0])):
        for start in range(0, n, CHUNK):
            yield dtype, start, torch.randn(min(CHUNK, n - start),
                                            generator=gen, device=device,
                                            dtype=torch.float32)


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None


def make(shape_tree, seed: int, device) -> Tuple[Any, List[Leaf]]:
    """The parameter tree of ``shape_tree``'s structure, drawn from
    ``seed`` on ``device``, and its layout."""
    leaves = layout(shape_tree)
    bufs = {dt: torch.empty(n, dtype=dt, device=device)
            for dt, n in _sizes(leaves).items()}
    for dtype, start, normals in _draws(leaves, seed, device):
        bufs[dtype][start:start + normals.numel()].copy_(normals)
        del normals
    params = _copy_structure(shape_tree)
    for lf in leaves:
        if lf.scale:
            n = int(np.prod(lf.shape))
            view = bufs[lf.dtype][lf.offset:lf.offset + n].view(lf.shape)
            view.mul_(lf.scale)
        else:
            view = torch.zeros(lf.shape, dtype=lf.dtype, device=device)
        _set(params, lf.path, view)
    return params, leaves


def leaf_init(leaves: List[Leaf], seed: int, device,
              visit: Callable[[int, int, torch.Tensor], None]) -> None:
    """Draw ``make``'s numbers again and call ``visit(leaf index, first
    element, values)`` for every part of a drawn leaf that a chunk holds:
    the values equal, bit for bit, what :func:`make` put there (the same
    normals, cast to the leaf's dtype, then scaled in it)."""
    by_dtype: Dict[torch.dtype, List[Tuple[int, Leaf]]] = {}
    for i, lf in enumerate(leaves):
        if lf.scale:
            by_dtype.setdefault(lf.dtype, []).append((i, lf))
    for dtype, start, normals in _draws(leaves, seed, device):
        end = start + normals.numel()
        for i, lf in by_dtype[dtype]:
            n = int(np.prod(lf.shape))
            lo, hi = max(lf.offset, start), min(lf.offset + n, end)
            if lo >= hi:
                continue
            part = normals[lo - start:hi - start].to(dtype).mul_(lf.scale)
            visit(i, lo - lf.offset, part)
        del normals

