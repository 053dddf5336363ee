"""Gradient compression before the reduction across slow links.

Twin of ``repro/optim/grad_compress.py``:

* ``bf16``     — cast grads to bf16 for the reduction (2× wire bytes).
* ``int8_ef``  — per-tensor symmetric int8 quantization with **error
  feedback**: the quantization residual is carried in the train state and
  added back before the next step's quantization, which keeps SGD unbiased
  in the long run (Seide et al.; 1-bit Adam lineage).

Rounding is half to even, as ``jnp.round``'s (and ``torch.round``'s).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import tree


def compress_bf16(grads: Any) -> Any:
    return tree.map_tree(lambda g: g.to(torch.bfloat16), grads)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, 127.0)     # a true f32 division


def _quant_int8(g: torch.Tensor, scale: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if scale is None:
        scale = _scale(g.abs().amax())
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8_ef(grads: Any, error: Optional[Any],
                     groups: Optional[Any] = None):
    """Returns (quantized_grads_dequantized, new_error): the dequantized
    value enters the optimizer, the f32 residual ``g - dq`` is carried.

    ``groups`` (a tree of the grads' structure with a key per leaf) makes
    the leaves of one key share a scale, the largest amax among them: the
    reference's per-tensor scale spans a stacked leaf, which the port
    keeps as one tensor per layer (``transformer.reference_leaves``).
    Without it each leaf has its own."""
    if error is None:
        error = tree.map_tree(torch.zeros_like, grads)
    g32s = tree.map_tree(lambda g, e: g.float() + e, grads, error)
    scales = None
    if groups is not None:
        amax = {}
        for key, g32 in zip(tree.leaves(groups), tree.leaves(g32s)):
            a = g32.abs().amax()
            amax[key] = a if key not in amax else torch.maximum(amax[key], a)
        scales = tree.map_tree(lambda key: _scale(amax[key]), groups)

    def one(g, g32, scale):
        q, scale = _quant_int8(g32, scale)
        dq = q.float() * scale
        return dq.to(g.dtype), (g32 - dq).float()

    out = tree.map_tree(one, grads, g32s, scales) if scales is not None \
        else tree.map_tree(lambda g, g32: one(g, g32, None), grads, g32s)
    # unzip the pairs: walk ``grads``' structure, whose leaves are out's
    return (tree.map_tree(lambda _, pair: pair[0], grads, out),
            tree.map_tree(lambda _, pair: pair[1], grads, out))


def init_error(params_like: Any) -> Any:
    return tree.map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params_like)
