"""AdamW with FP32 master weights (bf16 model params) + cosine schedule.

Twin of ``repro/optim/adamw.py``. Model params bf16 → grads bf16/f32 →
update in f32 against master copies → params recast to their dtype. The
state's trees (``mu``, ``nu``, ``master``) have the params' structure.

Unlike the reference's functional update, :func:`apply` updates the
params and the state's tensors in place and returns them: a second copy
of the optimizer state does not fit beside the first on one card at
training width. The arithmetic is the reference's, op for op, in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import tree


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # moments_dtype tree
    nu: Any                  # moments_dtype tree
    master: Any              # f32 tree (master weights)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    # bf16 moments halve the optimizer's memory
    moments_dtype: Any = torch.float32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0.1 of the peak, in f32."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def init(params: Any, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moments_dtype, device=p.device)
    some = tree.leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=tree.map_tree(zeros, params),
        nu=tree.map_tree(zeros, params),
        master=tree.map_tree(
            lambda p: p.detach().to(torch.float32, copy=True), params))


def state_shape(params_shape: Any, cfg: AdamWConfig) -> AdamWState:
    """:func:`init`'s state for a ``meta`` params tree
    (``transformer.params_shape``): shapes and dtypes, no storage."""
    return init(params_shape, cfg)


def global_norm(grads: Any) -> torch.Tensor:
    total = None
    for g in tree.leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply(params: Any, grads: Any, state: AdamWState, cfg: AdamWConfig,
          decay: Any = None):
    """One AdamW step: clip by the global norm, moments, bias correction,
    decoupled weight decay on matrices (``ndim >= 2``) only, or on the
    leaves whose entry in ``decay`` (a tree of bools of the params'
    structure) is true. Writes the new params, moments and masters into
    the given tensors and returns ``(params, new_state, {"grad_norm",
    "lr"})``."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    # an f32 division (``float / tensor`` multiplies by the reciprocal)
    clip = torch.clamp_max(gnorm.new_full((), cfg.grad_clip) / (gnorm + 1e-9),
                           1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(stepf.new_full((), cfg.b1), stepf)
    b2c = 1 - torch.pow(stepf.new_full((), cfg.b2), stepf)

    if decay is None:
        decay = tree.map_tree(lambda p: p.dim() >= 2, params)

    def upd(p, g, mu, nu, master, dec):
        g = g.float() * clip
        mu1 = mu.float().mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu1 = nu.float().mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu1 / b1c).div_(torch.sqrt(nu1 / b2c).add_(cfg.eps))
        if dec:                                      # decay matrices only
            delta.add_(cfg.weight_decay * master)
        master.sub_(lr * delta)
        p.copy_(master)
        mu.copy_(mu1)
        nu.copy_(nu1)

    tree.map_tree(upd, params, grads, state.mu, state.nu, state.master,
                  decay)
    new_state = AdamWState(step=step, mu=state.mu, nu=state.nu,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
