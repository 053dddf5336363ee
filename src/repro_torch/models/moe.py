"""Mixture-of-Experts layer: top-k router and grouped capacity dispatch.

Twin of ``repro/models/moe.py``: GShard/Switch-style dispatch over groups
of ``cfg.moe_group_size`` tokens, each expert taking at most ``capacity``
tokens per group, earlier choices first (choice-major, then token order).
The router runs in f32. The expert GEMMs go through
``execution.matmul_experts`` (one launch of kernel A for all experts) when
the policy is fp8 or its backend is a kernel backend, and through the f32
``batched_einsum`` otherwise, as the reference's ``edot`` routes them.

Expert capacity couples the tokens of one group: a token's expert may be
full because of another token. At decode a group is the step's slots, so
one slot's token can change another slot's routing.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.models.layers import (
    DEFAULT_RT, RuntimeCfg, batched_einsum, init_mlp, init_weight,
    shard_tag, swiglu_mlp)


def capacity(cfg: ArchConfig, group_size: int) -> int:
    c = int(math.ceil(group_size * cfg.experts_top_k
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(c, 1)


def _top_k(logits: torch.Tensor, k: int):
    """Softmax gates over the experts, the top-k of each token and their
    gates normalised to sum to 1."""
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return gates, topv, topi


def _aux(gates: torch.Tensor, topi: torch.Tensor, E: int,
         k: int) -> torch.Tensor:
    """Switch load-balance loss: E · mean(fraction routed) · mean(gate),
    normalised by k so perfect balance gives 1.0."""
    frac = F.one_hot(topi, E).float().sum(dim=2).mean(dim=1) / k  # (G, E)
    return (frac * gates.mean(dim=1)).sum(dim=-1).mean() * E


def router_dispatch(logits: torch.Tensor, cfg: ArchConfig, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with capacity. logits (G, gs, E) f32. Returns combine
    (G, gs, E, C) f32 (the normalised gate where routed, else 0), dispatch
    (G, gs, E, C) bool and the load-balance loss."""
    G, gs, E = logits.shape
    k = cfg.experts_top_k
    gates, topv, topi = _top_k(logits, k)
    onehot = F.one_hot(topi, E).float()                        # (G, gs, k, E)
    # position in expert: choice-major, then token order (GShard)
    oh_kt = onehot.transpose(1, 2).reshape(G, k * gs, E)
    pos_flat = torch.cumsum(oh_kt, dim=1) - oh_kt
    pos = pos_flat.reshape(G, k, gs, E).transpose(1, 2)        # (G, gs, k, E)
    in_cap = (pos < cap) & (onehot > 0)
    # capacity slot one-hot; a position at or past cap has none
    slot = (pos[..., None] == torch.arange(
        cap, device=logits.device, dtype=pos.dtype)).float()
    slot = slot * in_cap[..., None]                            # (G,gs,k,E,C)
    dispatch = slot.sum(dim=2) > 0
    combine = (slot * topv[..., None, None] * onehot[..., None]).sum(dim=2)
    return combine.float(), dispatch, _aux(gates, topi, E, k)


def gather_dispatch(logits: torch.Tensor, cfg: ArchConfig, cap: int):
    """The same routing as :func:`router_dispatch` as a sort and a gather:
    returns (token_idx (G, E, C) int64, weight (G, E, C) f32, aux); a slot
    past an expert's count has weight 0."""
    G, gs, E = logits.shape
    k = cfg.experts_top_k
    gates, topv, topi = _top_k(logits, k)
    # flat choices in choice-major priority order: index c * gs + s
    eid = topi.transpose(1, 2).reshape(G, k * gs)
    wgt = topv.transpose(1, 2).reshape(G, k * gs)
    order = torch.argsort(eid, dim=1, stable=True)             # by expert
    counts = F.one_hot(eid, E).sum(dim=1)                      # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(cap, device=logits.device)
    slot_pos = starts[:, :, None] + ar[None, None]             # (G, E, C)
    valid = ar[None, None] < counts[:, :, None]
    slot_pos = torch.clamp(slot_pos, 0, k * gs - 1)
    flat_choice = torch.gather(order, 1, slot_pos.reshape(G, E * cap))
    token_idx = (flat_choice % gs).reshape(G, E, cap)
    weight = torch.gather(wgt, 1, flat_choice).reshape(G, E, cap) * valid
    return token_idx, weight.float(), _aux(gates, topi, E, k)


def _edot(a: torch.Tensor, w: torch.Tensor, pol: ex.ExecutionPolicy,
          rt: RuntimeCfg) -> torch.Tensor:
    """(G, E, C, x) × (E, x, f) → (G, E, C, f). Per expert through the
    registry when the policy is fp8 or its backend a kernel backend (one
    launch of kernel A over the experts, each expert's rows being its
    (G · C, x) block, as the reference's per-expert ``ex.matmul`` sees
    them); otherwise the f32 batched einsum."""
    if pol.precision == "fp8" or pol.backend in ex.KERNEL_BACKENDS:
        G, E, C, x = a.shape
        rows = a.permute(1, 0, 2, 3).reshape(E, G * C, x)
        out = ex.matmul_experts(rows, w, pol, out_dtype=rt.act_dtype)
        return out.reshape(E, G, C, -1).permute(1, 0, 2, 3)
    return batched_einsum("gecx,exf->gecf", a, w, rt)


def moe_mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
            rt: RuntimeCfg = DEFAULT_RT) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x (B, S, d) → (out, aux loss). Expert weights:
    p["w_gate"|"w_up"] (E, d, f), p["w_down"] (E, f, d), p["router"] (d, E)
    f32; an optional p["shared"] dense SwiGLU expert. The B·S tokens form
    groups of ``min(moe_group_size, B·S)``, which must divide them, as in
    the reference."""
    b, s, d = x.shape
    E = cfg.num_experts
    T = b * s
    gs = min(cfg.moe_group_size, T)
    assert T % gs == 0, (T, gs)
    G = T // gs
    cap = capacity(cfg, gs)
    # token groups shard over every mesh axis; the dispatched experts
    # reshard to the expert layout (``runtime/sharding.make_shard_fn``)
    xt = shard_tag(rt, x.reshape(G, gs, d), "moe_tokens")
    logits = torch.einsum("gsd,de->gse", xt.float(), p["router"].float())
    if rt.moe_gather_dispatch:
        token_idx, weight, aux = gather_dispatch(logits, cfg, cap)
        idx = token_idx.reshape(G, E * cap)
        xin = torch.gather(xt, 1, idx[..., None].expand(G, E * cap, d)) \
            .reshape(G, E, cap, d)
    else:
        combine, dispatch, aux = router_dispatch(logits, cfg, cap)
        xin = batched_einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xt, rt)
    xin = shard_tag(rt, xin, "moe_dispatch")

    pol = ex.policy_from(cfg, rt)
    gate = _edot(xin, p["w_gate"], pol, rt)
    up = _edot(xin, p["w_up"], pol, rt)
    hmid = F.silu(gate.float()).to(rt.act_dtype) * up
    down = _edot(hmid, p["w_down"], pol, rt)

    if rt.moe_gather_dispatch:
        contrib = (down.float() * weight[..., None]).reshape(G, E * cap, d)
        out = torch.zeros((G, gs, d), dtype=torch.float32, device=x.device)
        out.scatter_add_(1, idx[..., None].expand(G, E * cap, d), contrib)
        out = out.to(x.dtype)
    else:
        out = batched_einsum("gsec,gecd->gsd", combine, down, rt,
                             out_dtype=x.dtype)
    out = out.reshape(b, s, d)
    if cfg.moe_shared_expert and "shared" in p:
        out = out + swiglu_mlp(x, p["shared"], cfg, rt)
    return out, aux.float()


def init_moe(cfg: ArchConfig, generator=None, device=None,
             dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Router (d, E) in f32, expert stacks in ``dtype`` with the
    reference's scale (fan-in = E, ``layers.init_weight``), and the shared
    expert where the config has one."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(*shape, dt=dtype):
        return init_weight(shape, dt, generator, device)

    p = {"router": w(d, E, dt=torch.float32), "w_gate": w(E, d, f),
         "w_up": w(E, d, f), "w_down": w(E, f, d)}
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(cfg, generator, device, dtype)
    return p
