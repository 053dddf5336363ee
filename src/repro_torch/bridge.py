"""Carry weights from the JAX package's parameter tree into the port.

The JAX tree arrives as numpy arrays (``jax.tree.map(np.asarray, params)``).
bf16 and fp8 arrays there are ``ml_dtypes`` types, which torch cannot take,
so they cross as raw bits: bf16 over ``uint16``, e4m3/e5m2 over ``uint8``,
then a ``view`` to the torch type. The dtype is recognised by name, so the
port needs no ``ml_dtypes``. Every value arrives bit for bit.

The reference stacks layer params on a leading ``n_super`` axis
(``init_params``' ``vmap``); :func:`params_from_numpy` unstacks them into
the port's list of per-layer dicts. It also takes the tree that the
reference's ``pack_model_params`` returns, whose packed leaves are
``PackedWeight`` named tuples of stacked values (n_super, K/2, N) and meta
(n_super, K/8, N) uint8: each becomes one port ``PackedWeight`` per layer.
:func:`caches_from_numpy` does the same for a serving cache, dense or
paged, and :func:`train_state_from_numpy` for the reference's train state
(params, AdamW moments and masters, the int8 error carry).
:func:`params_to_numpy` goes back: a port tree of the params' structure
(params, moments, masters, grads) in the reference's layout, layers
stacked again, so the tests can hold the two after N train steps.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.execution import PackedWeight

# dtype name → (numpy bit-carrier, torch type)
_BIT_TYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(a, device=None) -> torch.Tensor:
    """One numpy array → a torch tensor with the same bits."""
    a = np.array(a, order="C")        # a copy; 0-d stays 0-d
    name = str(a.dtype)
    if name in _BIT_TYPES:
        carrier, ttype = _BIT_TYPES[name]
        t = torch.from_numpy(a.view(carrier).copy()).view(ttype)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device) if device is not None else t


def to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A torch tensor → numpy; bf16/fp8 come back as their raw bit
    carriers (``uint16`` / ``uint8``), everything else as itself."""
    t = t.detach().cpu().contiguous()
    for carrier, ttype in _BIT_TYPES.values():
        if t.dtype == ttype:
            bits = torch.int16 if carrier is np.uint16 else torch.uint8
            return t.view(bits).numpy().view(carrier)
    return t.numpy()


def _convert(sub, device, take=None):
    """A subtree → torch: dicts recurse, a packed 2:4 weight (the
    reference's ``PackedWeight`` named tuple) becomes the port's, every
    array goes through ``take`` (an index into a stacked axis) first."""
    if isinstance(sub, dict):
        return {k: _convert(v, device, take) for k, v in sub.items()}

    def one(a):
        a = np.asarray(a)
        return to_torch(a if take is None else take(a), device)

    if isinstance(sub, tuple) and hasattr(sub, "meta"):
        return PackedWeight(one(sub.values), one(sub.meta))
    return one(sub)


def _unstack(tree, cfg, device):
    """The port's per-layer list: layer ``s * len(pat) + i`` is super-layer
    ``s`` of the reference's block ``b{i}``, and a hybrid stack's tail
    layer ``t`` (stacked ``(n_tail, ...)`` under ``tree["tail"]``)
    follows, in layer order."""
    from repro_torch.models.transformer import check_supported
    check_supported(cfg)
    n_pat = len(cfg.superlayer_pattern)
    layers = [_convert(tree["layers"][f"b{li % n_pat}"], device,
                       lambda a, s=li // n_pat: a[s])
              for li in range(cfg.num_superlayers * n_pat)]
    return layers + [_convert(tree["tail"], device, lambda a, t=t: a[t])
                     for t in range(cfg.hybrid_tail_layers)]


def params_from_numpy(tree: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """The JAX param tree (numpy leaves) → the port's params.

    ``tree["layers"]["b{i}"]`` holds block ``i`` of the super-layer
    pattern stacked over ``cfg.num_superlayers``; super-layer ``s`` of it
    becomes ``params["layers"][s * len(pattern) + i]``, and zamba2's tail
    layers (``tree["tail"]``) the layers after them. A MoE block's ``moe``
    subtree comes along: the f32 router, the expert stacks (4-D
    ``(n_super, E, d, f)`` there, 3-D ``(E, d, f)`` here) and the shared
    expert; a recurrent block's ``mamba`` or ``rwkv`` subtree; and the
    shared attention block (``params["shared_attn"]``, unstacked in both;
    its invoking layers' own dicts are empty). A packed tree's 3-D packed
    stacks (``pack_model_params``) become one packed weight per layer."""
    out = {key: _convert(tree[key], device)
           for key in ("embed", "head", "final_norm")}
    out["layers"] = _unstack(tree, cfg, device)
    if "shared_attn" in tree:
        out["shared_attn"] = _convert(tree["shared_attn"], device)
    return out


def caches_from_numpy(tree: Dict[str, Any], cfg,
                      device=None) -> List[Dict[str, torch.Tensor]]:
    """A JAX serving cache (numpy leaves) → the port's per-layer list.

    The dense cache ``{"layers": {"b{i}": {"k": (n_super, B, S, kvh, hd),
    "v": ..., "pos": (n_super, B, S)}}}`` (S the window's rows for a local
    block; a recurrent block's state leaves instead) and the paged one
    (pools ``(n_super, pages+1, page_size, ...)`` for the pooled blocks)
    stack super-layers on axis 0, and a hybrid stack's ``tree["tail"]``
    stacks its tail layers; the port's layer ``s * len(pattern) + i``
    gets every leaf of super-layer ``s`` of block ``i``, bit for bit."""
    return _unstack(tree, cfg, device)


def _stack(trees: List[Any]) -> Any:
    """Leafwise ``np.stack`` of same-structured trees of numpy arrays."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A port tree of the params' structure → the reference's layout with
    numpy leaves: ``layers`` stacked back into ``{"b{i}": (n_super, ...)}``,
    a hybrid stack's tail into ``tail``, ``shared_attn`` as it is. bf16
    and fp8 leaves come back as f32 (exact: every such value is an f32),
    the others in their own type."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()
        return t.numpy()

    def conv(sub):
        if isinstance(sub, dict):
            return {k: conv(v) for k, v in sub.items()}
        return leaf(sub)

    n_pat = len(cfg.superlayer_pattern)
    n_stack = cfg.num_superlayers * n_pat
    layers = [conv(p) for p in params["layers"]]
    out = {key: conv(params[key]) for key in ("embed", "head", "final_norm")}
    out["layers"] = {f"b{i}": _stack(layers[i:n_stack:n_pat])
                     for i in range(n_pat)}
    if cfg.hybrid_tail_layers:
        out["tail"] = _stack(layers[n_stack:])
    if "shared_attn" in params:
        out["shared_attn"] = conv(params["shared_attn"])
    return out


def train_state_from_numpy(state, cfg, device=None):
    """The reference's ``TrainState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)``) → the port's: params, the AdamW state's moments
    and masters (each of the params' structure) and the int8 error carry
    through :func:`params_from_numpy`, bit for bit; the step as a 0-d
    int32 tensor."""
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainState

    def tree(t):
        return None if t is None else params_from_numpy(t, cfg, device)

    opt = state.opt
    return TrainState(
        params=tree(state.params),
        opt=adamw.AdamWState(
            step=to_torch(np.asarray(opt.step, np.int32), device),
            mu=tree(opt.mu), nu=tree(opt.nu), master=tree(opt.master)),
        grad_error=tree(state.grad_error))
