"""Per-architecture sharding specs over the production device meshes.

Twin of ``repro/runtime/sharding.py``. Mesh axes (``launch/mesh.py``):
single pod ``(data=16, model=16)``, multi-pod ``(pod=2, data=16,
model=16)``. The policies are the reference's:

* batch           → ("pod", "data")
* TP (Megatron)   → weight output/input dims on "model" (column/row)
* FSDP (ZeRO-3)   → large weight dims also on "data" when ``cfg.fsdp``
* EP              → the expert dim on "model" when E divides by it, else
                    each expert's d_ff on "model" (granite)
* decode KV cache → (batch → data, seq → model), "flash-decoding"
* SSM states      → heads (mamba2) / value dim (rwkv6) on "model"

A :class:`Spec` has one entry per tensor dim: ``None``, a mesh axis name,
or a tuple of axis names (major first), as a ``PartitionSpec``;
:func:`placements` turns it into DTensor placements on a ``DeviceMesh``.
A dim on two axes is ``Shard(d)`` on both mesh dims: DTensor splits it by
the first mesh dim, then each part by the second, so device ``(i, j)``
holds block ``i * n_j + j``, GSPMD's major-first order. A spec whose axes
on one dim run against the mesh's order has no such placement and is
refused.

Every rule shards only dims that divide the axis size, checked when the
spec is made, and :func:`placements` checks it again. A parameter or cache
leaf whose name no rule knows raises: nothing is replicated by default.
The port's params and caches hold one dict per layer (``models/
transformer.py``), so their leaves have no stack dim; a rule reads the
reference's leaf name (``transformer.reference_leaves``) and the layer's
own shape, which is the reference's leaf shape without its stack dim.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.models.transformer import reference_leaves


class Spec(tuple):
    """One placement entry per tensor dim (see the module docstring);
    ``Spec("data", None)``. A 1-tuple entry is its one name and an empty
    tuple ``None``, so equal placements give equal specs."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def padded(self, ndim: int) -> "Spec":
        """The spec with ``None`` for every dim past its entries."""
        if len(self) > ndim:
            raise ValueError(f"{self} has more entries than {ndim} dims")
        return Spec(*self, *(None,) * (ndim - len(self)))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in _names(axes):
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _maybe(dim: int, mesh, axes):
    """``axes`` for this dim only if it divides evenly."""
    return axes if (axes and _fits(dim, mesh, axes)) else None


# ---------------------------------------------------------------------------
# Spec → DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh, shape: Optional[Sequence[int]] = None):
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others
    and on every mesh dim of size 1 (one device holds the whole dim either
    way, and DTensor plans size-1 shards as if they split). With
    ``shape``, every sharded dim must divide by its axes' size."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    out = [Replicate()] * len(order)
    seen = set()
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = [order.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {names} of dim {d} run against "
                             f"the mesh's order {order}")
        for a, i in zip(names, idx):
            if a in seen:
                raise ValueError(f"{spec}: axis {a!r} on two dims")
            seen.add(a)
            if sizes[a] > 1:
                out[i] = Shard(d)
        if shape is not None and names and shape[d] % axis_size(mesh, names):
            raise ValueError(f"{spec}: dim {d} of {tuple(shape)} does not "
                             f"divide by {names}' {axis_size(mesh, names)}")
    return out


def spec_of(pl, mesh, ndim: int) -> Spec:
    """The :class:`Spec` of DTensor placements ``pl`` (inverse of
    :func:`placements`); a ``Partial`` placement has none and raises."""
    from torch.distributed.tensor import Replicate, Shard
    entries: List[List[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, pl):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} on {name!r} has no spec")
    return Spec(*entries)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` placed by ``spec``."""
    spec = spec.padded(len(shape))
    placements(spec, mesh, shape)
    return tuple(n // axis_size(mesh, e) for n, e in zip(shape, spec))


def distribute_meta(t: torch.Tensor, spec: Spec, mesh):
    """A ``meta`` DTensor of ``t``'s shape and dtype placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    spec = spec.padded(t.dim())
    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, placements(spec, mesh, t.shape),
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def distribute_tree(tree_: Any, specs: Any, mesh) -> Any:
    return tree.map_tree(lambda t, s: distribute_meta(t, s, mesh), tree_,
                         specs)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_COLUMN = ("w_q", "w_k", "w_v", "w_gate", "w_up", "w_ck", "w_z", "w_x",
           "w_B", "w_C", "w_dt", "w_r", "w_g", "w_w", "w_cr")
_ROW = ("w_o", "w_down", "w_cv", "out_proj")
# norms, biases, mixing coefficients, A_log, D, u: replicated
_REPLICATED = ("norm1", "norm2", "final_norm", "A_log", "dt_bias", "D",
               "w_bias", "u", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
               "mu_ck", "mu_cr")


def _leaf_rule(path: str, shape: Tuple[int, ...], cfg: ArchConfig, mesh,
               policy: str = "tp_fsdp") -> Spec:
    """Spec of one parameter leaf (the reference's unstacked leaf).

    ``"tp_fsdp"``: Megatron TP on "model", plus ZeRO on "data" when
    ``cfg.fsdp``. ``"fsdp_only"``: both axes shard storage only, no tensor
    parallelism (the batch shards over every device; weights gather per
    layer)."""
    fsdp = "data" if (cfg.fsdp or policy == "fsdp_only") else None
    name = path.split("/")[-1]

    def spec(*axes):
        return Spec(*(_maybe(shape[i], mesh, ax)
                      for i, ax in enumerate(axes))).padded(len(shape))

    if name == "embed":                       # (Vp, d)
        return spec("model", fsdp)
    if name == "head":                        # (d, Vp)
        return spec(fsdp, "model")
    experts = "moe" in path and len(shape) == 3
    ep = experts and cfg.num_experts and _fits(shape[0], mesh, "model")
    if name in _COLUMN:
        if experts:                           # (E, d, f)
            return spec("model", fsdp, None) if ep \
                else spec(None, fsdp, "model")
        return spec(fsdp, "model")            # column parallel
    if name in _ROW:
        if experts:                           # (E, f, d)
            return spec("model", None, fsdp) if ep \
                else spec(None, "model", fsdp)
        return spec("model", fsdp)            # row parallel
    if name == "conv_w":                      # (4, conv_dim)
        return spec(None, "model")
    if name == "router" or name in _REPLICATED:   # router (d, E) f32
        return Spec().padded(len(shape))
    raise KeyError(f"no sharding rule for parameter {path!r} "
                   f"{tuple(shape)}")


def param_specs(cfg: ArchConfig, mesh, params_tree,
                policy: str = "tp_fsdp") -> Any:
    """A :class:`Spec` per leaf of a port params tree (tensors or
    ``meta`` shapes), in its structure."""
    names = reference_leaves(params_tree, cfg)
    return tree.map_tree(
        lambda leaf, ref: _leaf_rule(ref.name, tuple(leaf.shape), cfg, mesh,
                                     policy), params_tree, names)


# ---------------------------------------------------------------------------
# Activation / batch specs
# ---------------------------------------------------------------------------

def _batch(shape: ShapeConfig, mesh):
    ba = batch_axes(mesh)
    return ba if shape.global_batch % axis_size(mesh, ba) == 0 else None


def input_spec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Spec:
    """Spec of the token (or embedding) input batch."""
    if cfg.input_mode == "embeddings" and not shape.is_decode:
        return Spec(_batch(shape, mesh), None, None)
    return Spec(_batch(shape, mesh), None)


def logits_spec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Spec:
    vx = _maybe(cfg.padded_vocab, mesh, "model")
    if shape.is_decode:
        return Spec(_batch(shape, mesh), vx)
    return Spec(_batch(shape, mesh), None, vx)


# ---------------------------------------------------------------------------
# Decode cache specs
# ---------------------------------------------------------------------------

def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                cache_tree) -> Any:
    """A :class:`Spec` per leaf of a port cache (one dict per layer)."""
    baxes = _batch(shape, mesh)
    # when the batch cannot shard (long_500k, B=1), the cache's seq goes
    # on data and model
    seq_axes = "model" if baxes else ("data", "model")

    def rule(name, shp):
        if name in ("k", "v"):               # (B, S, kv, hd)
            return Spec(baxes, _maybe(shp[1], mesh, seq_axes), None, None)
        if name == "pos":                    # (B, S)
            return Spec(baxes, _maybe(shp[1], mesh, seq_axes))
        if name == "h":                      # mamba2 (B, nh, hp, N)
            return Spec(baxes, _maybe(shp[1], mesh, "model"), None, None)
        if name == "conv":                   # (B, 3, conv_dim)
            return Spec(baxes, None, _maybe(shp[2], mesh, "model"))
        if name == "S":                      # rwkv6 (B, nh, hd, hd)
            return Spec(baxes, None, None, _maybe(shp[3], mesh, "model"))
        if name in ("prev_tm", "prev_cm"):   # (B, 1, d)
            return Spec(baxes, None, None)
        raise KeyError(f"no sharding rule for cache leaf {name!r} "
                       f"{tuple(shp)}")

    return [{name: rule(name, tuple(t.shape)) for name, t in layer.items()}
            for layer in cache_tree]


# ---------------------------------------------------------------------------
# Activation constraint hook (RuntimeCfg.shard_fn)
# ---------------------------------------------------------------------------

def make_shard_fn(cfg: ArchConfig, mesh, shape: ShapeConfig,
                  seq_shard_acts: bool = True, decode_2d_tp: bool = False,
                  policy: str = "tp_fsdp"):
    """``shard_fn(tag, x)``: a DTensor ``x`` redistributed to the tag's
    spec (the twin of ``with_sharding_constraint``); a plain tensor, or a
    tag with no spec at this shape, passes through unchanged.

    ``seq_shard_acts`` shards the residual stream's seq dim on "model"
    between layers (Megatron-SP). ``decode_2d_tp``: decode activations
    replicate the batch and shard d on "data", so every matmul contracts
    against its resident 2-D weight shard instead of gathering it."""
    ba = batch_axes(mesh)
    model_free = True                        # "model" free for non-batch dims
    if policy == "fsdp_only":
        ba = ba + ("model",)                 # batch over every axis
        model_free = False
        seq_shard_acts = False
    baxes = ba if shape.global_batch % axis_size(mesh, ba) == 0 else None
    seq_model = cfg.attn_strategy == "seq_tp"
    all_ax = ba if not model_free else (
        (ba + ("model",)) if baxes else ("model",))
    msize = axis_size(mesh, "model")

    def tag_spec(tag: str, s: Tuple[int, ...]) -> Optional[Spec]:
        if tag == "act_btd":                 # residual stream (B, S, d)
            if shape.is_decode and decode_2d_tp:
                return Spec(None, None, _maybe(s[2], mesh, "data"))
            sx = "model" if (seq_shard_acts and not shape.is_decode
                             and s[1] % msize == 0) else None
            return Spec(baxes, sx, None)
        if tag == "attn_q":                  # (B, S, h, hd)
            if not model_free:
                return Spec(baxes, None, None, None)
            if seq_model and s[1] % msize == 0:
                return Spec(baxes, "model", None, None)
            if s[2] % msize == 0:
                return Spec(baxes, None, "model", None)
            return None
        if tag == "decode_q":                # (B, 1, h, hd)
            if decode_2d_tp:
                return Spec(None, None, None, None)
            return Spec(baxes, None, None, None)
        if tag == "rwkv_v":                  # (B, S, nh, hd), value dim
            return Spec(baxes, None, None, "model" if model_free else None)
        if tag == "moe_tokens":              # (G, gs, d)
            return Spec(_maybe(s[0], mesh, all_ax), None, None)
        if tag == "moe_dispatch":            # (G, E, C, d)
            if model_free and s[1] % msize == 0:
                return Spec(baxes, "model", None, None)
            return Spec(_maybe(s[0], mesh, all_ax), None, None, None)
        return None

    def fn(tag: str, x):
        from torch.distributed.tensor import DTensor
        spec = tag_spec(tag, tuple(x.shape))
        if spec is None or not isinstance(x, DTensor):
            return x
        # a tag's spec may split a dim unevenly, as the reference's
        # constraint may (GSPMD pads it; DTensor splits it unevenly)
        return x.redistribute(x.device_mesh, placements(spec, mesh))
    return fn
