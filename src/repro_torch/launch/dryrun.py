"""Distributed dry-run: trace every (arch × shape × mesh) cell per device.

Twin of ``repro/launch/dryrun.py``, which jits each step with production
shardings over 512 placeholder host devices, compiles it and reads XLA's
memory and cost analyses. The port traces the real step once, eagerly, on
``meta`` DTensors placed by ``runtime/sharding.py`` over a ``DeviceMesh``
of the fake process group (``launch/mesh.py``): the train step with AdamW
(``runtime/train_loop.make_train_step``), ``transformer.prefill`` and
``transformer.decode_step``. The tensors are ``meta`` by design, the twins
of the reference's ``ShapeDtypeStruct``s: nothing is computed, on the host
or on a card, and no collective moves a byte. A dispatch mode (:class:`
_Trace`) sees every op DTensor runs on the local shards and counts, per
device:

* ``flops``: the products' FLOPs (``torch.utils.flop_counter``'s
  formulas on the local shapes); work every device repeats counts in full
  on each. A kernel backend's launch is costed as that kernel (its
  operations and bytes as ``chip_smoke.bound_ms`` counts them).
* ``bytes_accessed``: every op's operands and result once, unfused, so it
  reads higher than XLA's fused count; views move nothing, and a row read
  or in-place row write (``index_select``, ``embedding``, ``index_copy_``,
  ...) moves its index and the rows it touches, not the tensor it
  indexes.
* the collectives DTensor issues (``roofline.collective_of``), whose ring
  wire bytes make the collective term.

Every layer is traced, so nothing is scaled by depth (``assemble(...,
layer=None)``); the one super-layer probe (``layer``) is kept for the
per-layer column only. The record's ``memory``: ``argument`` is the exact
local bytes of the step's inputs from their specs (``argument_by_input``
splits it); ``output`` the local bytes of its results and ``alias`` those
of them that are the inputs' own tensors (the state updated in place);
``temp`` the peak of live local bytes the trace allocated, less its
non-aliased outputs, each tensor alive from its op until Python frees it
(eager order; no scheduler reorders anything); ``per_device_total =
argument + output + temp - alias`` as in the reference. The reference's
``memory_static_sched`` and ``compile_s`` have no twin (there is no
compiler and no schedule); ``trace_s`` is the trace's wall time.

Where GSPMD computes on the shards where they lie and DTensor would
gather them first (or refuse), the trace runs the op on each device's own
shard, since it computes nothing: a view that folds dims split on the mesh
(``torch.matmul``'s fold of a (batch, seq) or (batch, heads) activation)
or splits a dim split on several mesh dims (:func:`_view_placements`),
and a row read or in-place row write into a tensor split along its rows
(the decode cache's, :meth:`_Trace._local_rows`). So the count does not
hang on DTensor's version. An op that DTensor has no sharding rule for at
its inputs' placements, and that cannot run so (no rule at all, or a view
that would split a sharded dim unevenly, which GSPMD reshards) is not
skipped: its inputs are gathered to every device (the gathers count as
collectives), it runs on the whole tensors, and the record lists it under
``replicated_ops`` (a fold among them also under ``replicated_folds``).
An op that writes its input in place cannot run on a gathered copy and
raises.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out build/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import (
    ARCH_NAMES, ARCHS, applicable_shapes, get_arch, get_shape)
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.kernels import _build
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RuntimeCfg
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.sharding import Spec


# ---------------------------------------------------------------------------
# Per-device counting
# ---------------------------------------------------------------------------

# ops that allocate without writing, and ops that relabel: no bytes move
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
_RELABEL = {"_unsafe_view", "detach", "alias", "lift_fresh",
            "_local_scalar_dense", "_wrap_tensor_autograd", "wait_tensor"}


# DTensor's refusals of an op at its inputs' placements: no rule at all, or
# none for this layout (a view that would split a sharded dim unevenly)
_NO_RULE = ("does not have a sharding strategy",
            "Sharding propagation failed")


def _nbytes(t: torch.Tensor) -> int:
    """The bytes ``t``'s elements span: an expanded (stride 0) operand is
    read once."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _keep(*_):
    """Finalizer that only holds its arguments alive."""


# views that fold or split dims, and row reads and in-place row writes
_VIEWS = {"view", "_unsafe_view"}
_ROW_READS = {"index_select", "embedding", "index"}
_ROW_WRITES = {"index_copy_", "index_put_"}


def _row_bytes(name: str, ins, outs) -> Optional[int]:
    """The bytes a row read or in-place row write moves: the index and the
    rows it touches (read and written once each), not the whole tensor it
    indexes; None for any other op."""
    if name in _ROW_READS:
        idx = sum(_nbytes(t) for t in ins[1:])
        return idx + 2 * sum(_nbytes(t) for t in outs)
    if name in _ROW_WRITES:
        return sum(_nbytes(t) for t in ins[1:-1]) + 2 * _nbytes(ins[-1])
    return None


def _view_groups(src, dst):
    """A reshape's dim groups: [(input dims, output dims)] whose sizes have
    equal products, in order; None where the shapes do not pair up."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        ins, outs, pa, pb = [], [], 1, 1
        if i < len(src):
            ins.append(i)
            pa, i = src[i], i + 1
        if j < len(dst):
            outs.append(j)
            pb, j = dst[j], j + 1
        while pa != pb:
            if pa < pb and i < len(src):
                ins.append(i)
                pa, i = pa * src[i], i + 1
            elif pb < pa and j < len(dst):
                outs.append(j)
                pb, j = pb * dst[j], j + 1
            else:
                return None
        groups.append((ins, outs))
    return groups


def _view_placements(x, dst, placements=None):
    """(the placements of ``x`` (placed by ``placements``, default its
    own) viewed as ``dst``, whether DTensor would gather or refuse them)
    where every device's own elements make the view's local tensor, else
    None. A fold (several input dims to one)
    keeps every mesh dim that split one of them, on the folded dim; a
    split (one input dim to several) gives each mesh dim that split it to
    the next non-unit output dim, which it must divide. DTensor folds
    only a split leading dim, and splits a dim split on one mesh dim
    only: on any other fold or split it gathers (or refuses) what GSPMD
    computes where it lies."""
    from torch.distributed.tensor import Shard
    groups = _view_groups(tuple(x.shape), dst)
    if groups is None:
        return None
    mesh = x.device_mesh
    src = list(x.placements if placements is None else placements)
    out, own = list(src), False
    for ins, outs in groups:
        ks = [k for k, p in enumerate(src)
              if isinstance(p, Shard) and p.dim in ins]
        if not ks:
            continue
        if len(outs) == 1:                              # a fold
            dims = sorted({src[k].dim for k in ks})
            lead = [d for d in ins if x.shape[d] > 1][:1]
            own |= len(ins) > 1 and (len(ks) > 1 or dims != lead)
            for k in ks:
                out[k] = Shard(outs[0])
        elif len(ins) == 1:                             # a split
            free = [o for o in outs if dst[o] > 1]
            if len(ks) > len(free):
                return None
            own |= len(ks) > 1
            for k, o in zip(ks, free):
                if dst[o] % mesh.size(k):
                    return None
                out[k] = Shard(o)
        else:
            return None
    for d, n in enumerate(dst):
        parts = 1
        for k, p in enumerate(out):
            if isinstance(p, Shard) and p.dim == d:
                parts *= mesh.size(k)
        if n % parts:
            return None
    return out, own


class _Trace(TorchDispatchMode):
    """Counts the local work of a trace on ``meta`` DTensors (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.colls = []
        self.live = 0
        self.peak = 0
        self.replicated = collections.Counter()
        self.replicated_folds = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._depth = 0
        self._sink = None

    def __enter__(self):
        self._sink = _build.COST_SINK
        _build.COST_SINK = self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COST_SINK = self._sink
        return super().__exit__(*exc)

    def _kernel(self, name: str, ops: float, nbytes: float) -> None:
        e = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        e["launches"] += 1
        e["flops"] += ops
        e["bytes"] += nbytes
        self.flops += ops
        self.bytes += nbytes

    def _free(self, n: int) -> None:
        self.live -= n

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _count(self, func, args, kwargs, out) -> None:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.is_meta for t in ins + outs):
            return                  # DTensor's own index bookkeeping
        coll = rl.collective_of(func, args, out)
        if coll is not None:
            self.colls.append(coll)
        name = func._schema.name.split("::")[-1]
        view = not func._schema.is_mutable and any(
            r.alias_info is not None for r in func._schema.returns)
        in_ids = {id(t) for t in ins}
        fresh = [t for t in outs if id(t) not in in_ids]
        if view or name in _RELABEL:
            for t in fresh:                  # a view keeps its base alive
                weakref.finalize(t, _keep, ins)
            return
        for t in fresh:
            self._alloc(t)
        if name in _ALLOC:
            return
        pkt = func._overloadpacket
        if pkt in _flop_registry():
            self.flops += _flop_registry()[pkt](*args, **kwargs, out_val=out)
        total = _row_bytes(name, ins, outs)
        if total is None:
            seen, total = set(), 0
            for t in ins + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    total += _nbytes(t)
        self.bytes += total

    def _from_local(self, local, like, placements, shape):
        from torch.distributed.tensor import DTensor
        shape = torch.Size(shape)
        return DTensor.from_local(
            local, like.device_mesh, placements, run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())

    def _local_view(self, func, args, kwargs, native_failed: bool):
        """A fold or split of a DTensor run on each device's own elements
        (:func:`_view_placements`): before DTensor where it would gather
        or refuse, or after it refused. Where no device's own elements
        make it (a split the mesh dim does not divide), the fewest mesh
        dims that block it are gathered first, and the view is listed as
        run gathered. None where it cannot run so."""
        x, dst = args[0], list(args[1])
        if kwargs or len(args) != 2:
            return None
        if -1 in dst:
            i = dst.index(-1)
            dst[i] = 1
            dst[i] = x.numel() // math.prod(dst)
        got = _view_placements(x, tuple(dst))
        if got is None and native_failed:
            x, got = self._gather_for_view(func, x, tuple(dst))
        if got is None or not (got[1] or native_failed):
            return None
        out = got[0]
        from torch.distributed.tensor import Shard
        mesh = x.device_mesh
        local = list(dst)
        for k, p in enumerate(out):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(k)
        with self:
            res = func(x._local_tensor, local)
        return self._from_local(res, x, out, dst)

    def _gather_for_view(self, func, x, dst):
        """(``x`` gathered on the fewest mesh dims that keep the view of
        ``dst`` from running on the shards, its placements viewed) or
        (``x``, None)."""
        import itertools
        from torch.distributed.tensor import Replicate, Shard
        split = [k for k, p in enumerate(x.placements)
                 if isinstance(p, Shard)]
        for n in range(1, len(split) + 1):
            for ks in itertools.combinations(split, n):
                want = [Replicate() if k in ks else p
                        for k, p in enumerate(x.placements)]
                got = _view_placements(x, dst, want)
                if got is None:
                    continue
                self.replicated[str(func)] += 1
                if len(dst) < x.dim():
                    self.replicated_folds += 1
                with self:
                    x = x.redistribute(x.device_mesh, want)
                return x, got
        return x, None

    def _local_rows(self, func, args, kwargs):
        """A row read (``index_select``) or in-place row write
        (``index_copy_``) of a tensor split along the indexed dim, run on
        each device's own rows with the whole index, as GSPMD's gather and
        scatter run where the rows lie (DTensor gathers the whole tensor
        first). A read's rows are partial sums over the mesh dims that
        split the dim; a write's new rows go whole to those mesh dims.
        None for any other op or layout."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        name = func._schema.name.split("::")[-1]
        if kwargs or name not in ("index_select", "index_copy_"):
            return None
        x, dim = args[0], args[1] % args[0].dim()
        if not isinstance(x, DTensor) or not any(
                isinstance(p, Shard) and p.dim == dim for p in x.placements):
            return None
        mesh = x.device_mesh

        def whole(a, want=None):
            if not isinstance(a, DTensor):
                return a
            want = want or [Replicate()] * mesh.ndim
            if list(a.placements) != list(want):
                with self:                   # its collectives count
                    a = a.redistribute(mesh, want)
            return a._local_tensor
        index = whole(args[2])
        if name == "index_select":
            with self:
                res = func(x._local_tensor, dim, index)
            out = [Partial() if isinstance(p, Shard) and p.dim == dim
                   else p for p in x.placements]
            shape = list(x.shape)
            shape[dim] = index.numel()
            return self._from_local(res, x, out, shape)
        want = [p if isinstance(p, Shard) and p.dim != dim else Replicate()
                for p in x.placements]
        src = whole(args[3], want)
        with self:
            func(x._local_tensor, dim, index, src)
        return x

    def _replicate(self, func, args, kwargs):
        """Run ``func``, which DTensor has no rule for, on its inputs
        gathered to every device; its result is replicated. An op that
        writes an input in place runs so only where every input already
        is replicated (its local tensors are the whole ones, so the write
        lands); on a split input it raises."""
        from torch.distributed.tensor import DTensor, Replicate
        dts = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, DTensor)]
        if func._schema.is_mutable:
            if not all(p.is_replicate() for a in dts for p in a.placements):
                raise NotImplementedError(
                    f"{func} has no DTensor sharding rule and writes a "
                    "split input in place: it cannot run on a gathered copy")
            self.replicated[str(func)] += 1
            with self:
                loc = tree_map(lambda a: a.to_local()
                               if isinstance(a, DTensor) else a,
                               (args, kwargs))
                func(*loc[0], **loc[1])
            return args[0]
        self.replicated[str(func)] += 1
        if func._schema.name.split("::")[-1] in _VIEWS \
                and len(args[1]) < args[0].dim():
            self.replicated_folds += 1
        mesh = dts[0].device_mesh
        rep = [Replicate()] * mesh.ndim

        def gather(a):
            if isinstance(a, DTensor):
                return a.redistribute(mesh, rep).to_local()
            return a
        with self:
            la, lk = tree_map(gather, (args, kwargs))
            out = func(*la, **lk)
        return tree_map(lambda o: DTensor.from_local(
            o, mesh, rep, run_check=False)
            if isinstance(o, torch.Tensor) else o, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._depth:
                return NotImplemented        # DTensor runs the local ops
            view = func._schema.name.split("::")[-1] in _VIEWS
            out = (self._local_view(func, args, kwargs, False) if view
                   else self._local_rows(func, args, kwargs))
            if out is not None:
                return out
            self._depth += 1
            try:
                with self:
                    return func(*args, **kwargs)
            except (NotImplementedError, RuntimeError) as e:
                if not any(m in str(e) for m in _NO_RULE):
                    raise
            finally:
                self._depth -= 1
            out = self._local_view(func, args, kwargs, True) if view \
                else None
            return out if out is not None else \
                self._replicate(func, args, kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def cost(self) -> rl.CellCost:
        return rl.CellCost(
            flops=self.flops, bytes_accessed=self.bytes,
            wire_bytes=rl.collective_wire_bytes(self.colls),
            collectives=rl.collective_summary(self.colls),
            wire_bytes_bf16=rl.collective_wire_bytes_bf16(self.colls))


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


@dataclasses.dataclass
class Traced:
    """One traced step: its per-device cost, memory, the ops it ran
    replicated for want of a sharding rule (and how many of them were
    folds), the kernels it costed, and the trace's wall seconds."""
    cost: rl.CellCost
    memory: Dict[str, Any]
    replicated_ops: Dict[str, int]
    replicated_folds: int
    kernels: Dict[str, Dict[str, float]]
    trace_s: float


def _local_bytes(t) -> int:
    from torch.distributed.tensor import DTensor
    return _nbytes(t._local_tensor if isinstance(t, DTensor) else t)


def _trace(step, inputs: Dict[str, Any], grad: bool) -> Traced:
    """Run ``step()`` under :class:`_Trace`; ``inputs`` names the trees it
    reads (their local bytes are the ``argument``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    by_input = {k: sum(_local_bytes(t) for t in tree.leaves(v))
                for k, v in inputs.items()}
    arg_ids = {id(t) for v in inputs.values() for t in tree.leaves(v)}
    tr = _Trace()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad), tr, implicit_replication():
        out = step()
    seconds = time.perf_counter() - t0
    leaves = [t for t in tree_flatten(out)[0]
              if isinstance(t, torch.Tensor)]
    output = sum(_local_bytes(t) for t in leaves)
    alias = sum(_local_bytes(t) for t in leaves if id(t) in arg_ids)
    argument = sum(by_input.values())
    temp = tr.peak - (output - alias)
    memory = {"argument": argument, "output": output, "temp": temp,
              "alias": alias,
              "per_device_total": argument + output + temp - alias,
              "argument_by_input": by_input,
              "method": "eager trace: peak of live local bytes"}
    del out, leaves
    return Traced(tr.cost(), memory, dict(tr.replicated),
                  tr.replicated_folds, tr.kernels,
                  seconds)


# ---------------------------------------------------------------------------
# Runtime config for tracing
# ---------------------------------------------------------------------------

def make_rt(cfg: ArchConfig, mesh, shape: ShapeConfig,
            seq_shard_acts: bool = True) -> RuntimeCfg:
    chunk = 2048 if shape.seq_len >= 32768 else 1024
    chunk_q = chunk
    if cfg.attn_strategy == "seq_tp" and not shape.is_decode:
        # context parallelism: q stays seq-sharded, every q row per kv
        # block (slicing a sharded dim would gather it); costs the causal
        # skip's FLOPs
        chunk_q = shape.seq_len
    return RuntimeCfg(
        chunk_q=chunk_q, chunk_kv=chunk,
        f32_batched_dots=False,        # bf16 operands, f32 accumulation
        shard_fn=sh.make_shard_fn(cfg, mesh, shape,
                                  seq_shard_acts=seq_shard_acts))


def input_struct(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The step's inputs as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings" and not shape.is_decode:
        inputs = torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                             device="meta")
    else:
        inputs = torch.empty((B, S), dtype=torch.int32, device="meta")
    if shape.kind == "train":
        return {"inputs": inputs,
                "labels": torch.empty((B, S), dtype=torch.int32,
                                      device="meta")}
    return {"inputs": inputs}


def _act_spec(cfg, shape, mesh, bspec, policy="tp_fsdp") -> Spec:
    """Residual-stream spec matching the act_btd anchor (seq on model)."""
    sx = "model" if shape.seq_len % sh.axis_size(mesh, "model") == 0 \
        else None
    if shape.is_decode or policy == "fsdp_only":
        sx = None
    return Spec(bspec[0], sx, None)


def _x(shape, cfg, seq, spec, mesh):
    return sh.distribute_meta(
        torch.empty((shape.global_batch, seq, cfg.d_model),
                    dtype=torch.bfloat16, device="meta"), spec, mesh)


def _super(cfg, mesh, pshape, pspecs):
    """The first super-layer's params and the shared block as DTensors."""
    p_super = sh.distribute_tree(tf.superlayer_params_slice(pshape, cfg),
                                 tf.superlayer_params_slice(pspecs, cfg),
                                 mesh)
    shared = pshape.get("shared_attn")
    if shared is not None:
        shared = sh.distribute_tree(shared, pspecs["shared_attn"], mesh)
    return p_super, shared


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------

def lower_train(cfg: ArchConfig, shape: ShapeConfig, mesh, rt: RuntimeCfg,
                with_layer: bool = True, grad_compress: str = "none",
                policy: str = "tp_fsdp",
                opt_cfg: Optional[adamw.AdamWConfig] = None):
    """(the train step's :class:`Traced`, the super-layer probe's cost or
    None). ``policy`` is the sharding policy; ``opt_cfg`` the optimizer's
    (default ``AdamWConfig()``, f32 moments)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    pshape = tf.params_shape(cfg)
    st_shape = tl.state_shape(cfg, opt_cfg, pshape, grad_compress)
    pspecs = sh.param_specs(cfg, mesh, pshape, policy)
    bspec = sh.input_spec(cfg, shape, mesh)
    if policy == "fsdp_only":
        ball = ("pod", "data", "model") if "pod" in mesh.mesh_dim_names \
            else ("data", "model")
        if shape.global_batch % sh.axis_size(mesh, ball) == 0:
            bspec = Spec(ball, *bspec[1:])
    batch_shape = input_struct(cfg, shape)
    batch = {"inputs": sh.distribute_meta(batch_shape["inputs"], bspec,
                                          mesh),
             "labels": sh.distribute_meta(batch_shape["labels"],
                                          Spec(bspec[0], None), mesh)}
    dist = lambda t: sh.distribute_tree(t, pspecs, mesh)  # noqa: E731
    opt = st_shape.opt
    state = tl.TrainState(
        params=dist(st_shape.params),
        opt=adamw.AdamWState(
            step=sh.distribute_meta(opt.step, Spec(), mesh),
            mu=dist(opt.mu), nu=dist(opt.nu), master=dist(opt.master)),
        grad_error=None if st_shape.grad_error is None
        else dist(st_shape.grad_error))
    step = tl.make_train_step(cfg, opt_cfg, rt, grad_compress=grad_compress)
    inputs = {"params": state.params, "mu": state.opt.mu,
              "nu": state.opt.nu, "master": state.opt.master,
              "step": state.opt.step, "batch": batch}
    if state.grad_error is not None:
        inputs["grad_error"] = state.grad_error
    traced = _trace(lambda: step(state, batch), inputs, grad=True)
    del state, batch, inputs

    layer_cost = None
    if with_layer:
        layer_cost = _lower_train_layer(cfg, shape, mesh, rt, pshape,
                                        pspecs, bspec, policy)
    return traced, layer_cost


def _lower_train_layer(cfg, shape, mesh, rt, pshape, pspecs, bspec,
                       policy="tp_fsdp") -> rl.CellCost:
    xspec = _act_spec(cfg, shape, mesh, bspec, policy)
    x = _x(shape, cfg, shape.seq_len, xspec, mesh)
    ct = _x(shape, cfg, shape.seq_len, xspec, mesh)
    p_super, shared = _super(cfg, mesh, pshape, pspecs)
    return _trace(lambda: tf.superlayer_train_cost(x, ct, p_super, shared,
                                                   cfg, rt),
                  {}, grad=True).cost


def lower_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh, rt: RuntimeCfg,
                  with_layer: bool = True, policy: str = "tp_fsdp"):
    pshape = tf.params_shape(cfg)
    pspecs = sh.param_specs(cfg, mesh, pshape, policy)
    bspec = sh.input_spec(cfg, shape, mesh)
    params = sh.distribute_tree(pshape, pspecs, mesh)
    inputs = sh.distribute_meta(input_struct(cfg, shape)["inputs"], bspec,
                                mesh)
    traced = _trace(lambda: tf.prefill(params, inputs, cfg, rt),
                    {"params": params, "inputs": inputs}, grad=False)
    del params, inputs

    layer_cost = None
    if with_layer:
        xspec = _act_spec(cfg, shape, mesh, bspec, policy)
        x = _x(shape, cfg, shape.seq_len, xspec, mesh)
        p_super, shared = _super(cfg, mesh, pshape, pspecs)
        layer_cost = _trace(lambda: tf.superlayer_forward(
            x, p_super, shared, cfg, rt), {}, grad=False).cost
    return traced, layer_cost


def lower_decode(cfg: ArchConfig, shape: ShapeConfig, mesh, rt: RuntimeCfg,
                 with_layer: bool = True, policy: str = "tp_fsdp"):
    """One decode step at the cache's last position, ``S - 1``, on the
    dense cache (the reference's decode step)."""
    B, S = shape.global_batch, shape.seq_len
    pshape = tf.params_shape(cfg)
    pspecs = sh.param_specs(cfg, mesh, pshape, policy)
    cshape = tf.cache_shape(cfg, B, S)
    cspecs = sh.cache_specs(cfg, shape, mesh, cshape)
    ba = sh.batch_axes(mesh)
    baxes = ba if B % sh.axis_size(mesh, ba) == 0 else None
    params = sh.distribute_tree(pshape, pspecs, mesh)
    caches = sh.distribute_tree(cshape, cspecs, mesh)
    tok = sh.distribute_meta(torch.empty((B, 1), dtype=torch.int32,
                                         device="meta"),
                             Spec(baxes, None), mesh)
    traced = _trace(lambda: tf.decode_step(params, tok, caches, S - 1, cfg,
                                           rt),
                    {"params": params, "caches": caches, "tokens": tok},
                    grad=False)
    del params, caches, tok

    layer_cost = None
    if with_layer:
        x = _x(shape, cfg, 1, Spec(baxes, None, None), mesh)
        p_super, shared = _super(cfg, mesh, pshape, pspecs)
        c_super = sh.distribute_tree(tf.superlayer_cache_slice(cshape, cfg),
                                     tf.superlayer_cache_slice(cspecs, cfg),
                                     mesh)
        layer_cost = _trace(lambda: tf.superlayer_decode(
            x, p_super, c_super, S - 1, shared, cfg, rt), {},
            grad=False).cost
    return traced, layer_cost


# ---------------------------------------------------------------------------
# One cell end-to-end
# ---------------------------------------------------------------------------

def record(rec: Dict[str, Any], cfg: ArchConfig, shape: ShapeConfig,
           traced: Traced, layer: Optional[rl.CellCost],
           chips: int, roofline: bool) -> Dict[str, Any]:
    """Fill a cell's record from its trace (shared with ``perf.py``)."""
    rec["ok"] = True
    rec["trace_s"] = traced.trace_s
    rec["memory"] = traced.memory
    rec["full"] = dataclasses.asdict(traced.cost)
    rec["layer"] = dataclasses.asdict(layer) if layer else None
    rec["n_bodies"] = cfg.num_superlayers
    rec["replicated_ops"] = traced.replicated_ops
    rec["replicated_folds"] = traced.replicated_folds
    rec["kernels"] = traced.kernels
    rec["model_flops"] = rl.model_flops_estimate(cfg, shape)
    rec["min_bytes"] = rl.min_bytes_estimate(cfg, shape)
    if roofline:
        roof = rl.assemble(rec["arch"], rec["shape"], chips, traced.cost,
                           None, cfg.num_superlayers, rec["model_flops"],
                           min_bytes=rec["min_bytes"], kind=shape.kind)
        rec["roofline"] = roof.to_dict()
    return rec


def lower_fn(shape: ShapeConfig):
    return {"train": lower_train, "prefill": lower_prefill}.get(
        shape.kind, lower_decode)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             with_layer: bool = True, verbose: bool = True) -> Dict:
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single", "chips": chips,
    }
    t0 = time.perf_counter()
    try:
        rt = make_rt(cfg, mesh, shape)
        traced, layer = lower_fn(shape)(cfg, shape, mesh, rt, with_layer)
        record(rec, cfg, shape, traced, layer, chips, not multi_pod)
        if verbose:
            full = traced.cost
            print(f"[{arch_name} × {shape_name} × {rec['mesh']}] OK "
                  f"trace={rec['trace_s']:.1f}s "
                  f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB")
            print("  memory:", {k: v for k, v in rec["memory"].items()
                                if k != "argument_by_input"})
            print("  cost: flops=%.3e bytes=%.3e wire=%.3e"
                  % (full.flops, full.bytes_accessed, full.wire_bytes))
            if rec["replicated_ops"]:
                print("  replicated (no sharding rule):",
                      rec["replicated_ops"])
            if "roofline" in rec:
                r = rec["roofline"]
                print("  roofline: compute=%.4fs memory=%.4fs coll=%.4fs "
                      "bottleneck=%s frac=%.3f"
                      % (r["compute_s"], r["memory_s"], r["collective_s"],
                         r["bottleneck"], r["roofline_fraction"]))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["trace_s"] = time.perf_counter() - t0
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch_name} × {shape_name} × {rec['mesh']}] FAIL "
                  f"{rec['error'][:200]}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-layer", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass

    cells = []
    if args.all:
        for name in ARCH_NAMES:
            for shp in applicable_shapes(ARCHS[name]):
                cells.append((name, shp.name, False))
                cells.append((name, shp.name, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    t0 = time.perf_counter()
    n_ok = 0
    for arch, shp, multi in cells:
        key = (arch, shp, "multi" if multi else "single")
        if key in done:
            print(f"[{arch} × {shp} × {key[2]}] cached, skipping")
            n_ok += 1
            continue
        rec = run_cell(arch, shp, multi,
                       with_layer=(not args.no_layer) and not multi)
        n_ok += bool(rec["ok"])
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"dry-run: {n_ok}/{len(cells)} cells OK in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0 if n_ok == len(cells) else 1


if __name__ == "__main__":
    raise SystemExit(main())
