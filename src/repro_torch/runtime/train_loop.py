"""Train-step builder: loss, grads, compression, optimizer, metrics.

Twin of ``repro/runtime/train_loop.py``. ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``; the launcher
(``launch/train.py``) drives it. Params are a tree of leaf tensors
(``models/transformer.init_params``); the step differentiates the loss
with ``torch.autograd.grad`` with respect to detached copies of them, so
the state's tensors never require grad, and the optimizer writes the new
values into them (``optim/adamw.apply``). The reference stacks a block's
layers into one leaf; where a rule looks at a whole leaf (AdamW's decay
of ``ndim >= 2`` leaves, int8 compression's per-tensor scale) the step
applies it to the stack (``transformer.reference_leaves``).

Under a kernel backend each linear runs its kernel forward inside an
autograd ``Function`` (``kernels/registry.py``), as the reference's
``custom_vjp`` does: a bf16 linear's backward is two more launches of
kernel A (dX and dW), one with an f32 cotangent (the LM head's) takes the
f32 reference's two products, and the fp8 and 2:4 entries differentiate
the torch reference. The stack's super-layers (``cfg.remat == "full"``)
and each chunk of the fused head and CE are checkpointed, so their
forward runs again in backward: each forward kernel launch of a
checkpointed region happens twice per step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.core import tree
from repro_torch.kernels import registry
from repro_torch.models.layers import DEFAULT_RT, RuntimeCfg, lm_logits
from repro_torch.models.transformer import forward_hidden, reference_leaves
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.runtime import telemetry as tm

AUX_LOSS_WEIGHT = 0.01
CE_CHUNK = 512         # seq-chunked fused LM-head loss (never materializes
                       # the full f32 (B, S, V) logits tensor)
GRAD_COMPRESS = ("none", "bf16", "int8_ef")


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    grad_error: Optional[Any]       # int8 error-feedback carry (or None)


def _token_ll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of each label under the f32 logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE. logits (B, S, Vp) f32 (padding already -1e30)."""
    return -torch.mean(_token_ll(logits, labels))


def chunked_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int,
                          chunk: int = CE_CHUNK, policy=None) -> torch.Tensor:
    """Fused head + CE over sequence chunks. While a gradient flows each
    chunk is checkpointed: backward computes its logits again instead of
    keeping them."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is no multiple of the CE chunk "
                         f"{chunk}")

    def one(h_c, l_c):
        logits = lm_logits(h_c, head_w, vocab_size, policy=policy)
        return -torch.sum(_token_ll(logits, l_c))

    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        h_c = hidden[:, i * chunk:(i + 1) * chunk]
        l_c = labels[:, i * chunk:(i + 1) * chunk]
        part = checkpoint(one, h_c, l_c, use_reentrant=False,
                          preserve_rng_state=False) if remat \
            else one(h_c, l_c)
        total = total + part
    return total / (b * s)


def make_loss_fn(cfg: ArchConfig, rt: RuntimeCfg):
    pol = ex.policy_from(cfg, rt)

    def loss_fn(params, batch):
        hidden, aux = forward_hidden(params, batch["inputs"], cfg, rt)
        ce = chunked_cross_entropy(hidden, params["head"], batch["labels"],
                                   cfg.vocab_size, policy=pol)
        loss = ce + AUX_LOSS_WEIGHT * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    return loss_fn


def init_state(params, opt_cfg: adamw.AdamWConfig,
               grad_compress: str = "none") -> TrainState:
    err = gc.init_error(params) if grad_compress == "int8_ef" else None
    return TrainState(params=params, opt=adamw.init(params, opt_cfg),
                      grad_error=err)


def state_shape(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                params_shape_tree, grad_compress: str = "none") -> TrainState:
    """:func:`init_state` for a ``meta`` params tree
    (``transformer.params_shape``): shapes and dtypes, no storage."""
    return init_state(params_shape_tree, opt_cfg, grad_compress)


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of params:
    ((loss, metrics), grads), the grads in the params' dtypes; a leaf the
    loss does not reach gets zeros, as in JAX. An ambient tracer that
    records phases (``telemetry.set_tracer``) gets a
    ``train_step.forward`` and a ``train_step.backward`` span per call,
    timed on the device on a card; the backward's ``meta`` holds its
    ``backward_paths``, the calls of each path of the kernels' autograd
    entries (``registry.BACKWARD_PATHS``) it made."""
    def fn(params, batch):
        flat = tree.leaves(params)
        diff = [p.detach().requires_grad_(True) for p in flat]
        it = iter(diff)
        tr = tm.get_tracer()
        on_card = bool(flat) and flat[0].is_cuda
        with torch.enable_grad():
            with tm.phase(tr, "train_step.forward", device_time=on_card):
                loss, metrics = loss_fn(
                    tree.map_tree(lambda _: next(it), params), batch)
            with tm.phase(tr, "train_step.backward",
                          device_time=on_card) as span:
                before = dict(registry.BACKWARD_PATHS)
                grads = torch.autograd.grad(loss, diff, allow_unused=True)
                if span is not None:
                    span.fields.setdefault("meta", {})["backward_paths"] = {
                        k: n - before[k]
                        for k, n in registry.BACKWARD_PATHS.items()}
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(flat, grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.map_tree(
            lambda _: next(grads), params)
    return fn


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    rt: RuntimeCfg = DEFAULT_RT,
                    grad_compress: str = "none",
                    microbatch: int = 0,
                    policy: Optional[ex.ExecutionPolicy] = None,
                    telemetry=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds ``inputs`` (B, S) tokens (or (B, S, d) embeddings) and
    ``labels`` (B, S) on the params' device. ``microbatch > 0`` splits the
    global batch into ``B // microbatch`` chunks taken in turn, their
    grads summed in f32 and averaged (the reference's ``scan``); the
    metrics are the last chunk's.

    ``policy`` (when given) overrides cfg.precision / cfg.sparsity_24 for
    every matmul in the step (``core/execution.apply_policy``); it leaves
    ``rt.use_pallas``, which also routes attention through the
    forward-only flash kernel, which refuses gradients.

    ``telemetry`` (a :class:`repro_torch.runtime.telemetry.Tracer`)
    records a ``train_build`` event and a ``train_step`` span per step,
    and is installed as the ambient tracer while each step runs. Built
    with ``phases=True`` it also records, inside the step,
    ``train_step.forward`` and ``train_step.backward`` (one each per
    microbatch chunk) and ``train_step.optimizer`` (gradient compression
    and ``adamw.apply``); on a card each carries ``meta["device_s"]``,
    its length on the device's timeline. The step's state is updated in
    place (``adamw.apply``) and returned."""
    if grad_compress not in GRAD_COMPRESS:
        raise ValueError(f"grad_compress {grad_compress!r} not in "
                         f"{GRAD_COMPRESS}")
    if policy is not None:
        cfg, rt = ex.apply_policy(cfg, rt, policy)
    if telemetry is not None:
        telemetry.record("train_build", precision=cfg.precision,
                         policy=policy.spec() if policy else "",
                         meta={"grad_compress": grad_compress,
                               "microbatch": microbatch,
                               "d_model": cfg.d_model, "d_ff": cfg.d_ff})
    grad_fn = value_and_grad(make_loss_fn(cfg, rt))

    def compute_grads(params, batch):
        if not microbatch:
            (_, metrics), grads = grad_fn(params, batch)
            return grads, metrics
        b = batch["inputs"].shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is no multiple of microbatch "
                             f"{microbatch}")
        n_chunks = b // microbatch
        acc = tree.map_tree(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n_chunks):
            mb = {k: v[i * microbatch:(i + 1) * microbatch]
                  for k, v in batch.items()}
            (_, metrics), grads = grad_fn(params, mb)
            acc = tree.map_tree(torch.add, acc, grads)
            del grads
        return tree.map_tree(lambda g: g / n_chunks, acc), metrics

    layout = {}

    def reference_layout(params):
        """The reference's leaf of each param (its stacks): names for the
        int8 scale groups, ndims for the decay rule; made once."""
        if not layout:
            ref = reference_leaves(params, cfg)
            layout["groups"] = tree.map_tree(lambda r: r.name, ref)
            layout["decay"] = tree.map_tree(lambda r: r.ndim >= 2, ref)
        return layout

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = compute_grads(state.params, batch)
        ref = reference_layout(state.params)
        new_err = state.grad_error
        on_card = batch["labels"].is_cuda
        with tm.phase(telemetry, "train_step.optimizer",
                      device_time=on_card):
            if grad_compress == "bf16":
                grads = gc.compress_bf16(grads)
            elif grad_compress == "int8_ef":
                grads, new_err = gc.compress_int8_ef(
                    grads, state.grad_error, ref["groups"])
            new_params, new_opt, opt_metrics = adamw.apply(
                state.params, grads, state.opt, opt_cfg, ref["decay"])
        return (TrainState(new_params, new_opt, new_err),
                {**metrics, **opt_metrics})

    if telemetry is None:
        return train_step

    def traced_step(state: TrainState, batch):
        prev = tm.set_tracer(telemetry)
        try:
            with telemetry.span("train_step"):
                return train_step(state, batch)
        finally:
            tm.set_tracer(prev)

    return traced_step
