"""Decoder stack for every block kind of the repo's configs.

Twin of ``repro/models/transformer.py``: the training forward
(``forward``, ``forward_hidden``: no caches, super-layers checkpointed
under ``cfg.remat``, :func:`_remat`), and for serving ``init_params``,
``prefill``, ``decode_step`` (with ``_decode_attn``) and
``init_cache``, the paged twins ``paged_decode_step`` (with
``_paged_decode_attn``) and ``init_paged_cache``, and the speculative
verify ``multi_decode_step`` / ``paged_multi_decode_step`` with the
rollback of rejected writes (``_rollback_caches``). ``params_shape`` and
``cache_shape`` give the trees on the ``meta`` device, and the
``superlayer_*`` functions run one super-layer alone (the dry-run's
per-layer probes, ``launch/dryrun.py``). Where the reference
scans over super-layers whose parameters are stacked on a leading axis,
the port keeps a Python list with one dict per layer and loops over it
(PyTorch runs eagerly; there is no trace to keep small). Layer ``i`` has
the kind ``pat[i % len(pat)]`` of ``cfg.superlayer_pattern``, and a hybrid
stack's ``cfg.hybrid_tail_layers`` trailing mamba2 layers follow
(:func:`layer_kinds`):

* ``attn_dense`` and ``attn_global``: attention over every position, then
  a SwiGLU MLP; their K/V leaves hold a row per position and move into
  the page pools of the paged cache (:data:`PAGED_KINDS`);
* ``attn_moe``: the same attention, then the MoE layer (``models/moe.py``);
* ``attn_local``: attention over the last ``cfg.window_size`` positions,
  whose cache is a rolling window of ``min(window, max_len)`` rows,
  position p at row ``p % window``, slot-indexed in the paged cache too;
* ``shared_attn`` (zamba2): the attention and MLP of the one
  ``params["shared_attn"]`` dict, whatever layer invokes it (its own
  layer dict is empty); its K/V are per invocation and pooled;
* ``mamba2`` and ``rwkv6`` (:data:`STATE_KINDS`): recurrent blocks whose
  cache is a whole-slot state (mamba2: ``h`` (B, nh, hp, N) f32 and
  ``conv`` (B, 3, di + 2N); rwkv6: ``S`` (B, nh, hd, hd) f32 and
  ``prev_tm`` / ``prev_cm`` (B, 1, d)), slot-indexed in the paged cache.

Decode writes the new token's K/V into the cache in place, saving a copy
of the whole cache per step; ``decode_step`` returns the same cache
objects it was given; the paged step does the same to its page pools. A
state leaf is replaced in its layer's dict by the step's new tensor, as
the reference's functional update replaces it (its type becomes the
step's: the conv and prev rows take the activation type); the tensor it
replaces is left as it was, so keeping a reference to it is a snapshot.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.core import tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.layers import (
    DEFAULT_RT, RuntimeCfg, dense, embed_tokens, init_attn, init_mlp,
    init_weight, lm_logits, rms_norm, shard_tag, swiglu_mlp)

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]

# Block kinds whose K/V/pos leaves become page pools in the paged cache.
# ``attn_local`` keeps its rolling window (already O(window); paging buys
# nothing), slot-indexed.
PAGED_KINDS = ("attn_dense", "attn_global", "attn_moe", "shared_attn")
# Recurrent kinds: their cache is a state that each step replaces whole.
STATE_KINDS = ("mamba2", "rwkv6")
# The block kinds this port serves.
SUPPORTED_KINDS = ("attn_dense", "attn_moe", "attn_local", "attn_global",
                   "shared_attn") + STATE_KINDS


def check_supported(cfg: ArchConfig) -> None:
    pat = cfg.superlayer_pattern
    if not set(pat) <= set(SUPPORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {pat} — the port serves "
            f"{', '.join(SUPPORTED_KINDS)} stacks")


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The block kind of every layer: the super-layer pattern repeated
    ``cfg.num_superlayers`` times, then the hybrid tail's mamba2 layers
    (zamba2-1.2b: 6 x (6 mamba2 + shared_attn) + 2, 44 layers)."""
    pat = cfg.superlayer_pattern
    return ([pat[i % len(pat)] for i in range(cfg.num_superlayers * len(pat))]
            + ["mamba2"] * cfg.hybrid_tail_layers)


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window_size if kind == "attn_local" else 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype=torch.bfloat16) -> Params:
    """Random weights with the reference's shapes and scales (norms are
    f32 zeros: the norm scale is ``1 + gamma``). The numbers differ from
    ``jax.random``'s; parity tests bridge the JAX init instead."""
    check_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def attn_layer(kind):
        layer = {"norm1": zeros(),
                 "attn": init_attn(cfg, generator, device, dtype),
                 "norm2": zeros()}
        if kind == "attn_moe":
            layer["moe"] = moe_mod.init_moe(cfg, generator, device, dtype)
        else:
            layer["mlp"] = init_mlp(cfg, generator, device, dtype)
        return layer

    def layer(kind):
        if kind == "mamba2":
            return {"norm1": zeros(),
                    "mamba": m2.init_mamba2(cfg, generator, device, dtype)}
        if kind == "rwkv6":
            return {"norm1": zeros(), "norm2": zeros(),
                    "rwkv": rk.init_rwkv6(cfg, generator, device, dtype)}
        if kind == "shared_attn":
            return {}                 # params["shared_attn"] serves it
        return attn_layer(kind)

    params: Params = {
        "embed": init_weight((vp, d), dtype, generator, device, scale=1.0),
        "head": init_weight((d, vp), dtype, generator, device),
        "final_norm": zeros(),
        "layers": [layer(kind) for kind in layer_kinds(cfg)]}
    if "shared_attn" in cfg.superlayer_pattern:
        params["shared_attn"] = attn_layer("shared_attn")
    return params


def params_shape(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """:func:`init_params`' tree on the ``meta`` device: every leaf's
    shape and dtype, no storage, nothing drawn from any generator."""
    return init_params(cfg, None, device="meta", dtype=dtype)


def block_params(kind: str, p: Params, params: Params) -> Params:
    """A layer's parameters: its own dict, or for a ``shared_attn`` layer
    the one shared block's."""
    return params["shared_attn"] if kind == "shared_attn" else p


def ffn(kind: str, h: torch.Tensor, p: Params, cfg: ArchConfig,
        rt: RuntimeCfg) -> torch.Tensor:
    """A layer's feed-forward sublayer: the MoE layer's output (its aux
    loss dropped) or the SwiGLU MLP's."""
    if kind == "attn_moe":
        return moe_mod.moe_mlp(h, p["moe"], cfg, rt)[0]
    return swiglu_mlp(h, p["mlp"], cfg, rt)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _kv_to_cache(k: torch.Tensor, v: torch.Tensor,
                 window: int = 0) -> Dict[str, torch.Tensor]:
    """Decode cache from prefill K/V (B, S, kv, hd); ``pos`` is per row.
    With a ``window`` and a prompt of at least ``window`` tokens the cache
    is the rolling window: row j holds the position p in [S - window, S)
    with p % window == j, so decode keeps writing at pos % window."""
    b, s = k.shape[:2]
    dev = k.device
    if not window or s < window:
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        return {"k": k, "v": v, "pos": pos.expand(b, s)}
    p = torch.arange(s - window, s, dtype=torch.int32, device=dev)
    rows = (p % window).long()
    # new_zeros: on a DTensor the window is one too (the dry-run)
    kc = k.new_zeros((b, window) + k.shape[2:])
    vc = v.new_zeros((b, window) + v.shape[2:])
    kc[:, rows] = k[:, s - window:]
    vc[:, rows] = v[:, s - window:]
    posc = torch.zeros((window,), dtype=torch.int32, device=dev)
    posc[rows] = p
    return {"k": kc, "v": vc, "pos": posc.expand(b, window)}


def prefill_block(kind: str, x: torch.Tensor, p: Params, cfg: ArchConfig,
                  rt: RuntimeCfg):
    """One layer over the prompt: (x, the layer's decode cache)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba2":
        o, (hs, conv) = m2.mamba2_block_with_state(h, p["mamba"], cfg, rt)
        return x + o, {"h": hs, "conv": conv}
    if kind == "rwkv6":
        o, (S, prev_tm) = rk.rwkv6_block_with_state(h, p["rwkv"], cfg, rt)
        x = x + o
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + rk.rwkv6_channel_mix(h2, p["rwkv"], cfg, rt)
        return x, {"S": S, "prev_tm": prev_tm, "prev_cm": h2[:, -1:, :]}
    window = _window(cfg, kind)
    a, (k, v) = attn_mod.attention_block(h, p["attn"], cfg, rt,
                                         window=window, return_kv=True)
    x = x + a
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn(kind, h, p, cfg, rt), _kv_to_cache(k, v, window)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeCfg = DEFAULT_RT):
    """tokens (B, S), or embeddings (B, S, d) → (last-token logits (B, Vp)
    f32, per-layer caches); each super-layer's input placed by the
    ``act_btd`` tag. A recurrent stack's prompt must fit one scan chunk or
    be a multiple of it (``min(rt.ssm_chunk, cfg.ssm_chunk)``), as in the
    reference."""
    x = embed_tokens(tokens, params["embed"]) if tokens.dim() == 2 \
        else tokens
    x = x.to(rt.act_dtype)
    caches: Caches = []
    n_pat = len(cfg.superlayer_pattern)
    n_stack = cfg.num_superlayers * n_pat
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        if i < n_stack and i % n_pat == 0:
            x = shard_tag(rt, x, "act_btd")
        x, cache = prefill_block(kind, x, block_params(kind, p, params),
                                 cfg, rt)
        caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, -1], params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, caches


# ---------------------------------------------------------------------------
# Training forward (no caches)
# ---------------------------------------------------------------------------

def train_block(kind: str, x: torch.Tensor, p: Params, cfg: ArchConfig,
                rt: RuntimeCfg):
    """One layer of the training forward, the reference's ``_apply_block``
    without a cache: (x, the layer's aux loss in f32, 0 but for MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba2":
        return x + m2.mamba2_block(h, p["mamba"], cfg, rt), aux
    if kind == "rwkv6":
        x = x + rk.rwkv6_block(h, p["rwkv"], cfg, rt)
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + rk.rwkv6_channel_mix(h2, p["rwkv"], cfg, rt), aux
    x = x + attn_mod.attention_block(h, p["attn"], cfg, rt,
                                     window=_window(cfg, kind))
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "attn_moe":
        mo, aux = moe_mod.moe_mlp(h, p["moe"], cfg, rt)
        return x + mo, aux
    return x + swiglu_mlp(h, p["mlp"], cfg, rt), aux


# The 2-D products that ``remat="dots"`` keeps: the ``torch`` backend's
# linears (``torch.matmul`` of an f32 (.., K) by a (K, N) folds to mm).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, cfg: ArchConfig):
    """``body`` under ``cfg.remat`` while a gradient flows.

    * ``"full"``: checkpointed; backward runs its forward again (so each
      kernel in it launches twice per step) instead of keeping its
      activations (the reference's ``nothing_saveable``).
    * ``"dots"``: checkpointed keeping the outputs of ``aten.mm`` and
      ``aten.addmm``, the linears' 2-D products, and recomputing the rest
      (the reference's ``dots_with_no_batch_dims_saveable``: batched
      products, attention's and the MoE's, are recomputed). Under a kernel
      backend the GEMM launch sits inside an autograd ``Function``
      (``kernels/registry.py``), which the dispatcher never sees as a
      product, so it is recomputed: kernel A still launches twice per
      linear, as a ``pallas_call`` is no dot to the reference's policy.
    * ``"none"``: ``body`` itself, every activation kept.

    The forward draws no random numbers: no RNG state is kept."""
    if not torch.is_grad_enabled() or cfg.remat not in ("full", "dots"):
        return body
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, body, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _superlayer_body(kinds: List[str], ps: List[Params], cfg: ArchConfig,
                     rt: RuntimeCfg):
    """One super-layer's training forward: h -> (h, the sum of its blocks'
    aux losses)."""
    def body(h):
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, p in zip(kinds, ps):
            h, a = train_block(kind, h, p, cfg, rt)
            total = total + a
        return h, total
    return body


def _run_stack(params: Params, x: torch.Tensor, cfg: ArchConfig,
               rt: RuntimeCfg):
    """The reference's ``_run_stack`` without caches: the super-layers in
    turn, each under :func:`_remat` and its input placed by the
    ``act_btd`` tag, their aux losses summed (each super-layer's own sum
    added to the carry, as its scan does), then the hybrid tail."""
    kinds = layer_kinds(cfg)
    n_pat = len(cfg.superlayer_pattern)
    n_stack = cfg.num_superlayers * n_pat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, n_stack, n_pat):
        ps = [block_params(kinds[i], params["layers"][i], params)
              for i in range(lo, lo + n_pat)]
        x = shard_tag(rt, x, "act_btd")
        x, a = _remat(_superlayer_body(kinds[lo:lo + n_pat], ps, cfg, rt),
                      cfg)(x)
        aux = aux + a
    for i in range(n_stack, len(kinds)):
        x, _ = train_block(kinds[i], x, params["layers"][i], cfg, rt)
    return x, aux


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """Where a port param sits in the reference's tree: the name of the
    reference's leaf (``layers/b{i}/...`` for block ``i`` of every
    super-layer, ``tail/...`` for every tail layer, else its own path) and
    that leaf's ndim."""
    name: str
    ndim: int


def reference_leaves(params: Params, cfg: ArchConfig):
    """A tree of the params' structure with a :class:`RefLeaf` per leaf.
    The reference stacks each block of the super-layer pattern over
    ``cfg.num_superlayers`` (and the hybrid tail over its layers) on a
    new leading axis, so the training rules that look at a whole leaf
    span the stack: AdamW decays leaves of ``ndim >= 2``, a layer's norm
    scale among them, and int8 gradient compression takes one scale per
    stacked leaf."""
    n_pat = len(cfg.superlayer_pattern)
    n_stack = cfg.num_superlayers * n_pat

    def walk(sub, name, stacked):
        if isinstance(sub, dict):
            return {k: walk(v, f"{name}/{k}", stacked)
                    for k, v in sub.items()}
        return RefLeaf(name, sub.dim() + stacked)

    out = {k: walk(v, k, 0) for k, v in params.items() if k != "layers"}
    out["layers"] = [
        walk(p, f"layers/b{i % n_pat}" if i < n_stack else "tail", 1)
        for i, p in enumerate(params["layers"])]
    return out


def forward_hidden(params: Params, inputs: torch.Tensor, cfg: ArchConfig,
                   rt: RuntimeCfg = DEFAULT_RT):
    """Backbone only: the final normed hidden (B, S, d) and the aux loss.
    ``inputs`` are (B, S) tokens or (B, S, d) embeddings. The train loss
    fuses the LM head per sequence chunk (``runtime/train_loop.py``), so
    the full f32 (B, S, V) logits are never made."""
    if inputs.dim() == 2:
        x = embed_tokens(inputs, params["embed"]).to(rt.act_dtype)
    else:
        x = inputs.to(rt.act_dtype)
    x, aux = _run_stack(params, x, cfg, rt)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, inputs: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeCfg = DEFAULT_RT):
    """inputs (B, S) tokens or (B, S, d) embeddings → (logits (B, S, Vp)
    f32, aux loss)."""
    x, aux = forward_hidden(params, inputs, cfg, rt)
    logits = lm_logits(x, params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_qkv(x, p, posb: torch.Tensor, cfg: ArchConfig, rt: RuntimeCfg):
    """The decode step's q (B, 1, h, hd) and k/v (B, 1, kvh, hd), roped at
    each slot's position."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["w_q"], cfg, rt, "q").reshape(b, 1, h, hd)
    k = dense(x, p["w_k"], cfg, rt, "k").reshape(b, 1, kvh, hd)
    v = dense(x, p["w_v"], cfg, rt, "v").reshape(b, 1, kvh, hd)
    q = attn_mod.apply_rope(q, posb[:, None], cfg.rope_theta)
    k = attn_mod.apply_rope(k, posb[:, None], cfg.rope_theta)
    # q is one row per slot: its own placement lets a seq-sharded cache be
    # contracted where it lies (``runtime/sharding.make_shard_fn``)
    return shard_tag(rt, q, "decode_q"), k, v


def _decode_attend(q, kc, vc, posc, posb: torch.Tensor, cfg: ArchConfig,
                   out_dtype, window: int = 0) -> torch.Tensor:
    """One query row per slot against cache rows: kc/vc (B, S, kvh, hd),
    posc (B, S). A row is attended when it was written (``posc >= 0``) at
    a position up to the slot's own, and then, in the dense layout, when
    its index is at most ``pos``, or, in a rolling window, when its
    position lies in the window's last ``window`` positions. The dense and
    the paged decode steps both end here, so their arithmetic cannot
    drift. Returns (B, 1, h*hd) in ``out_dtype``."""
    b, smax = kc.shape[:2]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    # GQA kept grouped: (b, kv, g, hd) × (b, s, kv, hd), f32 accumulation.
    q5 = q.reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q5.float(), kc.float()) * scale
    # posc = -1 marks unwritten (or freed) rows; each slot attends only to
    # rows its own occupant wrote at positions <= its own pos.
    pcol = posb[:, None]
    valid = (posc >= 0) & (posc <= pcol)
    if window:
        valid &= posc > pcol - window
    else:
        valid &= torch.arange(smax, device=q.device)[None, :] <= pcol
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, attn_mod.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pr.to(vc.dtype).float(), vc.float())
    return o.reshape(b, 1, h * hd).to(out_dtype)


def _dense_rows(b: int, smax: int, posb: torch.Tensor, window: int = 0):
    """Where a dense decode step writes in a (B, smax) cache, the same in
    every layer of that length: each slot's row in the flattened (B *
    smax) rows, and whether the write is kept. A rolling window writes at
    ``posb % smax`` and always keeps it. A full-length cache writes at
    ``posb`` clamped to the slot's last row and keeps it only below
    ``smax``: a write at or past the cache's end is dropped, as the
    reference's ``.at[bidx, slot].set`` drops it (a speculative verify
    probes up to k-1 positions past an almost-full slot). Computed once
    per step."""
    base = torch.arange(0, b * smax, smax, device=posb.device)
    if window:
        return base + posb % smax, None
    return base + posb.clamp(max=smax - 1), posb < smax


def _dense_write(cache, k: torch.Tensor, v: torch.Tensor,
                 posb: torch.Tensor, rows: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> None:
    """Write each slot's new K/V (B, kvh, hd) and position at its row
    (:func:`_dense_rows`) in place. A dropped write puts the clamped row's
    old value back: a device select, no host sync."""
    b, smax = cache["k"].shape[:2]
    for key, new in (("k", k), ("v", v), ("pos", posb)):
        flat = cache[key].view((b * smax,) + cache[key].shape[2:])
        new = new.to(flat.dtype)
        if keep is not None:
            old = flat.index_select(0, rows)
            mask = keep.view((b,) + (1,) * (old.dim() - 1))
            new = torch.where(mask, new, old)
        flat.index_copy_(0, rows, new)


def _decode_attn(x, p, cache, posb: torch.Tensor, rows: torch.Tensor,
                 keep: Optional[torch.Tensor], cfg: ArchConfig,
                 rt: RuntimeCfg, window: int = 0):
    """One-token attention over the dense (or rolling-window) cache, each
    slot at its own position ``posb`` (B,), writing where
    :func:`_dense_rows` says. The cache is updated in place."""
    q, k, v = _decode_qkv(x, p, posb, cfg, rt)
    _dense_write(cache, k[:, 0], v[:, 0], posb, rows, keep)
    o = _decode_attend(q, cache["k"], cache["v"], cache["pos"], posb, cfg,
                       x.dtype, window)
    return dense(o, p["w_o"], cfg, rt, "o")


def _paged_decode_attn(x, p, cache, posb: torch.Tensor,
                       page_map: torch.Tensor, cfg: ArchConfig,
                       rt: RuntimeCfg):
    """Decode attention over the pooled paged cache.

    ``cache`` holds pools: k/v ``(n_pages+1, page_size, kvh, hd)``, pos
    ``(n_pages+1, page_size)``; ``page_map`` is ``(B, max_pages)`` int32
    (``-1`` = unallocated). The last physical page is a *trash* page owned
    by no slot: writes for slots whose current page entry is ``-1`` (idle
    slots), or whose position is at or past ``max_pages * page_size``, land
    there, and gathers of unallocated logical pages read from it. Its rows
    are never attended to: an unallocated logical page's row indices all
    exceed the slot's ``pos`` (tables are prefixes), so the causal mask
    kills them.

    Exactness: the new token is written in place, the slot's pages are
    gathered back into the dense ``(B, max_len, ...)`` layout (row i holds
    position i; ``max_pages * page_size == max_len``), and the dense path's
    own arithmetic (:func:`_decode_attend`) runs on it. Masked rows get the
    same NEG_INF and a softmax weight of exactly 0, so paged greedy decode
    equals dense token for token.
    """
    b = x.shape[0]
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    q, k, v = _decode_qkv(x, p, posb, cfg, rt)
    kp, vp, pp = cache["k"], cache["v"], cache["pos"]
    ps = kp.shape[1]
    mp = page_map.shape[1]
    trash = kp.shape[0] - 1

    # write the current token at (physical page, in-page offset)
    lpage = torch.clamp(posb // ps, 0, mp - 1)
    off = posb % ps
    phys = torch.gather(page_map, 1, lpage[:, None])[:, 0].long()
    phys = torch.where((phys >= 0) & (posb < mp * ps), phys,
                       torch.full_like(phys, trash))
    kp[phys, off] = k[:, 0].to(kp.dtype)
    vp[phys, off] = v[:, 0].to(vp.dtype)
    pp[phys, off] = posb.to(pp.dtype)

    # gather back into the dense (b, max_len, ...) layout
    safe = torch.where(page_map >= 0, page_map,
                       torch.full_like(page_map, trash)).long()
    kc = kp[safe].reshape(b, mp * ps, kvh, hd)
    vc = vp[safe].reshape(b, mp * ps, kvh, hd)
    posc = pp[safe].reshape(b, mp * ps)
    o = _decode_attend(q, kc, vc, posc, posb, cfg, x.dtype)
    return dense(o, p["w_o"], cfg, rt, "o")


def _dense_attn(caches: Caches, posb: torch.Tensor, cfg: ArchConfig,
                rt: RuntimeCfg, paged_attn=None):
    """The step's attention ``attn(kind, h, p, cache)``: the write rows of
    each cache length computed once, before the layers; ``paged_attn``,
    when given, serves the :data:`PAGED_KINDS` layers."""
    b = posb.shape[0]
    rows = {}
    for kind, c in zip(layer_kinds(cfg), caches):
        if kind in STATE_KINDS or (paged_attn is not None
                                   and kind in PAGED_KINDS):
            continue
        window = _window(cfg, kind)
        key = (c["k"].shape[1], window)
        if key not in rows:
            rows[key] = _dense_rows(b, key[0], posb, window)

    def attn(kind, h, p, cache):
        if paged_attn is not None and kind in PAGED_KINDS:
            return paged_attn(h, p, cache)
        window = _window(cfg, kind)
        r, keep = rows[cache["k"].shape[1], window]
        return _decode_attn(h, p, cache, posb, r, keep, cfg, rt, window)
    return attn


def _positions(pos, b: int, device) -> torch.Tensor:
    posb = torch.as_tensor(pos, device=device).to(torch.long)
    return posb.expand(b) if posb.dim() == 0 else posb


def _decode_block(kind: str, x: torch.Tensor, p: Params, cache, attn,
                  cfg: ArchConfig, rt: RuntimeCfg) -> torch.Tensor:
    """One layer of a decode step (``attn`` from :func:`_dense_attn`); its
    cache is written in place, a state leaf replaced in the dict."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba2":
        o, (cache["h"], cache["conv"]) = m2.mamba2_decode(
            h, p["mamba"], cfg, (cache["h"], cache["conv"]), rt)
        return x + o
    if kind == "rwkv6":
        o, (cache["S"], cache["prev_tm"]) = rk.rwkv6_decode(
            h, p["rwkv"], cfg, (cache["S"], cache["prev_tm"]), rt)
        x = x + o
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        o, cache["prev_cm"] = rk.rwkv6_channel_mix_decode(
            h, p["rwkv"], cfg, cache["prev_cm"], rt)
        return x + o
    x = x + attn(kind, h, p["attn"], cache)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn(kind, h, p, cfg, rt)


def _decode(params: Params, tokens: torch.Tensor, caches: Caches, pos,
            cfg: ArchConfig, rt: RuntimeCfg, page_map=None):
    """The decode stack, each layer's attention from :func:`_dense_attn`
    (and, with ``page_map``, the paged attention of the pooled layers);
    each super-layer's input placed by the ``act_btd`` tag."""
    posb = _positions(pos, tokens.shape[0], tokens.device)
    paged = None
    if page_map is not None:
        paged = lambda h, p, cache: _paged_decode_attn(  # noqa: E731
            h, p, cache, posb, page_map, cfg, rt)
    attn = _dense_attn(caches, posb, cfg, rt, paged)
    x = embed_tokens(tokens, params["embed"]).to(rt.act_dtype)
    n_pat = len(cfg.superlayer_pattern)
    n_stack = cfg.num_superlayers * n_pat
    for i, (kind, p, cache) in enumerate(zip(layer_kinds(cfg),
                                             params["layers"], caches)):
        if i < n_stack and i % n_pat == 0:
            x = shard_tag(rt, x, "act_btd")
        x = _decode_block(kind, x, block_params(kind, p, params), cache,
                          attn, cfg, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, 0], params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, caches


def decode_step(params: Params, tokens: torch.Tensor, caches: Caches, pos,
                cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT):
    """One decoding step. tokens (B, 1); ``pos`` a scalar (lockstep) or a
    (B,) vector (continuous batching). A slot at or past the cache length
    writes nothing to a full-length cache (its row attends to the cache as
    it stands), as in the reference; a rolling window always writes, at
    ``pos % window``. Returns (logits (B, Vp) f32, caches updated in
    place)."""
    return _decode(params, tokens, caches, pos, cfg, rt)


def paged_decode_step(params: Params, tokens: torch.Tensor, caches: Caches,
                      pos, page_map: torch.Tensor, cfg: ArchConfig,
                      rt: RuntimeCfg = DEFAULT_RT):
    """``decode_step`` over a paged cache (``init_paged_cache`` layout).
    ``page_map`` (B, max_pages) int32 is shared by every pooled layer: one
    physical page id names the same rows in each layer's pools; the
    rolling windows stay slot-indexed and decode as in ``decode_step``.
    Returns (logits (B, Vp) f32, caches updated in place)."""
    page_map = page_map.to(device=tokens.device, dtype=torch.int32)
    return _decode(params, tokens, caches, pos, cfg, rt, page_map)


# ---------------------------------------------------------------------------
# Speculative multi-token verify (core/speculative.py)
# ---------------------------------------------------------------------------

def window_layers(caches: Caches, cfg: ArchConfig) -> Caches:
    """The rolling-window (state) leaves among ``caches``: those a decode
    step overwrites in place, where masking cannot bring back the row it
    replaced."""
    return [c for kind, c in zip(layer_kinds(cfg), caches)
            if kind == "attn_local"]


def state_layers(caches: Caches, cfg: ArchConfig) -> Caches:
    """The recurrent layers' caches (:data:`STATE_KINDS`): every decode
    step replaces their leaves whole."""
    return [c for kind, c in zip(layer_kinds(cfg), caches)
            if kind in STATE_KINDS]


def snapshot_states(states: Caches) -> Caches:
    """The state leaves as they stand: references, not copies (a step
    replaces a leaf and leaves the old tensor as it was)."""
    return [dict(c) for c in states]


def restore_states(states: Caches, snap: Caches) -> None:
    """Put a :func:`snapshot_states` back."""
    for c, old in zip(states, snap):
        c.update(old)


def save_window_rows(win: Caches, posb: torch.Tensor):
    """The rows a decode step at ``posb`` is about to overwrite in each
    rolling window, ``posb % w`` of each slot: (rows, [{k, v, pos} of
    those rows per layer]). With :func:`restore_window_rows` it is the
    undo log of the steps of a draft or a verify."""
    if not win:
        return None
    b, w = win[0]["k"].shape[:2]
    rows = torch.arange(0, b * w, w, device=posb.device) + posb % w
    return rows, [{key: c[key].view((b * w,) + c[key].shape[2:])
                   .index_select(0, rows) for key in ("k", "v", "pos")}
                  for c in win]


def restore_window_rows(win: Caches, log, undo: Optional[torch.Tensor] = None
                        ) -> None:
    """Put back the rows :func:`save_window_rows` saved, the last step
    first, so that a row two steps wrote gets its oldest value. ``log[j]``
    is step j's entry; with ``undo`` (B, k) bool only the (slot, step)
    pairs marked are put back, the others keep their write."""
    if not win:
        return
    b, w = win[0]["k"].shape[:2]
    for j in reversed(range(len(log))):
        rows, saved = log[j]
        for c, old in zip(win, saved):
            for key in ("k", "v", "pos"):
                flat = c[key].view((b * w,) + c[key].shape[2:])
                val = old[key]
                if undo is not None:
                    mask = undo[:, j].view((b,) + (1,) * (val.dim() - 1))
                    val = torch.where(mask, val, flat.index_select(0, rows))
                flat.index_copy_(0, rows, val)


def _rollback_caches(caches: Caches, n_acc: torch.Tensor, posb: torch.Tensor,
                     k: int, cfg: ArchConfig, log, snaps: List[Caches],
                     page_map: Optional[torch.Tensor] = None) -> None:
    """Bring a k-step verify's caches, in place, to each slot's state after
    its step ``n_acc``, as the reference's snapshot selection does. The
    leaf classes differ:

    * **Append leaves** (the :data:`PAGED_KINDS` K/V/pos): row ``posb + j``
      holds step j's write only, so every row above ``posb + n_acc`` goes
      back to the init values (pos -1, k/v 0), which is what an unwritten
      row holds: scrubbing a row nobody wrote changes nothing. Dense
      ``(B, max_len, ...)``: a mask over the rows (row index == position).
      Pooled ``(pages + 1, page_size, ...)``: each rejected step's (page,
      offset) row is scattered to the init values; accepted steps and
      unmapped or out-of-range positions go to the trash page.
    * **Rolling windows**: a step overwrites the row of the position
      ``window`` before its own, which no mask recovers. The reference
      keeps a snapshot of the whole cache per step; the port keeps the
      rows each step overwrote (``log``, from :func:`save_window_rows`)
      and puts back those of the rejected steps ``j > n_acc``, newest
      first. The window ends bit-equal to the reference's snapshot at step
      ``n_acc``.
    * **Recurrent states** (:data:`STATE_KINDS`): each step replaces them
      whole, so ``snaps[j]`` (:func:`snapshot_states` after step j) holds
      references to step j's tensors; each slot takes its row of
      ``snaps[n_acc]``, as the reference's per-slot gather does.
    """
    kinds = layer_kinds(cfg)
    append = [c for kind, c in zip(kinds, caches) if kind in PAGED_KINDS]
    j = torch.arange(k, device=posb.device)
    restore_window_rows(window_layers(caches, cfg), log,
                        j[None, :] > n_acc[:, None])
    slots = torch.arange(posb.shape[0], device=posb.device)
    pick = n_acc.long()
    for li, c in enumerate(state_layers(caches, cfg)):
        for key in c:
            c[key] = torch.stack([s[li][key] for s in snaps])[pick, slots]
    if not append:
        return
    if page_map is None:
        smax = append[0]["k"].shape[1]
        rows = torch.arange(smax, device=posb.device)
        scrub = rows[None, :] > (posb + n_acc)[:, None]          # (B, smax)
        for c in append:
            c["pos"].masked_fill_(scrub, -1)
            c["k"].masked_fill_(scrub[:, :, None, None], 0)
            c["v"].masked_fill_(scrub[:, :, None, None], 0)
        return
    pool = append[0]["k"]
    ps, trash = pool.shape[1], pool.shape[0] - 1
    mp = page_map.shape[1]
    j = j[1:]
    pj = posb[:, None] + j[None, :]                              # (B, k-1)
    lpage = torch.clamp(pj // ps, 0, mp - 1)
    phys = torch.gather(page_map.long(), 1, lpage)
    phys = torch.where((phys >= 0) & (pj < mp * ps) & (j[None, :]
                                                       > n_acc[:, None]),
                       phys, torch.full_like(phys, trash)).flatten()
    off = (pj % ps).flatten()
    for c in append:
        c["pos"][phys, off] = -1
        c["k"][phys, off] = 0
        c["v"][phys, off] = 0


def verify_decode(params: Params, tokens_seq: torch.Tensor, caches: Caches,
                  pos, active, cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT,
                  page_map: Optional[torch.Tensor] = None):
    """The k-step verify behind :func:`multi_decode_step` (and, with
    ``page_map``, :func:`paged_multi_decode_step`). Step ``j`` runs the
    plain decode step at ``pos + j`` on the ``B = slots`` rows, one step
    after another as in the reference: the same GEMM shapes and plans as
    plain decode, so each committed row has plain decode's bits. Returns
    ``(next_tokens (B, 1), greedy (B, k), n_acc (B,), caches, logits (B,
    k, Vp))``; the caches are rolled back in place
    (:func:`_rollback_caches`)."""
    b, k = tokens_seq.shape
    dev = tokens_seq.device
    posb = _positions(pos, b, dev)
    win = window_layers(caches, cfg)
    states = state_layers(caches, cfg)
    greedy, logits, log, snaps = [], [], [], []
    for j in range(k):
        tok = tokens_seq[:, j:j + 1].to(torch.int32)
        log.append(save_window_rows(win, posb + j))
        if page_map is None:
            lg, caches = decode_step(params, tok, caches, posb + j, cfg, rt)
        else:
            lg, caches = paged_decode_step(params, tok, caches, posb + j,
                                           page_map, cfg, rt)
        snaps.append(snapshot_states(states))
        greedy.append(torch.argmax(lg, dim=-1).to(torch.int32))
        logits.append(lg)
    g = torch.stack(greedy, dim=1)                               # (B, k)
    logits = torch.stack(logits, dim=1)
    if k == 1:
        return g[:, 0:1], g, torch.zeros((b,), dtype=torch.int32,
                                          device=dev), caches, logits
    match = tokens_seq[:, 1:].to(torch.int32) == g[:, :-1]
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    # idle slots behave as in plain decode, one write at their parked
    # position: their drafts are never accepted
    active = torch.as_tensor(active, device=dev).to(torch.bool)
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc)).to(
        torch.int32)
    next_tok = torch.gather(g, 1, n_acc[:, None].long())
    page_map = None if page_map is None else page_map.to(device=dev)
    _rollback_caches(caches, n_acc, posb, k, cfg, log, snaps, page_map)
    return next_tok, g, n_acc, caches, logits


def multi_decode_step(params: Params, tokens_seq: torch.Tensor,
                      caches: Caches, pos, active, cfg: ArchConfig,
                      rt: RuntimeCfg = DEFAULT_RT):
    """Score k candidate tokens (speculative verify).

    ``tokens_seq`` (B, k) holds each slot's next input token and k-1
    drafts; ``pos`` (B,) each slot's decode position; ``active`` (B,) bool
    marks occupied slots. Step ``j`` is plain ``decode_step`` at ``pos +
    j``, so its argmax ``greedy[:, j]`` is what plain greedy decode emits
    after committing the first ``j`` candidates, and ``n_acc`` is the
    longest prefix of drafts matching them. Where the batch's rows do not
    interact, the committed tokens ``greedy[:, :n_acc + 1]`` are plain
    greedy decode's. A MoE layer's expert capacity couples the rows of a
    step, so there a rejected draft of one slot can change another slot's
    routing, as in the reference.

    Returns ``(next_tokens (B, 1), greedy (B, k), n_acc (B,), caches)``,
    the caches updated in place with the rejected writes rolled back."""
    return verify_decode(params, tokens_seq, caches, pos, active, cfg,
                         rt)[:4]


def paged_multi_decode_step(params: Params, tokens_seq: torch.Tensor,
                            caches: Caches, pos, active,
                            page_map: torch.Tensor, cfg: ArchConfig,
                            rt: RuntimeCfg = DEFAULT_RT):
    """:func:`multi_decode_step` over a paged cache: the rejected pool
    writes are scrubbed before the host sees ``n_acc``, so the allocator
    can release over-grown pages afterwards (``PageAllocator.trim_slot``)
    without touching the card."""
    return verify_decode(params, tokens_seq, caches, pos, active, cfg, rt,
                         page_map=page_map)[:4]


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------

def _rows(n: int, batch: int, cfg: ArchConfig, dtype, device
          ) -> Dict[str, torch.Tensor]:
    """``batch`` × ``n`` zeroed K/V rows and ``pos = -1`` (unwritten)."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, n, kvh, hd), dtype=dtype, device=device),
            "pos": torch.full((batch, n), -1, dtype=torch.int32,
                              device=device)}


def _block_cache(kind: str, batch: int, max_len: int, cfg: ArchConfig,
                 dtype, device) -> Dict[str, torch.Tensor]:
    """One layer's dense cache: ``max_len`` rows per slot, the rolling
    window's ``min(window, max_len)``, or a recurrent layer's zeroed
    state (f32 but rwkv6's ``prev`` rows, in ``dtype``)."""
    if kind == "attn_local":
        return _rows(min(cfg.window_size, max_len), batch, cfg, dtype, device)
    if kind == "mamba2":
        h, conv = m2.init_mamba2_state(batch, cfg, device)
        return {"h": h, "conv": conv}
    if kind == "rwkv6":
        d, hd = cfg.d_model, cfg.ssm_head_dim
        return {"S": torch.zeros((batch, d // hd, hd, hd),
                                 dtype=torch.float32, device=device),
                "prev_tm": torch.zeros((batch, 1, d), dtype=dtype,
                                       device=device),
                "prev_cm": torch.zeros((batch, 1, d), dtype=dtype,
                                       device=device)}
    return _rows(max_len, batch, cfg, dtype, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Caches:
    """Zeroed K/V and ``pos = -1`` (unwritten) rows, or a zeroed state,
    one dict per layer."""
    check_supported(cfg)
    return [_block_cache(kind, batch, max_len, cfg, dtype, device)
            for kind in layer_kinds(cfg)]


def cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> Caches:
    """:func:`init_cache`'s tree on the ``meta`` device (shapes and
    dtypes, no storage)."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int,
                     page_size: int, pages: int, dtype=torch.bfloat16,
                     device=None) -> Caches:
    """Paged twin of ``init_cache``: the K/V/pos of each
    :data:`PAGED_KINDS` layer become pools of ``pages + 1`` physical pages
    (the extra one is the trash page, see ``_paged_decode_attn``) of
    ``page_size`` rows each, shared by all ``batch`` slots: k/v zeroed,
    pos -1. The rolling windows and the recurrent states stay
    slot-indexed, as in ``init_cache``.
    Requires ``max_len % page_size == 0`` so the gathered layout matches
    the dense one row for row."""
    check_supported(cfg)
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} not a multiple of "
                         f"page_size={page_size}")
    return [_rows(page_size, pages + 1, cfg, dtype, device)
            if kind in PAGED_KINDS
            else _block_cache(kind, batch, max_len, cfg, dtype, device)
            for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# One super-layer alone: the per-layer probes of ``launch/dryrun.py``
# ---------------------------------------------------------------------------

def superlayer_params_slice(params: Params, cfg: ArchConfig) -> List[Params]:
    """The first super-layer's layer dicts (a ``shared_attn`` layer's is
    empty: its block is ``params["shared_attn"]``). Works on a
    :func:`params_shape` tree too."""
    return params["layers"][:len(cfg.superlayer_pattern)]


def superlayer_cache_slice(caches: Caches, cfg: ArchConfig) -> Caches:
    """The first super-layer's layer caches."""
    return caches[:len(cfg.superlayer_pattern)]


def _pick(kind: str, p: Params, shared: Optional[Params]) -> Params:
    return shared if kind == "shared_attn" else p


def superlayer_forward(x: torch.Tensor, p_super: List[Params],
                       shared: Optional[Params], cfg: ArchConfig,
                       rt: RuntimeCfg):
    """One super-layer's training forward under ``cfg.remat``, its input
    placed by the ``act_btd`` tag as in the stack: x -> (x', aux)."""
    kinds = list(cfg.superlayer_pattern)
    x = shard_tag(rt, x, "act_btd")
    ps = [_pick(k, p, shared) for k, p in zip(kinds, p_super)]
    return _remat(_superlayer_body(kinds, ps, cfg, rt), cfg)(x)


def superlayer_train_cost(x: torch.Tensor, ct: torch.Tensor,
                          p_super: List[Params], shared: Optional[Params],
                          cfg: ArchConfig, rt: RuntimeCfg):
    """Forward and backward of one super-layer (the per-layer train-cost
    probe): the gradients of ``sum(y * ct) + aux`` with respect to (x,
    p_super) and, when there is one, the shared block, as trees of their
    structure."""
    trees = [x, p_super] + ([shared] if shared is not None else [])
    flat = tree.leaves(trees)
    diff = [t.detach().requires_grad_(True) for t in flat]
    it = iter(diff)
    xs, ps, *sh = tree.map_tree(lambda _: next(it), trees)
    with torch.enable_grad():
        y, aux = superlayer_forward(xs, ps, sh[0] if sh else None, cfg, rt)
        loss = torch.sum(y.float() * ct.float()) + aux
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = iter([torch.zeros_like(t) if g is None else g
                  for t, g in zip(flat, grads)])
    return tuple(tree.map_tree(lambda _: next(grads), trees))


def superlayer_decode(x: torch.Tensor, p_super: List[Params],
                      cache_super: Caches, pos, shared: Optional[Params],
                      cfg: ArchConfig, rt: RuntimeCfg):
    """One super-layer of a dense-cache decode step at ``pos``: (x, its
    caches) -> (x', the caches, written in place)."""
    kinds = list(cfg.superlayer_pattern)
    posb = _positions(pos, x.shape[0], x.device)
    attn = _dense_attn(cache_super, posb, cfg, rt)
    for kind, p, cache in zip(kinds, p_super, cache_super):
        x = _decode_block(kind, x, _pick(kind, p, shared), cache, attn,
                          cfg, rt)
    return x, cache_super
