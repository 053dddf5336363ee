"""Decoder stack for ``attn_dense`` architectures (llama3 and its kin).

Twin of ``repro/models/transformer.py`` for the serving slices:
``init_params``, ``prefill``, ``decode_step`` (with ``_decode_attn``) and
``init_cache``, the paged twins ``paged_decode_step`` (with
``_paged_decode_attn``) and ``init_paged_cache``, and the speculative
verify ``multi_decode_step`` / ``paged_multi_decode_step`` with the
rollback of rejected writes (``_rollback_caches``). Where the reference
scans over parameters stacked on a leading layer axis, the port keeps a
Python list with one dict per layer and loops over it (PyTorch runs
eagerly; there is no trace to keep small).

Decode writes the new token's K/V into the cache in place, saving a copy
of the whole cache per step; ``decode_step`` returns the same cache
objects it was given; the paged step does the same to its page pools.
Other block kinds (MoE, local attention, SSM, hybrid) are later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    DEFAULT_RT, RuntimeCfg, dense, embed_tokens, lm_logits, rms_norm,
    swiglu_mlp)

Params = Dict[str, Any]
Caches = List[Dict[str, torch.Tensor]]

# Block kinds whose K/V/pos leaves become page pools in the paged cache.
PAGED_KINDS = ("attn_dense", "attn_global", "attn_moe", "shared_attn")


def check_supported(cfg: ArchConfig) -> None:
    if cfg.superlayer_pattern != ("attn_dense",):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.superlayer_pattern} — only "
            "attn_dense stacks are ported so far; the other block kinds "
            "(MoE, local/global attention, mamba2, rwkv6, hybrid) come in "
            "a later slice")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init(shape, dtype, generator, device, scale: Optional[float] = None):
    """normal × fan_in^-0.5 (or ``scale``), drawn in f32 then cast."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * s).to(dtype)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype=torch.bfloat16) -> Params:
    """Random weights with the reference's shapes and scales (norms are
    f32 zeros: the norm scale is ``1 + gamma``). The numbers differ from
    ``jax.random``'s; parity tests bridge the JAX init instead."""
    check_supported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab

    def w(*shape, scale=None):
        return _init(shape, dtype, generator, device, scale)

    def zeros():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    params: Params = {"embed": w(vp, d, scale=1.0), "head": w(d, vp),
                      "final_norm": zeros(), "layers": []}
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "norm1": zeros(),
            "attn": {"w_q": w(d, cfg.q_dim), "w_k": w(d, cfg.kv_dim),
                     "w_v": w(d, cfg.kv_dim), "w_o": w(cfg.q_dim, d)},
            "norm2": zeros(),
            "mlp": {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                    "w_down": w(cfg.d_ff, d)},
        })
    return params


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _kv_to_cache(k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decode cache from prefill K/V (B, S, kv, hd); ``pos`` is per row."""
    b, s = k.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=k.device)
    return {"k": k, "v": v, "pos": pos.expand(b, s)}


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            rt: RuntimeCfg = DEFAULT_RT):
    """tokens (B, S) → (last-token logits (B, Vp) f32, per-layer caches)."""
    x = embed_tokens(tokens, params["embed"]).to(rt.act_dtype)
    caches: Caches = []
    for p in params["layers"]:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        a, (k, v) = attn_mod.attention_block(h, p["attn"], cfg, rt,
                                             return_kv=True)
        caches.append(_kv_to_cache(k, v))
        x = x + a
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + swiglu_mlp(h, p["mlp"], cfg, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, -1], params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, caches


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
    return q, k, v


def _decode_attend(q, kc, vc, posc, posb: torch.Tensor, cfg: ArchConfig,
                   out_dtype) -> torch.Tensor:
    """One query row per slot against cache rows in the dense layout: kc/vc
    (B, S, kvh, hd), posc (B, S). Row i is attended when it was written
    (``posc >= 0``) at a position up to the slot's own and ``i <= pos``.
    The dense and the paged decode steps both end here, so their arithmetic
    cannot drift. Returns (B, 1, h*hd) in ``out_dtype``."""
    b, smax = kc.shape[:2]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    # GQA kept grouped: (b, kv, g, hd) × (b, s, kv, hd), f32 accumulation.
    q5 = q.reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q5.float(), kc.float()) * scale
    # posc = -1 marks unwritten (or freed) rows; each slot attends only to
    # rows its own occupant wrote at positions <= its own pos.
    pcol = posb[:, None]
    valid = (posc >= 0) & (posc <= pcol) \
        & (torch.arange(smax, device=q.device)[None, :] <= pcol)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, attn_mod.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pr.to(vc.dtype).float(), vc.float())
    return o.reshape(b, 1, h * hd).to(out_dtype)


def _dense_rows(caches: Caches, posb: torch.Tensor):
    """Where a dense decode step writes, the same in every layer: each
    slot's row ``posb`` in the flattened (B * max_len) rows, clamped to the
    slot's last row, and whether the write is kept (``posb < max_len``).
    A write at or past the cache's end is dropped, as the reference's
    ``.at[bidx, slot].set`` drops it (a speculative verify probes up to k-1
    positions past an almost-full slot). Computed once per step."""
    b, smax = caches[0]["k"].shape[:2]
    rows = torch.arange(0, b * smax, smax, device=posb.device) \
        + posb.clamp(max=smax - 1)
    return rows, posb < smax


def _dense_write(cache, k: torch.Tensor, v: torch.Tensor,
                 posb: torch.Tensor, rows: torch.Tensor,
                 keep: torch.Tensor) -> None:
    """Write each slot's new K/V (B, kvh, hd) and position at its row
    (:func:`_dense_rows`) in place. A dropped write puts the clamped row's
    old value back: a device select, no host sync."""
    b, smax = cache["k"].shape[:2]
    for key, new in (("k", k), ("v", v), ("pos", posb)):
        flat = cache[key].view((b * smax,) + cache[key].shape[2:])
        old = flat.index_select(0, rows)
        mask = keep.view((b,) + (1,) * (old.dim() - 1))
        flat.index_copy_(0, rows, torch.where(mask, new.to(flat.dtype), old))


def _decode_attn(x, p, cache, posb: torch.Tensor, rows: torch.Tensor,
                 keep: torch.Tensor, cfg: ArchConfig, rt: RuntimeCfg):
    """One-token attention over the dense cache, each slot at its own
    position ``posb`` (B,), writing where :func:`_dense_rows` says. The
    cache is updated in place."""
    q, k, v = _decode_qkv(x, p, posb, cfg, rt)
    _dense_write(cache, k[:, 0], v[:, 0], posb, rows, keep)
    o = _decode_attend(q, cache["k"], cache["v"], cache["pos"], posb, cfg,
                       x.dtype)
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


def _decode(params: Params, tokens: torch.Tensor, caches: Caches, pos,
            cfg: ArchConfig, rt: RuntimeCfg, make_attn):
    """The decode stack; ``make_attn(posb)`` gives the step's attention
    ``attn(h, p, cache)`` (per-step work done once, before the layers)."""
    b = tokens.shape[0]
    posb = torch.as_tensor(pos, device=tokens.device).to(torch.long)
    posb = posb.expand(b) if posb.dim() == 0 else posb
    attn = make_attn(posb)
    x = embed_tokens(tokens, params["embed"]).to(rt.act_dtype)
    for p, cache in zip(params["layers"], caches):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn(h, p["attn"], cache)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + swiglu_mlp(h, p["mlp"], cfg, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, 0], params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, caches


def decode_step(params: Params, tokens: torch.Tensor, caches: Caches, pos,
                cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT):
    """One decoding step. tokens (B, 1); ``pos`` a scalar (lockstep) or a
    (B,) vector (continuous batching). A slot at or past the cache length
    writes nothing (its row attends to the cache as it stands), as in the
    reference. Returns (logits (B, Vp) f32, caches updated in place)."""
    def make_attn(posb):
        rows, keep = _dense_rows(caches, posb)
        return lambda h, p, cache: _decode_attn(h, p, cache, posb, rows,
                                                keep, cfg, rt)
    return _decode(params, tokens, caches, pos, cfg, rt, make_attn)


def paged_decode_step(params: Params, tokens: torch.Tensor, caches: Caches,
                      pos, page_map: torch.Tensor, cfg: ArchConfig,
                      rt: RuntimeCfg = DEFAULT_RT):
    """``decode_step`` over a paged cache (``init_paged_cache`` layout).
    ``page_map`` (B, max_pages) int32 is shared by every layer: one
    physical page id names the same rows in each layer's pools. Returns
    (logits (B, Vp) f32, caches updated in place)."""
    page_map = page_map.to(device=tokens.device, dtype=torch.int32)
    return _decode(params, tokens, caches, pos, cfg, rt,
                   lambda posb: lambda h, p, cache: _paged_decode_attn(
                       h, p, cache, posb, page_map, cfg, rt))


# ---------------------------------------------------------------------------
# Speculative multi-token verify (core/speculative.py)
# ---------------------------------------------------------------------------

def _rollback_caches(caches: Caches, n_acc: torch.Tensor, posb: torch.Tensor,
                     k: int, page_map: Optional[torch.Tensor] = None) -> None:
    """Scrub the rejected writes of a k-step verify, in place: every row
    above ``posb + n_acc`` goes back to the init values (pos -1, k/v 0),
    which is what an unwritten row holds, so scrubbing a row nobody wrote
    changes nothing. Row ``posb + j`` holds step ``j``'s write only, so
    the rows kept are the accepted steps' own.

    The reference keeps the last of its per-step snapshots and scrubs it
    the same way; only its append leaves (the attention K/V/pos that
    ``check_supported`` admits) are needed here. The state-leaf snapshots
    come with the block kinds that have state.

    * Dense ``(B, max_len, ...)``: a mask over the rows (row index ==
      position).
    * Pooled ``(pages + 1, page_size, ...)``: each rejected step's (page,
      offset) row is scattered to the init values; accepted steps and
      unmapped or out-of-range positions go to the trash page (several
      writes of one constant to it are harmless).
    """
    if page_map is None:
        smax = caches[0]["k"].shape[1]
        rows = torch.arange(smax, device=posb.device)
        scrub = rows[None, :] > (posb + n_acc)[:, None]          # (B, smax)
        for c in caches:
            c["pos"].masked_fill_(scrub, -1)
            c["k"].masked_fill_(scrub[:, :, None, None], 0)
            c["v"].masked_fill_(scrub[:, :, None, None], 0)
        return
    pool = caches[0]["k"]
    ps, trash = pool.shape[1], pool.shape[0] - 1
    mp = page_map.shape[1]
    j = torch.arange(1, k, device=posb.device)
    pj = posb[:, None] + j[None, :]                              # (B, k-1)
    lpage = torch.clamp(pj // ps, 0, mp - 1)
    phys = torch.gather(page_map.long(), 1, lpage)
    phys = torch.where((phys >= 0) & (pj < mp * ps) & (j[None, :]
                                                       > n_acc[:, None]),
                       phys, torch.full_like(phys, trash)).flatten()
    off = (pj % ps).flatten()
    for c in caches:
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
    posb = torch.as_tensor(pos, device=dev).to(torch.long)
    posb = posb.expand(b) if posb.dim() == 0 else posb
    greedy, logits = [], []
    for j in range(k):
        tok = tokens_seq[:, j:j + 1].to(torch.int32)
        if page_map is None:
            lg, caches = decode_step(params, tok, caches, posb + j, cfg, rt)
        else:
            lg, caches = paged_decode_step(params, tok, caches, posb + j,
                                           page_map, cfg, rt)
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
    _rollback_caches(caches, n_acc, posb, k, page_map)
    return next_tok, g, n_acc, caches, logits


def multi_decode_step(params: Params, tokens_seq: torch.Tensor,
                      caches: Caches, pos, active, cfg: ArchConfig,
                      rt: RuntimeCfg = DEFAULT_RT):
    """Score k candidate tokens (speculative verify).

    ``tokens_seq`` (B, k) holds each slot's next input token and k-1
    drafts; ``pos`` (B,) each slot's decode position; ``active`` (B,) bool
    marks occupied slots. Step ``j`` is plain ``decode_step`` at ``pos +
    j``, so its argmax ``greedy[:, j]`` is what plain greedy decode emits
    after committing the first ``j`` candidates; ``n_acc`` is the longest
    prefix of drafts matching them, and the committed tokens
    ``greedy[:, :n_acc + 1]`` are plain greedy decode's.

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


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Caches:
    """Zeroed K/V and ``pos = -1`` (unwritten) rows, one dict per layer."""
    check_supported(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    return [{"k": torch.zeros((batch, max_len, kvh, hd), dtype=dtype,
                              device=device),
             "v": torch.zeros((batch, max_len, kvh, hd), dtype=dtype,
                              device=device),
             "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device)}
            for _ in range(cfg.num_layers)]


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int,
                     page_size: int, pages: int, dtype=torch.bfloat16,
                     device=None) -> Caches:
    """Paged twin of ``init_cache``: each layer's K/V/pos become pools of
    ``pages + 1`` physical pages (the extra one is the trash page, see
    ``_paged_decode_attn``) of ``page_size`` rows each, shared by all
    ``batch`` slots: k/v zeroed, pos -1. Requires ``max_len % page_size ==
    0`` so the gathered layout matches the dense one row for row."""
    check_supported(cfg)
    if max_len % page_size:
        raise ValueError(f"max_len={max_len} not a multiple of "
                         f"page_size={page_size}")
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    p1 = pages + 1
    return [{"k": torch.zeros((p1, page_size, kvh, hd), dtype=dtype,
                              device=device),
             "v": torch.zeros((p1, page_size, kvh, hd), dtype=dtype,
                              device=device),
             "pos": torch.full((p1, page_size), -1, dtype=torch.int32,
                               device=device)}
            for _ in range(cfg.num_layers)]
