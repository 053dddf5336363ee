"""Attention: the chunked online-softmax prefill path and the block.

Twin of ``repro/models/attention.py``. ``chunked_attention`` is the plain
prefill path (blocked online softmax, fully masked blocks skipped, and a
sliding ``window`` for local layers); ``attention_block`` switches to the
flash-attention kernel when ``rt.use_pallas`` is set and the layer has no
window, as the reference does: local layers always prefill through
``chunked_attention``. ``decode_attention`` / ``decode_attention_block``
are the reference's single-token forms over a cache written at ``pos``
(the serving stack decodes through ``models/transformer.py`` instead).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    DEFAULT_RT, RuntimeCfg, apply_rope, dense, shard_tag)

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, kv, hd) -> (B, S, h, hd) by broadcast (GQA)."""
    b, s, kv, hd = k.shape
    if kv == num_heads:
        return k
    groups = num_heads // kv
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, num_heads, hd)


def _attn_block(q, k, v, qpos0: int, kpos0: int, *, causal: bool,
                window: int, scale: float):
    """One (q-chunk, kv-chunk) block → (scores max, exp sums, acc)."""
    cq, ck = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = qpos0 + torch.arange(cq, device=q.device)
    ki = kpos0 + torch.arange(ck, device=q.device)
    mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi[:, None] >= ki[None, :]
    if window:
        mask &= (qi[:, None] - ki[None, :]) < window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                         # (B, h, cq)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, l, acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      rt: RuntimeCfg = DEFAULT_RT,
                      q_offset: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention. q: (B, Sq, h, hd); k, v:
    (B, Skv, kv_heads, hd). Returns (B, Sq, h, hd)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(hd)
    cq, ck = min(rt.chunk_q, sq), min(rt.chunk_kv, skv)
    nq, nk = -(-sq // cq), -(-skv // ck)
    assert sq % cq == 0 and skv % ck == 0, (sq, cq, skv, ck)
    # the reference's jax.checkpoint per block: backward recomputes the
    # block's scores instead of keeping them (only where a gradient flows)
    remat = rt.remat_blocks and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        qpos0 = q_offset + i * cq
        j_hi = nk if not causal else min(nk, (qpos0 + cq + ck - 1) // ck)
        j_lo = max(0, (qpos0 - window) // ck) if window else 0
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(j_lo, j_hi):
            def block(a, bk, bv, qp=qpos0, kp=j * ck):
                return _attn_block(a, bk, bv, qp, kp, causal=causal,
                                   window=window, scale=scale)
            kj, vj = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
            if remat:
                bm, bl, bacc = checkpoint(block, qi, kj, vj,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                bm, bl, bacc = block(qi, kj, vj)
            m_new = torch.maximum(m, bm)
            c1, c2 = torch.exp(m - m_new), torch.exp(bm - m_new)
            l = l * c1 + bl * c2
            acc = acc * c1[..., None] + bacc * c2[..., None]
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]      # (B, h, cq, hd)
        outs.append(out.transpose(1, 2))                      # (B, cq, h, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a cache. q: (B, 1, h, hd); caches
    (B, Smax, kv, hd); ``cache_len`` (scalar or (B,)) is the number of
    valid positions, the new token's K/V already written; a ``window``
    keeps the last ``window`` of them."""
    b, _, h, hd = q.shape
    smax = k_cache.shape[1]
    k = _expand_kv(k_cache, h)
    v = _expand_kv(v_cache, h)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(smax, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < n
    if window:
        valid &= pos[None, :] >= n - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT, *,
                    window: int = 0,
                    positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Projections + RoPE + attention. x: (B, S, d)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = dense(x, p["w_q"], cfg, rt, "q").reshape(b, s, h, hd)
    k = dense(x, p["w_k"], cfg, rt, "k").reshape(b, s, kv, hd)
    v = dense(x, p["w_v"], cfg, rt, "v").reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_tag(rt, q, "attn_q")
    if rt.use_pallas and not window:
        from repro_torch.kernels import ops
        o = ops.flash_attention(q, k, v, causal=True)
    else:
        o = chunked_attention(q, k, v, causal=True, window=window, rt=rt)
    o = o.reshape(b, s, h * hd)
    out = dense(o, p["w_o"], cfg, rt, "o")
    if return_kv:
        return out, (k, v)
    return out


def decode_attention_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                           cfg: ArchConfig,
                           cache: Tuple[torch.Tensor, torch.Tensor], pos: int,
                           rt: RuntimeCfg = DEFAULT_RT, *, window: int = 0):
    """One-token attention block with a cache update. x (B, 1, d); cache
    (k, v) each (B, Smax, kv, hd); ``pos`` the row the new token's K/V is
    written to. Returns (out, (k_cache, v_cache)): new tensors, the given
    cache left as it was, as the reference's functional update leaves
    it."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_cache, v_cache = cache
    positions = torch.full((1,), pos, device=x.device)
    q = dense(x, p["w_q"], cfg, rt, "q").reshape(b, 1, h, hd)
    k = dense(x, p["w_k"], cfg, rt, "k").reshape(b, 1, kv, hd)
    v = dense(x, p["w_v"], cfg, rt, "v").reshape(b, 1, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1, window=window)
    out = dense(o.reshape(b, 1, h * hd), p["w_o"], cfg, rt, "o")
    return out, (k_cache, v_cache)
