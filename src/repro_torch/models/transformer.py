"""Decoder stack for ``attn_dense`` architectures (llama3 and its kin).

Twin of ``repro/models/transformer.py`` for the dense serving slice:
``init_params``, ``prefill``, ``decode_step`` (with ``_decode_attn``) and
``init_cache``. Where the reference scans over parameters stacked on a
leading layer axis, the port keeps a Python list with one dict per layer
and loops over it (PyTorch runs eagerly; there is no trace to keep small).

Decode writes the new token's K/V into the cache in place, saving a copy
of the whole cache per step; ``decode_step`` returns the same cache
objects it was given. Other block kinds (MoE, local attention, SSM,
hybrid) are later slices.
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

def _decode_attn(x, p, cache, posb: torch.Tensor, cfg: ArchConfig,
                 rt: RuntimeCfg):
    """One-token attention over the dense cache, each slot at its own
    position ``posb`` (B,). The cache is updated in place."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    q = dense(x, p["w_q"], cfg, rt, "q").reshape(b, 1, h, hd)
    k = dense(x, p["w_k"], cfg, rt, "k").reshape(b, 1, kvh, hd)
    v = dense(x, p["w_v"], cfg, rt, "v").reshape(b, 1, kvh, hd)
    q = attn_mod.apply_rope(q, posb[:, None], cfg.rope_theta)
    k = attn_mod.apply_rope(k, posb[:, None], cfg.rope_theta)

    kc, vc, posc = cache["k"], cache["v"], cache["pos"]
    smax = kc.shape[1]
    bidx = torch.arange(b, device=x.device)
    kc[bidx, posb] = k[:, 0].to(kc.dtype)
    vc[bidx, posb] = v[:, 0].to(vc.dtype)
    posc[bidx, posb] = posb.to(posc.dtype)

    scale = hd ** -0.5
    # GQA kept grouped: (b, kv, g, hd) × (b, s, kv, hd), f32 accumulation.
    q5 = q.reshape(b, kvh, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q5.float(), kc.float()) * scale
    # posc = -1 marks unwritten (or freed) rows; each slot attends only to
    # rows its own occupant wrote at positions <= its own pos.
    pcol = posb[:, None]
    valid = (posc >= 0) & (posc <= pcol) \
        & (torch.arange(smax, device=x.device)[None, :] <= pcol)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, attn_mod.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pr.to(vc.dtype).float(), vc.float())
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return dense(o, p["w_o"], cfg, rt, "o")


def decode_step(params: Params, tokens: torch.Tensor, caches: Caches, pos,
                cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT):
    """One decoding step. tokens (B, 1); ``pos`` a scalar (lockstep) or a
    (B,) vector (continuous batching). Every position must be below the
    cache length. Returns (logits (B, Vp) f32, caches updated in place)."""
    b = tokens.shape[0]
    posb = torch.as_tensor(pos, device=tokens.device).to(torch.long)
    posb = posb.expand(b) if posb.dim() == 0 else posb
    x = embed_tokens(tokens, params["embed"]).to(rt.act_dtype)
    for p, cache in zip(params["layers"], caches):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + _decode_attn(h, p["attn"], cache, posb, cfg, rt)
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + swiglu_mlp(h, p["mlp"], cfg, rt)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x[:, 0], params["head"], cfg.vocab_size,
                       policy=ex.policy_from(cfg, rt))
    return logits, caches


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
