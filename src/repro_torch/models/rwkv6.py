"""RWKV-6 (Finch) block: data-dependent decay linear attention.

Twin of ``repro/models/rwkv6.py``. Per head (hd = head dim), per token t:

  S_t = diag(w_t) S_{t-1} + k_tᵀ v_t           (state S: (hd_k, hd_v))
  y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

with the data-dependent decay w_t = exp(-exp(ŵ_t)). Prefill is chunked as
in the reference (quadratic within a chunk of ``min(rt.ssm_chunk,
cfg.ssm_chunk, S)`` tokens, which must divide S, and the state across
chunks); decode is the O(1) recurrence. The six time-mix and three
channel-mix projections go through ``layers.dense``; the wkv recurrence
runs in f32 as torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    DEFAULT_RT, RuntimeCfg, dense, init_weight, shard_tag)


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` (B, 1, d) is the decode carry."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return prev


def _wkv_chunk(r, k, v, w, u, S):
    """One chunk of the wkv recurrence.

    r, k, v, w (b, Lc, nh, hd), w the per-step decay in (0, 1]; u (nh, hd)
    the bonus; S (b, nh, hd, hd) the state (k-major, v-minor). Returns (y
    (b, Lc, nh, hd), S_next)."""
    Lc = r.shape[1]
    logw = torch.log(torch.clamp_min(w, 1e-30))
    cum = torch.cumsum(logw, dim=1)              # decay start..t (incl. t)
    # inter-chunk: y_inter[t] = r_t · (decay(start..t-1) ⊙ S), I at t = 0
    cum_prev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    r_dec = r * torch.exp(cum_prev)               # exponent <= 0: safe
    y_inter = torch.einsum("blhi,bhij->blhj", r_dec, S)
    # intra-chunk: A[t,s] = Σ_i r_t,i k_s,i exp(cum_prev[t] - cum[s])_i for
    # s < t, with the pairwise exponent (<= 0 on causal pairs): the
    # factorized exp(cum_prev[t]) · exp(-cum[s]) overflows f32 under strong
    # decay, the difference cannot. The other pairs are masked before the
    # exp (their exponent is positive, and an inf there would make the
    # gradient 0 * inf = NaN), as in mamba2's _ssd_chunk.
    seg = cum_prev[:, :, None] - cum[:, None, :]              # (b,t,s,nh,hd)
    strict = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    decay = torch.exp(seg.masked_fill(~strict[None, :, :, None, None],
                                      -torch.inf))
    A = torch.einsum("blmhi,blhi->blmh", decay * k[:, None], r)
    y_intra = torch.einsum("blmh,bmhj->blhj", A, v)
    diag = (r * u[None, None] * k).sum(dim=-1)                # (b,Lc,nh)
    y_intra = y_intra + diag[..., None] * v
    # state: S_next = diag(decay of the chunk) S + Σ_s diag(decay s+1..end)
    # k_s v_s
    total = cum[:, -1:]                                       # (b,1,nh,hd)
    k_tail = k * torch.exp(total - cum)
    S_next = (S * torch.exp(total)[:, 0, :, :, None]
              + torch.einsum("blhi,blhj->bhij", k_tail, v))
    return y_intra + y_inter, S_next


def _mix(x, xs, p, name):
    return x + (xs - x) * p[f"mu_{name}"].to(x.dtype)


def _group_norm_gate(y, g, x):
    """Per-head norm of y (..., nh, hd) f32, then the SiLU(g) gate; in
    x's type."""
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.reshape(g.shape) * F.silu(g.float())
    return y.to(x.dtype)


def _time_mix_inputs(x, xs, p, cfg: ArchConfig, rt: RuntimeCfg):
    """r, k, v (f32), g, and the decay w in (0, 1) (f32) of the five
    mixed inputs, each (..., nh, hd) but g (..., d)."""
    hd = cfg.ssm_head_dim
    nh = cfg.d_model // hd
    lead = x.shape[:-1]
    r = dense(_mix(x, xs, p, "r"), p["w_r"], cfg, rt, "rwkv_r")
    k = dense(_mix(x, xs, p, "k"), p["w_k"], cfg, rt, "rwkv_k")
    v = dense(_mix(x, xs, p, "v"), p["w_v"], cfg, rt, "rwkv_v")
    g = dense(_mix(x, xs, p, "g"), p["w_g"], cfg, rt, "rwkv_g")
    wlog = dense(_mix(x, xs, p, "w"), p["w_w"], cfg, rt, "rwkv_w")
    w = torch.exp(-torch.exp(wlog.float().reshape(lead + (nh, hd))
                             + p["w_bias"].reshape(nh, hd)))
    return (*(t.reshape(lead + (nh, hd)).float() for t in (r, k, v)), g, w)


def rwkv6_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT
                ) -> torch.Tensor:
    """Time-mix (wkv) sub-block. x: (B, S, d) -> (B, S, d)."""
    return rwkv6_block_with_state(x, p, cfg, rt)[0]


def rwkv6_block_with_state(x: torch.Tensor, p: Dict[str, torch.Tensor],
                           cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT):
    """Prefill: returns (out, (S_final f32, prev_tm = x's last row))."""
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    nh = d // hd
    r, k, v, g, w = _time_mix_inputs(x, _token_shift(x), p, cfg, rt)
    v = shard_tag(rt, v, "rwkv_v")          # value-dim sharding
    u = p["u"].reshape(nh, hd).float()

    Lc = min(rt.ssm_chunk, cfg.ssm_chunk, s)
    assert s % Lc == 0, (s, Lc)
    S = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s // Lc):
        sl = slice(i * Lc, (i + 1) * Lc)
        yi, S = _wkv_chunk(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, S)
        ys.append(yi)
    y = _group_norm_gate(torch.cat(ys, dim=1), g, x)
    out = dense(y, p["w_o"], cfg, rt, "rwkv_o")
    return out, (S, x[:, -1:, :])


def _channel_mix(x, xs, p, cfg: ArchConfig, rt: RuntimeCfg):
    xk = _mix(x, xs, p, "ck")
    xr = _mix(x, xs, p, "cr")
    rgate = torch.sigmoid(dense(xr, p["w_cr"], cfg, rt, "rwkv_cr").float())
    h = dense(xk, p["w_ck"], cfg, rt, "rwkv_ck")
    h = torch.square(torch.relu(h.float())).to(x.dtype)
    return (rgate * dense(h, p["w_cv"], cfg, rt, "rwkv_cv").float()
            ).to(x.dtype)


def rwkv6_channel_mix(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT
                      ) -> torch.Tensor:
    return _channel_mix(x, _token_shift(x), p, cfg, rt)


def rwkv6_channel_mix_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                             cfg: ArchConfig, prev: torch.Tensor,
                             rt: RuntimeCfg = DEFAULT_RT):
    """One-token channel mix; ``prev`` is the previous token's input
    (B, 1, d). Returns (out, new prev = x)."""
    return _channel_mix(x, _token_shift(x, prev), p, cfg, rt), x


def rwkv6_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                 cfg: ArchConfig, state, rt: RuntimeCfg = DEFAULT_RT):
    """One-token time mix. state = (S (B, nh, hd, hd) f32, prev_x (B, 1,
    d)). Returns (out, (S, x)): new tensors, the given state left as it
    was; the caller runs the channel mix with its own carry."""
    b, _, d = x.shape
    hd = cfg.ssm_head_dim
    nh = d // hd
    S, prev_x = state
    r, k, v, g, w = _time_mix_inputs(x, _token_shift(x, prev_x), p, cfg, rt)
    r, k, v, w = (t.reshape(b, nh, hd) for t in (r, k, v, w))
    u = p["u"].reshape(nh, hd).float()
    kv = k[..., :, None] * v[..., None, :]                    # (b,nh,hd,hd)
    y = torch.einsum("bhi,bhij->bhj", r, S + u[None, :, :, None] * kv)
    S = S * w[:, :, :, None] + kv
    y = _group_norm_gate(y, g, x)
    out = dense(y, p["w_o"], cfg, rt, "rwkv_o")
    return out, (S, x)


def init_rwkv6(cfg: ArchConfig, generator=None, device=None,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales (decay bias -0.6, bonus 0, every
    mix 0.5)."""
    d, f = cfg.d_model, cfg.d_ff

    def w(shape, scale=None):
        return init_weight(shape, dtype, generator, device, scale=scale)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    p = {"w_r": w((d, d)), "w_k": w((d, d)), "w_v": w((d, d)),
         "w_g": w((d, d)), "w_w": w((d, d), 0.01), "w_o": w((d, d)),
         "w_bias": full(d, -0.6), "u": full(d, 0.0),
         "w_cr": w((d, d)), "w_ck": w((d, f)), "w_cv": w((f, d))}
    for name in ("r", "k", "v", "g", "w", "ck", "cr"):
        p[f"mu_{name}"] = full(d, 0.5)
    return p
