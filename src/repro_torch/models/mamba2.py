"""Mamba2 (SSD) block: the chunked scan of prefill and the one-token step.

Twin of ``repro/models/mamba2.py``. Single-group SSD:

  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_tᵀ          (state: (nh, hp, N))
  y_t = C_t h_t + D x_t

Prefill cuts the sequence into chunks of ``Lc = min(rt.ssm_chunk,
cfg.ssm_chunk, S)`` tokens, which must divide S, as in the reference:
within a chunk the output is a masked quadratic product, across chunks the
state carries the recurrence. The port loops over the chunks in Python.
The five input projections and ``out_proj`` go through ``layers.dense``
(kernel A or D on the ``hopper`` backends), one call each; the recurrence
and the depthwise conv run in f32 as torch ops (a bf16 activation times
the f32 conv weight promotes to f32 in both frameworks).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import DEFAULT_RT, RuntimeCfg, dense, init_weight


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W. x: (B, S, C); w: (W, C). With
    ``state`` (B, W-1, C) (decode) the conv continues from it. Returns
    (out f32, the last W-1 rows of the padded input)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return out, new_state


def _ssd_chunk(xh, dt, dA_cumsum, B, C, h_prev):
    """One chunk of SSD.

    xh (b, Lc, nh, hp) input heads; dt (b, Lc, nh) steps (post-softplus);
    dA_cumsum (b, Lc, nh) the cumulative sum of dt * A within the chunk;
    B, C (b, Lc, N); h_prev (b, nh, hp, N). Returns (y (b, Lc, nh, hp),
    h_next)."""
    Lc = xh.shape[1]
    # inter-chunk: y_inter[t] = C_t · (h_prev decayed from the start to t)
    decay_to_t = torch.exp(dA_cumsum)                           # (b,Lc,nh)
    y_inter = torch.einsum("bln,bhpn->blhp", C, h_prev) \
        * decay_to_t[..., None]
    # intra-chunk: L[t,s] = exp(cum[t] - cum[s]) for s <= t. The pairs
    # s > t are masked before the exp, not after it as the reference's
    # where(causal, exp(seg), 0) does: there seg is positive and grows
    # with the chunk (full width, 256-token chunks: past 88, where f32's
    # exp overflows), and the gradient of a masked inf is 0 * inf = NaN.
    # exp(-inf) is 0 with a zero gradient; the causal pairs are unchanged.
    seg = dA_cumsum[:, :, None, :] - dA_cumsum[:, None, :, :]   # (b,t,s,nh)
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=xh.device))
    L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
    scores = torch.einsum("bln,bmn->blm", C, B)                 # (b,t,s)
    G = scores[..., None] * L                                   # (b,t,s,nh)
    y_intra = torch.einsum("blsh,bshp->blhp", G, dt[..., None] * xh)
    # state: h_next = h_prev·decay(chunk) + Σ_s decay(s..end) dt_s x_s ⊗ B_s
    total = dA_cumsum[:, -1:, :]                                # (b,1,nh)
    decay_from_s = torch.exp(total - dA_cumsum)                 # (b,Lc,nh)
    h_next = (h_prev * torch.exp(total)[:, 0, :, None, None]
              + torch.einsum("blhp,bln->bhpn",
                             (decay_from_s * dt)[..., None] * xh, B))
    return y_intra + y_inter, h_next


def _projections(x, p, cfg: ArchConfig, rt: RuntimeCfg):
    """The gate z and the conv input [x, B, C] and dt, five GEMMs."""
    z = dense(x, p["w_z"], cfg, rt, "ssm_z")
    xr = dense(x, p["w_x"], cfg, rt, "ssm_x")
    B_ = dense(x, p["w_B"], cfg, rt, "ssm_B")
    C_ = dense(x, p["w_C"], cfg, rt, "ssm_C")
    dt = dense(x, p["w_dt"], cfg, rt, "ssm_dt")
    return z, torch.cat([xr, B_, C_], dim=-1), dt


def _gated_out(y, z, x, p, cfg: ArchConfig, rt: RuntimeCfg):
    """y (..., di) f32 gated by SiLU(z), then ``out_proj``."""
    y = y * F.silu(z.float())
    return dense(y.to(x.dtype), p["out_proj"], cfg, rt, "ssm_out")


def mamba2_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                 cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT
                 ) -> torch.Tensor:
    """Full Mamba2 mixer. x: (B, S, d) -> (B, S, d)."""
    return mamba2_block_with_state(x, p, cfg, rt)[0]


def mamba2_block_with_state(x: torch.Tensor, p: Dict[str, torch.Tensor],
                            cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT):
    """Prefill: returns (out, (ssm state (B, nh, hp, N) f32, conv state)).
    The conv state is the last 3 rows of the conv input in f32, as in the
    reference: a prompt of S < 3 tokens leaves S rows."""
    b, s, _ = x.shape
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    nh, hp = cfg.ssm_nheads, cfg.ssm_head_dim

    z, conv_in, dt = _projections(x, p, cfg, rt)
    final_conv_state = conv_in[:, -3:, :].float()
    xbc, _ = _conv1d_causal(conv_in, p["conv_w"])
    xbc = F.silu(xbc.float())
    xr, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)

    A = -torch.exp(p["A_log"].float())                          # (nh,)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,S,nh)
    dA = dt * A

    xh = xr.reshape(b, s, nh, hp)
    Lc = min(rt.ssm_chunk, cfg.ssm_chunk, s)
    assert s % Lc == 0, (s, Lc)
    h = torch.zeros((b, nh, hp, N), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s // Lc):
        sl = slice(i * Lc, (i + 1) * Lc)
        yi, h = _ssd_chunk(xh[:, sl], dt[:, sl],
                           torch.cumsum(dA[:, sl], dim=1), B_[:, sl],
                           C_[:, sl], h)
        ys.append(yi)
    y = torch.cat(ys, dim=1)
    y = y + xh * p["D"].float()[None, None, :, None]
    out = _gated_out(y.reshape(b, s, di), z, x, p, cfg, rt)
    return out, (h, final_conv_state)


def mamba2_decode(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  cfg: ArchConfig, state: Tuple[torch.Tensor, torch.Tensor],
                  rt: RuntimeCfg = DEFAULT_RT):
    """One token. x (B, 1, d); state = (ssm (B, nh, hp, N) f32, conv (B, 3,
    di + 2N)). Returns (out, new state): new tensors, the given state left
    as it was; the new conv state is in the activation type, as the
    reference's is."""
    b = x.shape[0]
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    nh, hp = cfg.ssm_nheads, cfg.ssm_head_dim
    h, conv_state = state

    z, conv_in, dt = _projections(x, p, cfg, rt)
    xbc, conv_state = _conv1d_causal(conv_in, p["conv_w"], state=conv_state)
    xbc = F.silu(xbc.float())
    xr, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)

    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]            # (B,nh)
    dA = torch.exp(dt * A)
    xh = xr.reshape(b, nh, hp)
    Bv, Cv = B_[:, 0], C_[:, 0]                                 # (B,N)
    h = h * dA[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cv) \
        + xh * p["D"].float()[None, :, None]
    out = _gated_out(y.reshape(b, 1, di), z, x, p, cfg, rt)
    return out, (h, conv_state)


def init_mamba2(cfg: ArchConfig, generator=None, device=None,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The reference's shapes and scales (A = -1, dt bias -2, D = 1)."""
    d, di, N, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, \
        cfg.ssm_nheads

    def w(shape, dt=dtype, scale=None):
        return init_weight(shape, dt, generator, device, scale=scale)

    return {
        "w_z": w((d, di)), "w_x": w((d, di)), "w_B": w((d, N)),
        "w_C": w((d, N)), "w_dt": w((d, nh)),
        "conv_w": w((4, di + 2 * N), torch.float32, 0.5),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32,
                              device=device),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "out_proj": w((di, d)),
    }


def init_mamba2_state(batch: int, cfg: ArchConfig, device=None):
    """Zeroed (ssm (B, nh, hp, N), conv (B, 3, di + 2N)), both f32."""
    nh, hp, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    return (torch.zeros((batch, nh, hp, N), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, 3, cfg.ssm_d_inner + 2 * N),
                        dtype=torch.float32, device=device))
