"""Shared building blocks: norms, RoPE, the policy-routed linear, MLP.

Twin of ``repro/models/layers.py``. ``dense()`` resolves the execution
policy and dispatches through the matmul backend registry; every linear
layer of the model goes through it, with a dense (K, N) weight or a
:class:`PackedWeight` (sparse24 serving). ``batched_einsum`` is the
f32-accumulating batched product of decode attention and the MoE layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import execution as ex
from repro_torch.core import sparsity as sp
from repro_torch.core.execution import PackedWeight  # noqa: F401 (re-export)


@dataclasses.dataclass(frozen=True)
class RuntimeCfg:
    """Execution knobs threaded through model forward functions.

    ``use_pallas`` keeps the reference's name: it routes prefill attention
    through the flash-attention kernel (and, with no explicit policy,
    every linear through the ``hopper`` backend). ``f32_batched_dots`` and
    ``moe_gather_dispatch`` keep the reference's defaults:
    :func:`batched_einsum` upcasts its operands to f32, and the MoE layer
    dispatches by one-hot einsums (``models/moe.py``). ``ssm_chunk`` caps
    the chunk of the mamba2 and rwkv6 prefill scans (with
    ``cfg.ssm_chunk``); the port always loops over the chunks in Python,
    so the reference's ``static_loops`` and ``max_static_chunks`` have no
    counterpart. ``remat_blocks`` (the reference's default) recomputes
    each (q-chunk, kv-chunk) block of ``chunked_attention`` in backward
    instead of keeping its scores (memory only, never values);
    ``param_dtype`` is the reference's field and is read by nothing, in
    either package: weights take ``init_params``' ``dtype`` (bf16 by
    default) whatever it says. The reference's ``opt_barrier`` (an XLA
    scheduling hint between attention blocks) has no counterpart: PyTorch
    runs the blocks in program order. ``shard_fn(tag, x)``, when set,
    places the activation ``x`` by its tag (``runtime/sharding.py``
    redistributes a DTensor; a plain tensor passes through); ``None``
    leaves every activation as it is."""
    chunk_q: int = 1024
    chunk_kv: int = 1024
    use_pallas: bool = False
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    ssm_chunk: int = 256
    f32_batched_dots: bool = True
    moe_gather_dispatch: bool = False
    remat_blocks: bool = True
    # Explicit execution policy; wins over cfg.precision / use_pallas.
    policy: Any = None
    shard_fn: Any = None


def shard_tag(rt: RuntimeCfg, x, tag: str):
    """``rt.shard_fn(tag, x)``, or ``x`` itself when there is none."""
    if rt.shard_fn is None:
        return x
    return rt.shard_fn(tag, x)


DEFAULT_RT = RuntimeCfg()


class _StePrune24(torch.autograd.Function):
    """2:4 prune forward; straight-through backward (the gradient reaches
    every weight, pruned or not)."""

    @staticmethod
    def forward(ctx, w):
        return sp.prune_24(w)

    @staticmethod
    def backward(ctx, g):
        return g


def dense(x: torch.Tensor, w, cfg: ArchConfig, rt: RuntimeCfg = DEFAULT_RT,
          name: str = "") -> torch.Tensor:
    """``x @ w`` routed through the resolved execution policy.

    ``w`` is a dense (K, N) tensor or a :class:`PackedWeight`. Under a
    sparse24 policy a dense 2-D weight with K % 8 == 0 is 2:4-pruned here,
    with straight-through gradients; ``hopper_sparse24`` then demotes to
    ``hopper``, whose dense GEMM computes the same product with the STE's
    gradients (the backend's dense entry would prune again, per call)."""
    pol = ex.policy_from(cfg, rt)
    if not isinstance(w, PackedWeight) and pol.sparsity == "sparse24" \
            and w.dim() == 2 and w.shape[0] % 8 == 0:
        w = _StePrune24.apply(w)
        if pol.backend == "hopper_sparse24":
            pol = dataclasses.replace(pol, backend="hopper")
    return ex.matmul(x, w, pol, out_dtype=rt.act_dtype)


def batched_einsum(expr: str, a: torch.Tensor, b: torch.Tensor,
                   rt: RuntimeCfg, out_dtype=None) -> torch.Tensor:
    """Batched matmul with f32 accumulation, then ``out_dtype`` (default
    ``rt.act_dtype``). With ``rt.f32_batched_dots`` the operands are upcast
    to f32 first, as in the reference; without it they meet in their
    promoted type, as ``jnp.einsum``'s operands do (bf16 products on the
    card sum in f32 inside the library's kernel, whose result is in that
    type before ``out_dtype``)."""
    out_dtype = out_dtype or rt.act_dtype
    if rt.f32_batched_dots:
        return torch.einsum(expr, a.float(), b.float()).to(out_dtype)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(expr, a.to(dt), b.to(dt)).to(out_dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, h, hd); positions: (S,) or broadcastable (split halves)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(h: torch.Tensor, head_w: torch.Tensor, vocab_size: int,
              policy: Any = None) -> torch.Tensor:
    """Project to the (padded) vocab in f32; padding logits are -1e30.
    The head stays on the policy's bf16 dense path whatever its precision
    or sparsity, ``hopper_sparse24`` demoted to ``hopper`` (whose dense
    entry would prune the vocab projection)."""
    pol = policy or ex.get_default_policy()
    backend = "hopper" if pol.backend == "hopper_sparse24" else pol.backend
    logits = ex.matmul(
        h, head_w, dataclasses.replace(pol, precision="bf16",
                                       sparsity="dense", backend=backend),
        out_dtype=torch.float32)
    vp = head_w.shape[-1]
    if vp != vocab_size:
        mask = torch.arange(vp, device=logits.device) < vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits


def swiglu_mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ArchConfig,
               rt: RuntimeCfg = DEFAULT_RT) -> torch.Tensor:
    gate = dense(x, p["w_gate"], cfg, rt, "mlp_gate")
    up = dense(x, p["w_up"], cfg, rt, "mlp_up")
    h = F.silu(gate.float()).to(x.dtype) * up
    return dense(h, p["w_down"], cfg, rt, "mlp_down")


# ---------------------------------------------------------------------------
# Init (the reference's shapes and scales; torch's generator, not jax.random)
# ---------------------------------------------------------------------------

def init_weight(shape, dtype, generator=None, device=None,
                scale: Optional[float] = None) -> torch.Tensor:
    """normal × fan_in^-0.5 (or ``scale``), drawn in f32 then cast. As in
    the reference, fan_in is ``shape[0]``: an expert stack (E, d, f) is
    scaled by E^-0.5."""
    if device is not None and torch.device(device).type == "meta":
        # a shape-only tree (``transformer.params_shape``): draw nothing
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * s).to(dtype)


def init_mlp(cfg: ArchConfig, generator=None, device=None,
             dtype=torch.bfloat16, d_ff: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": init_weight((d, f), dtype, generator, device),
            "w_up": init_weight((d, f), dtype, generator, device),
            "w_down": init_weight((f, d), dtype, generator, device)}


def init_attn(cfg: ArchConfig, generator=None, device=None,
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"w_q": init_weight((d, cfg.q_dim), dtype, generator, device),
            "w_k": init_weight((d, cfg.kv_dim), dtype, generator, device),
            "w_v": init_weight((d, cfg.kv_dim), dtype, generator, device),
            "w_o": init_weight((cfg.q_dim, d), dtype, generator, device)}
