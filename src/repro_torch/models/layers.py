"""Shared building blocks: norms, RoPE, the policy-routed linear, MLP.

Twin of ``repro/models/layers.py``. ``dense()`` resolves the execution
policy and dispatches through the matmul backend registry; every linear
layer of the model goes through it, with a dense (K, N) weight or a
:class:`PackedWeight` (sparse24 serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
    every linear through the ``hopper`` backend)."""
    chunk_q: int = 1024
    chunk_kv: int = 1024
    use_pallas: bool = False
    act_dtype: Any = torch.bfloat16
    # Explicit execution policy; wins over cfg.precision / use_pallas.
    policy: Any = None


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
