"""Configuration dataclasses for architectures, shapes, and runs.

Every assigned architecture is expressed as an :class:`ArchConfig`; input
shapes are :class:`ShapeConfig`; a (arch, shape, mesh) triple plus technique
switches forms a :class:`RunConfig`, which is what the launcher consumes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    """Static description of a model architecture.

    The layer stack is described as a repeating *pattern* of block kinds so
    heterogeneous stacks (gemma3 5:1 local:global, zamba2 hybrid) can be
    lowered with a single ``lax.scan`` over super-layers.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # --- attention (0 heads == attention-free) ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 500_000.0

    # attention pattern: "full" | "local_global"
    attn_kind: str = "full"
    window_size: int = 0             # sliding window for local layers
    local_per_global: int = 0        # e.g. 5 -> pattern [local]*5 + [global]

    # --- MoE ---
    num_experts: int = 0
    experts_top_k: int = 0
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024       # GShard dispatch group size (tokens)

    # --- SSM / linear attention ---
    ssm_kind: str = ""               # "" | mamba2 | rwkv6
    ssm_state: int = 0               # N (mamba2 d_state)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn block every N ssm layers

    # --- IO ---
    input_mode: str = "tokens"       # tokens | embeddings (stub frontend)

    # --- norm/misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Vocab padding so the embedding/logits shard evenly on the model axis
    # (e.g. granite's 49155). Logits over padding are masked to -inf.
    vocab_pad_to: int = 256

    # --- technique switches (paper features; default paper-faithful FP8 off
    #     so bf16 is the dense baseline, mirroring the paper's dense rocBLAS
    #     baseline) ---
    precision: str = "bf16"          # bf16 | fp8
    sparsity_24: bool = False        # 2:4 packed weights in linear layers
    fp8_amax_history: int = 16

    # --- distribution policy ---
    attn_strategy: str = "head_tp"   # head_tp | seq_tp
    remat: str = "none"              # none | dots | full
    # Shard params on the data axis too (ZeRO-3/FSDP); required >= ~30B.
    fsdp: bool = False

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.num_heads == 0

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    # Layer pattern -------------------------------------------------------
    @property
    def superlayer_pattern(self) -> Tuple[str, ...]:
        """Block kinds inside one scanned super-layer."""
        if self.ssm_kind == "mamba2" and self.attn_every:
            # hybrid: attn_every mamba blocks then one shared attention block
            return tuple(["mamba2"] * self.attn_every + ["shared_attn"])
        if self.ssm_kind == "mamba2":
            return ("mamba2",)
        if self.ssm_kind == "rwkv6":
            return ("rwkv6",)
        if self.attn_kind == "local_global" and self.local_per_global:
            return tuple(["attn_local"] * self.local_per_global + ["attn_global"])
        if self.num_experts:
            return ("attn_moe",)
        return ("attn_dense",)

    @property
    def num_superlayers(self) -> int:
        """Scanned super-layers. Hybrid stacks may leave a tail (see below)."""
        pat = self.superlayer_pattern
        if "shared_attn" in pat:
            return self.num_layers // self.attn_every
        n, rem = divmod(self.num_layers, len(pat))
        if rem:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"superlayer size {len(pat)}")
        return n

    @property
    def hybrid_tail_layers(self) -> int:
        """Trailing SSM layers not covered by full (ssm*attn_every + shared
        attn) super-layers — e.g. zamba2's 38 = 6*6 + 2."""
        if "shared_attn" in self.superlayer_pattern:
            return self.num_layers % self.attn_every
        return 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND MODEL_FLOPS and memory checks)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d           # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d      # lm head
        pat = self.superlayer_pattern
        per_pattern = 0
        for kind in pat:
            if kind in ("attn_dense", "attn_local", "attn_global"):
                per_pattern += self._attn_params() + self._mlp_params()
            elif kind == "attn_moe":
                per_pattern += self._attn_params() + self._moe_params()
            elif kind == "mamba2":
                per_pattern += self._mamba2_params()
            elif kind == "rwkv6":
                per_pattern += self._rwkv6_params()
            elif kind == "shared_attn":
                pass                      # counted once below (shared)
            per_pattern += 2 * d          # norms
        if "shared_attn" in pat:
            per_ssm = self._mamba2_params() + 2 * d
            n += self.num_layers * per_ssm                         # all ssm blocks
            n += self._attn_params() + self._mlp_params() + 2 * d  # shared block, once
        else:
            n += (self.num_layers // len(pat)) * per_pattern
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE-aware)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        all_expert = self.num_layers * self.num_experts * 3 * d * self.d_ff
        k = self.experts_top_k + (1 if self.moe_shared_expert else 0)
        active_expert = self.num_layers * k * 3 * d * self.d_ff
        return total - all_expert + active_expert

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        d = self.d_model
        n = self.d_model * self.num_experts                 # router
        n += self.num_experts * 3 * d * self.d_ff           # expert FFNs
        if self.moe_shared_expert:
            n += 3 * d * self.d_ff
        return n

    def _mamba2_params(self) -> int:
        d, di, N = self.d_model, self.ssm_d_inner, self.ssm_state
        nh = self.ssm_nheads
        # in_proj -> (z, x, B, C, dt), conv over (x,B,C), out_proj
        n = d * (2 * di + 2 * N + nh)
        n += 4 * (di + 2 * N)            # conv1d width 4
        n += nh * 2                       # A_log, D
        n += di * d                       # out_proj
        return n

    def _rwkv6_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,w projections + output
        n = 5 * d * d + d * d
        n += self.ssm_nheads * self.ssm_head_dim  # u (bonus)
        n += 6 * d                        # mix coefficients
        # channel-mix: receptance (d,d), key (d,ff), value (ff,d)
        n += d * d + d * self.d_ff + self.d_ff * d
        return n

    def with_technique(self, precision: Optional[str] = None,
                       sparsity_24: Optional[bool] = None) -> "ArchConfig":
        kw = {}
        if precision is not None:
            kw["precision"] = precision
        if sparsity_24 is not None:
            kw["sparsity_24"] = sparsity_24
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(arch: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """Shapes assigned to an architecture.

    ``long_500k`` requires sub-quadratic attention: run for SSM/hybrid/
    linear-attention archs (zamba2, rwkv6) and — as a documented extra — for
    gemma3 (5/6 sliding-window layers, seq-sharded global cache). Skipped for
    pure full-attention archs per the assignment (see DESIGN.md §4).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.ssm_kind in ("mamba2", "rwkv6") or arch.attn_kind == "local_global":
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Run config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunConfig:
    arch: ArchConfig
    shape: ShapeConfig
    multi_pod: bool = False
    # training hyperparams (examples / e2e driver)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0              # 0 = no gradient accumulation
    grad_compress: str = "none"      # none | bf16 | int8_ef
    checkpoint_dir: str = ""
    checkpoint_every: int = 100
