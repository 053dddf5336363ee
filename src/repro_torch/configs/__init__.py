"""Architecture/shape registry.

``get_arch(name)`` returns the full published config; ``get_reduced(name)``
returns the CPU-smoke-test variant of the same family. ``ARCH_NAMES`` lists
the 10 assigned architectures (+ the paper's own §8 transformer case study).
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    applicable_shapes,
)

from repro_torch.configs import (
    musicgen_medium,
    zamba2_1p2b,
    deepseek_67b,
    llama3_405b,
    llama3_8b,
    gemma3_12b,
    llama4_scout,
    granite_moe,
    rwkv6_3b,
    chameleon_34b,
)

# The paper's §8.1 transformer-style FP8 case-study kernel: a small dense
# decoder used by benchmarks/fig14_transformer.py and examples.
PAPER_TRANSFORMER = ArchConfig(
    name="paper-transformer",
    family="dense",
    num_layers=4,
    d_model=512,
    d_ff=2048,
    vocab_size=32000,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    precision="fp8",
    attn_strategy="head_tp",
)

_MODULES = {
    "musicgen-medium": musicgen_medium,
    "zamba2-1.2b": zamba2_1p2b,
    "deepseek-67b": deepseek_67b,
    "llama3-405b": llama3_405b,
    "llama3-8b": llama3_8b,
    "gemma3-12b": gemma3_12b,
    "llama4-scout-17b-a16e": llama4_scout,
    "granite-moe-3b-a800m": granite_moe,
    "rwkv6-3b": rwkv6_3b,
    "chameleon-34b": chameleon_34b,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}
REDUCED = {name: mod.REDUCED for name, mod in _MODULES.items()}
ARCHS["paper-transformer"] = PAPER_TRANSFORMER
REDUCED["paper-transformer"] = PAPER_TRANSFORMER

ARCH_NAMES = tuple(_MODULES.keys())


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


def get_reduced(name: str) -> ArchConfig:
    try:
        return REDUCED[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REDUCED)}") from None


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None


def all_cells(include_extra: bool = True):
    """Yield every assigned (arch, shape) dry-run cell."""
    for name in ARCH_NAMES:
        arch = ARCHS[name]
        for shape in applicable_shapes(arch):
            yield arch, shape


__all__ = [
    "ArchConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS", "REDUCED",
    "ARCH_NAMES", "PAPER_TRANSFORMER", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "get_arch", "get_reduced", "get_shape", "applicable_shapes",
    "all_cells",
]
