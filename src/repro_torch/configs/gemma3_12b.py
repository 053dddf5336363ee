"""Gemma-3-12B — dense decoder with 5:1 local:global attention, 256k vocab.

[hf google/gemma-3-12b-pt] 48L d_model=3840 16H (GQA kv=8) head_dim=256
d_ff=15360 vocab=262144; sliding window 1024 on local layers, pattern
5 local : 1 global.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_size=262144,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    rope_theta=1_000_000.0,
    attn_kind="local_global",
    window_size=1024,
    local_per_global=5,
    attn_strategy="head_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="gemma3-12b-reduced",
    family="dense",
    num_layers=6,                 # one 5:1 super-layer
    d_model=128,
    d_ff=256,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=1_000_000.0,
    attn_kind="local_global",
    window_size=64,
    local_per_global=5,
    attn_strategy="head_tp",
    remat="full",
)
