"""Llama-3.1-8B — dense decoder, GQA, 128k vocab.

[arXiv:2407.21783] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    attn_strategy="head_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="llama3-8b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    d_ff=448,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=500_000.0,
    attn_strategy="head_tp",
    remat="full",
)
