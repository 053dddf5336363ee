"""Llama-3.1-405B — dense decoder, GQA, 128k vocab.

[arXiv:2407.21783] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    attn_strategy="head_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="llama3-405b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    d_ff=416,
    vocab_size=512,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=500_000.0,
    attn_strategy="head_tp",
)
