"""Chameleon-34B — early-fusion mixed-modal decoder over VQ image tokens.

[arXiv:2405.09818] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
The VQ-VAE image tokenizer frontend is a stub (``input_mode="embeddings"``):
input_specs() provides precomputed patch/token embeddings per the
backbone-only assignment.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    d_ff=22016,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10_000.0,
    input_mode="embeddings",
    attn_strategy="head_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="chameleon-34b-reduced",
    family="vlm",
    num_layers=2,
    d_model=128,
    d_ff=344,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=10_000.0,
    input_mode="embeddings",
    attn_strategy="head_tp",
)
