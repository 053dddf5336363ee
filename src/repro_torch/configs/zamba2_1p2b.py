"""Zamba2-1.2B — Mamba2 backbone + shared attention block (hybrid).

[arXiv:2411.15242; hf Zyphra/Zamba2-1.2B] 38L d_model=2048, shared attn
32H (kv=32), d_ff=8192, vocab=32000, ssm_state=64.

Modeled as 38 Mamba2 blocks with a parameter-shared attention+MLP block
invoked after every 6 Mamba2 blocks (6 invocations; 38 = 6*6 + 2 tail
blocks). See DESIGN.md §6 for the simplification notes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    ssm_kind="mamba2",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    attn_strategy="head_tp",
    remat="full",
)

REDUCED = ArchConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    num_layers=5,                 # 2*2 + 1 tail
    d_model=128,
    d_ff=256,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    ssm_kind="mamba2",
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=32,
    attn_every=2,
    attn_strategy="head_tp",
)
