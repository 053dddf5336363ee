"""Llama-4-Scout-17B-16E — MoE decoder (16 experts, top-1, shared expert).

[hf meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert) vocab=202048, MoE 16e top-1, early fusion.

40 heads do not divide the model axis (16) -> context-parallel attention.
16 experts shard exactly onto the model axis (expert parallelism).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    num_experts=16,
    experts_top_k=1,
    moe_shared_expert=True,
    attn_strategy="seq_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="llama4-scout-reduced",
    family="moe",
    num_layers=2,
    d_model=128,
    d_ff=256,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=500_000.0,
    num_experts=4,
    experts_top_k=1,
    moe_shared_expert=True,
    moe_group_size=64,
    attn_strategy="seq_tp",
)
