"""Granite-3.0-3B-A800M — fine-grained MoE decoder (40 experts, top-8).

[hf ibm-granite/granite-3.0-3b-a800m-base] 32L d_model=1536 24H (GQA kv=8)
per-expert d_ff=512, vocab=49155, MoE 40e top-8.

24 heads do not divide the model axis -> context-parallel attention.
40 experts do not divide the model axis -> each expert's d_ff (512) is
sharded instead (512/16 = 32 per shard). vocab 49155 is padded to 49408
for even embedding sharding (logits over padding masked).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    d_ff=512,
    vocab_size=49155,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    rope_theta=10_000.0,
    num_experts=40,
    experts_top_k=8,
    attn_strategy="seq_tp",
    remat="full",
)

REDUCED = ArchConfig(
    name="granite-moe-reduced",
    family="moe",
    num_layers=2,
    d_model=128,
    d_ff=64,
    vocab_size=515,               # deliberately non-multiple: exercises padding
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=10_000.0,
    num_experts=8,
    experts_top_k=2,
    moe_group_size=64,
    attn_strategy="seq_tp",
)
