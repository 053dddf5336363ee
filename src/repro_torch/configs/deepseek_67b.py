"""DeepSeek-67B — dense llama-architecture decoder.

[arXiv:2401.02954; hf deepseek-ai/deepseek-llm-67b-base] 95L d_model=8192
64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab_size=102400,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10_000.0,
    attn_strategy="head_tp",
    fsdp=True,
    remat="full",
)

REDUCED = ArchConfig(
    name="deepseek-67b-reduced",
    family="dense",
    num_layers=2,
    d_model=128,
    d_ff=344,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    rope_theta=10_000.0,
    attn_strategy="head_tp",
)
