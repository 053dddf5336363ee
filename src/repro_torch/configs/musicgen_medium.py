"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf facebook/musicgen-medium] 48L d_model=1536 24H
(GQA kv=24 == MHA) d_ff=6144 vocab=2048. Audio frontend is a stub:
``input_mode="embeddings"`` — input_specs() provides precomputed frame
embeddings (backbone-only per assignment).

24 heads do not divide the model axis (16) -> context-parallel attention
(``attn_strategy="seq_tp"``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    rope_theta=10_000.0,
    input_mode="embeddings",
    attn_strategy="seq_tp",
    remat="full",
)

REDUCED = ArchConfig(
    name="musicgen-medium-reduced",
    family="audio",
    num_layers=2,
    d_model=128,
    d_ff=256,
    vocab_size=512,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    rope_theta=10_000.0,
    input_mode="embeddings",
    attn_strategy="seq_tp",
    remat="full",
)
