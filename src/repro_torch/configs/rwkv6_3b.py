"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay linear attention.

[arXiv:2404.05892; hf RWKV/rwkv-6-world-3b] 32L d_model=2560 (attn-free)
d_ff=8960 vocab=65536; head_dim=64 -> 40 wkv heads.

The paper's FP8-matrix-core technique applies to the projection GEMMs only;
the wkv recurrence is not a matmul (see DESIGN.md §4 arch-applicability).
State is sharded along the value feature dim (64 -> 4/shard), which makes
the recurrence communication-free.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65536,
    num_heads=0,                  # attention-free
    ssm_kind="rwkv6",
    ssm_head_dim=64,
    ssm_expand=1,                 # wkv operates at d_model width
    ssm_chunk=128,                # pairwise-decay temp stays VMEM-sized
    attn_strategy="head_tp",      # unused (attn-free)
    remat="full",
)

REDUCED = ArchConfig(
    name="rwkv6-3b-reduced",
    family="ssm",
    num_layers=2,
    d_model=128,
    d_ff=256,
    vocab_size=512,
    num_heads=0,
    ssm_kind="rwkv6",
    ssm_head_dim=32,
    ssm_expand=1,
    ssm_chunk=32,
)
