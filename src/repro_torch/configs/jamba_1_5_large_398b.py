"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, ssm_state=16, d_inner_mult=2, conv_kernel=4,
)
