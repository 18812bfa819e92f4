"""Falcon-Mamba-7B — pure Mamba-1, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=65024, ssm_state=16, d_inner_mult=2, conv_kernel=4,
)
