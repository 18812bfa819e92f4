"""StarCoder2-15B — dense GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab_size=49152, head_dim=128, act="gelu", gated_mlp=False, rope_theta=1e5,
)
