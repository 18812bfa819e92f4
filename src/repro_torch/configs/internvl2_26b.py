"""InternVL2-26B — InternViT frontend (STUB: precomputed patch embeddings)
+ InternLM2-20B language backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, head_dim=128, rope_theta=1e6,
    frontend="vision", n_frontend_tokens=256,
)
