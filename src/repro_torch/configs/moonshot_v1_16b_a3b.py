"""Moonlight-16B-A3B (kimi/moonshot) — MoE 64 experts top-6, per-expert
d_ff=1408. [hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, head_dim=128,
    n_experts=64, top_k=6, moe_every=1,
)
