"""Whisper-medium — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, act="gelu", gated_mlp=False,
    encoder_decoder=True, n_encoder_layers=24, frontend="audio",
)
