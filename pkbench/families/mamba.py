"""The port's side of the Mamba-1 configurations."""

from __future__ import annotations


def arch(cfg: dict, dm: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name=cfg["name"], family="ssm", n_layers=dm["layers"],
        d_model=dm["d"], n_heads=1, n_kv_heads=1, d_ff=0,
        vocab_size=dm["vocab"], ssm_state=dm["n"],
        d_inner_mult=dm["di"] // dm["d"], conv_kernel=dm["ck"],
        dt_rank=dm["dtr"], norm_eps=dm["eps"], tie_embeddings=False,
        dtype="bfloat16")


def leaf_names(tmpl):
    from repro_torch.models.transformer import leaves
    for path, _ in leaves(tmpl):
        yield path, (path[3] if path[0] == "blocks" else path[0])


def to_global(weights: dict, name: str, shape):
    return weights[name]
