"""The port's side of the attention + routed-experts configurations."""

from __future__ import annotations

ATTN = {"norm": "attn_norm", "wq": "wq", "wk": "wk", "wv": "wv",
        "wo": "wo"}
MOE = {"norm": "moe_norm", "router": "router", "w1": "w1", "w3": "w3",
       "w2": "w2"}


def arch(cfg: dict, dm: dict):
    """The port's ``ArchConfig`` as the configuration file states it. No
    capacity (None) is the port's capacity factor at experts / top-k, at
    which every expert can take every token routed with it."""
    from repro_torch.configs.base import ArchConfig
    cf = dm["capacity_factor"]
    return ArchConfig(
        name=cfg["name"], family="moe", n_layers=dm["layers"],
        d_model=dm["d"], n_heads=dm["heads"], n_kv_heads=dm["kv_heads"],
        d_ff=dm["ff"], vocab_size=dm["vocab"], head_dim=dm["hd"],
        n_experts=dm["experts"], top_k=dm["top_k"], moe_every=1,
        capacity_factor=(dm["experts"] / dm["top_k"] if cf is None
                         else cf), rope_theta=dm["theta"],
        norm_eps=dm["eps"], act="silu", gated_mlp=True,
        tie_embeddings=False, dtype="bfloat16")


def leaf_names(tmpl):
    """(port path, benchmark weight) for every leaf of the template."""
    from repro_torch.models.transformer import leaves
    for path, _ in leaves(tmpl):
        if path[0] == "blocks":
            group = ATTN if path[2] == "attn" else MOE
            yield path, group[path[3]]
        else:
            yield path, path[0]


def to_global(weights: dict, name: str, shape):
    """The benchmark weight in the port's global shape: an expert weight
    (L, E, in, out) is the port's device-major (L, M, E/M, in, out) when
    every expert sits whole on one rank (E a multiple of the model axis)."""
    x = weights[name]
    if name in ("w1", "w3", "w2") and x.dim() == 4:
        if shape[2] * shape[1] != x.shape[1] or shape[-2:] != x.shape[-2:]:
            raise ValueError(f"{name}: experts split within an expert "
                             f"({tuple(x.shape)} -> {shape}) are not laid "
                             "out by this benchmark")
        x = x.reshape(shape)
    return x
