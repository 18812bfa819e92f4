"""Plain PyTorch oracles with the global-array semantics of
``repro/kernels/ref.py`` — the allclose targets the kernels are held to."""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_matmul import (  # noqa: F401
    grouped_matmul_plain as grouped_matmul_ref,
)
from repro_torch.kernels.mamba_scan import (  # noqa: F401
    mamba_scan_plain as mamba_scan_ref,
)
from repro_torch.kernels.matmul import matmul_plain as matmul_ref  # noqa: F401
from repro_torch.kernels.pk_comm import (  # noqa: F401
    ring_shift_plain as ring_shift_ref,
)

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q, k, v: (B, H, S, D), equal head counts."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    keep = torch.ones((s, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ag_matmul_ref(x, w):
    """Global semantics of AG+GEMM: the plain product (the gather makes
    every row available to every rank)."""
    return matmul_ref(x, w)


def matmul_rs_ref(x, w):
    """Global semantics of GEMM+RS: the plain product; sharding splits
    rows."""
    return matmul_ref(x, w)


def matmul_ar_ref(x, w):
    """Global semantics of GEMM+AR: the plain product, f32 out."""
    return torch.matmul(x.float(), w.float())


def all_gather_ref(x_global):
    """Identity at the global level: the gather leaves every rank holding
    the full array."""
    return x_global


def reduce_scatter_ref(x_global):
    """x_global: (n_dev, n_dev, blk, ...) — rank d holds partials x[d];
    the result's shard d is sum_j x[j, d]."""
    return x_global.sum(dim=0)
