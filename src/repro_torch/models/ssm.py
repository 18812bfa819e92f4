"""Mamba-1 selective SSM block (falcon-mamba, jamba's mamba layers) — the
twin of ``repro/models/ssm.py``, for serving and training.

Where the JAX model runs ``selective_scan_chunked`` (an XLA associative
scan), the port runs the hand-written scan kernel
(``kernels/mamba_scan.py``), which computes what the Pallas
``mamba_scan`` computes, and adds ``x·D`` after it as
``selective_scan_chunked`` does. In training the scan is an autograd
Function whose backward is the scan's hand-written backward kernel
(``mamba_scan_bwd``). The causal conv, the projections and the gate are
plain PyTorch.

Weights sharded over tp are stored stacked per rank (``core/pgl.py``):
``in_proj`` (R, d, 2·di/R) and ``dt_proj`` (R, dtr, di/R) over their
output dim, projected per rank and concatenated (``layers._col_proj``;
on (1, 4) ranks 0-1 hold the x half of ``in_proj`` and ranks 2-3 the z
half, so the x/z split crosses ranks); ``x_proj``, ``out_proj``, the conv
and the per-channel leaves over di, whose rank slabs are contiguous row
blocks, so their global view is a reshape (``layers._row_weight``) and
the products
that JAX sums over ranks (``x_proj``, ``out_proj``) are one product over
the whole di. No global copy of a weight is made. With FSDP on a dp > 1
mesh ``in_proj`` (sharded over d) and ``out_proj`` (over its output d)
are first gathered, one copy per dp group (``layers.project`` and
``layers.row_project``: the gathers XLA inserts in JAX). Activations are global
(B, S, di), channel r·di/R + j being rank r's channel j. The serving
cache's state ``h`` is stacked (R, B, di/R, N) and goes to the kernel as
it is; the conv tail (R, B, ck-1, di/R) is small and is reassembled
(``pgl.assemble`` / ``pgl.layout``).

Not ported: the bf16 scan dtype (``run.ssm_scan_dtype="bfloat16"``, ROADMAP
A10e), which only the forward without a cache reads — there JAX rounds
the associative scan's terms to bf16 in XLA's tree order, which a
sequential kernel cannot reproduce, so that forward raises — and
sequence-parallel SSM in the model (A10d; its state ring,
``core/ring_attention.ssm_entry_states``, is ported, and no model calls
it, in JAX either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import pgl
from repro_torch.core.pgl import P
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import (_col_proj, _row_weight, project,
                                       row_project)
from repro_torch.models.sharding import ShardingRules


def _causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, S, di); w: (di, ck); b: (di,). The sum
    of shifted views, in x's dtype, in the JAX order."""
    ck, s = w.shape[1], x.shape[1]
    pad = F.pad(x, (0, 0, ck - 1, 0))
    out = pad[:, 0:s] * w[:, 0]
    for i in range(1, ck):
        out = out + pad[:, i:i + s] * w[:, i]
    return out + b


def selective_scan_chunked(dt, b_ssm, c_ssm, x_conv, a, d_skip, h0, *,
                           chunk: int = 256,
                           h_out: torch.Tensor | None = None):
    """The selective scan plus the ``x·D`` skip.

    dt, x_conv: (B, S, di); b_ssm, c_ssm: (B, S, N); a: (di, N) f32;
    d_skip: (di,) f32; h0: (B, di, N) f32 or stacked (R, B, di/R, N).
    Returns (y (B, S, di) f32, h_last in h0's layout). The scan is the
    kernel; ``chunk`` never changes its result. The skip is added in place
    unless autograd tracks y."""
    y, h_last = mamba_scan(dt, b_ssm, c_ssm, x_conv, a, h0, chunk=chunk,
                           h_out=h_out)
    if y.requires_grad:
        return torch.addcmul(y, x_conv, d_skip), h_last
    return y.addcmul_(x_conv, d_skip), h_last


def mamba_mix(p, x, cfg: ArchConfig, *, h0=None, conv_state=None,
              chunk: int = 256, return_state: bool = False,
              h_out: torch.Tensor | None = None):
    """Core mamba mixing. x: (B, S, di) (post in_proj split, pre conv).

    p: {"conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D"},
    global or stacked per rank. ``conv_state`` is the global (B, ck-1, di)
    tail. Returns y (B, S, di) [+ (h_last, conv_tail) if return_state]."""
    b, s, di = x.shape
    n = cfg.ssm_state
    conv_w, conv_b = _row_weight(p["conv_w"]), _row_weight(p["conv_b"], 1)
    if conv_state is not None:   # decode/continuation: prepend cached tail
        xin = torch.cat([conv_state.to(x.dtype), x], dim=1)
        x_conv = _causal_conv1d(xin, conv_w, conv_b)[:, -s:]
    else:
        xin = x
        x_conv = _causal_conv1d(x, conv_w, conv_b)
    x_conv = F.silu(x_conv)

    proj = torch.matmul(x_conv, _row_weight(p["x_proj"]))
    dt, b_ssm, c_ssm = proj.split([cfg.dtr, n, n], dim=-1)
    dt = F.softplus(_col_proj(dt, p["dt_proj"])
                    + _row_weight(p["dt_bias"], 1))           # (B, S, di)
    a = -torch.exp(_row_weight(p["A_log"]).float())           # (di, N)

    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    y, h_last = selective_scan_chunked(
        dt, b_ssm, c_ssm, x_conv, a, _row_weight(p["D"], 1).float(), h0,
        chunk=chunk, h_out=h_out)
    y = y.to(x.dtype)
    if return_state:
        ck = conv_w.shape[1]
        # a copy, not a view: a view would keep this layer's whole
        # (B, S + ck - 1, di) input alive until the cache is stacked
        conv_tail = xin[:, -(ck - 1):, :].clone() if ck > 1 else \
            x.new_zeros((b, 0, di))
        return y, (h_last, conv_tail)
    return y


def mamba_block(p, x, cfg: ArchConfig, run: RunConfig,
                rules: ShardingRules | None, *, cache=None,
                h_out: torch.Tensor | None = None):
    """Full mamba block: in_proj -> conv/SSM mix -> gate -> out_proj.

    Without a cache (a whole sequence from a zero state: training and
    ``forward_prefill``) returns (out, None). With ``cache = (h, conv)``
    in the serving cache's layout returns (out, (h_last, conv_tail)) in
    that layout; the new state is written into ``h_out`` when one is
    given."""
    di = cfg.d_inner
    if cache is None and run.ssm_scan_dtype != "float32":
        raise NotImplementedError(
            f"ssm_scan_dtype={run.ssm_scan_dtype!r}: the bf16 scan terms of "
            "JAX's associative scan are ROADMAP item A10e; the port scans "
            "in float32")
    xz = project(x, p["in_proj"], 2 * di, rules, run)
    x_ssm, z = xz.split(di, dim=-1)
    if cache is None:
        y = mamba_mix(p, x_ssm, cfg, chunk=run.ssm_chunk)
        new_cache = None
    else:
        h, conv = cache
        stacked = conv.dim() == 4      # (R, B, ck-1, di/R): di over tp
        spec = P(None, None, rules.tp) if stacked else None
        if stacked:
            conv = pgl.assemble(conv, spec, rules.mesh, rules.tp)
        y, (h_last, tail) = mamba_mix(p, x_ssm, cfg, h0=h, conv_state=conv,
                                      return_state=True, h_out=h_out)
        if stacked:
            tail = pgl.layout(tail, spec, rules.mesh, rules.tp)
        new_cache = (h_last, tail)
    y = y * F.silu(z)
    return row_project(y, p["out_proj"], rules, run), new_cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    """Zero state: (h (B, di, N) f32, conv tail (B, ck-1, di))."""
    di, n, ck = cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    return (torch.zeros((batch, di, n), dtype=torch.float32, device=device),
            torch.zeros((batch, ck - 1, di), dtype=dtype, device=device))
