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

``run.ssm_scan_dtype="bfloat16"`` (ROADMAP A10e), which only the forward
without a cache reads, runs JAX's bf16 chunked scan in plain torch
(:func:`selective_scan_chunked_bf16`): JAX runs that path in XLA, not in
Pallas, and rounds ``a_bar``, ``bx`` and the ``h·c`` operands to bf16
inside ``lax.associative_scan``, whose odd/even recursion
:func:`associative_scan` copies so that the roundings fall on the same
terms; the cross-chunk carry stays f32. The f32 default runs the kernel.
Sequence-parallel SSM in the model (A10d) needs no port: its state ring,
``core/ring_attention.ssm_entry_states``, is ported, and no model calls
it, in JAX either.
"""

from __future__ import annotations

import functools

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


def associative_scan(fn, elems, dim: int):
    """``lax.associative_scan(fn, elems, axis=dim)`` for a tuple of
    tensors: JAX's odd/even recursion, step for step — adjacent pairs
    combined, the odd results scanned by recursion, the even ones combined
    from them, then interleaved — so that a rounding ``fn`` rounds the same
    partial products as JAX's does."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):                # interleave along dim
        full = ev.new_empty(*ev.shape[:dim], n, *ev.shape[dim + 1:])
        full[(slice(None),) * dim + (slice(0, None, 2),)] = ev
        full[(slice(None),) * dim + (slice(1, None, 2),)] = od
        out.append(full)
    return tuple(out)


def selective_scan_chunked_bf16(dt, b_ssm, c_ssm, x_conv, a, d_skip, h0, *,
                                chunk: int = 256):
    """JAX's ``selective_scan_chunked`` with ``scan_dtype=bfloat16`` in
    plain torch, with the ``x·D`` skip: a chunk's ``a_bar = exp(dt·a)`` and
    ``bx = dt·b·x`` rounded to bf16, the affine composition scanned in bf16
    by :func:`associative_scan`, ``h = aa·h_carry + bb`` in f32, then
    ``y = Σ_n bf16(h)·bf16(c)`` accumulated in f32. The carry between
    chunks stays f32. Returns (y (B, S, di) f32, h_last (B, di, N) f32)."""
    b, s, di = dt.shape
    if s % chunk != 0:
        chunk = s
    bf = torch.bfloat16

    def comb(u, v):        # (a, b)∘(a', b') = (a'a, a'b + b'), in bf16
        return (u[0] * v[0], v[0] * u[1] + v[1])

    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        dt_i, b_i, c_i, x_i = (t[:, c0:c0 + chunk]
                               for t in (dt, b_ssm, c_ssm, x_conv))
        a_bar = torch.exp(dt_i.float()[..., None] * a).to(bf)
        bx = (dt_i[..., None] * b_i[:, :, None, :]
              * x_i[..., None]).to(bf)                    # (B, c, di, N)
        aa, bb = associative_scan(comb, (a_bar, bx), 1)
        h_all = aa.float() * h[:, None] + bb.float()
        y_i = torch.einsum("bsdn,bsn->bsd", h_all.to(bf).float(),
                           c_i.to(bf).float())
        ys.append(y_i + x_i.float() * d_skip)
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


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
              h_out: torch.Tensor | None = None,
              scan_dtype: str = "float32"):
    """Core mamba mixing. x: (B, S, di) (post in_proj split, pre conv).

    p: {"conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D"},
    global or stacked per rank. ``conv_state`` is the global (B, ck-1, di)
    tail. ``scan_dtype="bfloat16"`` scans with bf16 terms
    (:func:`selective_scan_chunked_bf16`). Returns y (B, S, di) [+
    (h_last, conv_tail) if return_state]."""
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
    scan = (selective_scan_chunked_bf16 if scan_dtype == "bfloat16"
            else functools.partial(selective_scan_chunked, h_out=h_out))
    y, h_last = scan(dt, b_ssm, c_ssm, x_conv, a,
                     _row_weight(p["D"], 1).float(), h0, chunk=chunk)
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
    ``forward_prefill``) returns (out, None), scanning in
    ``run.ssm_scan_dtype``. With ``cache = (h, conv)``
    in the serving cache's layout returns (out, (h_last, conv_tail)) in
    that layout; the new state is written into ``h_out`` when one is
    given."""
    di = cfg.d_inner
    xz = project(x, p["in_proj"], 2 * di, rules, run)
    x_ssm, z = xz.split(di, dim=-1)
    if cache is None:
        y = mamba_mix(p, x_ssm, cfg, chunk=run.ssm_chunk,
                      scan_dtype=run.ssm_scan_dtype)
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
