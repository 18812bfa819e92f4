"""Expert parallelism on virtual ranks — the twin of ``repro/core/moe.py``.

Replicated dispatch (the JAX package's default strategy): activations are
replicated over the tensor-parallel axis after attention, so each rank
computes the experts it owns on the tokens routed to them; dispatch is a
local gather, and the combine is the psum a tensor-parallel FFN needs
anyway. EP×TP hybrid: ``ep = gcd(E, M)``, ``tp_ff = M // ep``; rank r owns
experts ``[(r // tp_ff) · E_loc, ...)`` with the ff slice ``r % tp_ff``.

Expert weights are stored device-major, ``(M, E_loc, d, ff_loc)`` over the
tp axis (``core/moe_layout.py`` converts to and from the logical layout),
and arrive in :func:`pk_moe_replicated` stacked as ``(R, E_loc, ...)``,
dim 0 the rank axis of ``core/pgl.py``. The body runs once for every
virtual rank: routing is computed once (the activations are the same on
every rank), the capacity selection per rank, and the three expert GEMMs of
all ``R · E_loc`` experts run as one launch each of the grouped-GEMM kernel
(``kernels/grouped_matmul.py``).

A2a dispatch (:func:`pk_moe_a2a`, the paper-faithful GShard schedule of
§4.3): each rank holds its own tokens, routes them, all-to-alls each
expert's chosen tokens to the rank that owns the expert, runs the expert
GEMMs there and all-to-alls the outputs back, once per capacity chunk. On
virtual ranks the body runs once: routing and capacity are per rank, on its
own tokens; the expert GEMMs of all ``R · E_loc`` experts are one
grouped-GEMM launch each. Neither package's model calls it
(``RunConfig.moe_strategy`` is read by neither), so it is an op.

Every top-k goes through :func:`topk_stable`, which breaks ties toward the
lower index as ``lax.top_k`` does (``torch.topk`` does not).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_matmul import grouped_matmul


def ep_tp_split(n_experts: int, model_size: int) -> tuple[int, int]:
    """(ep, tp_ff): expert-parallel degree and per-expert FFN TP degree."""
    ep = math.gcd(n_experts, model_size)
    return ep, model_size // ep


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    return max(1, math.ceil(n_tokens * top_k / n_experts * capacity_factor))


class DispatchPlan(NamedTuple):
    """The gating/capacity decision shared by every MoE variant."""
    cap: int          # per-expert capacity (tokens), clamped to n_tokens
    chunk: int        # tokens per overlap chunk of the capacity loop
    n_chunks: int     # cap // chunk (1 when cap is not chunkable)


def dispatch_plan(n_tokens: int, *, n_experts: int, top_k: int,
                  capacity_factor: float, n_chunks: int = 1) -> DispatchPlan:
    """Capacity + chunking for ``n_tokens`` routed tokens. ``n_chunks`` > 1
    is honored only when it divides the capacity (otherwise one bulk
    chunk, as in JAX)."""
    cap = min(capacity(n_tokens, n_experts, top_k, capacity_factor), n_tokens)
    chunk = cap // n_chunks if n_chunks > 1 and cap % n_chunks == 0 else cap
    return DispatchPlan(cap=cap, chunk=chunk, n_chunks=cap // chunk)


def topk_stable(x: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last dim and their indices, ties
    broken toward the lower index (``lax.top_k``'s order): a stable
    descending sort, sliced."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class RouterOut(NamedTuple):
    probs: torch.Tensor      # (T, E) f32
    top_vals: torch.Tensor   # (T, K) f32
    top_idx: torch.Tensor    # (T, K) int64


def route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
          norm_topk: bool = True) -> RouterOut:
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = topk_stable(probs, top_k)
    if norm_topk:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True).clamp_min(
            1e-9)
    return RouterOut(probs, top_vals, top_idx)


def aux_load_balance_loss(r: RouterOut, n_experts: int) -> torch.Tensor:
    """Switch-style load balance loss (fraction × mean prob per expert)."""
    t, k = r.top_idx.shape
    hits = torch.ones(t * k, dtype=torch.float32, device=r.probs.device)
    frac = torch.zeros(n_experts, dtype=torch.float32,
                       device=r.probs.device).index_add_(
        0, r.top_idx.reshape(-1), hits) / (t * k)
    return n_experts * torch.sum(frac * r.probs.mean(dim=0))


def _local_gates(r: RouterOut, e0, e_loc: int) -> torch.Tensor:
    """(E_loc, T) combined gate weight of each token for each owned expert;
    ``e0`` a first expert id, or one per rank as an (R,) tensor, which
    gives (R, E_loc, T)."""
    e0 = torch.as_tensor(e0, device=r.top_idx.device)
    e_ids = e0[..., None] + torch.arange(e_loc, device=e0.device)
    hit = r.top_idx[:, :, None] == e_ids[..., None, None, :]   # (..,T,K,E)
    return torch.einsum("...tke,tk->...et", hit.float(), r.top_vals)


def _expert_ffn(x_sel, w1, w3, w2, *, act=F.silu):
    """x_sel: (..., E_loc, C, d); w1/w3: (..., E_loc, d, f); w2: (...,
    E_loc, f, d) with the same leading dims. Every expert of every leading
    index is one group of the grouped GEMM: three launches (w1, w3, w2),
    f32 out, the activation rounded to x's dtype before w2, as the JAX
    einsums with ``preferred_element_type=f32``."""
    lead = x_sel.shape[:-2]
    xs = x_sel.reshape(-1, *x_sel.shape[-2:])

    def gmm(a, w):
        return grouped_matmul(a, w.reshape(-1, *w.shape[-2:]),
                              out_dtype=torch.float32)

    h = gmm(xs, w1)
    h = act(h) * gmm(xs, w3) if w3 is not None else act(h)
    out = gmm(h.to(x_sel.dtype), w2)
    return out.reshape(*lead, *out.shape[-2:])


def pk_moe_replicated(x, router_w, w1, w3, w2, *, ctx, n_experts: int,
                      top_k: int, capacity_factor: float = 1.25,
                      norm_topk: bool = True, n_chunks: int = 1,
                      ring_combine: bool = False,
                      plan: DispatchPlan | None = None):
    """Replicated-dispatch MoE over the stacked ranks of ``ctx``'s axis.

    x: (R, T, d) tokens, the same on every rank; router_w: (R, d, E), the
    same on every rank; w1/w3: (R, E_loc, d, ff_loc), w2: (R, E_loc,
    ff_loc, d) — each rank's device-major slice (w3 None: ungated).
    Returns ((R, T, d) output in x's dtype, the same on every rank; the
    aux loss, a scalar). ``plan`` carries the shared gating/capacity
    decision; when None it is derived here from ``n_chunks``. Under
    autograd the tokens and the router are read from rank 0's slab only
    (every slab is the same replicated tensor), so their gradients reach
    the global ``x`` and ``router`` once, not once a rank; the psum's
    backward gives every rank's partial the output's cotangent."""
    r_n, t, d = x.shape
    ep, tp_ff = ep_tp_split(n_experts, r_n)
    e_loc = n_experts // ep
    if w1.shape[1] != e_loc:
        raise ValueError(f"w1 holds {w1.shape[1]} experts per rank, the "
                         f"split of {n_experts} over {r_n} ranks gives "
                         f"{e_loc}")
    if plan is None:
        plan = dispatch_plan(t, n_experts=n_experts, top_k=top_k,
                             capacity_factor=capacity_factor,
                             n_chunks=n_chunks)
    if plan.cap > t:
        raise ValueError(f"capacity {plan.cap} exceeds {t} tokens")
    x0 = x[0]
    r = route(x0, router_w[0], top_k=top_k, norm_topk=norm_topk)
    ranks = torch.arange(r_n, device=x.device)
    gates = _local_gates(r, (ranks // tp_ff) * e_loc, e_loc)  # (R, E_loc, T)
    sel_gate, sel_idx = topk_stable(gates, plan.cap)         # (R, E_loc, C)
    valid = (sel_gate > 0).float()

    y = torch.zeros((r_n * t, d), dtype=torch.float32, device=x.device)
    row0 = (ranks * t).view(r_n, 1, 1)       # rank r's rows of y
    c = plan.chunk
    for ci in range(plan.n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        idx_c = sel_idx[..., sl]
        x_sel = x0.index_select(0, idx_c.reshape(-1)).reshape(
            r_n, e_loc, c, d)
        out_c = _expert_ffn(x_sel, w1, w3, w2)
        wgt = (sel_gate[..., sl] * valid[..., sl])[..., None]
        y.index_add_(0, (idx_c + row0).reshape(-1),
                     (out_c * wgt).reshape(-1, d))

    # one psum folds together the E_loc partition across ep groups and the
    # ff_loc partial sums across the tp_ff subgroups, in the activation
    # dtype (as JAX reduces it)
    y = ctx.psum(y.view(r_n, t, d).to(x.dtype),
                 backend="ring" if ring_combine else "bulk")
    return y, aux_load_balance_loss(r, n_experts)


def pk_moe_a2a(x, router_w, w1, w3, w2, *, ctx, n_experts: int, top_k: int,
               capacity_factor: float = 1.25, norm_topk: bool = True,
               n_chunks: int = 1, plan: DispatchPlan | None = None):
    """A2a-dispatch MoE over the stacked ranks of ``ctx``'s axis (JAX
    ``pk_moe_a2a``): experts sharded ``E_loc = E / R`` (rank r owns experts
    ``[r · E_loc, ...)``), each rank's tokens its own.

    x: (R, T, d); router_w: (R, d, E), the same on every rank; w1/w3: (R,
    E_loc, d, ff), w2: (R, E_loc, ff, d) (w3 None: ungated). Returns ((R,
    T, d) in x's dtype, each rank's aux loss (R,)). ``n_chunks`` > 1 splits
    the capacity loop (the shared ``DispatchPlan``); each chunk's dispatch
    is the destination-major ``(R, E_loc, Cc, d)`` of every rank, sent and
    returned by bulk all-to-alls (split = concat = 0), as JAX pins them;
    the combine scatter-adds in f32."""
    r_n, t, d = x.shape
    if n_experts % r_n or w1.shape[1] != n_experts // r_n:
        raise ValueError(f"{n_experts} experts over {r_n} ranks, w1 holding "
                         f"{w1.shape[1]} a rank")
    e_loc = n_experts // r_n
    if plan is None:
        plan = dispatch_plan(t, n_experts=n_experts, top_k=top_k,
                             capacity_factor=capacity_factor,
                             n_chunks=n_chunks)
    rt = route(x, router_w, top_k=top_k, norm_topk=norm_topk)  # (R, T, ..)
    hit = rt.top_idx[..., None] == torch.arange(n_experts, device=x.device)
    gates = torch.einsum("rtke,rtk->ret", hit.float(), rt.top_vals)
    sel_gate, sel_idx = topk_stable(gates, plan.cap)         # (R, E, C)
    valid = (sel_gate > 0).float()
    aux = torch.stack([aux_load_balance_loss(
        RouterOut(rt.probs[i], rt.top_vals[i], rt.top_idx[i]), n_experts)
        for i in range(r_n)])

    rows = (torch.arange(r_n, device=x.device) * t).view(r_n, 1, 1)
    x_all = x.reshape(r_n * t, d)
    y = torch.zeros((r_n * t, d), dtype=torch.float32, device=x.device)
    c = plan.chunk
    for ci in range(plan.n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        idx_c = sel_idx[..., sl] + rows                          # (R, E, Cc)
        # [src, dst, local expert, slot] -> [dst, src, ...]: the tokens
        # rank src sends to the owner of each expert, arriving by source
        x_send = x_all.index_select(0, idx_c.reshape(-1)).view(
            r_n, r_n, e_loc, c, d)
        x_recv = ctx.all_to_all(x_send, split_axis=0, concat_axis=0,
                                backend="bulk")
        x_mine = x_recv.transpose(1, 2).reshape(r_n, e_loc, r_n * c, d)
        out = _expert_ffn(x_mine, w1, w3, w2).to(x.dtype)
        out = out.view(r_n, e_loc, r_n, c, d).transpose(1, 2)
        back = ctx.all_to_all(out, split_axis=0, concat_axis=0,
                              backend="bulk").reshape(r_n, n_experts, c, d)
        wgt = (sel_gate[..., sl] * valid[..., sl])[..., None]
        y.index_add_(0, idx_c.reshape(-1),
                     (back.float() * wgt).reshape(-1, d))
    return y.view(r_n, t, d).to(x.dtype), aux


def moe_reference_dense(x, router_w, w1_full, w3_full, w2_full, *,
                        n_experts: int, top_k: int, norm_topk: bool = True):
    """Oracle: every expert on every token, masked combine — no capacity
    drop. x: (T, d); w1/w3: (E, d, ff); w2: (E, ff, d)."""
    r = route(x, router_w, top_k=top_k, norm_topk=norm_topk)
    outs = _expert_ffn(x.expand(n_experts, *x.shape), w1_full, w3_full,
                       w2_full)                                  # (E, T, d)
    gates = _local_gates(r, 0, n_experts)                        # (E, T)
    y = torch.einsum("etd,et->td", outs, gates)
    return y.to(x.dtype), aux_load_balance_loss(r, n_experts)
