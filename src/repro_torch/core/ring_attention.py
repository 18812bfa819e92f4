"""Sequence-parallel attention (paper §4.2) over stacked virtual ranks — the
twin of ``repro/core/ring_attention.py``.

Ring attention: the sequence is sharded over the ranks of ``ctx``'s axis
and the KV shards rotate around the ring; each rank runs blockwise
(online-softmax) attention on the shard it holds while the next one is in
flight. The JAX functions run inside ``shard_map`` on one rank's
``(B, H, S_loc, D)`` slab; here every tensor is stacked ``(R, B, H,
S_loc, D)`` (``core/pgl.py``) and the body runs once for all ranks:

* each ring step shifts the whole stacked (k, v) one hop with
  ``ctx.ring_shift`` — the p2p kernel under ``fused`` — issued before the
  held block is consumed, as in JAX;
* each hop is ONE launch of the flash kernel for all R ranks
  (``kernels/flash_attention.py::flash_attention_hop``, the rank folded
  into the batch), masked at global positions: under causal a rank whose
  held block comes from a later rank sees nothing and merges as a no-op,
  which is JAX's ``skip_block``; the diagonal block (the rank's own) is
  masked, an earlier block is full, masked only under a window;
* the hops' ``(o, m, l)`` are merged by the FlashAttention rule in plain,
  differentiable torch (f32), and the result is ``o / max(l, 1e-30)``.

Also the SSM analogue, sequence-parallel state passing for Mamba
(:func:`ssm_entry_states`); no model calls it, in JAX either.
"""

from __future__ import annotations

import torch

from repro_torch.core.template import rank_index
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_hop

__all__ = ["pk_ring_attention", "ring_attention_baseline",
           "ssm_entry_states"]


def _grouped_scores(q, k, scale):
    """q: (..., Hkv, G, Sq, D); k: (..., Hkv, Skv, D) -> (..., Hkv, G, Sq,
    Skv), f32."""
    return torch.einsum("...kgqd,...ksd->...kgqs", q.float(),
                        k.float()) * scale


def _block_update(q, k, v, m, l, o, *, scale, mask=None):
    """One online-softmax accumulation step (FlashAttention rule), JAX's
    ``_block_update`` with any leading dims. Shapes: q (..., Hkv, G, Sq,
    D); k, v (..., Hkv, Skv, D); m, l (..., Hkv, G, Sq) f32; o (..., Hkv,
    G, Sq, D) f32; ``mask`` (True = keep) broadcasts against the scores."""
    s = _grouped_scores(q, k, scale)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "...kgqs,...ksd->...kgqd", p, v.float())
    return m_new, l_new, o_new


def _causal_block_mask(sq: int, skv: int, q_offset, kv_offset,
                       window: int | None = None) -> torch.Tensor:
    """True = keep. Global-position causal (+ optional sliding window).
    Offsets are ints, giving (Sq, Skv), or per-rank (R,) tensors, giving
    (R, Sq, Skv)."""
    q_offset, kv_offset = (torch.as_tensor(o) for o in (q_offset, kv_offset))
    dev = q_offset.device
    qi = q_offset[..., None, None] + torch.arange(sq, device=dev)[:, None]
    ki = kv_offset[..., None, None] + torch.arange(skv, device=dev)[None, :]
    keep = ki <= qi
    if window is not None:
        keep = keep & (ki > qi - window)
    return keep


def pk_ring_attention(q, k, v, *, ctx, causal: bool = True,
                      window: int | None = None, scale: float | None = None):
    """q: (R, B, Hq, S_loc, D); k, v: (R, B, Hkv, S_loc, D), the sequence
    sharded over ``ctx``'s axis (rank r holds rows r·S_loc ...). Returns
    (R, B, Hq, S_loc, D) in q's dtype.

    At ring step i rank d holds the KV block of rank (d - i) % R (a
    right-going ring); the next shift is issued before the held block is
    consumed. A window masks every block with JAX's causal-plus-window mask
    (``_causal_block_mask`` includes causality), so the hop is masked
    whenever ``causal`` or ``window`` is set."""
    r, b, hq, s_loc, dim = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq ({hq}) must be a multiple of Hkv ({hkv})")
    scale = scale if scale is not None else dim ** -0.5
    masked = causal or window is not None

    def fold(t):
        return t.reshape(r * b, *t.shape[2:])

    qf = fold(q)
    m = torch.full((r * b, hq, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_ = torch.zeros_like(m)
    o = torch.zeros((r * b, hq, s_loc, dim), dtype=torch.float32,
                    device=q.device)
    kv = (k, v)
    for i in range(r):
        k_i, v_i = kv
        if i < r - 1:
            kv = ctx.ring_shift(kv)
        o_i, m_i, l_i = flash_attention_hop(
            qf, fold(k_i), fold(v_i), ranks=r, hop=i, causal=masked,
            window=window, scale=scale)
        m_new = torch.maximum(m, m_i)
        a, a_i = torch.exp(m - m_new), torch.exp(m_i - m_new)
        l_ = l_ * a + l_i * a_i
        o = o * a[..., None] + o_i * a_i[..., None]
        m = m_new
    out = o / l_.clamp_min(1e-30)[..., None]
    return out.reshape(r, b, hq, s_loc, dim).to(q.dtype)


def ring_attention_baseline(q, k, v, *, ctx, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None):
    """Non-overlapped baseline: a bulk all-gather of the full K/V over the
    sequence, then one local attention over it (JAX's schedule, including
    its window-only branch). Shapes as :func:`pk_ring_attention`."""
    r, b, hq, s_loc, dim = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dim ** -0.5
    k_full = ctx.all_gather(k, axis=2, backend="bulk")
    v_full = ctx.all_gather(v, axis=2, backend="bulk")
    s_full = k_full.shape[3]
    qg = q.reshape(r, b, hkv, g, s_loc, dim)
    s = _grouped_scores(qg, k_full, scale)
    if causal or window is not None:
        d = rank_index(q)
        mask = _causal_block_mask(s_loc, s_full, d * s_loc, 0, window)
        if not causal:      # window-only (bidirectional)
            qi = (d * s_loc)[:, None, None] + torch.arange(
                s_loc, device=q.device)[:, None]
            mask = mask | (torch.arange(s_full, device=q.device) > qi)
        s = torch.where(mask[:, None, None, None], s, torch.full_like(
            s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("rbkgqs,rbksd->rbkgqd", p, v_full.float())
    return out.reshape(r, b, hq, s_loc, dim).to(q.dtype)


def ssm_entry_states(chunk_decay, chunk_exit, *, ctx):
    """Sequence-parallel linear-SSM state exchange over stacked ranks.

    A chunk of ``h_t = a_t h_{t-1} + b_t`` acts on its entry state as
    ``h_out = A h_in + S`` (A its total decay, S its exit from zero); rank
    d needs the composition of the chunks of all ranks j < d applied to
    zero. An exclusive scan as a ring of R-1 hops, each forwarding the
    running composition one hop right; rank d reads its answer at hop
    i == d. ``chunk_decay``, ``chunk_exit``: (R, ...)."""
    n = ctx.axis_size
    d = rank_index(chunk_exit).view(-1, *([1] * (chunk_exit.dim() - 1)))
    h_entry = torch.zeros_like(chunk_exit)
    c_a, c_s = chunk_decay, chunk_exit              # window [d, d]
    for i in range(1, n):
        a_in, s_in = ctx.ring_shift((c_a, c_s))     # window [d-i .. d-1]
        h_entry = torch.where(d == i, s_in, h_entry)
        # compose: incoming window first, then this chunk -> [d-i .. d]
        c_a, c_s = chunk_decay * a_in, chunk_decay * s_in + chunk_exit
    return h_entry
