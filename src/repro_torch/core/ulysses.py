"""DeepSpeed-Ulysses sequence parallelism (paper §4.2, Fig. 11) over stacked
virtual ranks — the twin of ``repro/core/ulysses.py``.

Everything outside self-attention is sequence-sharded; attention itself is
head-sharded. Four all-to-alls re-shard q, k and v from sequence to heads
and the output back (``CommContext.all_to_all``, whose chunked backend is
the all-to-all kernel of ``kernels/pk_comm.py`` on the card), cut along a
bystander dim when ``n_chunks`` > 1, as in JAX. Tensors are stacked
``(R, B, H, S, D)`` (``core/pgl.py``) and the body runs once for all
ranks: the head-sharded, full-sequence mix is ONE launch of the flash
kernel (``kernels/flash_attention.py``) with the R ranks folded into the
batch, where JAX runs an XLA attention per rank.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["pk_ulysses_attention", "ulysses_attention_baseline"]


def _local_attention(q, k, v, *, causal, window, scale):
    """q: (R, B, Hq, S, D); k, v: (R, B, Hkv, S, D), every rank's full
    sequence. JAX's mask (``_causal_block_mask``) keeps ``ki <= qi``
    whenever a window is set, even with ``causal=False``, so the kernel
    runs causal then."""
    r, b = q.shape[:2]

    def fold(t):
        return t.reshape(r * b, *t.shape[2:])

    out = flash_attention(fold(q), fold(k), fold(v),
                          causal=causal or window is not None, window=window,
                          scale=scale)
    return out.reshape(q.shape)


def _repeat_kv_to(k, n_target_heads: int):
    """k: (R, B, Hkv, S, D) with its KV heads repeated (each one
    ``n_target_heads // Hkv`` times in a row) up to ``n_target_heads``."""
    hkv = k.shape[2]
    if hkv >= n_target_heads:
        return k
    if n_target_heads % hkv:
        raise ValueError(f"{hkv} KV heads do not repeat to {n_target_heads}")
    return k.repeat_interleave(n_target_heads // hkv, dim=2)


def pk_ulysses_attention(q, k, v, *, ctx, causal: bool = True,
                         window: int | None = None, scale: float | None = None,
                         n_chunks: int = 1):
    """q: (R, B, Hq, S_loc, D); k, v: (R, B, Hkv, S_loc, D), the sequence
    sharded over ``ctx``'s axis. Returns (R, B, Hq, S_loc, D) in q's dtype.

    The all-to-alls give each rank Hq/R heads of the whole sequence, the
    mix attends, and one all-to-all gives the sequence shards back. KV
    heads fewer than the axis size are repeated to it first (GQA, as in
    JAX). ``n_chunks`` goes to every all-to-all."""
    r, _, hq, _, _ = q.shape
    if hq % r:
        raise ValueError(f"{hq} heads do not split over {r} ranks")
    kr = _repeat_kv_to(k, max(k.shape[2], r))
    vr = _repeat_kv_to(v, max(v.shape[2], r))

    def to_heads(t):
        return ctx.all_to_all(t, split_axis=1, concat_axis=2,
                              n_chunks=n_chunks)

    out = _local_attention(to_heads(q), to_heads(kr), to_heads(vr),
                           causal=causal, window=window, scale=scale)
    return ctx.all_to_all(out, split_axis=2, concat_axis=1, n_chunks=n_chunks)


def ulysses_attention_baseline(q, k, v, *, ctx, causal: bool = True,
                               window: int | None = None,
                               scale: float | None = None):
    """The same function with one bulk all-to-all each (``n_chunks=1``),
    the YunChang-style baseline of paper Fig. 11."""
    return pk_ulysses_attention(q, k, v, ctx=ctx, causal=causal,
                                window=window, scale=scale, n_chunks=1)
