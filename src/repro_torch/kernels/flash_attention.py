"""FlashAttention (online softmax, causal and/or sliding window, GQA).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_fa_kernel``): grid (B·H, q blocks, kv blocks) with the kv dim
sequential, m/l/acc in VMEM scratch, fully masked kv blocks skipped with
``pl.when``; GQA repeat and padding live in the JAX ``ops.flash_attention``.

CUDA route (``csrc/flash_attention.cu``). One CTA per (64-query block,
b·Hq); each of its four warps owns 16 query rows. The CTA reads KV head
``h // (Hq/Hkv)`` directly, so GQA needs no repeat and no copy; it loops
over 64-key blocks, skipping a block on the same causal/window predicate as
the Pallas kernel (``flash_attention.py:37-41``), computes S = QKᵀ and
O += PV with ``mma.sync`` m16n8k16 (bf16 in, f32 accumulate), keeps m, l
and the O accumulator in f32 registers, masks the ragged sequence edge, and
writes O in q's dtype. P is rounded to bf16 before the PV product, as the
Pallas kernel rounds it to v's dtype. What bounds it on the card: at the
prefill shapes (S = 512, hd = 64) reading q, k, v and writing o — about as
many microseconds as its 4·B·Hq·S²·hd/2 causal operations take on the
tensor cores; the design's answer is to read K/V once per query block and
never write S or P to device memory. The kernel is instantiated for
head_dim 64 and 128; any other head_dim up to 128 is zero-padded to the
next of the two and the output sliced back, as JAX's
``ops.flash_attention`` pads to 128 (zero columns add nothing to q·k, and
v's padded columns are dropped); the scale stays that of the true width.

The hop (:func:`flash_attention_hop`) is one step of ring attention
(``core/ring_attention.py``), the same kernel with ``HOP``: the batch is R
ranks × B rows of stacked ``(R, B, H, S_loc, D)`` tensors, rank r's
queries sit at global rows ``r·S_loc + i`` and, at hop i, its keys at
``((r - i) mod R)·S_loc + j``; causal skip and mask use those global
positions, so a rank whose block lies wholly in the future exits at once.
It computes JAX's ``_block_update`` (``repro/core/ring_attention.py:38``)
from the zero state and returns the unnormalized f32 ``P V``, the row max
m (``NEG_INF`` where nothing is visible) and the row sum
``l = Σ exp(s - m)`` (0 there), which the caller merges; it never divides.
One launch covers all R ranks.

The plain version is the twin of ``ref.flash_attention_ref`` with GQA
grouping — the same function as ``layers._full_attention(causal=True)``.
On a CPU tensor the wrapper runs it; on a CUDA tensor it launches the
kernel or raises. Both wrappers are ``torch.autograd.Function``s: the
kernel in forward; in backward the gradient of the plain version,
recomputed in plain torch (f32 scores) from the saved q, k, v (for the hop
through o, m and l, since the merge uses all three). The Pallas kernel has no
backward kernel either — JAX trains through the XLA attention; a
hand-written backward kernel is queued in ROADMAP B7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
#: head_dims the CUDA kernel is instantiated for; others pad up to one
KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Skv, D). f32 softmax, GQA grouped."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def _hop_offsets(b: int, ranks: int, hop: int, sq: int, skv: int,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (q, kv) offsets of each of the ``b = ranks · B`` rows of a
    hop: rank r = row // B holds queries from ``r·sq`` and, at hop ``hop``,
    the keys of rank ``(r - hop) mod ranks`` from that rank's ``·skv``."""
    if ranks < 1 or b % ranks:
        raise ValueError(f"batch {b} is not a multiple of {ranks} ranks")
    r = torch.arange(ranks, device=device).repeat_interleave(b // ranks)
    return r * sq, (r - hop) % ranks * skv


def flash_attention_hop_plain(q, k, v, *, ranks=1, hop=0, causal=True,
                              window=None, scale=None):
    """One hop of ring attention in f32 (see the module docstring): q
    (R·B, Hq, S, D), k, v (R·B, Hkv, Skv, D) -> (o (R·B, Hq, S, D), m, l
    (R·B, Hq, S)), all f32. A row with no visible key has m = NEG_INF,
    l = 0 and o = 0, so it merges as a no-op."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    q_off, kv_off = _hop_offsets(b, ranks, hop, sq, skv, q.device)
    qg = q.reshape(b, hkv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = q_off[:, None, None] + torch.arange(sq, device=q.device)[:, None]
    ki = kv_off[:, None, None] + torch.arange(skv, device=q.device)
    keep = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    drop = ~keep[:, None, None]
    s = s.masked_fill(drop, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(drop, 0.0)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return (o.reshape(b, hq, sq, hd), m.reshape(b, hq, sq),
            p.sum(dim=-1).reshape(b, hq, sq))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,Hq,S,D), k/v "
                         f"(B,Hkv,S,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v differ in batch or head_dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq ({q.shape[1]}) must be a multiple of Hkv "
                         f"({k.shape[1]})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _cuda_inputs(q, k, v, window, scale, name):
    """Check CUDA inputs and pad head_dim up to the kernel's next width.
    Returns (q, k, v, true head_dim, scale of the true head_dim)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA {name} takes bf16 q, k, v")
    hd = q.shape[3]
    width = next((w for w in KERNEL_HEAD_DIMS if hd <= w), None)
    if width is None:
        raise ValueError(f"head_dim must be at most {KERNEL_HEAD_DIMS[-1]}, "
                         f"got {hd}")
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit head_dim stride and "
                             "16-byte aligned rows")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    return q, k, v, hd, scale if scale is not None else hd ** -0.5


def _strides(q, k, v) -> list[int]:
    return [t.stride(i) for t in (q, k, v) for i in range(3)]


def _forward(q, k, v, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    q, k, v, hd, scale = _cuda_inputs(q, k, v, window, scale,
                                      "flash_attention")
    b, hq, sq, width = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, width), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out[..., :hd]
    lib = _build.library()
    err = lib.pk_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, width, *_strides(q, k, v),
        int(causal), int(window or 0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pk_flash_attention_bf16")
    flash_attention.launches += 1
    return out[..., :hd]


def _hop_forward(q, k, v, ranks, hop, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_hop_plain(q, k, v, ranks=ranks, hop=hop,
                                         causal=causal, window=window,
                                         scale=scale)
    q, k, v, hd, scale = _cuda_inputs(q, k, v, window, scale,
                                      "flash_attention_hop")
    b, hq, sq, width = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if ranks < 1 or b % ranks:
        raise ValueError(f"batch {b} is not a multiple of {ranks} ranks")
    o = torch.empty((b, hq, sq, width), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    l_ = torch.empty_like(m)
    if b == 0 or sq == 0:
        return o[..., :hd], m, l_
    lib = _build.library()
    err = lib.pk_flash_attention_hop_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l_.data_ptr(), b, hq, hkv, sq, skv, width, *_strides(q, k, v),
        ranks, hop, int(causal), int(window or 0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pk_flash_attention_hop_bf16")
    flash_attention_hop.launches += 1
    return o[..., :hd], m, l_


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.opts
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            o = flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Attention of q (B, Hq, S, D) over k, v (B, Hkv, Skv, D), out like q."""
    _check(q, k, v)
    return _Flash.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ranks, hop, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(ranks=ranks, hop=hop, causal=causal, window=window,
                        scale=scale)
        return _hop_forward(q, k, v, ranks, hop, causal, window, scale)

    @staticmethod
    def backward(ctx, do, dm, dl):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            outs = flash_attention_hop_plain(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(outs, (q, k, v), (do, dm, dl))
        return dq, dk, dv, None, None, None, None, None


def flash_attention_hop(q, k, v, *, ranks=1, hop=0, causal=True, window=None,
                        scale=None):
    """One ring-attention hop over ``ranks`` stacked ranks folded into the
    batch: q (R·B, Hq, S, D), k, v (R·B, Hkv, Skv, D) -> (o, m, l) in f32
    (see the module docstring)."""
    _check(q, k, v)
    return _Hop.apply(q, k, v, ranks, hop, causal, window, scale)


flash_attention_hop.launches = 0
