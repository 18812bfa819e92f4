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
never write S or P to device memory. head_dim must be 64 or 128.

The plain version is the twin of ``ref.flash_attention_ref`` with GQA
grouping — the same function as ``layers._full_attention(causal=True)``.
On a CPU tensor the wrapper runs it; on a CUDA tensor it launches the
kernel or raises. The wrapper is a ``torch.autograd.Function``: the kernel
in forward; in backward the gradient of the plain version, recomputed in
plain torch (f32 scores) from the saved q, k, v. The Pallas kernel has no
backward kernel either — JAX trains through the XLA attention; a
hand-written backward kernel is queued in ROADMAP B7.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


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


def _forward(q, k, v, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("the CUDA flash_attention takes bf16 q, k, v")
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hd not in (64, 128):
        raise ValueError(f"head_dim must be 64 or 128, got {hd}")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention needs a unit head_dim stride "
                             "and 16-byte aligned rows")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((b, hq, sq, hd), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    lib = _build.library()
    err = lib.pk_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window or 0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "pk_flash_attention_bf16")
    flash_attention.launches += 1
    return out


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
