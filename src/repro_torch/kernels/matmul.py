"""Tiled bf16 GEMM — the local-compute tile of every fused kernel.

Replaces ``repro/kernels/matmul.py::matmul`` (the Pallas ``_mm_kernel``),
which tiles (M, K) @ (K, N) through 128×128×128 VMEM blocks with an f32
accumulator and relies on the JAX ``ops.matmul`` to pad to the tile.

CUDA route (``csrc/matmul.cu``, tile in ``csrc/mm_tile.cuh``). One CTA of
four warps computes a 64×64 output tile with ``mma.sync`` m16n8k16 (bf16
in, f32 accumulate), streaming 64×32 slices of x and 32×64 slices of w
through shared memory; ragged edges are masked, never padded. What bounds
it on the card: at large M the tensor cores (2·M·N·K operations over 989
TFLOP/s); at the serving path's small M (logits of a few tokens) reading w
(2·K·N bytes over 3.35 TB/s). This first version keeps one tile in flight
per CTA and no ``cp.async``/TMA pipeline — it is right and simple, and the
latency of each K step is what it pays for that; ``wgmma`` + TMA come later.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. The wrapper is a ``torch.autograd.Function``:
the kernel (or the plain version) in forward, ``dx = dy @ wᵀ`` and
``dw = xᵀ @ dy`` with ``torch.matmul`` in backward — the JAX package has no
backward kernel for it either (XLA transposes the einsum).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with an f32 accumulator, out in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul takes (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("the CUDA matmul takes bf16 operands")
    for t in (x, w):
        if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError("the CUDA matmul takes row-major operands with "
                             "16-byte aligned rows")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    err = lib.pk_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
        x.stride(0), w.stride(0), out.stride(0),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_matmul_bf16")
    matmul.launches += 1
    return out


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = torch.matmul(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype (f32 accumulation)."""
    _check(x, w)
    return _Matmul.apply(x, w)


matmul.launches = 0
