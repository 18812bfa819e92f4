"""Grouped (batched-expert) bf16 GEMM — the MoE expert GEMM.

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul`` (the Pallas
``_gmm_kernel``): x (E, C, d) @ w (E, d, f) through a grid (e, c_tile,
f_tile, k_tile) with the expert axis parallel, an f32 VMEM accumulator
carried over the sequential k axis, the output in x's dtype, and the JAX
``ops.grouped_matmul`` padding C, d and f to its 128 tiles.

CUDA route (``csrc/grouped_matmul.cu``, tile in ``csrc/mm_tile.cuh``). One
launch covers every group — on the MoE path every expert of every virtual
rank, ``G = R · E_loc`` — with the group on ``blockIdx.z``; each CTA of
four warps computes a 64×64 output tile with ``mma.sync`` m16n8k16 (bf16
in, f32 accumulate), looping over K in the block as the Pallas grid's
sequential k axis did. Ragged C (1 at decode) and N are masked, never
padded; a group stride of 0 broadcasts x to every group. The output is f32
(what the JAX model's ``_expert_ffn`` einsums give) or bf16 (what the
Pallas kernel and ``ref.grouped_matmul_ref`` give), as the caller asks.
What bounds it on the card: at decode (C = 1) reading every expert's
weights, 2·G·K·N bytes over 3.35 TB/s; at prefill (C = 240) still the
bytes by a little (2·G·C·K·N operations over 989 TFLOP/s are about 0.6 of
that time). This first version keeps one tile in flight per CTA with no
``cp.async``/TMA pipeline and runs every expert even when its capacity is
empty; ``wgmma`` + TMA and skipping empty experts come later.

On a CPU tensor the wrapper runs the plain version (``torch.matmul`` in
f32); on a CUDA tensor it launches the kernel or raises. The wrapper is a
``torch.autograd.Function`` whose backward uses ``torch.matmul`` — the JAX
package has no backward kernel either (XLA transposes the einsum).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """(G, C, K) @ (G, K, N) -> (G, C, N) with an f32 accumulator, out in
    ``out_dtype`` (default x's dtype)."""
    out = torch.matmul(x.float(), w.float())
    return out.to(out_dtype if out_dtype is not None else x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul takes (G, C, K) @ (G, K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def _forward(x: torch.Tensor, w: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("the CUDA grouped_matmul takes bf16 operands")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA grouped_matmul writes f32 or bf16, not "
                         f"{out_dtype}")
    g, c, k = x.shape
    n = w.shape[2]
    if n % 8:
        raise ValueError(f"the CUDA grouped_matmul needs N % 8 == 0, got "
                         f"N = {n}")
    for t in (x, w):
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 \
                or t.data_ptr() % 16:
            raise ValueError("the CUDA grouped_matmul takes row-major "
                             "groups with 16-byte aligned rows")
    out = torch.empty((g, c, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.pk_grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), g, c, n, k,
        x.stride(0), x.stride(1), w.stride(0), w.stride(1),
        out.stride(0), out.stride(1), int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_grouped_matmul_bf16")
    grouped_matmul.launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _forward(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = torch.matmul(dy, w.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.transpose(1, 2), dy) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (G, C, K) @ w (G, K, N) -> (G, C, N) in ``out_dtype`` (default
    x's dtype), f32 accumulation."""
    _check(x, w)
    return _GroupedMatmul.apply(x, w, out_dtype if out_dtype is not None
                                else x.dtype)


grouped_matmul.launches = 0
