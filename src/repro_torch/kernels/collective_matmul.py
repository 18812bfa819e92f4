"""Fused GEMM × all-reduce over the ranks of a PGL — paper Fig. 9.

Replaces ``repro/kernels/collective_matmul.py::matmul_ar_fused`` (the
Pallas ``_mm_ar_kernel`` + ``_rs_ring``): a K-sharded GEMM whose partial
products are reduce-scattered around an accumulate-and-forward ring, then
all-gathered inside the same kernel, giving the (n_dev, m/n_dev, n) f32
reduced blocks on every device. The TPU version walks the ring step by step
on one core, waiting on DMA semaphores between steps.

CUDA route (``csrc/collective_matmul.cu``, device functions in
``csrc/pk.cuh`` and ``csrc/mm_tile.cuh``). Blocks run in parallel and in
no order on Hopper, so the ring becomes a store-and-count reduction that no
block ever waits in:

1. grid (n tiles, m tiles, source rank r); the block computes its partial
   tile ``x[r, rows] @ w[r, :, cols]`` in f32 with the ``mm_tile`` GEMM;
2. the tile's rows belong to owner rank ``o = row // (m/R)`` (the
   reduce-scatter destination); the block stores its partial into
   ``landing[o][r]`` — the owner's PGL slot, addressed through the pointer
   table (``store_async``);
3. it fences and adds one to the tile's arrival flag (``signal``,
   ``atom.add.release.gpu``);
4. the block that arrives last (the add returned R-1) acquires (``wait``),
   sums the R partials in rank order and stores the reduced tile into
   ``out[d]`` for every rank d (the all-gather half).

The launcher zeroes the flags on the stream before each launch. Landing
slots and flags are scratch cached per (device, stream, R, m, n): launches
that share them run one after another on that stream, so no two launches
ever count into the same flags at once.

No block spin-waits, so the kernel is correct for any grid size and block
order, and the fixed summation order makes the result independent of
arrival order. Row chunking (``n_chunks``) is implicit in the 64-row
tiles: it is accepted and cannot change the result. What bounds it on the
card: at prefill (m = 2048, n = 2048, k = R·1408) the tensor cores, with
the landing round trip (R·m·n·4 bytes written and read) and the R-fold
output on top; at decode (m = 8) reading w. On one card the pointer tables
hold R slices of one allocation; a multi-GPU node feeds the same kernel
peer pointers.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises. The wrapper is a ``torch.autograd.Function``:
the kernel in forward; in backward the all-reduce's cotangent
``dy = Σ_r g_r`` (every rank's output is the same sum), then
``dx_r = dy @ w_rᵀ`` and ``dw_r = x_rᵀ @ dy`` with ``torch.matmul`` — the
JAX package has no backward kernel for it (XLA transposes the island).
"""

from __future__ import annotations

import torch

from repro_torch.core import pgl
from repro_torch.core.schedule import fit_chunks
from repro_torch.kernels import _build

#: the kernel's output tile (csrc/mm_tile.cuh: MT_BM x MT_BN)
TILE_M = 64
TILE_N = 64
#: pointer tables are passed to the kernel by value, at most this many ranks
MAX_RANKS = 8

# landing slots + arrival flags, cached by (device, stream, R, m, n)
_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def matmul_ar_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stacked partials ``x[r] @ w[r]`` in f32, summed over ranks in rank
    order and broadcast to every rank: (R, m, n) f32."""
    parts = torch.einsum("rmk,rkn->rmn", x.float(), w.float())
    acc = parts[0]
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r]
    return acc.unsqueeze(0).expand_as(parts).contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, n_chunks: int) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"matmul_ar takes stacked x (R, m, k_loc) and w "
                         f"(R, k_loc, n); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[1] % x.shape[0]:
        raise ValueError(f"m ({x.shape[1]}) must be divisible by the rank "
                         f"count ({x.shape[0]})")
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def _scratch(device, stream: int, r: int, m: int, n: int):
    key = (device, stream, r, m, n)
    if key not in _SCRATCH:
        tiles = -(-m // TILE_M) * -(-n // TILE_N)
        _SCRATCH[key] = (
            torch.empty((r, r, m // r, n), dtype=torch.float32,
                        device=device),
            torch.empty((tiles,), dtype=torch.int32, device=device))
    return _SCRATCH[key]


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return matmul_ar_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_ar runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("the CUDA matmul_ar takes bf16 operands")
    r, m, k = x.shape
    n = w.shape[2]
    if r > MAX_RANKS:
        raise ValueError(f"at most {MAX_RANKS} ranks, got {r}")
    if k % 8 or n % 8:
        raise ValueError("k_loc and n must be multiples of 8 (16-byte rows)")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((r, m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    landing, flags = _scratch(x.device, stream, r, m, n)
    tables = [_build.host_table(pgl.pointer_table(t))
              for t in (x, w, landing, out)]
    lib = _build.library()
    err = lib.pk_matmul_ar_bf16(*tables, flags.data_ptr(), r, m, n, k, stream)
    _build.check(err, "pk_matmul_ar_bf16")
    matmul_ar_fused.launches += 1
    return out


class _MatmulAR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dy = g[0].float()
        for r in range(1, g.shape[0]):
            dy = dy + g[r].float()
        dy = dy.to(x.dtype)
        dx = (torch.matmul(dy, w.transpose(1, 2))
              if ctx.needs_input_grad[0] else None)
        dw = (torch.matmul(x.transpose(1, 2), dy)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def matmul_ar_fused(x: torch.Tensor, w: torch.Tensor, *,
                    n_chunks: int = 1) -> torch.Tensor:
    """x (R, m, k_loc) bf16, w (R, k_loc, n) bf16 -> (R, m, n) f32: the
    all-reduced product, identical on every rank."""
    _check(x, w, n_chunks)
    fit_chunks(x.shape[1] // x.shape[0], n_chunks)   # validated, no effect
    return _MatmulAR.apply(x, w)


matmul_ar_fused.launches = 0
