"""Grouped (batched-expert) bf16 GEMM — the MoE expert GEMM (B9).

Replaces ``repro/kernels/grouped_matmul.py::grouped_matmul`` (the Pallas
``_gmm_kernel``): x (E, C, d) @ w (E, d, f) through a grid (e, c_tile,
f_tile, k_tile) with the expert axis parallel, an f32 VMEM accumulator
carried over the sequential k axis, the output in x's dtype, and the JAX
``ops.grouped_matmul`` padding C, d and f to its 128 tiles.

CUDA route (``csrc/grouped_matmul.cu`` on the Hopper mainloop of
``csrc/hopper_gemm.cuh``, its ``kGrouped`` mode; the mainloop's design note
is there): TMA loads of 128-byte-swizzled tiles into a ring of
shared-memory stages, one producer thread, one or two consumer warpgroups
on ``wgmma``, a persistent grid. One launch covers every group — on the MoE
path every expert of every virtual rank, ``G = R · E_loc`` = 64 — and x and
w are one 3-D tensor map each, (K, C, G) and (N, K, G), the group
outermost, boxes one group deep. TMA zero-fills each dimension at its own
edge, so a box at a ragged C or K reads zeros inside its group, never the
next group's rows; nothing is padded. A group stride of 0 (x broadcast to
every group, as the dense MoE oracle passes it) is a map of one group,
read at group 0. The output is f32 (what the JAX model's ``_expert_ffn``
einsums give) or bf16 (what the Pallas kernel and
``ref.grouped_matmul_ref`` give), as the caller asks, stored at its own
group and row strides with the quad-transposed 16-byte stores of B1's
epilogue, streaming (``StoreGrouped``).

What bounds it on an H100 SXM, and what ``plan`` does about it:

* **decode** (C = 1; also C = 60, the 128 bucket's capacity): every
  expert's weights, 2·G·K·N bytes over 3.35 TB/s (0.110 ms at moonshot's
  64 × 2048 × 1408). C <= 64 takes the bytes-bound regime: 64×64 tiles,
  one consumer warpgroup, 6 stages, two blocks an SM, x's box C rounded up
  to 8 rows (7 of 8 rows zero-filled at C = 1); the 64-row ``wgmma`` with
  one real row wastes tensor-core work that does not bound this regime.
  G·⌈N/64⌉ = 1,408 tiles fill the card.
* **prefill** (C = 240, the 512 bucket): still the bytes by a little — w,
  x and the f32 output, 0.155 ms, against 0.090 ms of operations at 989
  TFLOP/s. The compute-bound regime's 128×192 or 128×256 tiles; the row
  tile is the fastest index of the tile order, so the two row tiles of one
  (group, column tile) run side by side and w's tile comes from HBM once.

The tile is chosen for one group (``matmul.plan`` without ``count_all``),
so a group's bits do not depend on how many groups share the launch, nor
on the call: each output element is one block's K loop, in order. Every
expert runs even when its capacity is empty.

On a CPU tensor the wrapper runs the plain version (``torch.matmul`` in
f32); on a CUDA tensor it launches the kernel or raises. The wrapper is a
``torch.autograd.Function`` whose backward uses ``torch.matmul`` — the JAX
package has no backward kernel either (XLA transposes the einsum).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import matmul as MM
from repro_torch.roofline import counters


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """(G, C, K) @ (G, K, N) -> (G, C, N) with an f32 accumulator, out in
    ``out_dtype`` (default x's dtype)."""
    out = torch.matmul(x.float(), w.float())
    return out.to(out_dtype if out_dtype is not None else x.dtype)


def plan(g: int, c: int, n: int, k: int, *,
         sms: int = MM.H100_SMS) -> MM.GemmPlan:
    """The mainloop's plan for ``g`` groups of (c, k) @ (k, n): the regime
    and tile of one group (never counted over the groups), the persistent
    grid over all groups' tiles, and the 3-D TMA boxes, one group deep."""
    p = MM.plan(c, n, k, g, sms=sms)
    return dataclasses.replace(p, a_box=(*p.a_box, 1), b_box=(*p.b_box, 1))


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   out_dtype: torch.dtype) -> None:
    """What the CUDA kernel takes, checked before any launch: bf16 operands
    read through tensor maps (``matmul.check_tma_operand``: unit stride
    along a row, rows, row length and base 16-byte aligned), a group stride
    of 0 or a multiple of 8 elements, and an f32 or bf16 output."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("the CUDA grouped_matmul takes bf16 operands")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA grouped_matmul writes f32 or bf16, not "
                         f"{out_dtype}")
    if w.shape[2] % 8:
        raise ValueError(f"the CUDA grouped_matmul needs N % 8 == 0, got "
                         f"N = {w.shape[2]}")
    for t, name in ((x, "x"), (w, "w")):
        MM.check_tma_operand(t, name)
        if t.stride(0) % 8:
            raise ValueError(f"{name}: the CUDA grouped_matmul takes a group "
                             "stride of 0 or a multiple of 8 elements, got "
                             f"{t.stride(0)}")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul takes (G, C, K) @ (G, K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def _launch(x: torch.Tensor, w: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel over every group: out (G, C, N) in ``out_dtype``."""
    check_operands(x, w, out_dtype)
    g, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((g, c, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    p = plan(g, c, n, k, sms=MM.sm_count(x.device))
    err = _build.library().pk_grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), g, c, n, k,
        x.stride(0), x.stride(1), w.stride(0), w.stride(1),
        out.stride(0), out.stride(1), int(out_dtype == torch.float32),
        p.cfg, p.grid, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_grouped_matmul_bf16")
    grouped_matmul.launches += 1
    return out


def cost(g: int, c: int, n: int, k: int, elsize: int,
         out_elsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: 2·G·C·N·K operations; x and w read
    once, the (G, C, N) output written once."""
    return (2 * g * c * n * k,
            elsize * (g * c * k + g * k * n) + out_elsize * g * c * n)


def _forward(x: torch.Tensor, w: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    g, c, k = x.shape
    with counters.kernel("grouped_matmul", lambda: cost(
            g, c, w.shape[2], k, x.element_size(),
            torch.empty((), dtype=out_dtype).element_size())):
        if x.device.type == "cpu":
            return grouped_matmul_plain(x, w, out_dtype=out_dtype)
        if x.device.type == "meta":
            out = x.new_empty((g, c, w.shape[2]), dtype=out_dtype)
            counters.launched("grouped_matmul", int(out.numel() > 0
                                                    and k > 0))
            return out
        if x.device.type != "cuda":
            raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                             f"{x.device}")
        return _launch(x, w, out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _forward(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        # f32 products of the cotangent as it comes (f32 where the caller
        # asked for an f32 output), each result rounded once to its
        # operand's dtype: JAX's VJP of an einsum with
        # preferred_element_type=f32
        x, w = ctx.saved_tensors
        dy = dy.float()
        dx = torch.matmul(dy, w.float().transpose(1, 2)).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.float().transpose(1, 2), dy).to(w.dtype) \
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
