"""bf16 GEMM on the Hopper mainloop — the logits and loss GEMM (B1).

Replaces ``repro/kernels/matmul.py::matmul`` (the Pallas ``_mm_kernel``),
which tiles (M, K) @ (K, N) through 128×128×128 VMEM blocks with an f32
accumulator and relies on the JAX ``ops.matmul`` to pad to the tile.

CUDA route (``csrc/matmul.cu`` on the mainloop of ``csrc/hopper_gemm.cuh``;
the design note is there): TMA loads of 128-byte-swizzled tiles into a ring
of shared-memory stages, one producer thread, one or two consumer
warpgroups running ``wgmma``, a persistent grid. Ragged edges come from
TMA's zero fill, never from padding. A row length N that is no multiple
of 8 (whisper's vocab shard a rank, 12967 columns) takes w in rows padded
to 16 bytes, as the head is stored (``pgl.aligned_rows``), and returns a
view of an output whose rows are padded likewise: the epilogue stores the
last chunk whole into the padding. ``plan`` picks one of two regimes
from the shape:

* **compute-bound** (M > 64: prefill and loss logits, 2·M·N·K operations
  over 989 TFLOP/s): 128×256 or 128×192 tiles, two consumer warpgroups, one
  block an SM;
* **bytes-bound** (M <= 64: decode logits, w's bytes over 3.35 TB/s):
  64×64 tiles, one consumer warpgroup, two blocks an SM; K is never split.

The same ``plan`` serves the GEMM×collective kernels of
``kernels/collective_matmul.py`` on that mainloop, AG×GEMM and GEMM×RS /
GEMM×AR, with ``count_all``, and the grouped expert GEMM of
``kernels/grouped_matmul.py``.

``matmul_stacked`` multiplies one x by R stacked vocab shards in one launch
(the serving logits and the loss island had one launch per rank), so that
the decode logits have R times the tiles to spread over the SMs. The
plan's tile depends on (M, N, K) alone, never on R, so the stacked launch
gives the bits of R single launches, and every call the same bits: each
output element is one block's K loop, in order.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise; on a ``meta`` tensor (the dry-run) they return
the launch's output without data and record on the counter
(``roofline/counters.py``) the launches the card would make; ``.launches``
counts only the card's. Every branch gives the counter the kernel's FLOPs
and bytes by :func:`cost`. Both are ``torch.autograd.Function``s: the
kernel (or the plain version) in forward, ``dx = dy @ wᵀ`` and ``dw = xᵀ @
dy`` with ``torch.matmul`` in backward — the JAX package has no backward
kernel for it either (XLA transposes the einsum).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.roofline import counters
from repro_torch.kernels import _build

#: K a stage (``HG_BK`` of csrc/hopper_gemm.cuh): 64 bf16, one 128-byte row
BLOCK_K = 64
#: the launcher's configurations (``hg::launch`` in csrc/hopper_gemm.cuh),
#: by id: block rows and columns, ring stages, resident blocks an SM,
#: threads a block. 0 is the bytes-bound regime, 1 and 2 the compute-bound.
CONFIGS = {
    0: dict(block_m=64, block_n=64, stages=6, per_sm=2, threads=256),
    1: dict(block_m=128, block_n=192, stages=5, per_sm=1, threads=384),
    2: dict(block_m=128, block_n=256, stages=4, per_sm=1, threads=384),
}
#: an H100 SXM's SMs. The plan's tile width counts these whatever the card,
#: so the bits do not depend on it; only the persistent grid is sized for
#: the card's own count.
H100_SMS = 132
#: shared memory one block may take on an H100 (bytes)
SMEM_LIMIT = 232448
#: w slabs (tensor maps) a launch takes (``HG_MAX_MAPS``)
MAX_SLABS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How the kernel runs ``problems`` products of (m, k) @ (k, n)."""
    regime: str                 # "bytes" or "compute"
    cfg: int                    # the launcher's configuration (CONFIGS)
    block_m: int
    block_n: int
    stages: int
    tiles: int                  # output tiles a problem
    blocks: int                 # problems x tiles
    grid: int                   # persistent blocks launched
    threads: int
    smem_bytes: int             # dynamic shared memory a block
    # TMA boxes, innermost first; one group deep (a third dimension of 1)
    # for the grouped GEMM's 3-D maps
    a_box: tuple[int, ...]      # of x: (K, rows)
    b_box: tuple[int, ...]      # of w: (columns, K)


def plan(m: int, n: int, k: int, problems: int = 1, *, sms: int = H100_SMS,
         count_all: bool = False) -> GemmPlan:
    """The configuration and grid for ``problems`` (m, k) @ (k, n) products
    on a card of ``sms`` SMs. M <= 64 is bytes-bound: 64 x 64 tiles.
    Otherwise the tile width (192 or 256) that leaves the fewest columns
    idle over whole waves of 132 blocks, the wider on a tie, counted for one
    problem, so that a stack gives the bits of one launch a problem;
    ``count_all`` counts all problems, for kernels whose problems are parts
    of one output: the AG×GEMM's row slabs, GEMM×RS and GEMM×AR's R rank
    partials. Nothing in it depends on the card beyond the grid, or on how
    a caller chunks the rows."""
    def tiles(cfg):
        c = CONFIGS[cfg]
        return _cdiv(m, c["block_m"]) * _cdiv(n, c["block_n"])

    def cost(cfg):                      # waves x tile width
        waves = _cdiv((problems if count_all else 1) * tiles(cfg), H100_SMS)
        return waves * CONFIGS[cfg]["block_n"]

    regime = "bytes" if m <= 64 else "compute"
    cfg = 0 if regime == "bytes" else min((2, 1), key=cost)
    c = CONFIGS[cfg]
    blocks = problems * tiles(cfg)
    bm, bn = c["block_m"], c["block_n"]
    return GemmPlan(
        regime=regime, cfg=cfg, block_m=bm, block_n=bn, stages=c["stages"],
        tiles=tiles(cfg), blocks=blocks,
        grid=max(1, min(blocks, c["per_sm"] * sms)), threads=c["threads"],
        # the stages, 1 KB of alignment slack, the mbarrier pairs of the
        # stages and of the two hand-off slots (HG_SLOTS)
        smem_bytes=c["stages"] * (bm + bn) * 128 + 1024
        + 16 * (c["stages"] + 2),
        a_box=(BLOCK_K, min(bm, _cdiv(m, 8) * 8)), b_box=(64, BLOCK_K))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_tma_operand(t: torch.Tensor, name: str, *,
                      ragged: bool = False) -> None:
    """TMA reads rows through a tensor map: bf16, unit stride along the row,
    rows and base 16-byte aligned, and (unless ``ragged``) a row length of
    16 bytes. Raises before any launch."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 operands")
    if t.stride(-1) != 1 or t.stride(-2) % 8 or t.data_ptr() % 16 \
            or (t.shape[-1] % 8 and not ragged):
        raise ValueError(f"{name}: the CUDA kernel takes row-major operands "
                         "with 16-byte aligned base, rows and row length, "
                         f"got shape {tuple(t.shape)} strides {t.stride()} "
                         f"at {t.data_ptr():#x}")


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), or (M, K) @ (R, K, N) -> (R, M, N), with
    an f32 accumulator, out in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


#: the stacked form's plain version: the same broadcasting product
matmul_stacked_plain = matmul_plain


def _check(x: torch.Tensor, w: torch.Tensor, stacked: bool) -> None:
    dims = 3 if stacked else 2
    if x.dim() != 2 or w.dim() != dims or x.shape[1] != w.shape[-2]:
        want = "(M, K) @ (R, K, N)" if stacked else "(M, K) @ (K, N)"
        raise ValueError(f"matmul takes {want}, got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def cost(m: int, n: int, k: int, r: int = 1,
         elsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of x (m, k) against ``r`` slabs (k, n): 2·r·m·n·k
    operations; x and the slabs read once, the (r, m, n) output written
    once. The counter (``roofline/counters.py``) takes it on every device."""
    return (2 * r * m * n * k,
            elsize * (m * k + r * k * n + r * m * n))


def launches(m: int, n: int, k: int, r: int) -> int:
    """Launches of one call: one for every ``MAX_SLABS`` slabs (the tensor
    maps a launch takes), none for an empty or K = 0 product."""
    if m == 0 or n == 0 or r == 0 or k == 0:
        return 0
    return _cdiv(r, MAX_SLABS)


def _empty_out(x: torch.Tensor, r: int, m: int, n: int) -> torch.Tensor:
    """The (r, m, n) output, a view of rows padded to 16 bytes."""
    ldo = _cdiv(n, 8) * 8
    return torch.empty((r, m, ldo), dtype=x.dtype, device=x.device)[..., :n]


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel over the slabs of w (R, K, N): out (R, M, N) bf16, a view
    of rows padded to 16 bytes where N is no multiple of 8. More than
    ``MAX_SLABS`` slabs (16 tp ranks) take one launch a ``MAX_SLABS``; the
    plan does not depend on the slab count, so the bits do not either."""
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cpu or cuda, not {x.device}")
    r, k, n = w.shape
    m = x.shape[0]
    check_tma_operand(x, "x")
    for j in range(r):
        check_tma_operand(w[j], "w", ragged=True)
    out = _empty_out(x, r, m, n)
    if m == 0 or n == 0 or r == 0:
        return out
    if k == 0:
        return out.zero_()
    p = plan(m, n, k, min(r, MAX_SLABS), sms=sm_count(x.device))
    for j0 in range(0, r, MAX_SLABS):
        z = min(MAX_SLABS, r - j0)
        err = _build.library().pk_matmul_bf16(
            x.data_ptr(), x.stride(0),
            _build.host_table([w[j].data_ptr() for j in range(j0, j0 + z)]),
            z, w.stride(1),
            _build.host_table([out[j].data_ptr()
                               for j in range(j0, j0 + z)]),
            out.stride(1), m, n, k, p.cfg,
            plan(m, n, k, z, sms=sm_count(x.device)).grid,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "pk_matmul_bf16")
        matmul.launches += 1
    return out


def _meta(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The launch on ``meta`` (the dry-run): the output the card's launch
    returns, no data, and the launches the card would make recorded on
    the counter (``counters.launched``; ``matmul.launches`` counts only the
    card's)."""
    r, k, n = w.shape
    counters.launched("matmul", launches(x.shape[0], n, k, r))
    return _empty_out(x, r, x.shape[0], n)


class _Matmul(torch.autograd.Function):
    """x @ w for w (K, N) or stacked (R, K, N)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        r = 1 if w.dim() == 2 else w.shape[0]
        with counters.kernel("matmul", lambda: cost(
                x.shape[0], w.shape[-1], x.shape[1], r, x.element_size())):
            if x.device.type == "cpu":
                return matmul_plain(x, w)
            run = _meta if x.device.type == "meta" else _launch
            if w.dim() == 2:
                return run(x, w.unsqueeze(0))[0]
            return run(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (torch.matmul(dy, w.t()) if w.dim() == 2
                  else torch.einsum("rmn,rkn->mk", dy, w))
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.t(), dy)
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype (f32 accumulation)."""
    _check(x, w, stacked=False)
    return _Matmul.apply(x, w)


def matmul_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (R, K, N) -> (R, M, N) in x's dtype: x against R
    stacked shards in one launch, slab r equal bit for bit to
    ``matmul(x, w[r])``. Counts in ``matmul.launches``: the same kernel."""
    _check(x, w, stacked=True)
    return _Matmul.apply(x, w)


matmul.launches = 0
