"""Fused GEMM × collective kernels over the ranks of a PGL — paper Fig. 7-9.

Replace three Pallas kernels of ``repro/kernels/collective_matmul.py``. On
the TPU each walks a ring of R-1 hops on one core, waiting on DMA
semaphores between steps, with each hop split into row sub-chunks:

* ``ag_matmul_fused`` (``_ag_mm_kernel``): all-gather of row shards x
  (m_loc, k) fused with the GEMM against the local w (k, n) -> (R, m_loc,
  n) in x's dtype;
* ``matmul_rs_fused`` (``_mm_rs_kernel`` + ``_rs_ring``): a K-sharded GEMM
  whose partials are reduce-scattered around an accumulate-and-forward ring
  -> this rank's (m/R, n) f32 block;
* ``matmul_ar_fused`` (``_mm_ar_kernel``): the same ring, then an
  all-gather inside the kernel -> (R, m/R, n) f32 on every rank.

CUDA route (``csrc/collective_matmul.cu``, device functions in
``csrc/pk.cuh``). All three run on the Hopper mainloop of
``csrc/hopper_gemm.cuh`` (TMA loads into a ring of mbarrier stages, one
producer thread, consumer warpgroups on ``wgmma``, a persistent grid), with
the regime, tile and grid from ``kernels/matmul.py::plan``. Blocks run in
parallel and in no order on Hopper, and a block that spin-waits on one not
yet resident deadlocks, so no block of these kernels waits:

* AG×GEMM (``plan(..., count_all=True)``): problem (destination rank d, hop
  i) takes the source ``s = (d - i) mod R`` — the shard rank d holds after
  i hops of the right-going ring —, loads x[s]'s row tiles through source
  s's tensor map (on one card the load is the gather; on a multi-GPU node
  the same maps take peer pointers), multiplies them by w[d] and stores
  the tiles into rows ``s·m_loc + ...`` of out[d] in bf16, masked at m_loc
  so that a ragged tile never reaches source s+1's rows. Nothing depends
  on another block, and the tiling does not depend on ``n_chunks``. Bound
  at tinyllama's MLP (x (4, 1024, 2048), w (4, 2048, 2816)): the tensor
  cores, 1.9e11 operations.
* GEMM×RS and GEMM×AR (``plan(..., count_all=True)``): one kernel,
  store-and-count, the CUDA form of the TPU kernels' accumulate-and-forward
  ring:

  1. problem r is source rank r's partial ``x[r] @ w[r]``; its block reads
     only x[r] and w[r] through their tensor maps (so the same kernel takes
     peer pointers on a multi-GPU node), never the other ranks' K;
  2. tiles are taken with r fastest, so the R partials of one output tile
     are computed in the same wave and are read back from L2;
  3. each consumer warp stores its 16 rows (a strip) of the f32 partial
     into ``landing[o][r]`` — owner rank ``o = row // (m/R)``, the
     reduce-scatter destination, per row, since at decode (m/R = 2) one
     tile spans every owner — as ``float2``s (``store_async``: each quad a
     full 32-byte sector), then hands the tile through an mbarrier to the
     three idle warps of the producer warpgroup and goes on to the next
     tile's ``wgmma``;
  4. those "drain" warps add one to each strip's arrival count (``signal``,
     ``atom.add.release.gpu``, cumulative over the consumers' stores);
  5. a strip whose count is R (``wait``, acquire) is reduced in R parts of
     its rows, each claimed by compare-and-swap: source rank r's block
     settles part r of its previous tile's strips, and at the end every
     warp of a block sweeps its tiles for unclaimed parts. A part's R
     partials are read back (once, as last use), summed in rank order and
     stored into out[o] only (RS) or into out[d] for every rank d (AR).

  No block waits for another: an incomplete strip is left to the block
  that completes its count, which sweeps after counting. Spreading the
  parts over the R source blocks matters: "the last arrival reduces" piled
  the work onto whichever blocks ran late and measured slower. Counts,
  claims and landing slots follow the plan's tile (``_scratch``), cached
  per (device, stream, R, m, n, flags), so launches that share them run
  one after another on that stream; the launcher zeroes counts and claims
  on the stream before each launch. The plan depends on (m, n, k, R) alone,
  so RS and AR of one shape run the same tiles and RS's output is AR's
  owner rows bit for bit. Bound: the tensor cores at prefill (the landing
  round trip, R·m·n·4 bytes written and read, comes on top), reading w at
  decode.

The fixed summation order makes every result independent of arrival order.
Row chunking (``n_chunks``) is implicit in the row tiles: it is
validated with ``fit_chunks`` and cannot change the result.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. GEMM×AR is a ``torch.autograd.Function``: the
kernel in forward; in backward the all-reduce's cotangent ``dy = Σ_r g_r``
(every rank's output is the same sum), then ``dx_r = dy @ w_rᵀ`` and
``dw_r = x_rᵀ @ dy`` with ``torch.matmul`` — the JAX package has no
backward kernel for it (XLA transposes the island). AG×GEMM and GEMM×RS are
forward-only, as their Pallas kernels (which have no VJP, ROADMAP C9): a
call that would need a gradient raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import pgl
from repro_torch.core.comms import \
    all_gather_matmul_baseline as ag_matmul_plain
from repro_torch.core.schedule import fit_chunks
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import check_tma_operand, plan, sm_count
from repro_torch.roofline import counters

#: pointer tables are passed to the kernel by value, at most this many ranks
MAX_RANKS = 8

#: rows a consumer warp owns in a tile: the store-and-count epilogue
#: counts arrivals per strip of this many rows (``StoreAndCount`` in
#: csrc/collective_matmul.cu)
STRIP_M = 16

# landing slots + counts and claims, cached by (device, stream, R, m, n,
# flags)
_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _partial_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stacked partials ``x[r] @ w[r]`` in f32, summed over ranks in
    rank order: (m, n)."""
    parts = torch.einsum("rmk,rkn->rmn", x.float(), w.float())
    acc = parts[0]
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r]
    return acc


def matmul_ar_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reduced product broadcast to every rank: (R, m, n) f32."""
    acc = _partial_sum(x, w)
    return acc.unsqueeze(0).expand(x.shape[0], *acc.shape).contiguous()


def matmul_rs_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rank o's row block of the reduced product: (R, m/R, n) f32."""
    return _partial_sum(x, w).view(x.shape[0], -1, w.shape[2])


def _check(x: torch.Tensor, w: torch.Tensor, n_chunks: int, name: str, *,
           scatter: bool = True) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"{name} takes stacked x (R, m, k) and w (R, k, n); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if scatter and x.shape[1] % x.shape[0]:
        raise ValueError(f"m ({x.shape[1]}) must be divisible by the rank "
                         f"count ({x.shape[0]})")
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    rows = x.shape[1] // x.shape[0] if scatter else x.shape[1]
    fit_chunks(rows, n_chunks)       # validated; the tiles chunk implicitly


def _forward_only(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            f"{name} is forward-only: the JAX package's fused kernel has no "
            "gradient either (ROADMAP C9); use backend='bulk' or 'ring' to "
            "differentiate")


def cost(r: int, m: int, n: int, k: int, out_rows: int,
         out_elsize: int, elsize: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of one call over R ranks' (m, k) @ (k, n) products:
    2·R·m·n·k operations; x and w read once, the (R, out_rows, n) output
    written once."""
    return (2 * r * m * n * k,
            elsize * r * (m * k + k * n) + out_elsize * r * out_rows * n)


def _cuda_operands(x: torch.Tensor, w: torch.Tensor, name: str):
    """The checks every launch shares, on the card or on ``meta`` (the
    dry-run describes the card's launch); contiguous operands."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA {name} takes bf16 operands")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"at most {MAX_RANKS} ranks, got {x.shape[0]}")
    if x.shape[2] % 8 or w.shape[2] % 8:
        raise ValueError("k and n must be multiples of 8 (16-byte rows)")
    return x.contiguous(), w.contiguous()


def _scratch(device, stream: int, r: int, m: int, n: int, p):
    """The landing slots, (R, R, m/R, n) f32, and for each 16-row strip of
    the plan's output tiles an arrival count and R part claims."""
    flags = (r + 1) * p.tiles * p.block_m // STRIP_M
    key = (device, stream, r, m, n, flags)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty((r, r, m // r, n), dtype=torch.float32,
                        device=device),
            torch.empty((flags,), dtype=torch.int32, device=device))
    return _SCRATCH[key]


def _reduce(x: torch.Tensor, w: torch.Tensor, gather: bool,
            name: str) -> torch.Tensor:
    """Launch the store-and-count GEMM×RS (``gather`` False: (R, m/R, n))
    or GEMM×AR (True: (R, m, n)) kernel; f32 out. Counts the launch in
    ``matmul_ar_fused.launches`` or ``matmul_rs_fused.launches``; an empty
    or K = 0 call launches nothing and counts nothing."""
    x, w = _cuda_operands(x, w, name)
    r, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((r, m if gather else m // r, n), dtype=torch.float32,
                      device=x.device)
    if x.device.type == "meta":
        counters.launched("matmul_ar_fused" if gather else "matmul_rs_fused",
                          int(out.numel() > 0 and k > 0))
        return out
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    for j in range(r):
        check_tma_operand(x[j], f"{name} x")
        check_tma_operand(w[j], f"{name} w")
    p = plan(m, n, k, r, sms=sm_count(x.device), count_all=True)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    landing, flags = _scratch(x.device, stream, r, m, n, p)
    tables = [_build.host_table(pgl.pointer_table(t))
              for t in (x, w, landing, out)]
    fn = "pk_matmul_ar_bf16" if gather else "pk_matmul_rs_bf16"
    err = getattr(_build.library(), fn)(*tables, flags.data_ptr(),
                                       flags.numel(), r, m, n, k, p.cfg,
                                       p.grid, stream)
    _build.check(err, fn)
    (matmul_ar_fused if gather else matmul_rs_fused).launches += 1
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    r, m, k = x.shape
    with counters.kernel("matmul_ar_fused", lambda: cost(
            r, m, w.shape[2], k, m, 4, x.element_size())):
        if x.device.type == "cpu":
            return matmul_ar_plain(x, w)
        return _reduce(x, w, True, "matmul_ar")


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
    _check(x, w, n_chunks, "matmul_ar")
    return _MatmulAR.apply(x, w)


matmul_ar_fused.launches = 0


def ag_matmul_fused(x: torch.Tensor, w: torch.Tensor, *,
                    n_chunks: int = 1) -> torch.Tensor:
    """x (R, m_loc, k) bf16 row shards, w (R, k, n) bf16 -> (R, R·m_loc, n)
    bf16: rank d's gathered rows times w[d]. Forward-only."""
    _check(x, w, n_chunks, "ag_matmul", scatter=False)
    _forward_only(x, w, "ag_matmul_fused")
    r, m_loc, k = x.shape
    with counters.kernel("ag_matmul_fused", lambda: cost(
            r, r * m_loc, w.shape[2], k, r * m_loc, x.element_size(),
            x.element_size())):
        if x.device.type == "cpu":
            return ag_matmul_plain(x, w)
        return _ag_launch(x, w)


def _ag_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x, w = _cuda_operands(x, w, "ag_matmul")
    r, m_loc, k = x.shape
    n = w.shape[2]
    if x.device.type == "meta":
        counters.launched("ag_matmul_fused", int(r * m_loc * n > 0
                                                 and k > 0))
        return x.new_empty((r, r * m_loc, n))
    for j in range(r):
        check_tma_operand(x[j], "ag_matmul x")
        check_tma_operand(w[j], "ag_matmul w")
    out = torch.empty((r, r * m_loc, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    p = plan(m_loc, n, k, r * r, sms=sm_count(x.device), count_all=True)
    err = _build.library().pk_ag_matmul_bf16(
        *[_build.host_table(pgl.pointer_table(t)) for t in (x, w, out)],
        r, m_loc, n, k, p.cfg, p.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_ag_matmul_bf16")
    ag_matmul_fused.launches += 1
    return out


ag_matmul_fused.launches = 0


def matmul_rs_fused(x: torch.Tensor, w: torch.Tensor, *,
                    n_chunks: int = 1) -> torch.Tensor:
    """x (R, m, k_loc) bf16, w (R, k_loc, n) bf16 -> (R, m/R, n) f32: rank
    o's row block of the product summed over ranks. Forward-only."""
    _check(x, w, n_chunks, "matmul_rs")
    _forward_only(x, w, "matmul_rs_fused")
    r, m, k = x.shape
    with counters.kernel("matmul_rs_fused", lambda: cost(
            r, m, w.shape[2], k, m // r, 4, x.element_size())):
        if x.device.type == "cpu":
            return matmul_rs_plain(x, w)
        return _reduce(x, w, False, "matmul_rs")


matmul_rs_fused.launches = 0
