"""Ring all-gather, ring reduce-scatter and the p2p ring shift over the
ranks of a PGL.

Replace ``repro/kernels/pk_comm.py::ring_all_gather`` (the Pallas
``_ag_kernel``), ``::ring_reduce_scatter`` (``_rs_kernel``) and
``::p2p_ring_shift`` (``_p2p_kernel``). On the TPU
both walk a ring of R-1 hops on one core per chip: the all-gather forwards
each shard to the right neighbour's slot, one DMA semaphore per (hop,
chunk); the reduce-scatter sends a running accumulator to the left
neighbour's double-buffered landing slot, adds its own partial on arrival
(in ``x.dtype``, so the sum rounds at every hop) and acks the slot.

CUDA route (``csrc/pk_comm.cu``, flags and stores from ``csrc/pk.cuh``).
Blocks run in parallel and in no order on Hopper, and a block that
spin-waits on one not yet resident deadlocks, so neither kernel waits:

* all-gather: grid (tile, source rank s); each block reads one tile of
  rank s's shard once and stores it straight into slot s of every rank's
  output through the pointer tables (one-way stores, 16-byte words when
  the rows align). A copy is exact, so the result is bit-identical for
  every ``n_chunks``.
* reduce-scatter: the store-and-count scheme of the GEMM+AR kernel. Each
  (tile, source s, owner o) block stores its partial for owner o into o's
  landing slot s, fences and adds one to the tile's flag
  (``atom.add.release.gpu``); the block that arrives last acquires
  (``ld.acquire.gpu``), sums the R partials in rank order in f32 and rounds
  once to the output dtype. Unlike the TPU ring, which rounds at each hop
  in ``x.dtype`` and sums block b in ring order (rank b-1 first), the sum
  here is f32 in rank order — fixed, so independent of arrival order and of
  ``n_chunks``. The flags are zeroed on the stream before each launch;
  landing slots and flags are scratch cached per (device, stream, R, shard
  size, dtype), so launches that share them run one after another.

* p2p ring shift (one hop of ring attention's KV rotation): the TPU
  kernel waits on a neighbour barrier, then DMAs its whole buffer into the
  right neighbour's output. Here grid (tile, source rank s): each block
  stores one tile of rank s's buffer into rank (s + 1) % R's output slot
  (``pk::store_async``), fences, and counts itself in on the destination's
  flag (``pk::signal``, release). No block waits — the barrier guards a
  buffer still being read, and a fresh output needs no such guard — so the
  launch cannot deadlock on one card; the flags (one int per rank, zeroed
  before each launch) end at the tile count of each rank's buffer. Any
  shape and dtype: it moves the widest words (16 down to 1 byte) that
  divide the buffer's size and every slab's address. What bounds it:
  bytes, R·blk read and R·blk written; at ring attention's sizes (a few
  MB) the launch latency dominates.

``n_chunks`` splits a rank's rows into chunks (``fit_chunks``'
largest-divisor fallback, as in JAX); tiles never cross a chunk. What bounds
both on the card: bytes — the all-gather reads R·blk and writes R²·blk, the
reduce-scatter reads R²·blk and writes R·blk (plus the landing round trip,
R²·blk written and read again); neither does arithmetic worth counting. On
one card the pointer tables hold R slices of one allocation; a multi-GPU
node feeds the same kernels peer pointers.

Stacked layout (``core/pgl.py``): ``ring_all_gather`` takes (R, blk, ...)
— rank r's shard at ``x[r]`` — and returns (R, R, blk, ...);
``ring_reduce_scatter`` takes (R, R, blk, ...) — rank s's partial for
owner o at ``x[s, o]`` — and returns (R, blk, ...); ``p2p_ring_shift``
takes (R, ...) and returns ``out[(r + 1) % R] = x[r]``. On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernels
or raise.
"""

from __future__ import annotations

import torch

from repro_torch.core import pgl
from repro_torch.core.schedule import fit_chunks
from repro_torch.kernels import _build

#: pointer tables are passed to the kernels by value, at most this many ranks
MAX_RANKS = 8
#: vectors one block moves (csrc/pk_comm.cu TILE_VECS)
TILE_VECS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# reduce-scatter landing slots + arrival flags, by (device, stream, R, blk,
# dtype); the flags grow to the most tiles a launch has asked for
_SCRATCH: dict[tuple, list[torch.Tensor]] = {}
# p2p arrival flags (MAX_RANKS ints) by (device, stream)
_P2P_FLAGS: dict[tuple, torch.Tensor] = {}


def all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """(R, blk, ...) -> (R, R, blk, ...): every rank holds every shard."""
    return x.unsqueeze(0).expand(x.shape[0], *x.shape).contiguous()


def reduce_scatter_plain(x: torch.Tensor) -> torch.Tensor:
    """(R, R, blk, ...) -> (R, blk, ...): owner o gets the sum over sources
    s of ``x[s, o]``, in f32 in rank order, rounded once to x's dtype."""
    acc = x[0].float()
    for s in range(1, x.shape[0]):
        acc = acc + x[s].float()
    return acc.to(x.dtype)


def ring_shift_plain(x: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (R, ...): one hop right, ``out[(r + 1) % R] = x[r]``."""
    return torch.roll(x, 1, 0)


def _chunks(rows: int, n_chunks: int) -> int:
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    return fit_chunks(rows, n_chunks) if rows else 1


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"at most {MAX_RANKS} ranks, got {x.shape[0]}")


def ring_all_gather(x: torch.Tensor, *, n_chunks: int = 1) -> torch.Tensor:
    """x (R, blk, ...) stacked shards -> (R, R, blk, ...), in x's dtype."""
    if x.dim() < 1:
        raise ValueError("ring_all_gather takes a stacked (R, ...) tensor")
    r = x.shape[0]
    rows = x.shape[1] if x.dim() > 1 else 1
    n_chunks = _chunks(rows, n_chunks)
    if x.device.type == "cpu":
        return all_gather_plain(x)
    _check_cuda(x, "ring_all_gather")
    x = x.contiguous()
    out = torch.empty((r, *x.shape), dtype=x.dtype, device=x.device)
    blk_bytes = x[0].numel() * x.element_size()
    lib = _build.library()
    err = lib.pk_all_gather(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)), r, blk_bytes,
        blk_bytes // n_chunks,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_all_gather")
    ring_all_gather.launches += 1
    return out


ring_all_gather.launches = 0


def _scratch(device, stream: int, r: int, blk: int, dtype, n_chunks: int):
    key = (device, stream, r, blk, dtype)
    if key not in _SCRATCH:
        _SCRATCH[key] = [torch.empty((r, r, blk), dtype=dtype, device=device),
                         torch.empty((0,), dtype=torch.int32, device=device)]
    tiles = n_chunks * -(-(blk // n_chunks) // TILE_VECS)  # the most it uses
    if _SCRATCH[key][1].numel() < r * tiles:
        _SCRATCH[key][1] = torch.empty((r * tiles,), dtype=torch.int32,
                                       device=device)
    return _SCRATCH[key]


def ring_reduce_scatter(x: torch.Tensor, *,
                        n_chunks: int = 1) -> torch.Tensor:
    """x (R, R, blk, ...) per-owner partials -> (R, blk, ...) reduced, in
    x's dtype (f32 accumulation)."""
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"ring_reduce_scatter takes stacked partials "
                         f"(R, R, ...), got {tuple(x.shape)}")
    r = x.shape[0]
    rows = x.shape[2] if x.dim() > 2 else 1
    n_chunks = _chunks(rows, n_chunks)
    if x.device.type == "cpu":
        return reduce_scatter_plain(x)
    _check_cuda(x, "ring_reduce_scatter")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA reduce-scatter takes float32 or "
                         f"bfloat16, not {x.dtype}")
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    blk = x[0, 0].numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    landing, flags = _scratch(x.device, stream, r, blk, x.dtype, n_chunks)
    lib = _build.library()
    err = lib.pk_reduce_scatter(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)),
        _build.host_table(pgl.pointer_table(landing)), flags.data_ptr(), r,
        blk, blk // n_chunks, _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "pk_reduce_scatter")
    ring_reduce_scatter.launches += 1
    return out


ring_reduce_scatter.launches = 0


def p2p_flags(device, stream: int) -> torch.Tensor:
    """The arrival flags the p2p kernel counts into on ``stream``: after a
    launch over R ranks, entry d holds the number of tiles stored into rank
    d's output."""
    key = (device, stream)
    if key not in _P2P_FLAGS:
        _P2P_FLAGS[key] = torch.zeros((MAX_RANKS,), dtype=torch.int32,
                                      device=device)
    return _P2P_FLAGS[key]


def p2p_ring_shift(x: torch.Tensor) -> torch.Tensor:
    """x (R, ...) stacked buffers -> (R, ...) with ``out[(r + 1) % R] =
    x[r]``: one hop of the right-going ring, any dtype, bit for bit."""
    if x.dim() < 1:
        raise ValueError("p2p_ring_shift takes a stacked (R, ...) tensor")
    if x.device.type == "cpu":
        return ring_shift_plain(x)
    _check_cuda(x, "p2p_ring_shift")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    err = lib.pk_p2p_ring_shift(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)),
        p2p_flags(x.device, stream).data_ptr(), x.shape[0],
        x[0].numel() * x.element_size(), stream)
    _build.check(err, "pk_p2p_ring_shift")
    p2p_ring_shift.launches += 1
    return out


p2p_ring_shift.launches = 0
