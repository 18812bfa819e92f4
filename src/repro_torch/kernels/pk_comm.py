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

CUDA route (``csrc/pk_comm.cu``, flags and stores from ``csrc/pk.cuh``,
mbarriers and bulk copies from ``csrc/tma.cuh``). Blocks run in parallel
and in no order on Hopper, and a block that spin-waits on one not yet
resident deadlocks, so no kernel here waits on another block:

* all-gather: TMA staged, one read and R stores a tile (``ag_plan``). The
  kernel takes the shards as the view it is given — an FSDP ``dp_view`` is
  strided — through a tensor map carrying its strides, and writes a new
  (R, *gathered) output through a second map, slot s of every rank's
  gathered tensor, contiguous or in the memory order the caller asks
  (``fsdp_gather``: the weight's global layout, which its consumers read
  in place), so neither a copy before the launch nor one of the result
  after it is needed. A persistent grid (two one-warp blocks an
  SM) walks the (source s, tile) items; a tile is one box of about 32 KB.
  Its one working thread TMA-loads a tile into a ring of shared-memory
  stages (an mbarrier each) two items ahead and writes it by R TMA bulk
  tensor stores into slot s of every rank, refilling a stage once its
  stores have read it. Eight warps storing 16-byte words R times from the
  stage ran as fast (``scripts/ag_p2p_probe.py``); the bulk stores need no
  address arithmetic. Shapes a map cannot take (an inner run or a stride
  not a multiple of 16 bytes, an unaligned address, more than three dims
  after merging) run a word kernel over the same strided description: the
  plan names that route and why. A copy is exact, so the result is
  bit-identical for every ``n_chunks``; the TPU's chunks pipeline its R-1
  DMA hops, and the card's one pass needs none, so the plan does not
  depend on them. What bounds it: bytes, R·blk read and R²·blk written.
* reduce-scatter: pull and sum. The TPU ring's running accumulator
  becomes one pass over the partials: a persistent grid (``rs_plan``: two
  blocks an SM, or one block an item where there are fewer) walks the
  (owner o, tile) items, tiles never crossing a chunk. For each item one
  producer thread issues R TMA bulk copies (``cp.async.bulk``) of the tile
  of ``x[s, o]``, s = 0..R-1, into a ring of shared-memory stages (full
  and empty mbarriers); eight consumer warps sum the R tiles in f32 in
  rank order, round once to the output dtype and store 16-byte words into
  ``out[o]``.
  Unlike the TPU ring, which rounds at each hop in ``x.dtype`` and sums
  block b in ring order (rank b-1 first), the sum here is f32 in rank order
  — ``reduce_scatter_plain``'s arithmetic, so the result is bit-identical
  to it and independent of ``n_chunks``. No block waits on another, so a
  launch cannot deadlock; the stream orders it after the writes of its
  sources. The kernel moves R²·blk read and R·blk written, the bytes its
  bound counts: no landing slot, no flag, no second pass
  (``csrc/pk_comm_yardstick.cu`` keeps the store-and-count kernel it
  replaced, as a timing yardstick). Shapes bulk copies
  cannot take (a chunk not a multiple of 16 bytes, an address not 16-byte
  aligned) run an element-wise pull kernel with the same sums. On a
  multi-GPU node the same kernel would read peer pointers from the pointer
  table after a barrier between the cards; that is not built.

* p2p ring shift (one hop of ring attention's KV rotation): the TPU
  kernel waits on a neighbour barrier, then DMAs its whole buffer into the
  right neighbour's output. Here a persistent grid (``p2p_plan``: two
  blocks an SM) walks the (source s, 16 KB tile) items; each block copies
  its tile of rank s's buffer into rank (s + 1) % R's output with four
  16-byte loads in flight a thread, fences and counts the tile in on the
  destination's flag (``pk::signal``, release). No block waits — the
  barrier guards a buffer still being read, and a fresh output needs no
  such guard — so the launch cannot deadlock on one card. The flags are
  never reset (no memset before a launch): each launch adds its tiles,
  and ``P2pFlags`` keeps the count each flag must reach. Any shape and
  dtype: it moves the widest words (16 down to 1 byte) that divide the
  buffer's size and every slab's address. A TMA bulk load and store a
  tile ran 12% faster at the SP path's shape on an H100 SXM at 700 W
  (0.0045 against 0.0051 ms a launch); the words were kept, which need no
  proxy fence before the signal. What
  bounds it: bytes, R·blk read and R·blk written; at ring attention's sizes
  (a few MB) the launch's fixed time dominates.

``n_chunks`` splits a rank's rows into chunks (``fit_chunks``'
largest-divisor fallback, as in JAX); the reduce-scatter's tiles never
cross a chunk. What bounds the three on the card: bytes; none does
arithmetic worth counting. On one card the pointer tables (and the
all-gather's maps) address R slices of one allocation; a multi-GPU node
would feed the reduce-scatter and the shift peer pointers, and the
all-gather one output map a card (not built).

Stacked layout (``core/pgl.py``): ``ring_all_gather`` takes (R, blk, ...)
— rank r's shard at ``x[r]`` — and returns (R, R, blk, ...);
``all_gather_along`` takes (R, *local) in any layout and returns the
contiguous (R, *gathered) along a local dim (the FSDP gather);
``ring_reduce_scatter`` takes (R, R, blk, ...) — rank s's partial for
owner o at ``x[s, o]`` — and returns (R, blk, ...); ``p2p_ring_shift``
takes (R, ...) and returns ``out[(r + 1) % R] = x[r]``. On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernels
or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core import pgl
from repro_torch.core.schedule import fit_chunks
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import H100_SMS, SMEM_LIMIT, sm_count

#: pointer tables are passed to the kernels by value, at most this many ranks
MAX_RANKS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the reduce-scatter's bulk kernel: consumer threads + a producer warp,
#: bytes of R source tiles a stage, stages, blocks an SM (csrc/pk_comm.cu)
RS_THREADS = 256 + 32
RS_STAGE_BYTES = 32768
RS_STAGES = 3
RS_PER_SM = 2
#: the smallest tile a source the plan cuts a small shape into, in bytes
RS_MIN_TILE_BYTES = 2048
#: the element-wise kernel's block, and the most of its blocks an SM
RS_ELEM_THREADS = 256
RS_ELEM_PER_SM = 8
#: the all-gather's TMA route: bytes a tile (one box a stage), stages,
#: blocks an SM, the smallest tile the plan cuts a small shape into, the
#: shortest box row an inner dim is cut into; a block is one warp, whose
#: first thread issues the loads and the stores
AG_STAGE_BYTES = 32768
AG_STAGES = 3
AG_PER_SM = 2
AG_MIN_TILE_BYTES = 4096
AG_MIN_ROW_BYTES = 256
AG_THREADS = 32
#: the word route's block, and the most of its blocks an SM
AG_WORD_THREADS = 256
AG_WORD_PER_SM = 8
#: a tensor map's element (UINT64), its longest box dim, the local dims a
#: map takes (the input map adds the source, the output map the slot and
#: the rank), the dims the word kernel takes
_UNIT = 8
_BOX_MAX = 256
_MAP_DIMS = 3
_WORD_DIMS = 6
#: the p2p kernel: bytes a tile (one flag count), threads (each with four
#: loads in flight), blocks an SM
P2P_TILE_BYTES = 16384
P2P_THREADS = 256
P2P_PER_SM = 2
# p2p arrival flags by (device, stream)
_P2P_FLAGS: dict[tuple, "P2pFlags"] = {}


def all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """(R, blk, ...) -> (R, R, blk, ...): every rank holds every shard."""
    return x.unsqueeze(0).expand(x.shape[0], *x.shape).contiguous()


def gather_along_plain(x: torch.Tensor, axis: int,
                       order=None) -> torch.Tensor:
    """(R, *local) -> (R, *gathered): every rank holds the shards
    concatenated in rank order along local dim ``axis``; contiguous, or
    laid out as ``gathered_empty`` lays it out for ``order``."""
    full = torch.cat(list(x.unbind(0)), dim=axis)
    full = full.unsqueeze(0).expand(x.shape[0], *full.shape)
    return full.contiguous() if order is None else \
        gathered_empty(x, axis, order).copy_(full)


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


def gathered_empty(x: torch.Tensor, axis: int, order) -> torch.Tensor:
    """A new (R, *gathered) tensor for the gather of x along local dim
    ``axis``: contiguous, or with its local dims laid out in memory in
    ``order`` (outermost first) under the rank dim."""
    r = x.shape[0]
    gathered = list(x.shape[1:])
    gathered[axis] *= r
    if order is None:
        return x.new_empty((r, *gathered))
    if sorted(order) != list(range(len(gathered))):
        raise ValueError(f"order {order} is not a permutation of the "
                         f"{len(gathered)} local dims")
    perm = [0] + [1 + i for i in order]
    base = x.new_empty([r] + [gathered[i] for i in order])
    return base.permute([perm.index(i) for i in range(len(perm))])


def _launch_all_gather(x: torch.Tensor, out: torch.Tensor,
                       axis: int) -> torch.Tensor:
    """Launch the all-gather kernel at ``ag_plan``'s launch: x (R, *local)
    and a new ``out`` (R, *gathered) along local dim ``axis``, any strides
    each."""
    _check_cuda(x, "ring_all_gather")
    r = x.shape[0]
    if out.numel() == 0:
        return out
    p = _kept_ag_plan(r, tuple(x.shape[1:]), tuple(x.stride()[1:]),
                      x.stride(0), axis, x.element_size(), x.data_ptr() % 16,
                      tuple(out.stride()), sm_count(x.device),
                      (AG_STAGE_BYTES, AG_STAGES, AG_PER_SM,
                       AG_MIN_TILE_BYTES, AG_MIN_ROW_BYTES))
    nd = len(p.dims)
    ext, ist, ost = zip(*p.dims)
    err = _build.library().pk_all_gather(
        x.data_ptr(), out.data_ptr(), r, int(p.route == "tma"), p.unit, nd,
        (ctypes.c_int64 * nd)(*ext), (ctypes.c_int64 * nd)(*ist),
        (ctypes.c_int64 * nd)(*ost), p.src_stride, p.slot_stride,
        p.rank_stride, (ctypes.c_int * 3)(*(p.box or (0, 0, 0))), p.grid,
        p.stages, p.smem_bytes, torch.cuda.current_stream(x.device)
        .cuda_stream)
    _build.check(err, "pk_all_gather")
    ring_all_gather.launches += 1
    return out


@functools.lru_cache(maxsize=1024)
def _kept_ag_plan(r, local, strides, src_stride, axis, elsize, addr,
                  out_strides, sms, constants) -> "AgPlan":
    """``ag_plan`` of a launch, kept: a training step gathers a few shapes
    hundreds of times, and a plan costs tens of microseconds of host time.
    Only the address modulo 16 matters to a plan; the plan's constants are
    part of the key, so setting them (the probe's variants) plans anew."""
    return ag_plan(r, local, strides, src_stride, axis, elsize, addr=addr,
                   out_strides=out_strides, sms=sms)


def all_gather_along(x: torch.Tensor, axis: int, *,
                     order=None) -> torch.Tensor:
    """x (R, *local) stacked shards, any strides -> (R, *gathered), a new
    tensor: every rank's copy of the shards concatenated in rank order
    along local dim ``axis`` (the FSDP weight gather), contiguous, or with
    the local dims laid out in memory in ``order`` (outermost first: the
    layout its consumer reads). The kernel reads x's view as it is and
    writes that layout: no copy before or after it."""
    if x.dim() < 2 or not 0 <= axis < x.dim() - 1:
        raise ValueError(f"all_gather_along takes a stacked (R, *local) "
                         f"tensor and a local dim, got {tuple(x.shape)}, "
                         f"axis {axis}")
    if x.device.type == "cpu":
        return gather_along_plain(x, axis, order)
    return _launch_all_gather(x, gathered_empty(x, axis, order), axis)


def ring_all_gather(x: torch.Tensor, *, n_chunks: int = 1) -> torch.Tensor:
    """x (R, blk, ...) stacked shards -> (R, R, blk, ...), in x's dtype. A
    copy: the result is the same for every ``n_chunks``, and the kernel's
    tiling does not depend on it (``ag_plan``)."""
    if x.dim() < 1:
        raise ValueError("ring_all_gather takes a stacked (R, ...) tensor")
    rows = x.shape[1] if x.dim() > 1 else 1
    _chunks(rows, n_chunks)
    if x.device.type == "cpu":
        return all_gather_plain(x)
    flat = x.unsqueeze(1) if x.dim() == 1 else x
    out = _launch_all_gather(flat, gathered_empty(flat, 0, None), 0)
    return out.view(x.shape[0], *x.shape) if x.dim() > 1 else \
        out.view(x.shape[0], x.shape[0])


ring_all_gather.launches = 0


@dataclasses.dataclass(frozen=True)
class AgPlan:
    """How the all-gather kernel copies R sources' shards into the gathered
    layout. ``dims``: the copy's dims, inner first, after merging the dims
    that are contiguous in both the input and the output, each (extent in
    units, input stride, output stride), strides in bytes; source s adds
    ``s * src_stride`` bytes to the input and ``s * slot_stride`` to a
    rank's output, rank d ``d * rank_stride`` to the output."""
    route: str          # "tma" (the staged kernel) or "word"
    reason: str         # why the word route ("" on the tma route)
    unit: int           # bytes: a map element (8) or a word (1-16)
    dims: tuple         # ((extent, in stride, out stride), ...)
    src_stride: int
    slot_stride: int
    rank_stride: int
    box: tuple          # tma: a tile's extent a dim; word: ()
    tiles: int          # tma: tiles a source; word: units a source
    items: int          # (source, tile) items; word: units
    grid: int           # blocks launched (tma: persistent)
    threads: int
    stages: int
    smem_bytes: int     # dynamic shared memory a block: the .cu's ag_smem


def _contiguous_strides(shape) -> list[int]:
    st, acc = [], 1
    for n in reversed(shape):
        st.append(acc)
        acc *= n
    return st[::-1]


def _merged_dims(local, strides, out_strides, elsize) -> list[list[int]]:
    """The copy's dims, inner first by output stride: extents in elements,
    strides in bytes; size-1 dims dropped and each dim merged into the one
    inside it where it continues it in the input and in the output alike.
    The inner dim is made contiguous in both (an element of extent 1 in
    front where it is not)."""
    dims: list[list[int]] = []
    for n, si, so in sorted(zip(local, strides, out_strides),
                            key=lambda d: d[2]):
        if n == 1:
            continue
        si, so = si * elsize, so * elsize
        if dims and dims[-1][1] * dims[-1][0] == si \
                and dims[-1][2] * dims[-1][0] == so:
            dims[-1][0] *= n
        else:
            dims.append([n, si, so])
    if not dims or dims[0][1] != elsize or dims[0][2] != elsize:
        dims.insert(0, [1, elsize, elsize])
    return dims


def ag_plan(r: int, local, strides, src_stride: int, axis: int, elsize: int,
            *, addr: int = 0, out_strides=None,
            sms: int = H100_SMS) -> AgPlan:
    """The launch of an all-gather of R sources of ``local`` shape, source s
    at element ``s * src_stride + sum(i_k * strides[k])`` of an input at
    byte address ``addr``, into a new (R, *gathered) output (``local`` with
    dim ``axis`` R times longer, source s at slot s) at element strides
    ``out_strides`` (rank dim first; default contiguous), on a card of
    ``sms`` SMs. The dims are walked inner first by their output stride.

    The TMA route copies 8-byte units through two tensor maps, so it takes
    an inner dim contiguous in both layouts and a multiple of 16 bytes,
    every other stride a multiple of 16 bytes (below 2^40) and a 16-byte
    aligned address; at most three dims (the output map adds the slot and
    the rank: five). An inner dim longer than a box row (256 units) is
    tiled by its largest even divisor up to 256 (256 where that is shorter
    than ``AG_MIN_ROW_BYTES``), and cut in two where a dim is left, so that
    a box can span several of its rows. A tile is one box of about
    ``AG_STAGE_BYTES``, filled inner dim first, halved (down to
    ``AG_MIN_TILE_BYTES``) while the items would not give every block of
    the grid (``AG_PER_SM`` an SM) one. Every other shape takes the word
    route, whose word is the widest (16 down to 1 bytes) that divides every
    extent, stride and the address; ``reason`` says why."""
    local = tuple(int(n) for n in local)
    if r < 1 or not 0 <= axis < len(local) or len(strides) != len(local):
        raise ValueError(f"ag_plan: R={r}, local {local}, axis {axis}")
    gathered = list(local)
    gathered[axis] *= r
    out_strides = tuple(out_strides or _contiguous_strides([r, *gathered]))
    ostr = out_strides[1:]
    slot = local[axis] * ostr[axis] * elsize
    rank = out_strides[0] * elsize
    src = src_stride * elsize
    dims = _merged_dims(local, strides, ostr, elsize)
    inner = dims[0][0] * elsize                     # bytes, contiguous
    outer = [d for dim in dims[1:] for d in dim[1:]] + [src, slot, rank]
    why = ""
    if addr % 16:
        why = "address not 16-byte aligned"
    elif inner % 16:
        why = "inner run not a multiple of 16 bytes"
    elif any(st % 16 or st >= 1 << 40 for st in outer):
        why = "a stride not a multiple of 16 bytes"
    elif any(n >= 1 << 32 for n, _, _ in dims):
        why = "an extent of 2^32 or more"
    else:
        units = row = inner // _UNIT
        tma = [[units, _UNIT, _UNIT]] + dims[1:]
        if units > _BOX_MAX:
            w = max(d for d in range(2, _BOX_MAX + 1, 2) if units % d == 0)
            row = w if w * _UNIT >= AG_MIN_ROW_BYTES else _BOX_MAX
            if row == w and len(tma) < _MAP_DIMS:
                tma[:1] = [[w, _UNIT, _UNIT],
                           [units // w, w * _UNIT, w * _UNIT]]
        if len(tma) > _MAP_DIMS:
            why = f"{len(tma)} dims: a map takes {_MAP_DIMS}"
    if why:
        return _ag_word_plan(r, dims, elsize, src, slot, rank, addr, why,
                             sms)
    while len(tma) < _MAP_DIMS:         # extent-1 dims, strides continuing
        n, si, so = tma[-1]
        tma.append([1, si * n, so * n])
    box = _ag_box(r, tma, row, AG_PER_SM * sms)
    tiles = math.prod(-(-n // b) for (n, _, _), b in zip(tma, box))
    stage_bytes = -(-_UNIT * math.prod(box) // 128) * 128   # TMA alignment
    return AgPlan("tma", "", _UNIT, tuple(map(tuple, tma)), src, slot, rank,
                  tuple(box), tiles, r * tiles,
                  max(1, min(r * tiles, AG_PER_SM * sms)), AG_THREADS,
                  AG_STAGES, AG_STAGES * stage_bytes + AG_STAGES * 8)


def _ag_box(r: int, dims, row: int, cap: int) -> list[int]:
    """A tile: the inner dim's extent up to a box row of ``row`` units,
    then each outer dim up to about ``AG_STAGE_BYTES``; halved, outer dims
    first, while R sources' tiles are fewer than ``cap`` blocks and the
    tile stays at least ``AG_MIN_TILE_BYTES``."""
    box = [min(dims[0][0], row)]
    left = max(1, AG_STAGE_BYTES // (_UNIT * box[0]))
    for n, _, _ in dims[1:]:
        b = max(1, min(n, _BOX_MAX, left))
        box.append(b)
        left = left // b if b == n else 1

    def items(bx):
        return r * math.prod(-(-n // b) for (n, _, _), b in zip(dims, bx))
    while items(box) < cap and _UNIT * math.prod(box) // 2 \
            >= AG_MIN_TILE_BYTES:
        k = next((k for k in range(len(box) - 1, 0, -1) if box[k] > 1),
                 0 if box[0] % 4 == 0 else None)
        if k is None:
            break
        box[k] = -(-box[k] // 2) if k else box[k] // 2
    return box


def _ag_word_plan(r, dims, elsize, src, slot, rank, addr, why,
                  sms) -> AgPlan:
    """The word route: every dim in words of the widest size (16 down to 1
    bytes) that divides the inner run, every stride and the address."""
    inner = dims[0][0] * elsize
    g = math.gcd(inner, addr, src, slot, rank,
                 *(st for dim in dims[1:] for st in dim[1:]))
    unit = next(u for u in (16, 8, 4, 2, 1) if g % u == 0)
    words = [[inner // unit, unit, unit]] + [list(d) for d in dims[1:]]
    if len(words) > _WORD_DIMS:
        raise NotImplementedError(f"all-gather of a view of {len(words)} "
                                  f"strided dims: the word kernel takes "
                                  f"{_WORD_DIMS}")
    per_src = math.prod(n for n, _, _ in words)
    grid = max(1, min(-(-r * per_src // AG_WORD_THREADS),
                      AG_WORD_PER_SM * sms))
    return AgPlan("word", why, unit, tuple(map(tuple, words)), src, slot,
                  rank, (), per_src, r * per_src, grid, AG_WORD_THREADS, 0,
                  0)


@dataclasses.dataclass(frozen=True)
class RsPlan:
    """How the reduce-scatter kernel runs R owners' blocks of ``blk``
    elements in chunks of ``chunk``."""
    bulk: bool          # TMA bulk copies (else the element-wise kernel)
    tile: int           # elements a source a stage (0: element-wise)
    tiles_per_chunk: int
    items: int          # (owner, tile) work items; element-wise: outputs
    grid: int           # persistent blocks launched
    threads: int
    stages: int
    smem_bytes: int     # dynamic shared memory a block: the .cu's
                        # rs_smem, which the launch checks


def rs_plan(r: int, blk: int, chunk: int, elsize: int, *, aligned: bool,
            sms: int = H100_SMS) -> RsPlan:
    """The launch of a reduce-scatter of R ranks' (R, blk) partials in
    chunks of ``chunk`` elements of ``elsize`` bytes on a card of ``sms``
    SMs. Bulk copies take 16-byte aligned addresses (``aligned``: every
    rank's input and output) and chunks of a multiple of 16 bytes; a stage
    holds R tiles of about ``RS_STAGE_BYTES`` together, halved (down to
    ``RS_MIN_TILE_BYTES`` a source) while the items would not give every
    block of the grid (``RS_PER_SM`` blocks an SM) one. Item i is owner i
    // (items / R), then chunk and tile; block b takes items b, b + grid,
    ..."""
    if r < 1 or chunk < 1 or blk % chunk:
        raise ValueError(f"rs_plan: R={r}, blk={blk}, chunk={chunk}")
    if not (aligned and chunk * elsize % 16 == 0):
        grid = max(1, min(-(-r * blk // RS_ELEM_THREADS),
                          RS_ELEM_PER_SM * sms))
        return RsPlan(False, 0, 0, r * blk, grid, RS_ELEM_THREADS, 0, 0)
    tile_bytes = RS_STAGE_BYTES // r // 16 * 16
    cap = RS_PER_SM * sms

    def items(tb):
        return r * (blk // chunk) * -(-chunk * elsize // tb)
    while tile_bytes // 2 >= RS_MIN_TILE_BYTES and items(tile_bytes) < cap:
        tile_bytes = tile_bytes // 2 // 16 * 16
    tile = min(tile_bytes // elsize, chunk)
    tile_bytes = tile * elsize
    tpc = -(-chunk // tile)
    n = r * (blk // chunk) * tpc
    return RsPlan(True, tile, tpc, n, max(1, min(n, cap)), RS_THREADS,
                  RS_STAGES, RS_STAGES * r * tile_bytes + 2 * RS_STAGES * 8)


def ring_reduce_scatter(x: torch.Tensor, *,
                        n_chunks: int = 1) -> torch.Tensor:
    """x (R, R, blk, ...) per-owner partials -> (R, blk, ...) reduced, in
    x's dtype (f32 accumulation)."""
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"ring_reduce_scatter takes stacked partials "
                         f"(R, R, ...), got {tuple(x.shape)}")
    rows = x.shape[2] if x.dim() > 2 else 1
    n_chunks = _chunks(rows, n_chunks)
    if x.device.type == "cpu":
        return reduce_scatter_plain(x)
    _check_cuda(x, "ring_reduce_scatter")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA reduce-scatter takes float32 or "
                         f"bfloat16, not {x.dtype}")
    return _reduce_scatter_cuda(x.contiguous(), n_chunks)


def _reduce_scatter_cuda(x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Launch the reduce-scatter kernel on contiguous CUDA partials at
    ``rs_plan``'s launch."""
    r = x.shape[0]
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    blk = x[0, 0].numel()
    ins, outs = pgl.pointer_table(x), pgl.pointer_table(out)
    p = rs_plan(r, blk, blk // n_chunks, x.element_size(),
                aligned=all(a % 16 == 0 for a in ins + outs),
                sms=sm_count(x.device))
    err = _build.library().pk_reduce_scatter(
        _build.host_table(ins), _build.host_table(outs), r, blk,
        blk // n_chunks, _DTYPE_CODE[x.dtype], p.tile, p.grid, p.stages,
        p.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pk_reduce_scatter")
    ring_reduce_scatter.launches += 1
    return out


ring_reduce_scatter.launches = 0


@dataclasses.dataclass(frozen=True)
class P2pPlan:
    """How the p2p kernel moves R ranks' buffers of ``blk`` bytes."""
    tile_bytes: int
    tiles: int          # tiles a rank: what a launch adds to each flag
    grid: int           # persistent blocks launched
    threads: int


def p2p_plan(r: int, blk_bytes: int, *, sms: int = H100_SMS) -> P2pPlan:
    """The launch of one hop of R buffers of ``blk_bytes`` each: tiles of
    ``P2P_TILE_BYTES`` (the last one short), a persistent grid of at most
    ``P2P_PER_SM`` blocks an SM walking the (source, tile) items."""
    tiles = -(-blk_bytes // P2P_TILE_BYTES)
    return P2pPlan(P2P_TILE_BYTES, tiles,
                   max(1, min(r * tiles, P2P_PER_SM * sms)), P2P_THREADS)


@dataclasses.dataclass
class P2pFlags:
    """The arrival flags the p2p kernel counts into on one stream
    (``MAX_RANKS`` int32 on the card) and the count each must have reached
    once the launches so far have run. No launch resets them: one over R
    ranks adds its plan's tiles to flags 0..R-1, and ``advance`` adds them
    to ``expected`` (counts modulo 2^32, as the int32 adds wrap)."""
    flags: torch.Tensor
    expected: list

    def advance(self, r: int, tiles: int) -> None:
        for d in range(r):
            self.expected[d] = (self.expected[d] + tiles) % 2 ** 32

    def counts(self, r: int) -> list[int]:
        """Flags 0..r-1 as they stand, modulo 2^32 (a device read)."""
        return [v % 2 ** 32 for v in self.flags[:r].tolist()]


def p2p_flags(device, stream: int) -> P2pFlags:
    """The arrival flags of the p2p kernel on ``stream``: after the launches
    so far, entry d has counted every tile stored into rank d's output."""
    key = (device, stream)
    if key not in _P2P_FLAGS:
        _P2P_FLAGS[key] = P2pFlags(
            torch.zeros((MAX_RANKS,), dtype=torch.int32, device=device),
            [0] * MAX_RANKS)
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
    r = x.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ins, outs = pgl.pointer_table(x), pgl.pointer_table(out)
    blk_bytes = x[0].numel() * x.element_size()
    p = p2p_plan(r, blk_bytes, sms=sm_count(x.device))
    flags = p2p_flags(x.device, stream)
    err = _build.library().pk_p2p_ring_shift(
        _build.host_table(ins), _build.host_table(outs),
        flags.flags.data_ptr(), r, blk_bytes, p.tile_bytes, p.grid, stream)
    _build.check(err, "pk_p2p_ring_shift")
    flags.advance(r, p.tiles)
    p2p_ring_shift.launches += 1
    return out


p2p_ring_shift.launches = 0
