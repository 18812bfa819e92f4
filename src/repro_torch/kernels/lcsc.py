"""The LCSC program template (paper §3.2.3) on Hopper, and the ring
all-gather written on it.

Replaces ``repro/kernels/lcsc.py::lcsc_kernel`` and ``::lcsc_ring_all_gather``.
On the TPU the paper's four workers — loader, consumer, storer,
communicator — are issue streams of one core: per ring step the
communicator starts the next remote DMA, the others work while it flies,
and the step closes on the hop's DMA semaphores. The ring all-gather
written on it stages the local shard into its own output slot, then at
step i forwards the shard that arrived i hops ago to the right neighbour.

CUDA route (``csrc/lcsc.cuh``, the template; ``csrc/lcsc.cu``, the
all-gather on it; bulk copies and mbarriers from ``csrc/tma.cuh``). The
ring stays a ring of R - 1 dependent hops: at step i rank d forwards slot
(d - i) mod R, which arrived from its left neighbour at step i - 1, into
the same slot of its right neighbour's output. So, unlike every other
communication kernel of the port, blocks wait on other blocks. The design:

* the work unit is a tile, not a step (``lcsc_plan``): an item is (step i,
  rank d, tile t), a persistent grid walks the items in step-major order,
  and item (i, d, t) waits only on the flag of the item it forwards,
  (i - 1, left of d, t) — never on the whole step. Tile t can be at hop 3
  while tile t + 40 is at hop 1: the hops pipeline, and the chain of R - 1
  dependent hops adds one tile's hop latency a hop, at the tail;
* TMA stages: one thread a block loads each item's tile (``cp.async.bulk``)
  into a ring of shared-memory stages, one mbarrier each, and writes it by
  bulk stores from the stage. Step 0 is the prologue fused with the first
  hop: rank d's tile is loaded once and stored into slot d of its own
  output and of its right neighbour's. The ring moves R (R - 1) blk read
  and R² blk written (at R = 2 the bound's (R + R²) blk); the template it
  replaced, which staged the shard into its own slot and read it back, moved
  2 R² blk. Shapes bulk copies cannot take (a block or an address not a
  multiple of 16 bytes) take the word route, the same walk in words of 1-8
  bytes through registers; the plan names the route and why;
* flags that are never reset: one int an item. ``LcscFlags`` keeps an
  epoch per (device, stream) and passes one more to each launch; an item
  stamps its flag with it (release) once its bulk stores are complete, and
  a waiter spins until ``(int32)(flag - epoch) >= 0`` (acquire). A flag an
  earlier launch stamped, whatever its shape, holds an earlier epoch, so no
  wait is satisfied by a stale stamp; no memset, so a launch is one device
  op. (A count kept per launch shape, as the p2p shift's flags keep, would
  go wrong here: a smaller launch leaves some (step, tile) flags untouched.)
  Every 2^30 launches the wrapper zeroes the flags once, so that the int32
  difference never wraps. The host picks the epoch, so the kernel cannot
  be captured in a CUDA graph (every replay would reuse one epoch, and a
  replay's waits would be met by the one before's stamps: a stale read).
  The wrapper raises under stream capture; an epoch kept on the card and
  advanced by the kernel would lift that;
* memory order across proxies (written once, in the template): a tile is
  written by bulk stores (async proxy), signalled by a flag store (generic
  proxy) and read by another block's TMA load (async proxy). The producer
  waits for its bulk groups to complete (``cp.async.bulk.wait_group``, not
  ``.read``), fences (``fence.proxy.async.global``) and stores the flag
  with release semantics; the waiter fences after its acquire, before its
  load;
* progress: the item waited on always comes earlier in the walk. Loads run
  ahead only for items whose wait has already arrived; a block blocks on a
  wait only at that item's turn, after completing and stamping every item
  of its own before it. So the earliest unstamped item's block always
  moves, and by induction every item is stamped — if every block is
  resident. The launch is cooperative (``cudaLaunchCooperativeKernel``),
  which CUDA refuses rather than run a grid that cannot be co-resident; a
  refusal raises here, with no fallback to the ring kernel of
  ``pk_comm.py``, to a plain copy or to the CPU. A spin past ~2^32 SM
  cycles traps, so a bug fails the launch instead of hanging the card.

The template keeps the TPU form's five slots — prologue, communicator,
loader, consumer, storer — as callables on an item; the all-gather fills
the prologue and the communicator (``csrc/lcsc.cu``). The CPU tests walk
a twin of the device's items over CPU tensors. ``csrc/lcsc_yardstick.cu``
keeps the step-synchronous template and kernel this replaced, as a timing
yardstick no wrapper calls.

A copy is exact, so the result is bit-identical to ``all_gather_plain`` and
to ``pk_comm.ring_all_gather``. What bounds it: bytes; the gather's bound
counts (R + R²) blk, the ring's own floor (R (R - 1) + R²) blk.

Stacked layout (``core/pgl.py``): x (R, *local), rank r's shard at x[r],
-> (R, R, *local), any dtype. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import pgl
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import H100_SMS, sm_count
from repro_torch.kernels.pk_comm import (_check_cuda, all_gather_plain,
                                        copy_cost)
from repro_torch.roofline import counters

#: the TMA route: bytes a tile (one stage), stages, blocks an SM, the
#: smallest tile the plan cuts a small shape into; a block is one warp
#: (``lcsc::kThreads``), whose first thread issues the loads and the stores
LCSC_TILE_BYTES = 32768
LCSC_STAGES = 3
LCSC_PER_SM = 2
LCSC_MIN_TILE_BYTES = 4096
#: the word route: bytes a tile, one-warp blocks an SM
LCSC_WORD_TILE_BYTES = 4096
LCSC_WORD_PER_SM = 8
#: bytes of a stage's ``lcsc::Hop`` and mbarrier (csrc/lcsc.cuh)
_HOP_BYTES = 32
_MBAR_BYTES = 8
#: arrival flags per (device, stream), in ints: one an item; a plan of more
#: items is refused
FLAG_INTS = 1 << 18
#: launches between two zeroings of the flags (the epoch's int32 window)
EPOCH_SPAN = 1 << 30

_FLAGS: dict[tuple, "LcscFlags"] = {}


@dataclasses.dataclass(frozen=True)
class LcscPlan:
    """How the LCSC all-gather walks R ranks' blocks of ``blk_bytes``."""
    route: str          # "tma" (bulk copies through stages) or "word"
    reason: str         # why the word route ("" on the tma route)
    unit: int           # word: the word's bytes, 1-8; tma: 0
    tile_bytes: int
    tiles: int          # tiles a rank's block (the last one short)
    steps: int          # steps walked: max(R - 1, 1)
    items: int          # steps x R x tiles; item k stamps flag k
    grid: int           # persistent blocks, co-resident
    stages: int         # tma: the ring; word: 0
    smem_bytes: int     # dynamic shared memory a block: the .cu's
                        # lcsc::smem, which the launch checks


def lcsc_plan(r: int, blk_bytes: int, elsize: int, addr_bits: int, *,
              sms: int = H100_SMS) -> LcscPlan:
    """The launch of the LCSC all-gather of R blocks of ``blk_bytes`` (of
    ``elsize``-byte elements) on a card of ``sms`` SMs; ``addr_bits``: every
    rank's input and output address or'ed together (only its low four bits
    matter). Bulk copies take a block and addresses that are multiples of
    16 bytes; tiles of ``LCSC_TILE_BYTES``, halved (down to
    ``LCSC_MIN_TILE_BYTES``) while a step's R x tiles items would not give
    every block of the grid (``LCSC_PER_SM`` an SM) one. Other shapes take
    the word route: words of the widest size (8 down to 1 bytes) dividing
    the block and the addresses, tiles of ``LCSC_WORD_TILE_BYTES``. A block
    smaller than a tile is one tile. Raises where the items outnumber
    ``FLAG_INTS``."""
    if not 1 <= r <= 8 or blk_bytes < 0 or elsize < 1 \
            or blk_bytes % elsize:
        raise ValueError(f"lcsc_plan: R={r}, blk_bytes={blk_bytes}, "
                         f"elsize={elsize}")
    steps = max(r - 1, 1)
    low = (blk_bytes | addr_bits) % 16
    why = ("address not 16-byte aligned" if addr_bits % 16 else
           "block not a multiple of 16 bytes" if blk_bytes % 16 else "")
    if why:
        unit = next(u for u in (8, 4, 2, 1) if low % u == 0)
        tile = LCSC_WORD_TILE_BYTES
        per_sm, stages, smem = LCSC_WORD_PER_SM, 0, 0
    else:
        unit, tile = 0, LCSC_TILE_BYTES
        cap = LCSC_PER_SM * sms
        while tile // 2 >= LCSC_MIN_TILE_BYTES \
                and r * -(-blk_bytes // tile) < cap:
            tile //= 2
        per_sm, stages = LCSC_PER_SM, LCSC_STAGES
    tile = max(unit or 16, min(tile, blk_bytes))    # a small block: one tile
    if not why:
        stage = -(-tile // 128) * 128               # TMA's 128-byte stages
        smem = stages * (stage + _MBAR_BYTES + _HOP_BYTES)
    tiles = -(-blk_bytes // tile)
    items = steps * r * tiles
    if items > FLAG_INTS:
        raise ValueError(f"lcsc_plan: {items} items (R={r}, {tiles} tiles "
                         f"of {tile} bytes) exceed the {FLAG_INTS} flags")
    return LcscPlan("word" if why else "tma", why, unit, tile, tiles, steps,
                    items, max(1, min(items, per_sm * sms)), stages, smem)


@functools.lru_cache(maxsize=1024)
def _kept_plan(r, blk_bytes, elsize, addr_bits, sms, constants) -> LcscPlan:
    """``lcsc_plan`` of a launch shape, kept (a plan costs tens of
    microseconds of Python); the plan's constants are part of the key, so
    setting them (the probe's variants) plans anew."""
    return lcsc_plan(r, blk_bytes, elsize, addr_bits, sms=sms)


@dataclasses.dataclass
class LcscFlags:
    """The arrival flags of the LCSC kernels on one stream (``FLAG_INTS``
    int32 on the card, zero at first) and the epoch of the last launch.
    Launch n stamps each of its items' flags with epoch n; an item waits
    until the flag it waits on holds its own launch's epoch or later, as
    int32 arithmetic: ``(int32)(flag - epoch) >= 0``. No launch resets the
    flags; every ``EPOCH_SPAN`` launches ``next_epoch`` zeroes them (one
    memset, on the stream) and starts again at 1, so that no stamp is ever
    2^31 launches old."""
    flags: torch.Tensor
    epoch: int = 0

    def next_epoch(self) -> int:
        """The epoch of the next launch (its stamp and its waits' bar)."""
        if self.epoch == EPOCH_SPAN:
            self.flags.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


def lcsc_flags(device, stream: int) -> LcscFlags:
    """The arrival flags of the LCSC kernels on ``stream``."""
    key = (device, stream)
    if key not in _FLAGS:
        _FLAGS[key] = LcscFlags(torch.zeros((FLAG_INTS,), dtype=torch.int32,
                                            device=device))
    return _FLAGS[key]


def lcsc_ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """x (R, *local) stacked shards -> (R, R, *local): every rank holds
    every shard, in x's dtype, bit for bit."""
    if x.dim() < 1:
        raise ValueError("lcsc_ring_all_gather takes a stacked (R, ...) "
                         "tensor")
    with counters.kernel("lcsc_ring_all_gather",
                         lambda: copy_cost(x, x.shape[0] * x.numel())):
        if x.device.type == "cpu":
            return all_gather_plain(x)
        _check_cuda(x, "lcsc_ring_all_gather")
        if x.device.type == "meta":
            x = x.contiguous()
            out = x.new_empty((x.shape[0], *x.shape))
            counters.launched("lcsc_ring_all_gather", int(out.numel() > 0))
            return out
        return _launch(x)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("lcsc_ring_all_gather cannot be captured in a "
                           "CUDA graph: the epoch its flags wait on is "
                           "chosen on the host at each launch, so every "
                           "replay would reuse one and its waits would be "
                           "met by the last replay's stamps")
    x = x.contiguous()
    r = x.shape[0]
    out = torch.empty((r, *x.shape), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ins, outs = pgl.pointer_table(x), pgl.pointer_table(out)
    bits = 0
    for a in ins + outs:
        bits |= a
    blk = x[0].numel() * x.element_size()
    p = _kept_plan(r, blk, x.element_size(), bits % 16, sm_count(x.device),
                   (LCSC_TILE_BYTES, LCSC_STAGES, LCSC_PER_SM,
                    LCSC_MIN_TILE_BYTES, LCSC_WORD_TILE_BYTES,
                    LCSC_WORD_PER_SM))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flags = lcsc_flags(x.device, stream)
    err = _build.library().pk_lcsc_all_gather(
        _build.host_table(ins), _build.host_table(outs),
        flags.flags.data_ptr(), FLAG_INTS, r, blk, int(p.route == "tma"),
        p.unit, p.tile_bytes, p.grid, p.stages, p.smem_bytes,
        flags.next_epoch(), stream)
    _build.check(err, "pk_lcsc_all_gather")
    lcsc_ring_all_gather.launches += 1
    return out


lcsc_ring_all_gather.launches = 0
