"""The port's ring all-gather on the LCSC template against the JAX package.

``repro_torch/kernels/lcsc.py::lcsc_ring_all_gather`` on CPU tensors runs
its plain version; it is held bit for bit against the Pallas
``repro/kernels/lcsc.py::lcsc_ring_all_gather`` (the template's demo) in TPU
interpret mode under ``shard_map`` on R in {2, 4} emulated devices, and
against the port's ring all-gather of ``pk_comm.py`` (a copy is exact).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.kernels import lcsc as jlcsc  # noqa: E402
from repro_torch.kernels import lcsc as LC  # noqa: E402
from repro_torch.kernels import pk_comm as PK  # noqa: E402


def _pallas(r, x):
    if not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    mesh = compat.make_mesh((r,), ("x",))
    f = jax.jit(compat.shard_map(
        lambda a: jlcsc.lcsc_ring_all_gather(a[0], "x")[None], mesh=mesh,
        in_specs=JP("x"), out_specs=JP("x"), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("shape,dtype", [((8, 16), np.float32),
                                         ((3, 5, 7), np.float32),
                                         ((6, 10), np.int32)])
def test_lcsc_plain_matches_pallas_kernel(r, shape, dtype):
    rng = np.random.default_rng(r)
    x = (rng.standard_normal((r, *shape)) * 100).astype(dtype)
    before = LC.lcsc_ring_all_gather.launches
    got = LC.lcsc_ring_all_gather(torch.from_numpy(x))
    assert got.shape == (r, r, *shape)
    np.testing.assert_array_equal(got.numpy(), _pallas(r, x))
    assert torch.equal(got, PK.ring_all_gather(torch.from_numpy(x)))
    assert LC.lcsc_ring_all_gather.launches == before   # no kernel on cpu


def test_lcsc_refuses_other_devices():
    # meta is the dry-run's device: the card's output, its launch recorded
    # on the counter (``.launches`` counts the card's alone), no data, and
    # the card's rank limit
    from repro_torch.roofline import counters
    n = LC.lcsc_ring_all_gather.launches
    with counters.StepCounter("meta") as c:
        out = LC.lcsc_ring_all_gather(torch.empty(2, 4, device="meta"))
    assert out.shape == (2, 2, 4) and out.is_meta
    assert dict(c.launches) == {"lcsc_ring_all_gather": 1}
    assert LC.lcsc_ring_all_gather.launches == n
    with pytest.raises(ValueError, match="at most"):
        LC.lcsc_ring_all_gather(torch.empty(9, 4, device="meta"))
    with pytest.raises(ValueError, match="stacked"):
        LC.lcsc_ring_all_gather(torch.tensor(1.0))


# ---------------------------------------------------------------------------
# lcsc_plan, the item walk and the epoch flags, held on the CPU
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import math  # noqa: E402

#: (R, local shape, element bytes) of every launch chip_smoke.py and the
#: card's tests make: the ring all-gather's FSDP shard shapes, the MLP shard
#: over 2, 4 and 8 ranks, ragged f32 and byte shapes, the TP run's hand-off
#: gather of the GEMM+RS output (4, 1024, 2048) bf16, and the small shapes
PATH_SHAPES = [(2, (1024, 4, 64), 2), (2, (1024, 4, 512), 2),
               (2, (1024, 4, 1408), 2), (2, (1024, 4, 8000), 2),
               (4, (512, 4, 1408), 2), (8, (256, 4, 1408), 2),
               (8, (3, 5, 7), 4), (4, (1001,), 1), (4, (1024, 2048), 2),
               (2, (4, 24), 2), (4, (3, 5), 2), (8, (6, 7), 4),
               (1, (8, 8), 4), (4, (512, 4, 64), 2), (2, (4096,), 1)]
#: what two blocks an SM may take each (233,472 bytes an SM, 1 KB reserved
#: a block)
TWO_A_SM = 233472 // 2 - 1024


def _blk(shape, elsize):
    return math.prod(shape) * elsize


@dataclasses.dataclass(frozen=True)
class Item:
    """One item of the walk (the device's ``lcsc::item``): the tile's bytes
    [begin, begin + nbytes) of a block; where it comes from — ``("in",
    rank)`` or ``("out", rank, slot)`` — and the (rank, slot) outputs it is
    stored into; the item whose flag it waits on (-1: none)."""
    k: int
    step: int
    rank: int
    tile: int
    begin: int
    nbytes: int
    waits_on: int
    src: tuple
    dsts: tuple


def _items(p, r, blk_bytes):
    """The all-gather's items in walk order, item k at index k: the twin of
    ``lcsc::run``'s walk (``csrc/lcsc.cuh``) and of the workers of
    ``csrc/lcsc.cu``. Block b takes items b, b + grid, ..."""
    out = []
    for k in range(p.items):
        step, rest = divmod(k, r * p.tiles)
        d, t = divmod(rest, p.tiles)
        left, right = (d - 1) % r, (d + 1) % r
        s = (d - step) % r
        src, dsts = ("in", d), []
        if step == 0:                               # the prologue
            dsts.append((d, d))
        if step < r - 1:                            # the communicator
            if step > 0:
                src = ("out", d, s)
            dsts.append((right, s))
        begin = t * p.tile_bytes
        out.append(Item(k, step, d, t, begin,
                        min(p.tile_bytes, blk_bytes - begin),
                        ((step - 1) * r + left) * p.tiles + t if step else -1,
                        src, tuple(dsts)))
    return out


def _arrived(flag, epoch):
    """The device's ``lcsc::arrived``: a flag stamped with ``epoch`` or
    later, as int32 arithmetic."""
    return (int(flag) - epoch) % 2 ** 32 < 2 ** 31


@pytest.mark.parametrize("r,shape,elsize", PATH_SHAPES)
def test_lcsc_plan_at_every_path_shape(r, shape, elsize):
    """The route is TMA exactly where the block is a multiple of 16 bytes;
    tiles cover the block (the last one short, none empty), are multiples
    of the route's unit and stay within the plan's bounds; the items are
    max(R - 1, 1) steps of R x tiles and fit the flags; the grid is
    persistent and the ring fits two blocks an SM."""
    blk = _blk(shape, elsize)
    p = LC.lcsc_plan(r, blk, elsize, 0)
    assert p.route == ("tma" if blk % 16 == 0 else "word")
    assert bool(p.reason) == (p.route == "word")
    granule = p.unit or 16              # the TMA route's bulk granule
    assert p.tile_bytes % granule == 0 and blk % granule == 0
    assert (p.tiles - 1) * p.tile_bytes < blk <= p.tiles * p.tile_bytes
    assert p.steps == max(r - 1, 1)
    assert p.items == p.steps * r * p.tiles <= LC.FLAG_INTS
    if p.route == "tma":
        assert p.unit == 0
        assert p.tile_bytes <= LC.LCSC_TILE_BYTES
        assert p.tile_bytes >= min(blk, LC.LCSC_MIN_TILE_BYTES)
        assert 1 <= p.grid == min(p.items, LC.LCSC_PER_SM * LC.H100_SMS)
        stage = -(-p.tile_bytes // 128) * 128
        assert p.smem_bytes == p.stages * (stage + 8 + 32) <= TWO_A_SM
        assert 2 <= p.stages <= 8
        if r * -(-blk // LC.LCSC_TILE_BYTES) < p.grid:  # a small shape
            assert r * p.tiles >= p.grid or \
                p.tile_bytes in (LC.LCSC_MIN_TILE_BYTES, blk)
    else:
        assert p.unit in (1, 2, 4, 8) and (p.stages, p.smem_bytes) == (0, 0)
        assert 1 <= p.grid == min(p.items, LC.LCSC_WORD_PER_SM * LC.H100_SMS)


def test_lcsc_plan_routes_r1_empty_unaligned_and_refusals():
    """R = 1 walks one step (its prologue); an empty block has no item; an
    address off 16 bytes takes the word route in the widest word it
    allows; a plan of more items than flags, or nonsense, raises."""
    one = LC.lcsc_plan(1, 256, 4, 0)
    assert (one.route, one.steps, one.tiles, one.items, one.grid) == \
        ("tma", 1, 1, 1, 1)
    empty = LC.lcsc_plan(4, 0, 2, 0)
    assert empty.items == 0 and empty.grid == 1
    for addr, unit in ((8, 8), (4, 4), (2, 2), (1, 1), (16, 0), (32, 0)):
        p = LC.lcsc_plan(2, 1 << 20, 2, addr)
        assert p.unit == unit
        assert p.route == ("tma" if unit == 0 else "word")
        if unit:
            assert p.reason == "address not 16-byte aligned"
    assert LC.lcsc_plan(4, 1001, 1, 0).reason == \
        "block not a multiple of 16 bytes"
    with pytest.raises(ValueError, match="exceed"):
        LC.lcsc_plan(8, 1 << 30, 2, 0)
    for bad in ((0, 64, 2, 0), (9, 64, 2, 0), (2, 63, 2, 0), (2, -16, 2, 0)):
        with pytest.raises(ValueError, match="lcsc_plan"):
            LC.lcsc_plan(*bad)


def test_lcsc_small_shapes_cut_tiles_for_the_grid():
    """A shape whose R x tiles would leave blocks idle halves its tiles down
    to the floor; the MLP shards keep the full tile."""
    big = LC.lcsc_plan(2, _blk((1024, 4, 1408), 2), 2, 0)
    assert big.tile_bytes == LC.LCSC_TILE_BYTES and big.grid == 264
    small = LC.lcsc_plan(2, _blk((1024, 4, 64), 2), 2, 0)
    assert small.tile_bytes == LC.LCSC_MIN_TILE_BYTES
    assert (small.tiles, small.items, small.grid) == (128, 256, 256)


def _simulate(p, r, blk, x, out, flags, epoch, order_seed):
    """Run the plan's items over CPU byte tensors as the device's persistent
    blocks would, in rounds: each block tries its next item (block b takes
    items b, b + grid, ...), in an order shuffled each round, and takes it
    only once the flag it waits on holds this launch's epoch (a stale stamp
    does not count). Returns the (rank, slot, tile) writes."""
    items = _items(p, r, blk)
    assert [it.k for it in items] == list(range(p.items))
    queues = [list(range(b, p.items, p.grid)) for b in range(p.grid)]
    rng = np.random.default_rng(order_seed)
    writes = {}
    while any(queues):
        moved = False
        for b in rng.permutation(p.grid):
            if not queues[b]:
                continue
            it = items[queues[b][0]]
            if it.waits_on >= 0:
                assert it.waits_on < it.k        # earlier in the walk
                if not _arrived(flags[it.waits_on], epoch):
                    continue
                # what it forwards is what the item it waited on stored
                assert (it.src[1], it.src[2]) in items[it.waits_on].dsts
                assert items[it.waits_on].tile == it.tile
            lo, hi = it.begin, it.begin + it.nbytes
            src = x[it.src[1]] if it.src[0] == "in" else \
                out[it.src[1], it.src[2]]
            for d, s in it.dsts:
                key = (d, s, it.tile)
                assert key not in writes, f"{key} written twice"
                writes[key] = it.k
                out[d, s, lo:hi] = src[lo:hi]
            flags[it.k] = epoch
            queues[b].pop(0)
            moved = True
        assert moved, "no block could move: the walk deadlocks"
    return writes


@pytest.mark.parametrize("r,shape,elsize", [(2, (96, 40), 2), (3, (50, 16), 4),
                                            (4, (64, 64), 2), (8, (33, 16), 2),
                                            (4, (1001,), 1), (8, (3, 5, 7), 4),
                                            (1, (8, 8), 4), (5, (7,), 2)])
@pytest.mark.parametrize("tile", [None, 256])
def test_lcsc_walk_reproduces_all_gather_plain(r, shape, elsize, tile):
    """The plan's items, walked by the persistent blocks in shuffled order
    over CPU tensors, write every output (rank, slot, tile) exactly once,
    wait only on items earlier in the walk, forward only what the item
    waited on stored, never deadlock, and give all_gather_plain bit for
    bit."""
    dtype = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32}[elsize]
    x = (torch.from_numpy(np.random.default_rng(r).standard_normal(
        (r, *shape))) * 50).to(dtype)
    blk = _blk(shape, elsize)
    consts = {} if tile is None else {"LCSC_TILE_BYTES": tile,
                                      "LCSC_MIN_TILE_BYTES": 64,
                                      "LCSC_WORD_TILE_BYTES": tile}
    old = {k: getattr(LC, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(LC, k, v)
        p = LC.lcsc_plan(r, blk, elsize, 0, sms=4)
    finally:
        for k, v in old.items():
            setattr(LC, k, v)
    xb = x.contiguous().view(torch.uint8).reshape(r, blk)
    out = torch.empty((r, r, blk), dtype=torch.uint8)
    flags = np.zeros(p.items, np.int64)
    for seed in range(2):               # a second launch over stale flags
        out.fill_(0xA5)
        writes = _simulate(p, r, blk, xb, out, flags, seed + 1, seed)
        assert sorted(writes) == [(d, s, t) for d in range(r)
                                  for s in range(r) for t in range(p.tiles)]
        got = out.view(dtype).reshape(r, r, *shape)
        assert torch.equal(got.view(torch.uint8),
                           PK.all_gather_plain(x).view(torch.uint8))


def test_lcsc_epochs_across_shapes_never_take_a_stale_stamp():
    """Launches of different shapes on one stream's flags, R = 8 then R = 2
    then R = 8: at each launch's start no item's wait is satisfied by what
    earlier launches stamped; each launch stamps exactly its own items' flags
    with its epoch; and the zeroing every EPOCH_SPAN launches starts the
    epochs again with no stale stamp."""
    f = LC.LcscFlags(torch.zeros(LC.FLAG_INTS, dtype=torch.int32))
    shapes = [(8, (256, 4, 1408), 2), (2, (1024, 4, 64), 2),
              (8, (256, 4, 1408), 2), (2, (4, 24), 2), (8, (3, 5, 7), 4)]
    for n, (r, shape, elsize) in enumerate(shapes, start=1):
        blk = _blk(shape, elsize)
        p = LC.lcsc_plan(r, blk, elsize, 0)
        before = f.flags.clone()
        epoch = f.next_epoch()
        assert epoch == n
        items = _items(p, r, blk)
        for it in items:
            if it.waits_on >= 0:
                assert not _arrived(f.flags[it.waits_on], epoch)
        for it in items:                # the walk in order: each wait met
            if it.waits_on >= 0:
                assert _arrived(f.flags[it.waits_on], epoch)
            f.flags[it.k] = epoch
        assert (f.flags[:p.items] == epoch).all()
        assert torch.equal(f.flags[p.items:], before[p.items:])
    f.epoch = LC.EPOCH_SPAN             # the last launch of a span
    f.flags[:100] = LC.EPOCH_SPAN
    assert f.next_epoch() == 1 and not f.flags.any()
    assert not _arrived(0, 1) and _arrived(1, 1) and _arrived(2, 1)
    # int32 arithmetic across the wrap: one launch later is later
    assert _arrived(-2 ** 31, 2 ** 31 - 1)
    assert not _arrived(2 ** 31 - 1, -2 ** 31)


def test_lcsc_kept_plan_keys_on_the_constants():
    """The kept plan is the plan of its launch shape and changes with the
    plan's constants."""
    blk = _blk((1024, 4, 1408), 2)
    c = (LC.LCSC_TILE_BYTES, LC.LCSC_STAGES, LC.LCSC_PER_SM,
         LC.LCSC_MIN_TILE_BYTES, LC.LCSC_WORD_TILE_BYTES,
         LC.LCSC_WORD_PER_SM)
    assert LC._kept_plan(2, blk, 2, 0, 132, c) == LC.lcsc_plan(2, blk, 2, 0)
    old = LC.LCSC_TILE_BYTES
    try:
        LC.LCSC_TILE_BYTES = 16384
        q = LC._kept_plan(2, blk, 2, 0, 132, (16384,) + c[1:])
    finally:
        LC.LCSC_TILE_BYTES = old
    assert q.tile_bytes == 16384 and q.tiles == 704
