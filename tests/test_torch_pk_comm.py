"""The port's ring all-gather / reduce-scatter against the JAX package.

The plain versions of ``repro_torch/kernels/pk_comm.py`` (what the wrappers
run on CPU tensors) are held against the Pallas kernels themselves,
``repro/kernels/pk_comm.py`` in TPU interpret mode under ``shard_map`` on
the emulated devices, for R in {2, 4} ranks and n_chunks in {1, 2, 3, 4}
(3 does not divide the 4-row shards: ``fit_chunks`` falls back to 2):

* all-gather is a copy: bit-exact against JAX, and bit-identical across
  chunk counts;
* reduce-scatter sums R float32 partials in another order than the TPU
  ring (rank order in f32 against ring order): rtol = atol = 1e-5 against
  JAX, and bit-identical across the port's chunk counts.

Then ``CommContext.all_gather`` / ``reduce_scatter``: bulk == fused on the
CPU, each backend's autograd backward equals the other op, and the JAX
guards and resolution hold.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.kernels import pk_comm as jpk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.kernels import pk_comm as PK  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = (1, 2, 3, 4)
BLK = (4, 24)          # one rank's shard: 4 rows of 24


def _np(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _jax_kernel(fn, r, x, n_chunks):
    """A Pallas ring kernel on an r-device mesh, per-rank inputs x[d]."""
    if not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    mesh = compat.make_mesh((r,), ("x",))
    f = jax.jit(compat.shard_map(
        lambda a: fn(a[0], "x", n_chunks=n_chunks)[None], mesh=mesh,
        in_specs=JP("x"), out_specs=JP("x"), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("r", [2, 4])
def test_all_gather_plain_matches_pallas_kernel(r):
    x = _np(r, *BLK, seed=r)
    first = None
    for nc in CHUNKS:
        got = PK.ring_all_gather(torch.from_numpy(x), n_chunks=nc).numpy()
        assert got.shape == (r, r, *BLK)
        want = _jax_kernel(jpk.ring_all_gather, r, x, nc)
        np.testing.assert_array_equal(got, want)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)


@pytest.mark.parametrize("r", [2, 4])
def test_reduce_scatter_plain_matches_pallas_kernel(r):
    x = _np(r, r, *BLK, seed=10 + r)
    first = None
    for nc in CHUNKS:
        got = PK.ring_reduce_scatter(torch.from_numpy(x),
                                     n_chunks=nc).numpy()
        assert got.shape == (r, *BLK)
        want = _jax_kernel(jpk.ring_reduce_scatter, r, x, nc)
        np.testing.assert_allclose(got, want, **TOL)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)


def test_refs_match_jax():
    x = _np(4, 4, *BLK, seed=3)
    np.testing.assert_array_equal(
        tref.all_gather_ref(torch.from_numpy(x)).numpy(),
        np.asarray(jref.all_gather_ref(x)))
    np.testing.assert_allclose(
        tref.reduce_scatter_ref(torch.from_numpy(x)).numpy(),
        np.asarray(jref.reduce_scatter_ref(x)), **TOL)


# ---------------------------------------------------------------------------
# CommContext.all_gather / reduce_scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_ctx_all_gather_backends_and_autograd(r, axis):
    ctx = CommContext("data", mesh=VirtualMesh((r, 2), ("data", "model")))
    local = [4, 6, 8]
    x = torch.from_numpy(_np(r, *local, seed=axis))
    outs = {be: ctx.all_gather(x, axis=axis, backend=be)
            for be in ("bulk", "fused")}
    want_shape = list(local)
    want_shape[axis] *= r
    assert outs["bulk"].shape == (r, *want_shape)
    np.testing.assert_array_equal(outs["bulk"].numpy(),
                                  outs["fused"].numpy())
    # every rank holds the rank-order concatenation of the shards
    np.testing.assert_array_equal(
        outs["bulk"][r - 1].numpy(),
        np.concatenate(list(x.numpy()), axis=axis))
    # autograd of the gather is the reduce-scatter of the cotangent
    g = torch.from_numpy(_np(r, *want_shape, seed=7))
    for be in ("bulk", "fused"):
        xr = x.clone().requires_grad_(True)
        (ctx.all_gather(xr, axis=axis, backend=be) * g).sum().backward()
        want = ctx.reduce_scatter(g, axis=axis, backend="bulk")
        np.testing.assert_allclose(xr.grad.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("r", [2, 4])
def test_ctx_reduce_scatter_backends_and_autograd(r):
    ctx = CommContext("data", mesh=VirtualMesh((r, 2), ("data", "model")))
    x = torch.from_numpy(_np(r, 4 * r, 6, seed=r))
    bulk = ctx.reduce_scatter(x, backend="bulk")
    fused = ctx.reduce_scatter(x, backend="fused")
    assert bulk.shape == (r, 4, 6)
    np.testing.assert_allclose(bulk.numpy(), fused.numpy(), **TOL)
    np.testing.assert_allclose(
        bulk.numpy(), x.numpy().sum(0).reshape(r, 4, 6), **TOL)
    g = torch.from_numpy(_np(r, 4, 6, seed=5))
    for be in ("bulk", "fused"):
        xr = x.clone().requires_grad_(True)
        (ctx.reduce_scatter(xr, backend=be) * g).sum().backward()
        np.testing.assert_array_equal(
            xr.grad.numpy(), ctx.all_gather(g, backend="bulk").numpy())


def test_ctx_gather_scatter_resolution_and_guards():
    mesh = VirtualMesh((2, 2), ("data", "model"))
    x = torch.ones(2, 4, 6)
    # auto resolves to bulk, as in JAX; a pin naming a backend these ops
    # lack falls back to the policy; a per-call one raises
    for pin in (None, "ring", "fused"):
        ctx = CommContext("data", mesh=mesh, backend=pin)
        assert ctx.all_gather(x).shape == (2, 8, 6)
        assert ctx.reduce_scatter(x).shape == (2, 2, 6)
    with pytest.raises(ValueError, match="has no backend"):
        CommContext("data", mesh=mesh).all_gather(x, backend="ring")
    ctx = CommContext("data", mesh=mesh)
    with pytest.raises(ValueError, match="axis=0 only"):
        ctx.reduce_scatter(x, axis=1, backend="fused")
    with pytest.raises(ValueError, match="divisible"):
        ctx.reduce_scatter(torch.ones(2, 3, 6))
    with pytest.raises(ValueError, match="stacked"):
        ctx.all_gather(torch.ones(3, 4))
    with pytest.raises(NotImplementedError, match="A9"):
        ctx.all_to_all(x)
    # the GEMM collectives take stacked operands over this axis too
    w = torch.ones(2, 6, 4)
    assert ctx.all_gather_matmul(x, w).shape == (2, 8, 4)
    assert ctx.matmul_reduce_scatter(x, w).shape == (2, 2, 4)
    with pytest.raises(ValueError, match="stacked"):
        ctx.all_gather_matmul(torch.ones(3, 4, 6), w)
    # ring_shift is ported (kernel B8): one hop right, dim 0 rolled
    np.testing.assert_array_equal(ctx.ring_shift(x).numpy(),
                                  torch.roll(x, 1, 0).numpy())


def test_fused_wrappers_refuse_other_devices():
    x = torch.ones(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        PK.ring_all_gather(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        PK.ring_reduce_scatter(torch.ones(2, 2, 4, device="meta"))
    with pytest.raises(ValueError, match="n_chunks"):
        PK.ring_all_gather(torch.ones(2, 4), n_chunks=0)



# ---------------------------------------------------------------------------
# rs_plan: the CUDA reduce-scatter's launch, held on the CPU
# ---------------------------------------------------------------------------

#: (R, rows, n): the FSDP shard shapes of the (2, 4) training run, (R_dp,
#: d/2, R_tp, n), and the MLP shard over 4 and 8 ranks
RS_PATH_SHAPES = [(2, 1024, 64), (2, 1024, 512), (2, 1024, 1408),
                  (2, 1024, 8000), (4, 512, 1408), (8, 256, 1408)]
#: what two blocks an SM may take each (233,472 bytes an SM, 1 KB reserved
#: a block)
TWO_A_SM = 233472 // 2 - 1024


def _rs_walk(p, r, chunk):
    """The (owner, first element, elements) of every item the kernel's
    blocks take, block b items b, b + grid, ... (csrc/pk_comm.cu)."""
    per_owner = p.items // r
    out = []
    for b in range(p.grid):
        for i in range(b, p.items, p.grid):
            o, rest = divmod(i, per_owner)
            c, t = divmod(rest, p.tiles_per_chunk)
            begin = c * chunk + t * p.tile
            out.append((o, begin, min(p.tile, (c + 1) * chunk - begin)))
    return out


@pytest.mark.parametrize("r,rows,n", RS_PATH_SHAPES)
@pytest.mark.parametrize("n_chunks", CHUNKS)
@pytest.mark.parametrize("elsize", [2, 4])
def test_rs_plan_covers_every_owner_tile_once(r, rows, n, n_chunks, elsize):
    """Every element of every owner's block is summed by exactly one item;
    no tile crosses a chunk; every bulk copy is 16-byte aligned and a
    multiple of 16 bytes; the ring fits two blocks an SM."""
    blk = rows * 4 * n
    chunk = blk // PK._chunks(rows, n_chunks)
    p = PK.rs_plan(r, blk, chunk, elsize, aligned=True)
    assert p.bulk and p.threads == PK.RS_THREADS
    assert 1 <= p.grid <= PK.RS_PER_SM * PK.H100_SMS
    assert p.smem_bytes <= TWO_A_SM
    assert p.smem_bytes == p.stages * r * p.tile * elsize + 2 * p.stages * 8
    covered = np.zeros((r, blk), np.int8)
    for o, begin, length in _rs_walk(p, r, chunk):
        assert length > 0 and begin // chunk == (begin + length - 1) // chunk
        assert begin * elsize % 16 == 0 and length * elsize % 16 == 0
        covered[o, begin:begin + length] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("r,blk,chunk,elsize,aligned", [
    (2, 140, 70, 2, True),      # 140-byte chunks: not a multiple of 16
    (2, 4096, 4096, 2, False),  # an address off 16 bytes
    (8, 21, 7, 4, True)])
def test_rs_plan_takes_the_element_wise_kernel_where_bulk_copies_cannot(
        r, blk, chunk, elsize, aligned):
    p = PK.rs_plan(r, blk, chunk, elsize, aligned=aligned)
    assert not p.bulk and p.tile == 0 and p.smem_bytes == 0
    assert p.items == r * blk
    assert 1 <= p.grid <= -(-p.items // p.threads)


def test_rs_plan_cuts_small_shapes_for_the_grid_and_caps_the_tile():
    """A block the grid would leave idle halves the tile (down to 2 KB a
    source); a chunk smaller than a tile is one tile."""
    small = PK.rs_plan(2, 1024 * 4 * 64, 1024 * 4 * 64, 2, aligned=True)
    assert small.tile * 2 == PK.RS_MIN_TILE_BYTES
    big = PK.rs_plan(2, 1024 * 4 * 1408, 1024 * 4 * 1408, 2, aligned=True)
    assert big.tile * 2 * 2 == PK.RS_STAGE_BYTES
    assert big.items >= big.grid == PK.RS_PER_SM * PK.H100_SMS
    tiny = PK.rs_plan(3, 288, 288, 2, aligned=True)
    assert (tiny.tile, tiny.tiles_per_chunk, tiny.items) == (288, 1, 3)
    with pytest.raises(ValueError, match="rs_plan"):
        PK.rs_plan(2, 100, 30, 2, aligned=True)


# ---------------------------------------------------------------------------
# ag_plan: the CUDA all-gather's launch, held on the CPU
# ---------------------------------------------------------------------------

from repro_torch.core import pgl  # noqa: E402
from repro_torch.core.comms import all_gather_stacked  # noqa: E402

#: the FSDP-sharded weights of full-width tinyllama-1.1b, tp-stacked over 4
#: ranks as stored, and the stored dim their gather runs along: rows (wq,
#: wk/wv, w1/w3, head) and columns (wo, w2, emb)
FSDP_WEIGHTS = [((4, 2048, 512), 1), ((4, 2048, 64), 1),
                ((4, 2048, 1408), 1), ((4, 2048, 8000), 1),
                ((4, 512, 2048), 2), ((4, 1408, 2048), 2),
                ((4, 8000, 2048), 2)]
#: the memory order fsdp_gather gives each copy: the global weight's. The
#: row-gathered weights are tp-sharded over their columns (the tp rank dim
#: sits between d and n in memory); the others over their rows (contiguous)
FSDP_ORDER = {1: (1, 0, 2), 2: None}


def _fsdp_view(stored, sdim, r, device="meta", dtype=torch.bfloat16):
    """The dp-stacked view an FSDP gather hands the kernel, and its axis."""
    w = torch.empty(stored, dtype=dtype, device=device)
    return pgl.dp_view(w, sdim, r), sdim


def _plan_of(x, axis, addr=0, out=None):
    return PK.ag_plan(x.shape[0], tuple(x.shape[1:]), tuple(x.stride()[1:]),
                      x.stride(0), axis, x.element_size(), addr=addr,
                      out_strides=None if out is None else out.stride())


def _tma_items(p, r):
    """The (source, tile coordinates) of every item the TMA kernel's blocks
    take, block b items b, b + grid, ... (csrc/pk_comm.cu)."""
    t = [-(-n // b) for (n, _, _), b in zip(p.dims, p.box)]
    out = []
    for blk in range(p.grid):
        for i in range(blk, p.items, p.grid):
            s, rest = divmod(i, p.tiles)
            k0, rest = rest % t[0], rest // t[0]
            out.append((s, k0, rest % t[1], rest // t[1]))
    return out, t


@pytest.mark.parametrize("stored,sdim", FSDP_WEIGHTS)
@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("layout", ["contiguous", "fsdp"])
def test_ag_plan_covers_every_source_tile_once(stored, sdim, r, layout):
    """At every FSDP shard shape, rows and columns, over R dp ranks, into a
    contiguous output and into the memory order fsdp_gather gives it: the
    plan takes the TMA route on the strided view itself; its boxes tile
    each dim; the blocks take every (source, tile) exactly once; the ring
    fits two blocks an SM; the maps' strides and rows are 16-byte
    multiples."""
    x, axis = _fsdp_view(stored, sdim, r)
    assert not x.is_contiguous()
    order = FSDP_ORDER[sdim] if layout == "fsdp" else None
    out = PK.gathered_empty(x, sdim, order)
    p = _plan_of(x, sdim, out=out)
    assert p.route == "tma" and p.reason == "" and p.unit == 8
    assert len(p.dims) == len(p.box) == 3
    assert p.smem_bytes <= TWO_A_SM
    box_bytes = 8 * math.prod(p.box)
    stage = -(-box_bytes // 128) * 128          # a TMA box 128-B aligned
    assert p.smem_bytes == p.stages * stage + p.stages * 8
    assert box_bytes <= PK.AG_STAGE_BYTES and p.box[0] % 2 == 0
    assert all(1 <= b <= 256 for b in p.box)
    assert p.dims[0][1:] == (8, 8)
    for st in [s for d in p.dims[1:] for s in d[1:]] + [
            p.src_stride, p.slot_stride, p.rank_stride]:
        assert st % 16 == 0
    assert 1 <= p.grid <= PK.AG_PER_SM * PK.H100_SMS
    # the units of a source: every byte of the shard once
    assert 8 * math.prod(n for n, _, _ in p.dims) == \
        x[0].numel() * x.element_size()
    items, t = _tma_items(p, r)
    for (n, _, _), b, k in zip(p.dims, p.box, t):
        assert (k - 1) * b < n <= k * b
    assert len(items) == len(set(items)) == r * math.prod(t) == p.items


@pytest.mark.parametrize("shape,dtype,make,why", [
    ((2, 5, 3), torch.uint8, None, "inner run"),
    ((2, 3, 5), torch.bfloat16, None, "inner run"),
    ((8, 6, 7), torch.float32, None, "inner run"),
    ((2, 4, 24), torch.bfloat16, None, ""),
    ((2, 8, 2048), torch.float32, None, ""),
    ((2, 4, 24), torch.bfloat16, "offset", "address"),
    ((2, 4, 24), torch.bfloat16, "transpose", "inner run"),
    ((2, 8, 12), torch.bfloat16, "columns", "inner run"),
    ((2, 16, 40), torch.bfloat16, "rows-odd", "stride"),
    ((2, 3, 4, 5, 16), torch.bfloat16, "every-other", "dims"),
])
def test_ag_plan_takes_the_word_route_exactly_where_a_map_cannot_go(
        shape, dtype, make, why):
    """The word route is taken for a misaligned address, an inner run not a
    multiple of 16 bytes, a stride not a multiple of 16 bytes or more dims
    than a map takes — and only then."""
    base = torch.zeros(math.prod(shape) + 64, dtype=dtype)
    x = base[:math.prod(shape)].view(shape)
    axis, addr = 0, 0
    if make == "offset":                   # 8 bytes past an aligned base
        x = base[4:4 + math.prod(shape)].view(shape)
        addr = 8
    elif make == "transpose":
        x = x.transpose(1, 2)
    elif make == "columns":                # a stored (.., 8, 12) bf16 leaf
        x = pgl.dp_view(base[:2 * 8 * 12].view(2, 8, 12), 2, 2)
        axis = 2
    elif make == "rows-odd":               # rows of 40 bf16 (80 bytes)
        x = base[:2 * 16 * 41].view(2, 16, 41)[:, :, :40]
    elif make == "every-other":            # 4 dims no merge joins
        x = base.new_zeros((2, 6, 8, 5, 32))[:, ::2, ::2, :, :16]
    p = _plan_of(x, axis, addr)
    assert (p.route == "word") == bool(why)
    assert why in p.reason
    if p.route == "word":
        assert p.smem_bytes == 0 and p.box == () and p.stages == 0
        assert p.items == x.numel() * x.element_size() // p.unit


def _as_units(t, unit):
    """t's bytes (contiguous storage from t's first element) as a flat
    tensor of ``unit``-byte words, and the byte offset of t in them."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    b = flat.view(torch.uint8)
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64, 16: torch.int64}[unit]
    n = b.numel() // torch.empty(0, dtype=words).element_size()
    return b[:n * torch.empty(0, dtype=words).element_size()].view(words), \
        t.storage_offset() * t.element_size()


def _walk(p, x, out):
    """Run the plan on CPU tensors as the kernel would: the TMA route box by
    box (a box of the input map stored into slot s of every rank's output
    through the output map), the word route word by word."""
    r = x.shape[0]
    step = 16 if p.unit == 16 else p.unit
    xin, off_in = _as_units(x, step)
    xout, off_out = _as_units(out, step)
    es = xin.element_size()
    if p.route == "tma":
        items, t = _tma_items(p, r)
        for s, *ks in items:
            c = [k * b for k, b in zip(ks, p.box)]
            size = [min(b, n - ci) for (n, _, _), b, ci in
                    zip(p.dims, p.box, c)]
            rest = sum(ci * d[1] for ci, d in zip(c[1:], p.dims[1:]))
            src = torch.as_strided(
                xin, size[::-1], [d[1] // es for d in p.dims][::-1],
                (off_in + s * p.src_stride + 8 * c[0] + rest) // es)
            orest = sum(ci * d[2] for ci, d in zip(c[1:], p.dims[1:]))
            for dst in range(r):
                torch.as_strided(
                    xout, size[::-1], [d[2] // es for d in p.dims][::-1],
                    (off_out + dst * p.rank_stride + s * p.slot_stride
                     + 8 * c[0] + orest) // es).copy_(src)
        return
    ext = [n for n, _, _ in p.dims]
    idx = np.indices(ext[::-1]).reshape(len(ext), -1)[::-1]
    io = sum(i * d[1] for i, d in zip(idx, p.dims))
    oo = sum(i * d[2] for i, d in zip(idx, p.dims))
    for s in range(r):
        v = xin[torch.from_numpy((off_in + s * p.src_stride + io) // es)]
        for dst in range(r):
            xout[torch.from_numpy((off_out + dst * p.rank_stride
                                   + s * p.slot_stride + oo) // es)] = v


@pytest.mark.parametrize("stored,sdim", [((4, 64, 32), 1), ((4, 32, 64), 2),
                                         ((4, 256, 96), 1),
                                         ((4, 1408, 24), 1),
                                         ((4, 48, 256), 2)])
@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("order", [None, (1, 0, 2), (2, 1, 0)])
def test_ag_plan_walk_reproduces_the_gathered_layout(stored, sdim, r, order):
    """The TMA route's boxes, walked over CPU tensors from a dp_view into a
    contiguous or a permuted output, write exactly
    ``all_gather_stacked(..., "bulk")``, and through the public layout
    ``all_gather_plain``."""
    w = torch.from_numpy(_np(*stored, seed=r)).to(torch.bfloat16)
    x = pgl.dp_view(w, sdim, r)
    out = PK.gathered_empty(x, sdim, order).fill_(float("nan"))
    p = _plan_of(x, sdim, out=out)
    assert p.route == ("word" if order == (2, 1, 0) else "tma")
    _walk(p, x, out)
    want = all_gather_stacked(x, sdim, "bulk")
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    if order is not None:
        return
    front = x.movedim(1 + sdim, 1).contiguous()
    q = _plan_of(front, 0)
    got = torch.empty((r, r * front.shape[1], *front.shape[2:]),
                      dtype=w.dtype)
    _walk(q, front, got)
    assert torch.equal(got.view(r, *front.shape),
                       PK.all_gather_plain(front))


@pytest.mark.parametrize("shape,dtype", [((2, 5, 3), torch.uint8),
                                         ((4, 3, 5), torch.bfloat16),
                                         ((8, 6, 7), torch.float32)])
def test_ag_plan_word_walk_reproduces_all_gather_plain(shape, dtype):
    x = (torch.from_numpy(_np(*shape)) * 50).to(dtype)
    p = _plan_of(x, 0)
    assert p.route == "word"
    out = torch.zeros((shape[0], shape[0] * shape[1], *shape[2:]),
                      dtype=dtype)
    _walk(p, x, out)
    assert torch.equal(out.view(shape[0], *shape), PK.all_gather_plain(x))


@pytest.mark.parametrize("stored,sdim", [((4, 64, 32), 1), ((4, 32, 64), 2)])
@pytest.mark.parametrize("r", [2, 4])
def test_fused_all_gather_stacked_is_contiguous_and_equals_bulk(stored, sdim,
                                                                 r):
    """Contiguous by default; in fsdp_gather's memory order each copy is the
    global weight, contiguous (the tp rank dim next to the dim tp shards);
    both backends give the same values in the same layout."""
    w = torch.from_numpy(_np(*stored, seed=sdim)).to(torch.bfloat16)
    x = pgl.dp_view(w, sdim, r)
    fused = all_gather_stacked(x, sdim, "fused")
    assert fused.is_contiguous()
    assert torch.equal(fused, all_gather_stacked(x, sdim, "bulk"))
    order = FSDP_ORDER[sdim]
    for be in ("fused", "bulk"):
        got = all_gather_stacked(x, sdim, be, order)
        assert torch.equal(got, fused) and got.stride() == \
            PK.gathered_empty(x, sdim, order).stride()
        if order is not None:          # rank r's copy: the global (d, n)
            assert got[r - 1].transpose(0, 1).reshape(stored[1], -1) \
                .data_ptr() == got[r - 1].data_ptr()


def test_fsdp_gather_lays_each_copy_out_as_the_global_weight():
    """Through fsdp_gather on a (2, 4) mesh: a weight tp-sharded over its
    columns (w1) comes back with the tp rank dim between d and n in memory,
    one over its rows (w2) contiguous; both equal the stored weight."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.template import fsdp_gather
    from repro_torch.models.sharding import ShardingRules
    run = RunConfig(fsdp=True, comm_backend="fused")
    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model")), run)
    for spec_dims, stored, dim in (((16, 32), (4, 16, 8), 0),
                                   ((32, 16), (4, 8, 16), 1)):
        w = torch.from_numpy(_np(*stored))
        spec = rules.w2d(*spec_dims, tp_dim=1 - dim)
        c = fsdp_gather(w, spec, rules, run, dim=dim)
        assert c.shape == (2, *stored) and torch.equal(c[1], w)
        glob = c[0].movedim(0, 1) if dim == 0 else c[0]     # (d_in, R, ..)
        assert glob.is_contiguous() and c.is_contiguous() == (dim == 1)


def test_ag_plan_does_not_depend_on_chunks_and_refuses_bad_arguments():
    """A copy needs no chunking on the card: the public wrapper checks
    n_chunks as before, and its plan is the same whatever the count."""
    x = torch.from_numpy(_np(2, 1024, 4, 64))
    for nc in CHUNKS:
        assert torch.equal(PK.ring_all_gather(x, n_chunks=nc),
                           PK.all_gather_plain(x))
    with pytest.raises(ValueError, match="ag_plan"):
        PK.ag_plan(2, (4, 8), (8, 1), 32, 2, 2)
    with pytest.raises(ValueError, match="local dim"):
        PK.all_gather_along(x, 3)


# ---------------------------------------------------------------------------
# p2p_plan and the monotonic arrival flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,elsize", [((4, 1, 4, 2048, 64), 2),
                                          ((4, 3, 5, 7), 4), ((2, 9), 2),
                                          ((3, 5), 1), ((8, 6, 130), 4)])
def test_p2p_expected_count_advances_by_the_plan_tiles(shape, elsize):
    """Each launch adds the plan's tiles a rank to flags 0..R-1 and to the
    wrapper's expected counts, which wrap as the int32 flags do."""
    r, blk = shape[0], math.prod(shape[1:]) * elsize
    p = PK.p2p_plan(r, blk)
    assert p.tiles == -(-blk // p.tile_bytes) >= 1
    assert 1 <= p.grid <= min(r * p.tiles, PK.P2P_PER_SM * PK.H100_SMS)
    f = PK.P2pFlags(torch.zeros(PK.MAX_RANKS, dtype=torch.int32),
                    [0] * PK.MAX_RANKS)
    for launch in range(1, 4):
        f.advance(r, p.tiles)
        f.flags[:r] += p.tiles          # what the kernel's signals add
        assert f.expected[:r] == [launch * p.tiles] * r
        assert f.counts(r) == f.expected[:r]
    assert f.expected[r:] == [0] * (PK.MAX_RANKS - r)
    f.expected[0] = 2 ** 32 - 1
    f.advance(1, 2)
    assert f.expected[0] == 1


def test_p2p_plan_tiles_the_sp_hop():
    """k of the SP path, 1 MB a rank: 64 tiles of 16 KB, one block each; a
    ragged buffer's last tile is short, and still one count."""
    p = PK.p2p_plan(4, 1 << 20)
    assert (p.tiles, p.grid, p.threads) == (64, 256, PK.P2P_THREADS)
    assert PK.p2p_plan(4, 18).tiles == 1
    assert PK.p2p_plan(4, PK.P2P_TILE_BYTES + 1).tiles == 2
