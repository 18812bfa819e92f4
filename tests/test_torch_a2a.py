"""The port's ``CommContext.all_to_all`` and its kernel's launch plan,
against the JAX package on the CPU.

* bulk and chunked (1-4 chunks) at R = 2 and 4 for the split/concat pairs
  (0, 0), (1, 2), (2, 1) and (2, 3): bit for bit JAX's
  ``CommContext.all_to_all`` (``lax.all_to_all`` and ``pk_all_to_all``) in
  float32 — the op is a copy — and so is its gradient against
  ``jax.grad``; the ``auto`` resolution (the analytic chunk count, fitted to
  a bystander dim) and the fallback of a context-wide pin the op lacks;
* ``a2a_plan``: the device's item walk (``a2a_items``) run over CPU byte
  buffers at every shape ``chip_smoke.py`` launches (Ulysses' q, kv and
  output at 1 and 2 chunks, the MoE dispatch, f32 once) and at small shapes
  with every word size and a row tail — every output byte written exactly
  once, the result ``all_to_all_plain``'s.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.core.schedule import a2a_chunk_axis  # noqa: E402
from repro_torch.kernels import pk_comm as PK  # noqa: E402

torch.set_num_threads(1)

PAIRS = [(0, 0), (1, 2), (2, 1), (2, 3)]


def _local(r):
    """A local payload every pair splits, with a bystander dim that takes
    1-4 chunks for each pair."""
    return (4, 2 * r, 2 * r, 12)


def _x(r, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((r, *_local(r))).astype(np.float32)


def _jax_a2a(x, split_axis, concat_axis, **kw):
    """JAX's all_to_all on each rank's x[r] (stacked in, stacked out)."""
    r = x.shape[0]
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext(axis_name="x", mesh=mesh)
    f = compat.shard_map(
        lambda t: ctx.all_to_all(t[0], split_axis=split_axis,
                                 concat_axis=concat_axis, **kw)[None],
        mesh=mesh, in_specs=(JP("x"),), out_specs=JP("x"), check_vma=False)
    return jax.jit(f)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("split_axis,concat_axis", PAIRS)
@pytest.mark.parametrize("r", [2, 4])
def test_all_to_all_matches_jax_bit_for_bit(r, split_axis, concat_axis,
                                            n_chunks):
    """n_chunks 1 resolves to bulk, 2-4 to chunked (both packages)."""
    x = _x(r, seed=r + n_chunks)
    f = _jax_a2a(x, split_axis, concat_axis, n_chunks=n_chunks)
    want = np.asarray(f(x))
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    with mock.patch.object(PK, "all_to_all", wraps=PK.all_to_all) as kern:
        got = ctx.all_to_all(torch.from_numpy(x), split_axis=split_axis,
                             concat_axis=concat_axis, n_chunks=n_chunks)
    assert kern.call_count == (n_chunks > 1)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("split_axis,concat_axis", PAIRS)
@pytest.mark.parametrize("r", [2, 4])
def test_all_to_all_gradient_matches_jax(r, split_axis, concat_axis,
                                         n_chunks):
    """The transpose: the all-to-all with the axes swapped, same chunks."""
    x = _x(r, seed=3)
    shape = (r, *PK.a2a_local_shape(x.shape[1:], r, split_axis,
                                    concat_axis))
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    f = _jax_a2a(x, split_axis, concat_axis, n_chunks=n_chunks)
    want = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(f(t) * w)))(x))
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    xt = torch.from_numpy(x).requires_grad_(True)
    with mock.patch.object(PK, "all_to_all", wraps=PK.all_to_all) as kern:
        out = ctx.all_to_all(xt, split_axis=split_axis,
                             concat_axis=concat_axis, n_chunks=n_chunks)
        (out * torch.from_numpy(w)).sum().backward()
    if n_chunks > 1:
        assert [c.args[1:] + (c.kwargs["n_chunks"],)
                for c in kern.call_args_list] == [
            (split_axis, concat_axis, 2), (concat_axis, split_axis, 2)]
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_all_to_all_auto_and_pinned_resolution():
    """``auto``: the analytic count (here ``downstream_compute_s`` asks for
    8) fitted to the bystander dim that splits most (12 -> 6), as JAX's
    ``pk_all_to_all`` fits it; a tiny payload alone stays bulk. A pinned
    backend the op lacks falls back to ``auto``; a per-call one raises, an
    unknown pin raises."""
    r = 4
    x = _x(r, seed=9)
    local = x.shape[1:]
    want = jsched.choose_a2a_chunks(
        x[0].nbytes, axis_size=r, downstream_compute_s=1.0,
        hw=jcm.H100_SXM, shape=local, split_axis=1, concat_axis=2)
    assert want == 6 == a2a_chunk_axis(local, 1, 2, 8)[1]
    mesh = VirtualMesh((r,), ("x",))
    f = _jax_a2a(x, 1, 2, downstream_compute_s=1.0)
    ref = np.asarray(f(x))
    for pin in (None, "auto", "fused", "ring"):
        ctx = CommContext("x", mesh=mesh, backend=pin, hw=tcm.H100_SXM)
        with mock.patch.object(PK, "all_to_all",
                               wraps=PK.all_to_all) as kern:
            got = ctx.all_to_all(torch.from_numpy(x), split_axis=1,
                                 concat_axis=2, downstream_compute_s=1.0)
            small = ctx.all_to_all(torch.ones(r, 1, r, 1, 2), split_axis=1,
                                   concat_axis=2)
        assert [c.kwargs["n_chunks"] for c in kern.call_args_list] == [6]
        np.testing.assert_array_equal(got.numpy(), ref)
        assert small.shape == (r, 1, 1, r, 2)
    # a pinned chunked runs at least 2 chunks; none splits -> bulk
    ctx = CommContext("x", mesh=mesh, backend="chunked")
    with mock.patch.object(PK, "all_to_all", wraps=PK.all_to_all) as kern:
        ctx.all_to_all(torch.from_numpy(x), split_axis=1, concat_axis=2)
        ctx.all_to_all(torch.ones(r, r, r), split_axis=0, concat_axis=1)
    assert [c.kwargs["n_chunks"] for c in kern.call_args_list] == [2]
    with pytest.raises(ValueError, match="has no backend 'fused'"):
        CommContext("x", mesh=mesh).all_to_all(
            torch.from_numpy(x), split_axis=1, concat_axis=2,
            backend="fused")
    with pytest.raises(ValueError, match="unknown backend"):
        CommContext("x", mesh=mesh, backend="nccl").all_to_all(
            torch.from_numpy(x), split_axis=1, concat_axis=2)
    with pytest.raises(ValueError, match="not divisible by 4 ranks"):
        CommContext("x", mesh=mesh).all_to_all(
            torch.ones(r, 3, 4), split_axis=0, concat_axis=1)
    with pytest.raises(ValueError, match="stacked tensor with 4 ranks"):
        CommContext("x", mesh=mesh).all_to_all(
            torch.ones(2, 4, 4), split_axis=0, concat_axis=1)


@pytest.mark.parametrize("shape,dtype", [((2, 3, 4), torch.float32),
                                         ((1, 2, 8), torch.bfloat16)])
def test_a2a_chunk_schedule_matches_jax(shape, dtype):
    """The island's auto chunk count: the analytic policy, both specs."""
    for jhw, thw in ((jcm.TPU_V5E, tcm.TPU_V5E),
                     (jcm.H100_SXM, tcm.H100_SXM)):
        for r in (2, 4):
            for scale in (1, 64, 4096):
                local = (shape[0], 4 * r, shape[1] * scale, shape[2] * 8)
                j = JaxCommContext("x", mesh=compat.make_mesh((r,), ("x",)),
                                   hw=jhw).a2a_chunk_schedule(
                    local, 1, 2, dtype_bytes=dtype.itemsize)
                t = CommContext("x", mesh=VirtualMesh((r,), ("x",)),
                                hw=thw).a2a_chunk_schedule(
                    local, 1, 2, dtype_bytes=dtype.itemsize)
                assert (t.n_chunks, t.source) == (j.n_chunks, j.source)


# ---------------------------------------------------------------------------
# the kernel's launch plan, walked on the CPU
# ---------------------------------------------------------------------------

def _walk(x, split_axis, concat_axis, n_chunks):
    """``all_to_all``'s launches with each kernel replaced by its item walk
    over the byte buffers of x and a new output: every (source,
    destination, tile) item copies bytes [lo, hi) of its rows. Returns the
    output, the (start, length) of every byte run written, the plans."""
    r = x.shape[0]
    out = x.new_empty((r, *PK.a2a_local_shape(x.shape[1:], r, split_axis,
                                              concat_axis)))
    src, dst = _bytes(x), _bytes(out)
    base_in = x.untyped_storage().data_ptr()
    base_out = out.untyped_storage().data_ptr()
    starts, lengths, plans = [], [], []
    for xi, oi in PK.a2a_chunks(x, out, split_axis, concat_axis, n_chunks):
        ins = [xi[s].data_ptr() for s in range(r)]
        outs = [oi[d].data_ptr() for d in range(r)]
        addr = 0
        for a in ins + outs:
            addr |= a % 16
        ins = [a - base_in for a in ins]
        outs = [a - base_out for a in outs]
        p = PK.a2a_plan(r, xi.shape[1:], xi.stride()[1:], oi.stride()[1:],
                        split_axis, concat_axis, x.element_size(), addr=addr)
        plans.append(p)
        for s, d, rows, lo, hi in PK.a2a_items(p, r):
            io, oo = PK.a2a_row_offsets(
                p, torch.arange(rows.start, rows.stop))
            i0 = ins[s] + d * p.dst_in + io + lo
            o0 = outs[d] + s * p.src_out + oo + lo
            if len(rows) == 1:
                a, b = int(i0), int(o0)
                dst[b:b + hi - lo] = src[a:a + hi - lo]
            else:
                span = torch.arange(hi - lo)
                dst[(o0[:, None] + span).view(-1)] = \
                    src[(i0[:, None] + span).view(-1)]
            starts.append(o0)
            lengths.append(torch.full_like(o0, hi - lo))
    return out, torch.cat(starts), torch.cat(lengths), plans


def _bytes(t):
    """The bytes of t's whole storage, flat."""
    return torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())


def _check_walk(x, split_axis, concat_axis, n_chunks):
    out, starts, lengths, plans = _walk(x, split_axis, concat_axis, n_chunks)
    order = torch.argsort(starts)
    starts, lengths = starts[order], lengths[order]
    # the runs tile the output: each starts where the one before it ends
    assert int(starts[0]) == 0
    assert torch.equal(starts[1:], starts[:-1] + lengths[:-1])
    assert int(starts[-1] + lengths[-1]) == out.numel() * out.element_size()
    want = PK.all_to_all_plain(x, split_axis, concat_axis)
    assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))
    r = x.shape[0]
    for p in plans:
        assert p.grid <= PK.A2A_PER_SM * 132 and p.items == r * r * p.tiles
        assert p.piece * p.rows_per_tile * p.unit <= PK.A2A_TILE_BYTES \
            or p.rows_per_tile == 1
    return plans


#: chip_smoke.py's all-to-all shapes: Ulysses' q, kv and output at the path
#: width (tinyllama-1.1b on (1, 4), seq 8192), the MoE dispatch at moonshot
#: width (4 ranks x 16 experts, capacity 512), f32 once
CHIP_SHAPES = [((4, 1, 32, 2048, 64), 1, 2, 1, torch.bfloat16),
               ((4, 1, 32, 2048, 64), 1, 2, 2, torch.bfloat16),
               ((4, 1, 8, 8192, 64), 2, 1, 2, torch.bfloat16),
               ((4, 1, 4, 2048, 64), 1, 2, 2, torch.bfloat16),
               ((4, 4, 16, 512, 2048), 0, 0, 1, torch.bfloat16),
               ((4, 1, 32, 2048, 64), 1, 2, 2, torch.float32)]


@pytest.mark.parametrize("shape,split_axis,concat_axis,n_chunks,dtype",
                         CHIP_SHAPES)
def test_a2a_plan_walk_at_chip_shapes(shape, split_axis, concat_axis,
                                      n_chunks, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-2 ** 15, 2 ** 15, shape, dtype=torch.int16,
                      generator=g).view(torch.bfloat16)
    if dtype == torch.float32:
        x = x.float()
    plans = _check_walk(x, split_axis, concat_axis, n_chunks)
    assert len(plans) == n_chunks
    for p in plans:
        assert p.unit == 16 and p.tail == 0
        # Ulysses' hd chunk: 64-byte rows in bf16
        if n_chunks == 2 and dtype == torch.bfloat16:
            assert p.row_bytes == 64


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_a2a_plan_walk_small_shapes(r):
    """Word sizes 16 down to 1 byte, a row tail (rows of 40 bytes on
    16-byte row starts), strided inputs, more chunks than divide."""
    g = torch.Generator().manual_seed(r)
    cases = [((r, 2 * r, 4, 40), 0, 1, 2, torch.bfloat16),   # tail 8
             ((r, 3, 2 * r, 5), 1, 0, 3, torch.float32),
             ((r, 2 * r, 3, 7), 0, 2, 1, torch.bfloat16),
             ((r, 4, r, 6), 1, 1, 4, torch.uint8),
             ((r, 2, 2 * r, 2, 3), 1, 3, 2, torch.float32)]
    tails = 0
    for shape, a, c, n, dtype in cases:
        x = torch.randint(0, 255, shape, generator=g).to(dtype)
        for view in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
            plans = _check_walk(view, a, c, n)
            tails += sum(p.tail > 0 for p in plans)
    assert tails > 0 or r == 1
    if r > 1:
        with pytest.raises(ValueError, match="not divisible"):
            PK.all_to_all(torch.ones(r, 2 * r + 1, 3), 0, 1)


def test_all_to_all_cpu_wrapper_is_the_plain_version():
    x = torch.randn(4, 8, 6, 4)
    for n in (1, 2, 3):
        assert torch.equal(PK.all_to_all(x, 0, 1, n_chunks=n),
                           PK.all_to_all_plain(x, 0, 1))
    with pytest.raises(ValueError, match="n_chunks"):
        PK.all_to_all(x, 0, 1, n_chunks=0)
