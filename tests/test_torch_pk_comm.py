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

