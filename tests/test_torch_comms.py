"""The port's CommContext against the JAX package's: the analytic schedule
and cost model make the same decisions on a grid of shapes and axis sizes
for both hardware specs, backend precedence and the ValueError shape guards
behave the same, and the three matmul_all_reduce backends compute the same
function (float32 on the CPU, rtol = atol = 1e-5: sums in another order).
"""

import dataclasses
from functools import partial

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
from repro_torch.core import comms as tcomms  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(16, 12, 32), (256, 2048, 1408), (2048, 2048, 1408),
          (8, 2048, 1408), (8192, 8192, 8192), (4096, 1024, 512)]
RANKS = [2, 4, 8]
HW = [("tpu_v5e", jcm.TPU_V5E, tcm.TPU_V5E),
      ("h100_sxm", jcm.H100_SXM, tcm.H100_SXM)]
OPS = ("all_gather_matmul", "matmul_reduce_scatter", "matmul_all_reduce")


def _ctxs(r, jhw, thw, **kw):
    return (JaxCommContext(axis_name="x", mesh=compat.make_mesh((r,), ("x",)),
                           hw=jhw, **kw),
            CommContext(axis_name="x", mesh=VirtualMesh((r,), ("x",)),
                        hw=thw, **kw))


def test_costmodel_is_a_copy():
    for (_, jhw, thw) in HW:
        assert dataclasses.asdict(jhw) == dataclasses.asdict(thw)
        for m, n, k in SHAPES:
            for kind in ("all_gather", "reduce_scatter", "all_reduce"):
                for c in (1, 2, 4):
                    for f in ("overlapped_gemm_collective_cost",
                              "fused_pipeline_cost", "chunk_pipeline_cost",
                              "bulk_gemm_collective_cost"):
                        kw = dict(axis_size=4, kind=kind, hw=None)
                        if f == "overlapped_gemm_collective_cost":
                            kw["n_chunks"] = c
                        elif f != "bulk_gemm_collective_cost":
                            kw["sub_chunks"] = c
                        a = getattr(jcm, f)(m, n, k, **{**kw, "hw": jhw})
                        b = getattr(tcm, f)(m, n, k, **{**kw, "hw": thw})
                        assert a.total == b.total, (f, m, n, k, kind, c)
    for extent in range(0, 40):
        for c in (1, 2, 3, 4, 8):
            assert jsched.fit_chunks(extent, c) == tsched.fit_chunks(extent,
                                                                     c)


@pytest.mark.parametrize("hw_name,jhw,thw", HW)
@pytest.mark.parametrize("r", RANKS)
def test_schedule_decisions_match_jax(hw_name, jhw, thw, r):
    jctx, tctx = _ctxs(r, jhw, thw)
    for m, n, k in SHAPES:
        for kind in ("all_gather", "reduce_scatter", "all_reduce"):
            a = jsched.choose_gemm_collective(m, n, k, axis_size=r, kind=kind,
                                              hw=jhw)
            b = tsched.choose_gemm_collective(m, n, k, axis_size=r, kind=kind,
                                              hw=thw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            for fused in (False, True):
                a = jsched.choose_gemm_chunks(m, n, k, axis_size=r,
                                              kind=kind, hw=jhw, fused=fused)
                b = tsched.choose_gemm_chunks(m, n, k, axis_size=r,
                                              kind=kind, hw=thw, fused=fused)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for op in OPS:
            for fused_ok in (False, True):
                for bidir_ok in (False, True):
                    assert jctx.auto_gemm_backend(
                        op, m, n, k, fused_ok=fused_ok, bidir_ok=bidir_ok) \
                        == tctx.auto_gemm_backend(
                            op, m, n, k, fused_ok=fused_ok, bidir_ok=bidir_ok)
            for be in ("ring", "fused"):
                for n_chunks in (None, 3):
                    a = jctx.gemm_chunk_schedule(op, m, n, k, backend=be,
                                                 n_chunks=n_chunks)
                    b = tctx.gemm_chunk_schedule(op, m, n, k, backend=be,
                                                 n_chunks=n_chunks)
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# dispatch: precedence and shape guards
# ---------------------------------------------------------------------------

def _stacked(x, w, r):
    """Global (m, r·k) and (r·k, n) numpy -> stacked K shards (torch)."""
    m, kk = x.shape
    xs = torch.from_numpy(x).reshape(m, r, kk // r).permute(1, 0, 2)
    ws = torch.from_numpy(w).reshape(r, kk // r, -1)
    return xs.contiguous(), ws


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spy(monkeypatch):
    """Record which matmul_all_reduce implementation the port runs."""
    from repro_torch.kernels import collective_matmul
    calls = []
    for mod, name, tag in ((tcomms, "matmul_all_reduce_baseline", "bulk"),
                           (tcomms, "pk_matmul_all_reduce", "ring"),
                           (collective_matmul, "matmul_ar_fused", "fused")):
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, _tag=tag, **kw):
            calls.append(_tag)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


def test_precedence_per_call_over_pin_over_policy(monkeypatch):
    calls = _spy(monkeypatch)
    r = 4
    xs, ws = _stacked(_np(8, 16, seed=1), _np(16, 8, seed=2), r)
    mesh = VirtualMesh((r,), ("x",))
    CommContext("x", mesh=mesh).matmul_all_reduce(xs, ws)      # policy
    CommContext("x", mesh=mesh, backend="ring").matmul_all_reduce(xs, ws)
    CommContext("x", mesh=mesh, backend="ring").matmul_all_reduce(
        xs, ws, backend="fused")                                # per call
    CommContext("x", mesh=mesh, backend="ring_bidir").matmul_all_reduce(
        xs, ws)                         # pin the op lacks -> policy
    assert calls == ["bulk", "ring", "fused", "bulk"]


def test_unknown_and_missing_backends_raise_like_jax():
    r = 4
    jmesh = compat.make_mesh((r,), ("x",))
    x, w = _np(8, 16), _np(16, 8)
    xs, ws = _stacked(x, w, r)
    tmesh = VirtualMesh((r,), ("x",))
    with pytest.raises(ValueError, match="unknown backend"):
        JaxCommContext("x", mesh=jmesh, backend="rinng").matmul_all_reduce(
            x, w)
    with pytest.raises(ValueError, match="unknown backend"):
        CommContext("x", mesh=tmesh, backend="rinng").matmul_all_reduce(
            xs, ws)
    with pytest.raises(ValueError, match="no backend"):
        JaxCommContext("x", mesh=jmesh).psum(jnp.ones((4,)), backend="nope")
    with pytest.raises(ValueError, match="no backend"):
        CommContext("x", mesh=tmesh).psum(torch.ones(r, 4), backend="nope")


def test_shape_guard_raises_per_call_and_degrades_pinned(monkeypatch):
    r = 4
    x, w = _np(3, 8 * r, seed=3), _np(8 * r, 8, seed=4)   # m = 3: indivisible
    xs, ws = _stacked(x, w, r)
    jmesh, tmesh = compat.make_mesh((r,), ("x",)), VirtualMesh((r,), ("x",))
    for backend in ("ring", "fused"):
        with pytest.raises(ValueError, match="divisible by the axis size"):
            CommContext("x", mesh=tmesh).matmul_all_reduce(xs, ws,
                                                           backend=backend)
    with pytest.raises(ValueError, match="divisible by the axis size"):
        JaxCommContext("x", mesh=jmesh).matmul_all_reduce(x, w,
                                                          backend="ring")
    calls = _spy(monkeypatch)
    got = CommContext("x", mesh=tmesh, backend="ring").matmul_all_reduce(xs,
                                                                          ws)
    assert calls == ["bulk"]
    pinned = JaxCommContext("x", mesh=jmesh, backend="ring")
    want = jax.jit(compat.shard_map(
        pinned.matmul_all_reduce, mesh=jmesh,
        in_specs=(JP(None, "x"), JP("x", None)), out_specs=JP(),
        check_vma=False))(x, w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)
    # psum ring needs the local leading dim divisible, as in JAX
    with pytest.raises(ValueError, match="divisible by the axis size"):
        CommContext("x", mesh=tmesh).psum(torch.ones(r, 2 * r + 1, 4),
                                          backend="ring")


def test_not_ported_paths_raise():
    mesh = VirtualMesh((4,), ("x",))
    with pytest.raises(NotImplementedError, match="item 12"):
        CommContext("x", mesh=mesh, policy="measured")
    # quantized wires are ported (ROADMAP item 11,
    # tests/test_torch_quant.py)
    assert CommContext("x", mesh=mesh, wire="int8").wire_format().name == \
        "int8"
    assert CommContext("x", mesh=mesh, wire="bf16").wire_format() is None
    # all_to_all is ported: block r of rank s lands at slot s of rank r
    x = torch.arange(4 * 4 * 2.0).view(4, 4, 2)
    out = CommContext("x", mesh=mesh).all_to_all(x, split_axis=0,
                                                  concat_axis=1)
    assert out.shape == (4, 1, 8)
    for r in range(4):
        assert torch.equal(out[r, 0], x[:, r].reshape(8))


# ---------------------------------------------------------------------------
# the three backends compute one function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("m,k_loc,n", [(8, 16, 12), (16, 8, 24)])
def test_matmul_all_reduce_backends_agree(r, m, k_loc, n):
    x, w = _np(m, r * k_loc, seed=r + m), _np(r * k_loc, n, seed=n)
    xs, ws = _stacked(x, w, r)
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    outs = {be: ctx.matmul_all_reduce(xs, ws, backend=be, n_chunks=2)
            for be in ("bulk", "ring", "fused")}
    jmesh = compat.make_mesh((r,), ("x",))
    jctx = JaxCommContext("x", mesh=jmesh)
    want = np.asarray(jax.jit(compat.shard_map(
        partial(jctx.matmul_all_reduce, backend="bulk"), mesh=jmesh,
        in_specs=(JP(None, "x"), JP("x", None)), out_specs=JP(),
        check_vma=False))(x, w))
    for be, got in outs.items():
        assert got.shape == (r, m, n) and got.dtype == torch.float32, be
        for rank in range(r):
            np.testing.assert_allclose(got[rank].numpy(), want, **TOL)


@pytest.mark.parametrize("backend", ["bulk", "ring"])
def test_psum_matches_jax(backend):
    r = 4
    y = _np(r, 8, 3, seed=7)                    # rank r's local (8, 3)
    jmesh = compat.make_mesh((r,), ("x",))
    jctx = JaxCommContext("x", mesh=jmesh)
    want = np.asarray(jax.jit(compat.shard_map(
        partial(jctx.psum, backend=backend), mesh=jmesh,
        in_specs=JP("x"), out_specs=JP(), check_vma=False))(
            y.reshape(r * 8, 3)))
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    got = ctx.psum(torch.from_numpy(y), backend=backend)
    for rank in range(r):
        np.testing.assert_allclose(got[rank].numpy(), want, **TOL)
    np.testing.assert_array_equal(ctx.pmax(torch.from_numpy(y))[0].numpy(),
                                  y.max(axis=0))
