"""The port's tensor-parallel GEMM collectives against the JAX package.

``CommContext.all_gather_matmul`` (paper Fig. 7) and
``CommContext.matmul_reduce_scatter`` (Fig. 8) on stacked operands are held
against JAX's ops under ``shard_map`` on emulated devices, on (2,) and (4,),
for every backend: ``bulk``, ``ring`` (chunk_dim "m" and "n", 1-4 chunks;
3 does not divide every chunked extent, so ``fit_chunks`` falls back),
``ring_bidir`` (even and odd local rows) and ``fused`` (on the CPU the
port's wrappers run their plain versions; JAX runs its Pallas kernels in TPU
interpret mode). The plain versions are also held against the Pallas
``ag_matmul_fused`` / ``matmul_rs_fused`` kernels themselves. Float32 inputs
from a numpy seed; rtol = atol = 1e-5 (sums in another order, as in
``tests/test_torch_comms.py``). Every chunk count gives the port the same
bits (JAX claims it for its rings and kernels; the port's rings run each
step's GEMM whole).

Then: the shape guards (per-call raises, pins degrade), ``auto`` resolution
on the same ``HardwareSpec``, gradients through ``bulk`` and ``ring``
against ``jax.grad``, the fused wrappers refusing a gradient (JAX's fused
ops have none: ROADMAP C9), and declared ``Island``s — the way
``benchmarks/paper_figures._gemm_island`` declares them — running their
bodies through these ops and planning as JAX's do, including the
pinned-backend reason at an indivisible m.
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
from repro.core import comms as jcomms  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import template as jtemplate  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro.kernels import collective_matmul as jcmm  # noqa: E402
from repro_torch.core import comms as tcomms  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core import template as ttemplate  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import P, VirtualMesh  # noqa: E402
from repro_torch.kernels import collective_matmul as CM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = (1, 2, 3, 4)
AG = "all_gather_matmul"
RS = "matmul_reduce_scatter"
# (r, m_loc, k, n_loc): even and odd local rows on (2,) and (4,)
AG_CASES = [(2, 6, 16, 12), (2, 3, 16, 12), (4, 4, 8, 10), (4, 5, 8, 6)]
# (r, m, k_loc, n)
RS_CASES = [(2, 8, 8, 12), (4, 16, 4, 10)]
# JAX specs of the global operands and output (x, w, out)
SPECS = {AG: (JP("x", None), JP(None, "x"), JP(None, "x")),
         RS: (JP(None, "x"), JP("x", None), JP("x", None))}
TSPECS = {AG: (P("x", None), P(None, "x"), P(None, "x")),
          RS: (P(None, "x"), P("x", None), P("x", None))}


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _globals(op, case, seed=0):
    """Global numpy operands of ``op`` at ``case``."""
    if op == AG:
        r, m_loc, k, n_loc = case
        return _np(r * m_loc, k, seed=seed), _np(k, r * n_loc, seed=seed + 1)
    r, m, k_loc, n = case
    return _np(m, r * k_loc, seed=seed), _np(r * k_loc, n, seed=seed + 1)


def _stack(op, r, x, w):
    """Global torch operands -> the port's stacked (R, ...) layout."""
    mesh = VirtualMesh((r,), ("x",))
    xs, ws, _ = TSPECS[op]
    return pgl.layout(x, xs, mesh, "x"), pgl.layout(w, ws, mesh, "x")


def _unstack(op, r, y):
    return pgl.assemble(y, TSPECS[op][2], VirtualMesh((r,), ("x",)), "x")


def _jax(op, r, x, w, **kw):
    """JAX's CommContext op on an r-device mesh, global in and out."""
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext("x", mesh=mesh)
    xs, ws, out = SPECS[op]
    f = jax.jit(compat.shard_map(partial(getattr(ctx, op), **kw), mesh=mesh,
                                 in_specs=(xs, ws), out_specs=out,
                                 check_vma=False))
    return np.asarray(f(x, w))


def _port(op, r, x, w, **kw):
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    xs, ws = _stack(op, r, torch.from_numpy(x), torch.from_numpy(w))
    return _unstack(op, r, getattr(ctx, op)(xs, ws, **kw)).numpy()


def _needs_interpret(backend):
    if backend == "fused" and not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")


def _check_backend(op, case, backend, chunk_dim):
    _needs_interpret(backend)
    r = case[0]
    x, w = _globals(op, case, seed=sum(case))
    counts = (1,) if backend == "bulk" else CHUNKS
    first = None
    for nc in counts:
        kw = dict(backend=backend, n_chunks=nc, chunk_dim=chunk_dim)
        got = _port(op, r, x, w, **kw)
        np.testing.assert_allclose(got, _jax(op, r, x, w, **kw), **TOL)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)   # the same bits


@pytest.mark.parametrize("backend,chunk_dim", [
    ("bulk", None), ("ring", "m"), ("ring", "n"), ("ring_bidir", "m"),
    ("fused", None)])
@pytest.mark.parametrize("case", AG_CASES)
def test_all_gather_matmul_matches_jax(case, backend, chunk_dim):
    _check_backend(AG, case, backend, chunk_dim)


@pytest.mark.parametrize("backend,chunk_dim", [
    ("bulk", None), ("ring", "m"), ("ring", "n"), ("fused", None)])
@pytest.mark.parametrize("case", RS_CASES)
def test_matmul_reduce_scatter_matches_jax(case, backend, chunk_dim):
    _check_backend(RS, case, backend, chunk_dim)


def _pallas(fn, op, r, x, w, n_chunks):
    """A Pallas GEMM-collective kernel in interpret mode; per-device out."""
    mesh = compat.make_mesh((r,), ("x",))
    xs, ws, _ = SPECS[op]
    f = jax.jit(compat.shard_map(
        lambda a, b: fn(a, b, "x", n_chunks=n_chunks)[None], mesh=mesh,
        in_specs=(xs, ws), out_specs=JP("x"), check_vma=False))
    return np.asarray(f(x, w))


@pytest.mark.parametrize("case", [AG_CASES[0], AG_CASES[3]])
def test_ag_matmul_plain_matches_pallas_kernel(case):
    _needs_interpret("fused")
    r, m_loc, _, n_loc = case
    x, w = _globals(AG, case, seed=3)
    xs, ws = _stack(AG, r, torch.from_numpy(x), torch.from_numpy(w))
    for nc in CHUNKS:
        got = tops.pk_ag_matmul(xs, ws, n_chunks=nc)
        assert got.shape == (r, r * m_loc, n_loc) and got.dtype == xs.dtype
        want = _pallas(jcmm.ag_matmul_fused, AG, r, x, w, nc)
        np.testing.assert_allclose(got.numpy(),
                                   want.reshape(r, r * m_loc, n_loc), **TOL)
    np.testing.assert_allclose(
        tref.ag_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jnp.dot(x, w)), **TOL)


@pytest.mark.parametrize("case", RS_CASES)
def test_matmul_rs_plain_matches_pallas_kernel(case):
    _needs_interpret("fused")
    r, m, _, n = case
    x, w = _globals(RS, case, seed=4)
    xs, ws = _stack(RS, r, torch.from_numpy(x), torch.from_numpy(w))
    first = None
    for nc in CHUNKS:
        got = tops.pk_matmul_rs(xs, ws, n_chunks=nc)
        assert got.shape == (r, m // r, n) and got.dtype == torch.float32
        want = _pallas(jcmm.matmul_rs_fused, RS, r, x, w, nc)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        first = got if first is None else first
        assert torch.equal(got, first)
    np.testing.assert_allclose(
        tref.matmul_rs_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        x @ w, **TOL)


# ---------------------------------------------------------------------------
# guards and resolution
# ---------------------------------------------------------------------------

def test_shape_guards_raise_per_call_and_degrade_pinned():
    r = 4
    jmesh, tmesh = compat.make_mesh((r,), ("x",)), VirtualMesh((r,), ("x",))
    # GEMM+RS at m = 18: ring and fused need m divisible by the axis
    x, w = _globals(RS, (r, 18, 4, 8), seed=5)
    xs, ws = _stack(RS, r, torch.from_numpy(x), torch.from_numpy(w))
    for be in ("ring", "fused"):
        with pytest.raises(ValueError, match="divisible by the axis size"):
            CommContext("x", mesh=tmesh).matmul_reduce_scatter(xs, ws,
                                                               backend=be)
        with pytest.raises(ValueError, match="divisible by the axis size"):
            JaxCommContext("x", mesh=jmesh).matmul_reduce_scatter(
                x, w, backend=be)
    # a pin degrades to bulk, whose scatter needs the divisibility too
    with pytest.raises(ValueError, match="divisible"):
        CommContext("x", mesh=tmesh, backend="ring").matmul_reduce_scatter(
            xs, ws)
    # AG+GEMM at m_loc = 1 on an even axis: ring_bidir per call raises, a
    # pin degrades to ring — equal to JAX's pinned result
    x, w = _globals(AG, (r, 1, 8, 6), seed=6)
    xs, ws = _stack(AG, r, torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError, match="m_loc >= 2"):
        CommContext("x", mesh=tmesh).all_gather_matmul(xs, ws,
                                                       backend="ring_bidir")
    with pytest.raises(ValueError, match="m_loc >= 2"):
        JaxCommContext("x", mesh=jmesh).all_gather_matmul(
            x[:1], w[:, :6], backend="ring_bidir")
    got = CommContext("x", mesh=tmesh, backend="ring_bidir"
                      ).all_gather_matmul(xs, ws)
    pinned = JaxCommContext("x", mesh=jmesh, backend="ring_bidir")
    want = jax.jit(compat.shard_map(
        pinned.all_gather_matmul, mesh=jmesh, in_specs=SPECS[AG][:2],
        out_specs=SPECS[AG][2], check_vma=False))(x, w)
    np.testing.assert_allclose(_unstack(AG, r, got).numpy(),
                               np.asarray(want), **TOL)


def _spy_port(monkeypatch, calls):
    """Record which implementation the port runs; return meta tensors."""
    def fake(tag, shape_of):
        def f(x, w, **kw):
            calls.append("ring_bidir" if kw.get("bidirectional") else tag)
            return torch.empty(shape_of(x, w), device="meta")
        return f

    def ag(x, w):
        return x.shape[0], x.shape[0] * x.shape[1], w.shape[2]

    def rs(x, w):
        return x.shape[0], x.shape[1] // x.shape[0], w.shape[2]

    for name, tag, shp in (("all_gather_matmul_baseline", "bulk", ag),
                           ("pk_all_gather_matmul", "ring", ag),
                           ("matmul_reduce_scatter_baseline", "bulk", rs),
                           ("pk_matmul_reduce_scatter", "ring", rs)):
        monkeypatch.setattr(tcomms, name, fake(tag, shp))


def _spy_jax(monkeypatch, calls):
    def wrap(tag, orig):
        def f(*a, **kw):
            calls.append(tag if not kw.get("bidirectional") else
                         "ring_bidir")
            return orig(*a, **kw)
        return f

    for name, tag in (("all_gather_matmul_baseline", "bulk"),
                      ("pk_all_gather_matmul", "ring"),
                      ("matmul_reduce_scatter_baseline", "bulk"),
                      ("pk_matmul_reduce_scatter", "ring")):
        monkeypatch.setattr(jcomms, name, wrap(tag, getattr(jcomms, name)))


@pytest.mark.parametrize("r", [2, 4, 8])
def test_auto_resolution_matches_jax(monkeypatch, r):
    """backend=None resolves alike on the same HardwareSpec (H100 SXM),
    traced only: JAX by ``eval_shape``, the port on meta tensors."""
    port_calls, jax_calls = [], []
    _spy_port(monkeypatch, port_calls)
    _spy_jax(monkeypatch, jax_calls)
    jmesh = compat.make_mesh((r,), ("x",))
    jctx = JaxCommContext("x", mesh=jmesh, hw=jcm.H100_SXM)
    tctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    for m, n, k in ((16, 12, 32), (256, 2048, 1408), (2048, 2048, 1408),
                    (8, 2048, 1408), (8192, 8192, 8192), (4096, 1024, 512),
                    (18, 64, 64)):
        for op in (AG, RS):
            if op == AG:
                if m % r:
                    continue
                xg, wg = (m, k), (k, r * n)
                xs, ws = (r, m // r, k), (r, k, n)
            else:
                xg, wg = (m, r * k), (r * k, n)
                xs, ws = (r, m, k), (r, k, n)
            before = len(jax_calls)
            f = compat.shard_map(getattr(jctx, op), mesh=jmesh,
                                 in_specs=SPECS[op][:2],
                                 out_specs=SPECS[op][2], check_vma=False)
            try:
                jax.eval_shape(f, jax.ShapeDtypeStruct(xg, jnp.bfloat16),
                               jax.ShapeDtypeStruct(wg, jnp.bfloat16))
            except Exception:
                if len(jax_calls) == before:   # failed before dispatching
                    raise
            getattr(tctx, op)(torch.empty(xs, dtype=torch.bfloat16,
                                          device="meta"),
                              torch.empty(ws, dtype=torch.bfloat16,
                                          device="meta"))
            assert port_calls[-1] == jax_calls[-1], (op, m, n, k, r)
    assert set(port_calls) >= {"bulk", "ring"}


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,backend", [(AG, "bulk"), (AG, "ring"),
                                        (AG, "ring_bidir"), (RS, "bulk"),
                                        (RS, "ring")])
def test_gradients_match_jax(op, backend):
    case = AG_CASES[2] if op == AG else RS_CASES[1]
    r = case[0]
    x, w = _globals(op, case, seed=7)
    kw = dict(backend=backend, n_chunks=2)
    y = _jax(op, r, x, w, **kw)
    cot = _np(*y.shape, seed=8)
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext("x", mesh=mesh)
    f = compat.shard_map(partial(getattr(ctx, op), **kw), mesh=mesh,
                         in_specs=SPECS[op][:2], out_specs=SPECS[op][2],
                         check_vma=False)
    jgx, jgw = jax.jit(jax.grad(lambda a, b: jnp.sum(f(a, b) * cot),
                                argnums=(0, 1)))(x, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    xs, ws = _stack(op, r, tx, tw)
    tctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    out = _unstack(op, r, getattr(tctx, op)(xs, ws, **kw))
    np.testing.assert_allclose(out.detach().numpy(), y, **TOL)
    gx, gw = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                 (tx, tw))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **TOL)


@pytest.mark.parametrize("op", [AG, RS])
def test_fused_refuses_gradient_as_jax_has_none(op):
    _needs_interpret("fused")
    case = AG_CASES[2] if op == AG else RS_CASES[1]
    r = case[0]
    x, w = _globals(op, case, seed=9)
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext("x", mesh=mesh)
    f = compat.shard_map(partial(getattr(ctx, op), backend="fused"),
                         mesh=mesh, in_specs=SPECS[op][:2],
                         out_specs=SPECS[op][2], check_vma=False)
    with pytest.raises(AssertionError):
        jax.grad(lambda a: jnp.sum(f(a, w)))(x)
    xs, ws = _stack(op, r, torch.from_numpy(x), torch.from_numpy(w))
    tctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    fused = CM.ag_matmul_fused if op == AG else CM.matmul_rs_fused
    with pytest.raises(NotImplementedError, match="C9"):
        getattr(tctx, op)(xs.requires_grad_(True), ws, backend="fused")
    with pytest.raises(NotImplementedError, match="C9"):
        fused(xs, ws.requires_grad_(True))
    with torch.no_grad():                    # forward-only use is fine
        assert fused(xs, ws).shape[0] == r


# ---------------------------------------------------------------------------
# islands
# ---------------------------------------------------------------------------

def _islands(op, backend, m, n, k, r):
    """The same declared GEMM island in both packages (as
    ``paper_figures._gemm_island``), JAX's priced on the port's H100."""
    xs, ws, out = SPECS[op]
    j = jtemplate.Island(
        f"{op}/{backend}", mesh=compat.make_mesh((r,), ("x",)), axis="x",
        inputs={"x": xs, "w": ws}, out_specs=out,
        body=lambda ctx, x, w: getattr(ctx, op)(x, w, backend=backend),
        comm=jtemplate.Comm(op, m=m, n=n, k=k, backend=backend),
        hw=jcm.H100_SXM)
    txs, tws, tout = TSPECS[op]
    t = ttemplate.Island(
        f"{op}/{backend}", mesh=VirtualMesh((r,), ("x",)), axis="x",
        inputs={"x": txs, "w": tws}, out_specs=tout,
        body=lambda ctx, x, w: getattr(ctx, op)(x, w, backend=backend),
        comm=ttemplate.Comm(op, m=m, n=n, k=k, backend=backend))
    return j, t


PLAN_FIELDS = ("island", "axis", "axis_size", "fallback", "reason", "op",
               "backend", "n_chunks", "chunk_dim", "hidden_fraction",
               "source", "wire")


def _same_plan(j, t):
    jp, tp = dataclasses.asdict(j.plan()), t.plan().asdict()
    for f in PLAN_FIELDS:
        assert jp[f] == tp[f], (f, jp[f], tp[f])


@pytest.mark.parametrize("op,backend", [(AG, "bulk"), (AG, "ring"),
                                        (AG, "ring_bidir"), (AG, "fused"),
                                        (RS, "bulk"), (RS, "ring"),
                                        (RS, "fused")])
def test_island_runs_gemm_ops_and_plans_like_jax(op, backend):
    _needs_interpret(backend)
    case = AG_CASES[2] if op == AG else RS_CASES[1]
    r = case[0]
    x, w = _globals(op, case, seed=10)
    m = x.shape[0]
    n = case[3]
    k = x.shape[1] if op == AG else x.shape[1] // r
    j, t = _islands(op, backend, m, n, k, r)
    _same_plan(j, t)
    want = np.asarray(jax.jit(lambda a, b: j(x=a, w=b))(x, w))
    got = t(x=torch.from_numpy(x), w=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("backend", ["ring", "fused"])
def test_plan_reason_of_indivisible_pin_matches_jax(backend):
    """A call-site pin that breaks m % axis == 0 says the runtime raises."""
    j, t = _islands(RS, backend, 18, 8, 4, 4)
    tp = t.plan()
    assert tp.reason == (f"pinned backend={backend} violates m % axis == 0 "
                         "— the runtime raises ValueError for this call")
    assert (tp.reason, tp.backend, tp.fallback) == (
        j.plan().reason, j.plan().backend, j.plan().fallback)
    _same_plan(j, t)
