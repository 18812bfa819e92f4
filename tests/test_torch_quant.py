"""The port's int8 wire formats (``core/quant.py``, ``optim/compress.py``
and the quantized rings of ``core/comms.py``) against the JAX package.

Every JAX program that quantizes runs compiled (the rings, the KV cache,
the train step), and XLA folds the division of a block's max by the
constant 127 into a multiply by its f32 reciprocal; eager JAX divides, and
so differs from compiled JAX in the last bit of about 4.5% of the scales
(``test_scales_follow_compiled_jax``). The port multiplies, so it is held
against JAX's functions under ``jax.jit``:

* ``quantize_blocks`` / ``dequantize_blocks`` / ``quant_dequant`` bit for
  bit at ragged last dims and at blocks of 256 and 32; row chunks quantize
  as the whole does.
* ``compressed_psum`` on a stacked (4, ...) tensor bit for bit against
  JAX's inside ``shard_map`` on 4 emulated devices.
* ``ErrorFeedbackInt8.transform`` over 3 steps, the state carried from
  call to call outside the compiled function (each of JAX's calls
  compiled): outputs and residuals bit for bit.
* The quantized rings — ``all_gather_matmul`` (ring and ring_bidir),
  ``matmul_reduce_scatter`` and ``matmul_all_reduce`` with
  ``wire="int8"`` at 1, 2 and 4 chunks on (2,) and (4,) — against JAX's
  rings. Torch's CPU GEMM and XLA's round sums in other orders, so two
  kinds of data: weights with at most two power-of-two entries a column
  and rank, which make every GEMM exact in any order and so hold the wire
  bit for bit (ROADMAP C3's case, int8 ``ring_bidir`` AG+GEMM at 4
  chunks, among them); and normal data, held within rtol = atol = 1e-5.
  Every chunk count gives the port the same bits.
* ``int8_sr`` by its properties (JAX's threefry bits are not reproduced):
  it differs from round-to-nearest, every element lies within one
  quantum of its value, and the mean of 64 draws lies within 0.3 quanta.
* Under a quantized wire ``auto`` never resolves to ``fused`` (on a
  mesh whose device reports cuda), and the island plans' ``wire`` field
  equals JAX's ``island_plans`` on (2, 2).
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
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import P, VirtualMesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.optim import compress as C  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
AG, RS, AR = "all_gather_matmul", "matmul_reduce_scatter", \
    "matmul_all_reduce"
SPECS = {AG: (JP("x", None), JP(None, "x"), JP(None, "x")),
         RS: (JP(None, "x"), JP("x", None), JP("x", None)),
         AR: (JP(None, "x"), JP("x", None), JP())}
TSPECS = {AG: (P("x", None), P(None, "x"), P(None, "x")),
          RS: (P(None, "x"), P("x", None), P("x", None)),
          AR: (P(None, "x"), P("x", None), P(None, None))}


def _np(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [1, 17, 256, 300, 513])
@pytest.mark.parametrize("block", [256, 32])
def test_quantize_blocks_bit_for_bit(cols, block):
    x = _np(6, cols, seed=cols, scale=3.0)
    x[0] = 0.0                                  # an all-zero row: SCALE_EPS
    jq, js = jax.jit(partial(JQ.quantize_blocks, block=block))(x)
    tq, ts = Q.quantize_blocks(torch.from_numpy(x), block=block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        Q.dequantize_blocks(tq, ts, cols).numpy(),
        np.asarray(jax.jit(partial(JQ.dequantize_blocks, cols=cols))(jq,
                                                                      js)))
    np.testing.assert_array_equal(
        Q.quant_dequant(torch.from_numpy(x), block=block).numpy(),
        np.asarray(jax.jit(partial(JQ.quant_dequant, block=block))(x)))


def test_scales_follow_compiled_jax():
    """XLA compiles ``max / 127`` as ``max * (1/127)``: compiled and eager
    JAX disagree in the last bit of some scales, and the port is the
    compiled one."""
    x = _np(4096, 16, seed=5)
    eager = np.asarray(JQ.quantize_blocks(jnp.asarray(x))[1])
    comp = np.asarray(jax.jit(JQ.quantize_blocks)(x)[1])
    port = Q.quantize_blocks(torch.from_numpy(x))[1].numpy()
    np.testing.assert_array_equal(port, comp)
    assert 0 < (eager != comp).sum() < 0.1 * comp.size
    np.testing.assert_allclose(eager, comp, rtol=2 ** -23, atol=0)


def test_row_chunk_invariance():
    """Quantizing row chunks equals quantizing the whole and slicing: what
    keeps the quantized rings' bits independent of the chunk count."""
    x = torch.from_numpy(_np(16, 300, seed=1))
    q, s = Q.quantize_blocks(x)
    for c in (2, 4, 8):
        rows = 16 // c
        for j in range(c):
            qj, sj = Q.quantize_blocks(x[j * rows:(j + 1) * rows])
            assert torch.equal(qj, q[j * rows:(j + 1) * rows])
            assert torch.equal(sj, s[j * rows:(j + 1) * rows])


def test_wire_formats_match_jax():
    assert set(Q.WIRE_FORMATS) == set(JQ.WIRE_FORMATS)
    for name in Q.WIRE_FORMATS:
        assert dataclasses.asdict(Q.WIRE_FORMATS[name]) == \
            dataclasses.asdict(JQ.WIRE_FORMATS[name])
        t, j = Q.resolve_wire(name), JQ.resolve_wire(name)
        assert (t is None) == (j is None)
        if t is not None:
            assert t.bytes_per_element == j.bytes_per_element == 1.015625
        for n in (1, 1000, 4096):
            assert Q.wire_payload_bytes(n, name) == \
                JQ.wire_payload_bytes(n, name)
            assert Q.wire_dtype_bytes(name, 4) == JQ.wire_dtype_bytes(name, 4)
    assert C.compressed_payload_bytes(1024) == \
        JC.compressed_payload_bytes(1024) == 1040.0
    with pytest.raises(ValueError, match="unknown wire format"):
        Q.resolve_wire("fp4")
    with pytest.raises(ValueError, match="unknown wire format"):
        CommContext("x", mesh=VirtualMesh((2,), ("x",)), wire="fp4")


# ---------------------------------------------------------------------------
# compressed_psum and error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 300), (4, 3, 97), (4, 512)])
def test_compressed_psum_bit_for_bit(mesh4, shape):
    x = _np(*shape, seed=len(shape))
    x[2] *= 50.0                # one rank's max sets the shared scales
    f = jax.jit(compat.shard_map(
        lambda a: JC.compressed_psum(a[0], "x")[None], mesh=mesh4,
        in_specs=JP("x"), out_specs=JP("x"), check_vma=False))
    want = np.asarray(f(x))
    got = C.compressed_psum(torch.from_numpy(x))
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(want[0], want[3])       # the same on every rank


def test_error_feedback_bit_for_bit_over_three_steps():
    grads = {"w": _np(33, 7, seed=8, scale=0.01),
             "b": {"x": _np(300, seed=9, scale=0.1)}}
    jef, tef = JC.ErrorFeedbackInt8(), C.ErrorFeedbackInt8()
    js = jef.init(jax.tree.map(jnp.asarray, grads))
    ts = tef.init(jax.tree.map(torch.from_numpy, grads))
    jtransform = jax.jit(jef.transform)
    for step in range(3):
        g = jax.tree.map(lambda a: a * (1.0 + step), grads)
        jd, js = jtransform(jax.tree.map(jnp.asarray, g), js)
        td, ts = tef.transform(jax.tree.map(torch.from_numpy, g), ts)
        for got, want in ((td, jd), (ts.residual, js.residual)):
            for a, b in zip(jax.tree.leaves(jax.tree.map(
                    lambda t: t.numpy(), got)), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a, np.asarray(b))
    # the residual is carried: step 3's output is not quant_dequant(g)
    assert not torch.equal(td["w"], Q.quant_dequant(torch.from_numpy(
        grads["w"] * 3.0)))


# ---------------------------------------------------------------------------
# the quantized rings against JAX's
# ---------------------------------------------------------------------------

def _exact_weight(rows: int, cols: int, ranks: int, seed: int) -> np.ndarray:
    """(rows, cols) with at most two entries ±2^e (e in -1..1) per column
    in each rank's block of rows: every GEMM over it is exact in any
    summation order."""
    rng = np.random.default_rng(seed)
    w = np.zeros((rows, cols), np.float32)
    blk = rows // ranks
    for r in range(ranks):
        for j in range(cols):
            for i in rng.choice(blk, size=min(2, blk), replace=False):
                w[r * blk + i, j] = rng.choice([-1, 1]) * 2.0 ** int(
                    rng.integers(-1, 2))
    return w


def _operands(op, r, exact, seed):
    if op == AG:
        m_loc, k, n_loc = 8, 300, 12
        x = _np(r * m_loc, k, seed=seed)
        w = (_exact_weight(k, r * n_loc, 1, seed + 1) if exact
             else _np(k, r * n_loc, seed=seed + 1, scale=0.1))
    else:
        m, k_loc, n = 8 * r, 8, 300
        x = _np(m, r * k_loc, seed=seed)
        w = (_exact_weight(r * k_loc, n, r, seed + 1) if exact
             else _np(r * k_loc, n, seed=seed + 1))
    return x, w


def _jax_ring(op, r, x, w, **kw):
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext("x", mesh=mesh)
    xs, ws, out = SPECS[op]
    f = jax.jit(compat.shard_map(partial(getattr(ctx, op), **kw), mesh=mesh,
                                 in_specs=(xs, ws), out_specs=out,
                                 check_vma=False))
    return np.asarray(f(x, w))


def _port_ring(op, r, x, w, **kw):
    mesh = VirtualMesh((r,), ("x",))
    xs, ws, out = TSPECS[op]
    got = getattr(CommContext("x", mesh=mesh), op)(
        pgl.layout(torch.from_numpy(x), xs, mesh, "x"),
        pgl.layout(torch.from_numpy(w), ws, mesh, "x"), **kw)
    return pgl.assemble(got, out, mesh, "x").numpy()


RINGS = [(AG, "ring"), (AG, "ring_bidir"), (RS, "ring"), (AR, "ring")]


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("op,backend", RINGS)
def test_int8_rings_bit_for_bit_with_exact_gemms(op, backend, r):
    x, w = _operands(op, r, exact=True, seed=r)
    first = None
    for nc in (1, 2, 4):
        kw = dict(backend=backend, n_chunks=nc, wire="int8")
        got = _port_ring(op, r, x, w, **kw)
        np.testing.assert_array_equal(got, _jax_ring(op, r, x, w, **kw),
                                      err_msg=f"{op}/{backend}/c={nc}")
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)   # every count, one result
    # the wire did quantize: not the full-precision ring's result
    assert not np.array_equal(first, _port_ring(op, r, x, w,
                                                backend=backend))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("op,backend", RINGS)
def test_int8_rings_match_jax_on_normal_data(op, backend, r):
    x, w = _operands(op, r, exact=False, seed=10 + r)
    first = None
    for nc in (1, 2, 4):
        kw = dict(backend=backend, n_chunks=nc, wire="int8")
        got = _port_ring(op, r, x, w, **kw)
        np.testing.assert_allclose(got, _jax_ring(op, r, x, w, **kw), **TOL,
                                   err_msg=f"{op}/{backend}/c={nc}")
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)


def test_int8_sr_properties():
    r = 4
    mesh = VirtualMesh((r,), ("x",))
    ctx = CommContext("x", mesh=mesh)
    x = _np(r * 8, 48, seed=20)
    # an identity weight makes AG+GEMM return the dequantized rows exactly
    eye = np.tile(np.eye(48, dtype=np.float32), (1, r))
    xs = pgl.layout(torch.from_numpy(x), P("x", None), mesh, "x")
    ws = pgl.layout(torch.from_numpy(eye), P(None, "x"), mesh, "x")
    rtn = ctx.all_gather_matmul(xs, ws, backend="ring", wire="int8")
    sr = ctx.all_gather_matmul(xs, ws, backend="ring", wire="int8_sr")
    assert not torch.equal(sr, rtn)
    # the same call rounds the same way (seeded generators), on every rank
    assert torch.equal(sr, ctx.all_gather_matmul(xs, ws, backend="ring",
                                                 wire="int8_sr"))
    quantum = np.abs(x).max(axis=1, keepdims=True) / 127.0
    for d in range(r):
        assert (np.abs(sr[d].numpy() - x) <= quantum * (1 + 1e-6)).all()
    # unbiased: the mean of 64 draws is within 0.3 quanta of the value
    # (the draws' spread is <= 1/16 of a quantum: ~5 sigma)
    xt = torch.from_numpy(x)
    draws = torch.stack([
        Q.dequantize_blocks(*Q.quantize_blocks(
            xt, generator=torch.Generator().manual_seed(s)), 48)
        for s in range(64)])
    assert (np.abs(draws.mean(0).numpy() - x) <= 0.3 * quantum).all()
    assert not torch.equal(draws[0], draws[1])
    # the rings' other ops take int8_sr as well, within a quantum's error
    xr, wr = _operands(RS, r, exact=False, seed=21)
    for op in (RS, AR):
        a = _port_ring(op, r, xr, wr, backend="ring", wire="int8_sr")
        b = _port_ring(op, r, xr, wr, backend="bulk")
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.15 * np.abs(
            b).max())


def test_auto_never_fused_under_a_quantized_wire():
    """On a mesh whose device reports cuda the policy prefers the fused
    kernel; under a quantized wire it picks a ring (the fused kernels ship
    full precision), with row chunks. JAX makes the same call given
    ``fused_ok=True``."""
    mesh = VirtualMesh((4,), ("x",), torch.device("cuda"))
    jctx = JaxCommContext("x", mesh=compat.make_mesh((4,), ("x",)),
                          hw=jcm.H100_SXM)
    for wire in (None, "int8", "int8_sr"):
        ctx = CommContext("x", mesh=mesh, wire=wire)
        assert ctx._prefer_fused()
        for op in (AG, RS, AR):
            for m, n, k in ((4096, 5632, 2048), (8192, 8192, 8192),
                            (256, 2048, 1408)):
                got = ctx.auto_gemm_backend(op, m, n, k,
                                            fused_ok=ctx._prefer_fused())
                want = jctx.auto_gemm_backend(op, m, n, k, fused_ok=True,
                                              wire=wire)
                assert got == want, (wire, op, m, n, k)
                if wire is None:
                    assert got in ("fused", "bulk")
                else:
                    assert got in ("ring", "ring_bidir", "bulk")
                    if got != "bulk":
                        sched = ctx.gemm_chunk_schedule(op, m, n, k,
                                                        backend=got,
                                                        chunk_dim="n")
                        assert sched.chunk_dim == "m"


@pytest.mark.parametrize("wire", [None, "int8", "int8_sr"])
@pytest.mark.parametrize("backend", [None, "ring", "fused"])
def test_island_plans_wire_field_match_jax(wire, backend):
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    kw = dict(fsdp=False, comm_wire=wire, comm_backend=backend,
              sp_attention="none")
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jrules = JaxRules(compat.make_mesh((2, 2), ("data", "model")), jrun)
    trules = ShardingRules(VirtualMesh((2, 2), ("data", "model")), trun)
    for phase, seq in (("prefill", 16), ("decode", 16), ("all", 32)):
        want = JL.island_plans(jcfg, jrun, jrules, batch=4, seq=seq,
                               phase=phase)
        got = L.island_plans(tcfg, trun, trules, batch=4, seq=seq,
                             phase=phase)
        assert [p.island for p in got] == [p.island for p in want]
        for a, b in zip(got, want):
            assert (a.wire, a.backend, a.n_chunks, a.chunk_dim) == \
                (b.wire, b.backend, b.n_chunks, b.chunk_dim), (phase, a, b)
    gemm = [p for p in got if p.op == "matmul_all_reduce"]
    assert gemm and all(
        p.wire == ((wire or "bf16") if p.backend == "ring" else None)
        for p in gemm)
