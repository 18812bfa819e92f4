"""The port's MoE core and grouped GEMM against the JAX package.

Inputs come from numpy and go through both packages on the CPU: the
grouped GEMM's plain version against ``ref.grouped_matmul_ref`` and the
Pallas kernel in interpret mode; routing, capacity, gates and the aux loss
against ``repro.core.moe``; ``pk_moe_replicated`` on the port's stacked
virtual ranks against the JAX function under ``shard_map`` on the same
(1, R) mesh of emulated devices. Tolerances: 1e-5 (rtol and atol) in
float32 — the same sums, taken in another order; one bf16 rounding (rtol
1e-2) where the output is bf16. Index results (top-k, capacity
selection) and the pure layout permutations are compared exactly.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import moe_layout as jlayout  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import moe_layout  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.kernels import grouped_matmul as GM  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# grouped GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 3, 60])
@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_matmul_plain_matches_jax(c, bf16):
    """(E, C, d) @ (E, d, f) at ragged C: the plain version against the JAX
    oracle and the Pallas kernel (interpret mode, padded to its tiles by
    ``ops.grouped_matmul``), in the input dtype and in f32."""
    e, d, f = 4, 48, 40
    x, w = _np(e, c, d, seed=1), _np(e, d, f, seed=2, scale=d ** -0.5)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    tol = dict(rtol=1e-2, atol=1e-2) if bf16 else TOL
    got = GM.grouped_matmul(tx, tw)
    assert got.dtype == tdt and got.shape == (e, c, f)
    for want in (jref.grouped_matmul_ref(jx, jw),
                 jops.grouped_matmul(jx, jw, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    # the f32 output of _expert_ffn's einsums (preferred_element_type=f32)
    got32 = GM.grouped_matmul(tx, tw, out_dtype=torch.float32)
    want32 = jnp.einsum("ecd,edf->ecf", jx, jw,
                        preferred_element_type=jnp.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), **TOL)


def test_grouped_matmul_guards_and_backward():
    with pytest.raises(ValueError, match="grouped_matmul takes"):
        GM.grouped_matmul(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5))
    with pytest.raises(ValueError, match="grouped_matmul takes"):
        GM.grouped_matmul(torch.zeros(2, 3, 4), torch.zeros(2, 5, 5))
    x = torch.from_numpy(_np(3, 5, 8, seed=3)).requires_grad_(True)
    w = torch.from_numpy(_np(3, 8, 6, seed=4)).requires_grad_(True)
    gy = torch.from_numpy(_np(3, 5, 6, seed=5))
    dx, dw = torch.autograd.grad(GM.grouped_matmul(x, w), (x, w), gy)
    want = torch.autograd.grad(torch.bmm(x, w), (x, w), gy)
    for a, b in zip((dx, dw), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# routing, capacity, gates, aux loss
# ---------------------------------------------------------------------------

def test_dispatch_plan_and_capacity_match_jax():
    for n_tok in (1, 8, 37, 512, 2048):
        for e, k, cf in ((64, 6, 1.25), (4, 2, 1.25), (8, 2, 4.0)):
            assert moe.capacity(n_tok, e, k, cf) == \
                jmoe.capacity(n_tok, e, k, cf)
            for nc in (1, 2, 3, 4):
                got = moe.dispatch_plan(n_tok, n_experts=e, top_k=k,
                                        capacity_factor=cf, n_chunks=nc)
                want = jmoe.dispatch_plan(n_tok, n_experts=e, top_k=k,
                                          capacity_factor=cf, n_chunks=nc)
                assert tuple(got) == tuple(want)
    for e, m in ((64, 4), (4, 8), (8, 16), (8, 1), (6, 4)):
        assert moe.ep_tp_split(e, m) == jmoe.ep_tp_split(e, m)
    # the full-width moonshot split on (1, 4): 16 experts per rank, full ff
    assert moe.ep_tp_split(64, 4) == (4, 1)
    assert moe.dispatch_plan(8, n_experts=64, top_k=6,
                             capacity_factor=1.25).cap == 1
    assert moe.dispatch_plan(4 * 512, n_experts=64, top_k=6,
                             capacity_factor=1.25).cap == 240


@pytest.mark.parametrize("row", [
    [0.2, .5, .5, 0, .5, 0, 0, .1],
    [0.0] * 4096,
    [0.0, 0.3, 0.0, 0.3] * 1024,
])
def test_topk_breaks_ties_like_lax(row):
    """Tied values come out lowest index first, as ``lax.top_k`` gives them
    (``torch.topk`` does not)."""
    x = np.asarray(row, np.float32)
    if len(row) == 4096 and not x.any():
        x[[0, 3, 6, 9, 12]] = 0.25
    for k in (1, 4, 5):
        wv, wi = lax.top_k(jnp.asarray(x), k)
        gv, gi = moe.topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _router_inputs(t=24, d=16, e=8, seed=0, dup=True):
    x = _np(t, d, seed=seed)
    if dup:                       # duplicate tokens: tied gates in capacity
        x[t // 2:] = x[:t - t // 2]
    return x, _np(d, e, seed=seed + 1)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_route_gates_aux_and_capacity_select_match_jax(norm_topk):
    x, wr = _router_inputs()
    e, k = 8, 2
    jr = jmoe.route(jnp.asarray(x), jnp.asarray(wr), top_k=k,
                    norm_topk=norm_topk)
    tr = moe.route(torch.from_numpy(x), torch.from_numpy(wr), top_k=k,
                   norm_topk=norm_topk)
    np.testing.assert_allclose(tr.probs.numpy(), np.asarray(jr.probs), **TOL)
    np.testing.assert_allclose(tr.top_vals.numpy(), np.asarray(jr.top_vals),
                               **TOL)
    np.testing.assert_array_equal(tr.top_idx.numpy(), np.asarray(jr.top_idx))
    np.testing.assert_allclose(float(moe.aux_load_balance_loss(tr, e)),
                               float(jmoe.aux_load_balance_loss(jr, e)),
                               **TOL)
    for e0, e_loc in ((0, 8), (2, 2), (6, 2)):
        jg = jmoe._local_gates(jr, e0, e_loc)
        tg = moe._local_gates(tr, e0, e_loc)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
        cap = moe.dispatch_plan(x.shape[0], n_experts=e, top_k=k,
                                capacity_factor=1.25).cap
        _, jidx = lax.top_k(jg, cap)
        _, tidx = moe.topk_stable(tg, cap)
        # the duplicated tokens tie: JAX's selection, index for index
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # per-rank first experts give each rank's gates at once
    tg = moe._local_gates(tr, torch.tensor([0, 2, 4, 6]), 2)
    for r in range(4):
        np.testing.assert_allclose(
            tg[r].numpy(), np.asarray(jmoe._local_gates(jr, 2 * r, 2)),
            **TOL)


def test_local_gates_bit_identical_on_integer_inputs():
    rng = np.random.default_rng(7)
    t, k, e = 40, 3, 8
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    vals = rng.integers(-5, 6, (t, k)).astype(np.float32)
    probs = rng.integers(0, 4, (t, e)).astype(np.float32)
    jr = jmoe.RouterOut(jnp.asarray(probs), jnp.asarray(vals),
                        jnp.asarray(idx))
    tr = moe.RouterOut(torch.from_numpy(probs), torch.from_numpy(vals),
                       torch.from_numpy(idx).long())
    for e0, e_loc in ((0, 8), (4, 4), (3, 2)):
        np.testing.assert_array_equal(
            moe._local_gates(tr, e0, e_loc).numpy(),
            np.asarray(jmoe._local_gates(jr, e0, e_loc)))
    np.testing.assert_array_equal(
        float(moe.aux_load_balance_loss(tr, e)),
        float(jmoe.aux_load_balance_loss(jr, e)))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,m", [(4, 1), (4, 2), (4, 4), (4, 8), (8, 4),
                                 (2, 8)])
def test_moe_layout_round_trip_matches_jax(e, m):
    d, ff = 6, 16
    w1 = _np(e, d, ff, seed=1)
    w2 = _np(e, ff, d, seed=2)
    for w, is_w2 in ((w1, False), (w2, True)):
        dm = moe_layout.logical_to_dm(w, m, w2=is_w2)
        np.testing.assert_array_equal(
            dm, jlayout.logical_to_dm(w, m, w2=is_w2))
        back = moe_layout.dm_to_logical(dm, e, w2=is_w2)
        np.testing.assert_array_equal(back, w)
        np.testing.assert_array_equal(
            back, jlayout.dm_to_logical(dm, e, w2=is_w2))
    # integer-valued weights survive both directions bit for bit
    wi = np.arange(e * d * ff, dtype=np.float32).reshape(e, d, ff)
    np.testing.assert_array_equal(
        moe_layout.dm_to_logical(moe_layout.logical_to_dm(wi, m), e), wi)
    with pytest.raises(ValueError, match="device-major"):
        moe_layout.dm_to_logical(np.zeros((m, e + 1, d, ff), np.float32), e)


# ---------------------------------------------------------------------------
# the MoE function
# ---------------------------------------------------------------------------

E, K, D, FF, T_TOK = 4, 2, 16, 24, 32


def _moe_weights(seed=3):
    return (_np(E, D, FF, seed=seed, scale=0.3),
            _np(E, D, FF, seed=seed + 1, scale=0.3),
            _np(E, FF, D, seed=seed + 2, scale=0.3))


def test_moe_reference_dense_matches_jax():
    x, wr = _router_inputs(t=T_TOK, d=D, e=E, seed=5)
    w1, w3, w2 = _moe_weights()
    want, jaux = jmoe.moe_reference_dense(
        jnp.asarray(x), jnp.asarray(wr), jnp.asarray(w1), jnp.asarray(w3),
        jnp.asarray(w2), n_experts=E, top_k=K)
    got, aux = moe.moe_reference_dense(
        torch.from_numpy(x), torch.from_numpy(wr), torch.from_numpy(w1),
        torch.from_numpy(w3), torch.from_numpy(w2), n_experts=E, top_k=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_pk_moe_replicated_matches_jax(r, ring, n_chunks):
    """EP on (1, 2) and (1, 4), EP×TP on (1, 8) (tp_ff = 2): the port's
    body over R stacked ranks against the JAX function under shard_map,
    bulk and ring combine, 1 and 2 capacity chunks (cap 20)."""
    x, wr = _router_inputs(t=T_TOK, d=D, e=E, seed=6)
    w1, w3, w2 = _moe_weights()
    dm = [moe_layout.logical_to_dm(w, r, w2=i == 2)
          for i, w in enumerate((w1, w3, w2))]
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, n_chunks=n_chunks,
              ring_combine=ring)
    assert moe.dispatch_plan(T_TOK, n_experts=E, top_k=K,
                             capacity_factor=1.25,
                             n_chunks=n_chunks).n_chunks == n_chunks
    mesh = compat.make_mesh((1, r), ("data", "model"))
    f = jax.jit(compat.shard_map(
        lambda x, wr, a, b, c: tuple(
            v[None] for v in jmoe.pk_moe_replicated(
                x, wr, a[0], b[0], c[0], axis_name="model", **kw)),
        mesh=mesh, in_specs=(JP(), JP(), JP("model"), JP("model"),
                             JP("model")),
        out_specs=(JP("model"), JP("model")), check_vma=False))
    jy, jaux = f(x, wr, *dm)
    ctx = CommContext(axis_name="model",
                      mesh=VirtualMesh((1, r), ("data", "model")))
    ty, taux = moe.pk_moe_replicated(
        torch.from_numpy(x).expand(r, *x.shape),
        torch.from_numpy(wr).expand(r, *wr.shape),
        *(torch.from_numpy(w) for w in dm), ctx=ctx, **kw)
    assert ty.shape == (r, T_TOK, D)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(np.full(r, float(taux)), np.asarray(jaux),
                               **TOL)


def test_pk_moe_replicated_chunks_and_dense_oracle():
    """With a capacity that covers every token the replicated dispatch is
    the dense oracle; chunking the capacity loop changes nothing."""
    x, wr = _router_inputs(t=T_TOK, d=D, e=E, seed=8, dup=False)
    w1, w3, w2 = _moe_weights(seed=9)
    want, _ = moe.moe_reference_dense(
        *(torch.from_numpy(a) for a in (x, wr, w1, w3, w2)), n_experts=E,
        top_k=K)
    ctx = CommContext(axis_name="model",
                      mesh=VirtualMesh((1, 4), ("data", "model")))
    dm = [torch.from_numpy(moe_layout.logical_to_dm(w, 4, w2=i == 2))
          for i, w in enumerate((w1, w3, w2))]
    outs = []
    for nc in (1, 2, 4):
        y, _ = moe.pk_moe_replicated(
            torch.from_numpy(x).expand(4, *x.shape),
            torch.from_numpy(wr).expand(4, *wr.shape), *dm, ctx=ctx,
            n_experts=E, top_k=K, capacity_factor=float(E) / K, n_chunks=nc)
        outs.append(y[0])
    for y in outs:
        np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="experts per rank"):
        moe.pk_moe_replicated(
            torch.from_numpy(x).expand(4, *x.shape),
            torch.from_numpy(wr).expand(4, *wr.shape), *dm, ctx=ctx,
            n_experts=2 * E, top_k=K)
