"""The port's Ulysses attention (``core/ulysses.py``) and a2a-dispatch MoE
(``core/moe.py::pk_moe_a2a``) against the JAX package on the CPU, in
float32.

* ``pk_ulysses_attention`` (1 and 2 all-to-all chunks) and
  ``ulysses_attention_baseline`` against JAX's under ``shard_map`` at
  ``test_sp_and_moe.py``'s shapes (B 2, Hq 8, Hkv 2, S 32, D 16) on 2 and 4
  ranks — 4 ranks repeat the 2 KV heads (GQA) — causal with and without a
  window of 12, and non-causal with and without it (with a window JAX's
  mask is causal as well): outputs and the gradients of q, k and v against
  ``jax.grad`` within 1e-5 (the same sums; softmax and products in another
  order);
* ``pk_moe_a2a`` on (4,) at ``test_sp_and_moe.py``'s MoE shapes (T 8 a
  rank, d 16, ff 24, 8 experts top-2): output and each rank's aux loss
  within 1e-5 of JAX's, bulk and 2 capacity chunks; the capacity selection
  index for index; with a capacity that covers every token, the dense
  oracle.
"""

from functools import partial
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import ulysses as jul  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro_torch.core import moe  # noqa: E402
from repro_torch.core import ulysses  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.kernels import pk_comm as PK  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _shard_seq(t, r):
    """(B, H, S, D) -> stacked (R, B, H, S/R, D), the sequence sharded."""
    b, h, s, d = t.shape
    return t.reshape(b, h, r, s // r, d).permute(2, 0, 1, 3, 4)


def _unshard_seq(t):
    r, b, h, s_loc, d = t.shape
    return t.permute(1, 2, 0, 3, 4).reshape(b, h, r * s_loc, d)


@pytest.mark.parametrize("fn", ["pk1", "pk2", "baseline"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None), (False, 12)])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_attention_matches_jax(n, causal, window, fn):
    b, hq, hkv, s, d = 2, 8, 2, 32, 16
    q, k, v = _np(b, hq, s, d, seed=0), _np(b, hkv, s, d, seed=1), \
        _np(b, hkv, s, d, seed=2)
    w = _np(b, hq, s, d, seed=3)
    chunks = {"pk1": 1, "pk2": 2, "baseline": None}[fn]
    jmesh = compat.make_mesh((n,), ("x",))
    jctx = JaxCommContext(axis_name="x", mesh=jmesh)
    jfn = jul.ulysses_attention_baseline if chunks is None else partial(
        jul.pk_ulysses_attention, n_chunks=chunks, ctx=jctx)
    spec = JP(None, None, "x")
    f = compat.shard_map(
        lambda q, k, v: jfn(q, k, v, "x", causal=causal, window=window),
        mesh=jmesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(f)(q, k, v))
    want_g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                              argnums=(0, 1, 2)))(q, k, v)

    ctx = CommContext("x", mesh=VirtualMesh((n,), ("x",)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    kw = dict(ctx=ctx, causal=causal, window=window)
    with mock.patch.object(PK, "all_to_all", wraps=PK.all_to_all) as kern:
        if chunks is None:
            out = ulysses.ulysses_attention_baseline(
                *(_shard_seq(t, n) for t in (tq, tk, tv)), **kw)
        else:
            out = ulysses.pk_ulysses_attention(
                *(_shard_seq(t, n) for t in (tq, tk, tv)), n_chunks=chunks,
                **kw)
        got = _unshard_seq(out)
        (got * torch.from_numpy(w)).sum().backward()
    # 4 all-to-alls forward, 4 backward, chunked (the kernel's wrapper)
    # only when asked
    assert kern.call_count == (8 if chunks == 2 else 0)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for t, g in zip((tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_ulysses_guards_and_kv_repeat():
    ctx = CommContext("x", mesh=VirtualMesh((4,), ("x",)))
    q = torch.ones(4, 1, 6, 2, 8)
    with pytest.raises(ValueError, match="6 heads do not split over 4"):
        ulysses.pk_ulysses_attention(q, q[:, :, :2], q[:, :, :2], ctx=ctx)
    k = torch.arange(3.0).view(1, 1, 3, 1, 1).expand(4, 1, 3, 2, 1)
    with pytest.raises(ValueError, match="3 KV heads do not repeat to 4"):
        ulysses._repeat_kv_to(k, 4)
    k2 = torch.arange(2.0).view(1, 1, 2, 1, 1).expand(4, 1, 2, 2, 1)
    assert ulysses._repeat_kv_to(k2, 4)[0, 0, :, 0, 0].tolist() == \
        [0.0, 0.0, 1.0, 1.0]
    assert ulysses._repeat_kv_to(k2, 2) is k2


# ---------------------------------------------------------------------------
# a2a-dispatch MoE
# ---------------------------------------------------------------------------

MOE = dict(t=32, d=16, ff=24, e=8, k=2)


def _moe_inputs(n):
    t, d, ff, e = MOE["t"], MOE["d"], MOE["ff"], MOE["e"]
    return (_np(t, d, seed=0), _np(d, e, seed=4), _np(e, d, ff, seed=5,
                                                      scale=0.1),
            _np(e, d, ff, seed=6, scale=0.1), _np(e, ff, d, seed=7,
                                                   scale=0.1))


def _jax_moe_a2a(n, cap, n_chunks, x, wr, w1, w3, w2):
    e = MOE["e"]
    mesh = compat.make_mesh((n,), ("x",))

    def dm(w):
        return w.reshape(n, e // n, *w.shape[1:])
    f = compat.shard_map(
        lambda x, wr, a, b, c: (lambda y, aux: (y, aux[None]))(
            *jmoe.pk_moe_a2a(x, wr, a[0], b[0], c[0], axis_name="x",
                             n_experts=e, top_k=MOE["k"],
                             capacity_factor=cap, n_chunks=n_chunks)),
        mesh=mesh, in_specs=(JP("x"), JP(), JP("x"), JP("x"), JP("x")),
        out_specs=(JP("x"), JP("x")), check_vma=False)
    y, aux = jax.jit(f)(x, wr, dm(w1), dm(w3), dm(w2))
    return np.asarray(y), np.asarray(aux)


def _port_moe_a2a(n, cap, n_chunks, x, wr, w1, w3, w2):
    e, t = MOE["e"], MOE["t"]

    def dm(w):
        return torch.from_numpy(w.reshape(n, e // n, *w.shape[1:]))
    ctx = CommContext("x", mesh=VirtualMesh((n,), ("x",)))
    xs = torch.from_numpy(x).view(n, t // n, -1)
    wrs = torch.from_numpy(wr).expand(n, *wr.shape)
    y, aux = moe.pk_moe_a2a(xs, wrs, dm(w1), dm(w3), dm(w2), ctx=ctx,
                            n_experts=e, top_k=MOE["k"],
                            capacity_factor=cap, n_chunks=n_chunks)
    return y.reshape(t, -1).numpy(), aux.numpy()


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_pk_moe_a2a_matches_jax(n_chunks):
    """capacity_factor 2.0 (capacity 4 of 8 tokens a rank: 2 chunks of 2,
    tokens dropped), as JAX's ``test_moe_a2a_chunked_matches_bulk``."""
    n = 4
    args = _moe_inputs(n)
    want_y, want_aux = _jax_moe_a2a(n, 2.0, n_chunks, *args)
    with mock.patch.object(moe, "topk_stable",
                           wraps=moe.topk_stable) as topk:
        got_y, got_aux = _port_moe_a2a(n, 2.0, n_chunks, *args)
    np.testing.assert_allclose(got_y, want_y, **TOL)
    np.testing.assert_allclose(got_aux, want_aux, **TOL)
    # the capacity selection, rank by rank, index for index
    plan = jmoe.dispatch_plan(MOE["t"] // n, n_experts=MOE["e"],
                              top_k=MOE["k"], capacity_factor=2.0,
                              n_chunks=n_chunks)
    assert plan.n_chunks == n_chunks
    sel = [c for c in topk.call_args_list if c.args[1] == plan.cap]
    assert len(sel) == 1
    _, got_idx = moe.topk_stable(*sel[0].args)
    x, wr = args[0], args[1]
    for rank in range(n):
        xr = jnp.asarray(x.reshape(n, MOE["t"] // n, -1)[rank])
        r = jmoe.route(xr, jnp.asarray(wr), top_k=MOE["k"])
        gates = jmoe._local_gates(r, 0, MOE["e"])
        _, want_idx = lax.top_k(gates, plan.cap)
        np.testing.assert_array_equal(got_idx[rank].numpy(),
                                      np.asarray(want_idx))


def test_pk_moe_a2a_covers_every_token_like_the_dense_oracle():
    """Capacity factor E / k: nothing drops, so the a2a dispatch is the
    dense oracle's function (``test_moe_vs_dense_oracle``), 1 or 2 chunks
    (only the scatter order differs); the guard on the expert split."""
    n = 4
    x, wr, w1, w3, w2 = _moe_inputs(n)
    cap = MOE["e"] / MOE["k"]
    want, _ = moe.moe_reference_dense(
        torch.from_numpy(x), torch.from_numpy(wr), torch.from_numpy(w1),
        torch.from_numpy(w3), torch.from_numpy(w2), n_experts=MOE["e"],
        top_k=MOE["k"])
    for n_chunks in (1, 2):
        got, _ = _port_moe_a2a(n, cap, n_chunks, x, wr, w1, w3, w2)
        np.testing.assert_allclose(got, want.numpy(), **TOL)
    ctx = CommContext("x", mesh=VirtualMesh((n,), ("x",)))
    with pytest.raises(ValueError, match="8 experts over 4 ranks"):
        moe.pk_moe_a2a(torch.ones(n, 2, 16), torch.ones(n, 16, 8),
                       torch.ones(n, 3, 16, 24), None,
                       torch.ones(n, 3, 24, 16), ctx=ctx, n_experts=8,
                       top_k=2)
