"""The port's ring shift and ring attention against the JAX package, in
float32 on the CPU.

* ``CommContext.ring_shift`` on pytrees: bulk against JAX's bulk
  (``lax.ppermute``), fused (the p2p kernel's plain version on CPU
  tensors) against JAX's fused backend, which runs the Pallas
  ``p2p_ring_shift`` in TPU interpret mode — bit for bit, a shift is a
  copy; ``reverse=True`` under bulk, fused refusing it with JAX's message.
* ``pk_ring_attention`` and ``ring_attention_baseline`` against JAX's
  under ``shard_map`` on (1, 2) and (1, 4): causal, window 12 and
  non-causal, as ``tests/test_sp_and_moe.py`` runs them — rtol = atol =
  1e-5 (the hops merge in another order than JAX's sequential update).
  Also non-causal with window 12, where JAX's two functions differ
  (ROADMAP C8: the ring masks causally, the baseline keeps every later
  key); the port's do the same.
* the ring attention gradient with respect to q, k and v, under the
  port's bulk and fused backends, against JAX's bulk gradient — rtol =
  atol = 1e-4; JAX's fused ring shift has no VJP (ROADMAP C7).
* ``ssm_entry_states`` against JAX's — rtol = atol = 1e-5.
* the plain flash hop at global offsets, merged into a running state,
  against JAX's ``_block_update`` under ``_causal_block_mask`` — rtol =
  atol = 1e-5; a row with nothing visible is (NEG_INF, 0, 0) exactly.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import ring_attention as JRA  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core import ring_attention as RA  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, HQ, HKV, S, D = 2, 8, 2, 32, 16
SPEC = JP(None, None, "model")
CASES = [(True, None), (True, 12), (False, None), (False, 12)]


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed=0):
    return (_np(B, HQ, S, D, seed=seed), _np(B, HKV, S, D, seed=seed + 1),
            _np(B, HKV, S, D, seed=seed + 2))


def _meshes(n):
    return (compat.make_mesh((1, n), ("data", "model")),
            VirtualMesh((1, n), ("data", "model")))


def _port(fn, n, q, k, v, backend=None, **kw):
    """The port's op on (1, n): global numpy inputs laid out stacked over
    the model axis, the result assembled back to global."""
    mesh = _meshes(n)[1]
    ctx = CommContext("model", mesh=mesh, backend=backend)
    spec = pgl.P(None, None, "model", None)
    st = [pgl.layout(t if torch.is_tensor(t) else torch.from_numpy(t), spec,
                     mesh, "model") for t in (q, k, v)]
    return pgl.assemble(fn(*st, ctx=ctx, **kw), spec, mesh, "model")


def _jax(fn, n, q, k, v, **kw):
    mesh = _meshes(n)[0]
    f = jax.jit(compat.shard_map(
        lambda q, k, v: fn(q, k, v, "model", **kw), mesh=mesh,
        in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False))
    return f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


# -- ring_shift ------------------------------------------------------------

def _tree(r):
    return {"k": _np(r, 3, 5, seed=1),
            "kv": (_np(r, 2, 7, seed=2), _np(r, 4, seed=3))}


def _jax_shift(r, tree, **kw):
    mesh = compat.make_mesh((r,), ("x",))
    backend = kw.pop("backend", None)
    if backend == "fused" and not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    ctx = JaxCommContext(axis_name="x", mesh=mesh, backend=backend)
    specs = jax.tree.map(lambda _: JP("x"), tree)
    f = jax.jit(compat.shard_map(lambda t: ctx.ring_shift(t, **kw),
                                 mesh=mesh, in_specs=(specs,),
                                 out_specs=specs, check_vma=False))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, tree)))


def _port_shift(r, tree, backend=None, **kw):
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)), backend=backend)
    out = ctx.ring_shift(
        {"k": torch.from_numpy(tree["k"]),
         "kv": tuple(torch.from_numpy(t) for t in tree["kv"])}, **kw)
    assert isinstance(out["kv"], tuple)
    return {"k": out["k"].numpy(), "kv": tuple(t.numpy() for t in out["kv"])}


def _assert_tree_equal(got, want):
    np.testing.assert_array_equal(got["k"], want["k"])
    for g, w in zip(got["kv"], want["kv"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("backend", [None, "bulk", "fused"])
def test_ring_shift_matches_jax_bit_for_bit(r, backend):
    tree = _tree(r)
    want = _jax_shift(r, tree, backend=backend)
    _assert_tree_equal(_port_shift(r, tree, backend=backend), want)
    np.testing.assert_array_equal(want["k"], np.roll(tree["k"], 1, 0))


@pytest.mark.parametrize("r", [2, 4])
def test_ring_shift_fused_matches_pallas_p2p_kernel(r):
    """The fused backend against the Pallas p2p kernel itself, in TPU
    interpret mode, as ``tests/test_pk_comm.py`` runs it."""
    if not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    from repro.kernels.pk_comm import p2p_ring_shift
    x = _np(r, 8, 16, seed=r)
    mesh = compat.make_mesh((r,), ("x",))
    f = jax.jit(compat.shard_map(lambda a: p2p_ring_shift(a[0], "x")[None],
                                 mesh=mesh, in_specs=JP("x"),
                                 out_specs=JP("x"), check_vma=False))
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)))
    got = ctx.ring_shift(torch.from_numpy(x), backend="fused")
    np.testing.assert_array_equal(got.numpy(), np.asarray(f(jnp.asarray(x))))


def test_ring_shift_reverse_and_guards():
    tree = _tree(4)
    _assert_tree_equal(_port_shift(4, tree, reverse=True),
                       _jax_shift(4, tree, reverse=True))
    ctx = CommContext("x", mesh=VirtualMesh((4,), ("x",)))
    x = torch.ones(4, 3)
    with pytest.raises(ValueError, match="sends right only"):
        ctx.ring_shift(x, reverse=True, backend="fused")
    with pytest.raises(ValueError, match="stacked"):
        ctx.ring_shift(torch.ones(3, 3))
    with pytest.raises(ValueError, match="has no backend"):
        ctx.ring_shift(x, backend="ring")
    # a run-wide pin of fused pins the kernel; one this op lacks falls back
    # to the policy (bulk), as in JAX
    for pin in ("fused", "ring"):
        got = CommContext("x", mesh=VirtualMesh((4,), ("x",)),
                          backend=pin).ring_shift(torch.arange(4.0))
        np.testing.assert_array_equal(got.numpy(), [3.0, 0.0, 1.0, 2.0])


def test_ring_shift_gradients_are_the_transposed_hop():
    ctx = CommContext("x", mesh=VirtualMesh((4,), ("x",)))
    g = torch.from_numpy(_np(4, 5, seed=7))
    for be in ("bulk", "fused"):
        x = torch.from_numpy(_np(4, 5, seed=8)).requires_grad_(True)
        (ctx.ring_shift(x, backend=be) * g).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(),
                                      np.roll(g.numpy(), -1, 0))


# -- ring attention --------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal,window", CASES)
@pytest.mark.parametrize("name", ["pk_ring_attention",
                                  "ring_attention_baseline"])
def test_sp_attention_matches_jax(n, causal, window, name):
    q, k, v = _qkv()
    want = np.asarray(_jax(getattr(JRA, name), n, q, k, v, causal=causal,
                           window=window))
    for backend in ((None, "fused") if name == "pk_ring_attention"
                    else (None,)):
        got = _port(getattr(RA, name), n, q, k, v, backend=backend,
                    causal=causal, window=window)
        assert got.shape == (B, HQ, S, D)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal,window", CASES)
def test_ring_attention_grad_matches_jax_bulk(n, causal, window):
    q, k, v = _qkv(seed=3)
    g = _np(B, HQ, S, D, seed=9)

    def jloss(q, k, v):
        out = _jax(JRA.pk_ring_attention, n, q, k, v, causal=causal,
                   window=window)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for backend in ("bulk", "fused"):
        ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
        out = _port(RA.pk_ring_attention, n, *ts, backend=backend,
                    causal=causal, window=window)
        (out * torch.from_numpy(g)).sum().backward()
        for t, w in zip(ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       **GRAD_TOL)


def test_jax_fused_ring_shift_has_no_gradient():
    """ROADMAP C7: ``jax.grad`` through JAX's fused ring shift (a Pallas
    call with DMA semaphores) fails; the port's fused shift differentiates
    as the bulk transpose, equal to JAX's bulk gradient."""
    if not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    r = 4
    x = _np(r, 3, 5, seed=11)
    g = _np(r, 3, 5, seed=12)
    mesh = compat.make_mesh((r,), ("x",))

    def jloss(backend):
        ctx = JaxCommContext(axis_name="x", mesh=mesh, backend=backend)
        f = compat.shard_map(lambda t: ctx.ring_shift(t), mesh=mesh,
                             in_specs=JP("x"), out_specs=JP("x"),
                             check_vma=False)
        return lambda t: jnp.sum(f(t) * g)

    with pytest.raises(AssertionError):
        jax.grad(jloss("fused"))(jnp.asarray(x))
    want = np.asarray(jax.grad(jloss("bulk"))(jnp.asarray(x)))
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",)), backend="fused")
    xt = torch.from_numpy(x).requires_grad_(True)
    (ctx.ring_shift(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


@pytest.mark.parametrize("n", [2, 4])
def test_noncausal_window_ring_and_baseline_differ_as_in_jax(n):
    """ROADMAP C8: non-causal with a window, JAX's ring attention masks
    causally (``_causal_block_mask`` keeps ki <= qi) and its baseline keeps
    every later key, so the two are different functions; the port keeps
    each one's semantics (held against JAX above)."""
    q, k, v = _qkv(seed=5)
    kw = dict(causal=False, window=12)
    j = [np.asarray(_jax(f, n, q, k, v, **kw))
         for f in (JRA.pk_ring_attention, JRA.ring_attention_baseline)]
    t = [_port(f, n, q, k, v, **kw).numpy()
         for f in (RA.pk_ring_attention, RA.ring_attention_baseline)]
    assert np.abs(j[0] - j[1]).max() > 0.1
    np.testing.assert_allclose(t[0] - t[1], j[0] - j[1], **TOL)


def test_ssm_entry_states_matches_jax():
    n, dm, ns = 4, 6, 5
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 0.99, (n, dm, ns)).astype(np.float32)
    sx = _np(n, dm, ns, seed=1)
    mesh = compat.make_mesh((n,), ("x",))
    f = jax.jit(compat.shard_map(
        lambda a, s: JRA.ssm_entry_states(a[0], s[0], "x")[None], mesh=mesh,
        in_specs=(JP("x"), JP("x")), out_specs=JP("x"), check_vma=False))
    want = np.asarray(f(jnp.asarray(a), jnp.asarray(sx)))
    for backend in ("bulk", "fused"):
        ctx = CommContext("x", mesh=VirtualMesh((n,), ("x",)),
                          backend=backend)
        got = RA.ssm_entry_states(torch.from_numpy(a), torch.from_numpy(sx),
                                  ctx=ctx)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(want[0], 0.0)


def test_block_update_and_mask_match_jax():
    rng = np.random.default_rng(2)
    q = _np(1, HKV, 4, 8, D, seed=1)
    k, v = _np(1, HKV, 8, D, seed=2), _np(1, HKV, 8, D, seed=3)
    m = rng.normal(size=(1, HKV, 4, 8)).astype(np.float32)
    l_ = rng.uniform(0.5, 2.0, (1, HKV, 4, 8)).astype(np.float32)
    o = _np(1, HKV, 4, 8, D, seed=4)
    for window in (None, 5):
        jm = JRA._causal_block_mask(8, 8, 16, 8, window)
        tm = RA._causal_block_mask(8, 8, 16, 8, window)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        want = JRA._block_update(*map(jnp.asarray, (q, k, v, m, l_, o)),
                                 scale=0.25, mask=jm)
        got = RA._block_update(*map(torch.from_numpy, (q, k, v, m, l_, o)),
                               scale=0.25, mask=tm)
        for g_, w in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_flash_hop_at_offsets_matches_block_update(causal, window):
    """Each of the 4 hops of 4 ranks (rank r's queries at r·8, its held
    keys from rank (r - i) % 4), merged into a finite running state,
    against JAX's ``_block_update`` on that state under
    ``_causal_block_mask``; without a mask when neither is set."""
    r, s, g = 4, 8, HQ // HKV
    q = _np(r * B, HQ, s, D, seed=5)
    k, v = _np(r * B, HKV, s, D, seed=6), _np(r * B, HKV, s, D, seed=7)
    rng = np.random.default_rng(8)
    m0 = rng.normal(size=(r * B, HQ, s)).astype(np.float32)
    l0 = rng.uniform(0.5, 2.0, (r * B, HQ, s)).astype(np.float32)
    o0 = _np(r * B, HQ, s, D, seed=9)
    masked = causal or window is not None
    for hop in range(r):
        o_i, m_i, l_i = FA.flash_attention_hop(
            *map(torch.from_numpy, (q, k, v)), ranks=r, hop=hop,
            causal=masked, window=window, scale=D ** -0.5)
        m_new = torch.maximum(torch.from_numpy(m0), m_i)
        a, a_i = torch.exp(torch.from_numpy(m0) - m_new), torch.exp(
            m_i - m_new)
        l_new = torch.from_numpy(l0) * a + l_i * a_i
        o_new = torch.from_numpy(o0) * a[..., None] + o_i * a_i[..., None]
        for rank in range(r):
            rows = slice(rank * B, (rank + 1) * B)
            src = (rank - hop) % r
            mask = (JRA._causal_block_mask(s, s, rank * s, src * s, window)
                    if masked else None)

            def grouped(t):
                return jnp.asarray(t[rows].reshape(B, HKV, g, *t.shape[2:]))

            wm, wl, wo = JRA._block_update(
                grouped(q), jnp.asarray(k[rows]), jnp.asarray(v[rows]),
                grouped(m0), grouped(l0), grouped(o0), scale=D ** -0.5,
                mask=mask)
            for got, want in ((m_new, wm), (l_new, wl), (o_new, wo)):
                np.testing.assert_allclose(
                    got[rows].numpy(), np.asarray(want).reshape(
                        got[rows].shape), **TOL)
            if mask is not None and not bool(np.asarray(mask).any()):
                assert bool((m_i[rows] == FA.NEG_INF).all())
                assert not bool(l_i[rows].any() or o_i[rows].any())
