"""The plain versions of the port's three kernels against the JAX package.

Inputs come from numpy (``default_rng``) and go through both packages in
float32 on the CPU: the JAX side through its oracles (``kernels/ref.py``),
the Pallas wrappers in interpret mode where they run (``ops.matmul``,
``ops.flash_attention``), and the ``bulk``/``ring`` GEMM+AR backends under
``shard_map`` on the emulated mesh — not the Pallas GEMM+AR kernel, which
cannot run (ROADMAP C1). Tolerance rtol = atol = 1e-5: the same sums,
taken in another order.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.core.comms import CommContext as JaxCommContext  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import collective_matmul as CM  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (37, 50, 29), (130, 64, 200)])
def test_matmul_plain_matches_jax(m, k, n):
    x, w = _np(m, k, seed=1), _np(k, n, seed=2)
    got = MM.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.matmul_ref(x, w)),
                               **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.matmul(x, w, interpret=True)), **TOL)
    np.testing.assert_allclose(
        tref.matmul_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        got.numpy(), **TOL)


@pytest.mark.parametrize("hq,hkv,s,causal,window", [
    (4, 4, 64, True, None),      # MHA, causal
    (4, 2, 50, True, 16),        # GQA, sliding window, ragged S
    (4, 1, 64, False, None),     # MQA, full attention
    (8, 2, 37, True, None),      # GQA, ragged S
])
def test_flash_attention_plain_matches_jax(hq, hkv, s, causal, window):
    b, hd = 2, 16
    q, k, v = _np(b, hq, s, hd, seed=1), _np(b, hkv, s, hd, seed=2), \
        _np(b, hkv, s, hd, seed=3)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    # the XLA mix of the model (GQA grouped, no repeat)
    want = JL._full_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the kernel oracle, on repeated KV heads
    kr, vr = np.repeat(k, hq // hkv, 1), np.repeat(v, hq // hkv, 1)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(q, kr, vr, causal=causal,
                                                 window=window)), **TOL)
    np.testing.assert_allclose(
        tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(kr),
                                 torch.from_numpy(vr), causal=causal,
                                 window=window).numpy(), got, **TOL)


def test_flash_attention_plain_matches_pallas_interpret():
    """GQA + ragged S through the Pallas wrapper in interpret mode."""
    b, hq, hkv, s, hd = 1, 4, 2, 40, 16
    q, k, v = _np(b, hq, s, hd, seed=4), _np(b, hkv, s, hd, seed=5), \
        _np(b, hkv, s, hd, seed=6)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True).numpy()
    want = jops.flash_attention(q, k, v, causal=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _jax_matmul_ar(r, backend, n_chunks, x, w):
    mesh = compat.make_mesh((r,), ("x",))
    ctx = JaxCommContext(axis_name="x", mesh=mesh)
    f = compat.shard_map(
        partial(ctx.matmul_all_reduce, backend=backend, n_chunks=n_chunks),
        mesh=mesh, in_specs=(JP(None, "x"), JP("x", None)),
        out_specs=JP(), check_vma=False)
    return np.asarray(jax.jit(f)(x, w))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("n_chunks", [1, 2])
def test_pk_matmul_ar_plain_matches_jax(r, n_chunks):
    m, k_loc, n = 8, 12, 16
    x, w = _np(m, r * k_loc, seed=r), _np(r * k_loc, n, seed=10 + r)
    # the PGL layout: rank r holds K-shard r of x's columns and w's rows
    xs = torch.from_numpy(x).reshape(m, r, k_loc).permute(1, 0, 2)
    ws = torch.from_numpy(w).reshape(r, k_loc, n)
    got = tops.pk_matmul_ar(xs, ws, n_chunks=n_chunks)
    assert got.shape == (r, m, n) and got.dtype == torch.float32
    got = got.numpy()
    for rank in range(1, r):        # every rank holds the same result
        np.testing.assert_array_equal(got[rank], got[0])
    np.testing.assert_allclose(got[0], np.asarray(jref.matmul_ar_ref(x, w)),
                               **TOL)
    np.testing.assert_allclose(
        tref.matmul_ar_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        got[0], **TOL)
    for backend in ("bulk", "ring"):
        np.testing.assert_allclose(
            got[0], _jax_matmul_ar(r, backend, n_chunks, x, w), **TOL)


def test_kernel_wrappers_validate_inputs():
    with pytest.raises(ValueError, match="divisible"):
        CM.matmul_ar_fused(torch.zeros(4, 6, 8), torch.zeros(4, 8, 8))
    with pytest.raises(ValueError, match="n_chunks"):
        CM.matmul_ar_fused(torch.zeros(2, 4, 8), torch.zeros(2, 8, 8),
                           n_chunks=0)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FA.flash_attention(torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8),
                           torch.zeros(1, 2, 4, 8))
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        MM.matmul(torch.zeros(2, 3), torch.zeros(4, 5))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors no kernel launches: the counters stay put."""
    before = (MM.matmul.launches, FA.flash_attention.launches,
              CM.matmul_ar_fused.launches)
    MM.matmul(torch.ones(2, 2), torch.ones(2, 2))
    FA.flash_attention(torch.ones(1, 2, 3, 4), torch.ones(1, 1, 3, 4),
                       torch.ones(1, 1, 3, 4))
    CM.matmul_ar_fused(torch.ones(2, 2, 4), torch.ones(2, 4, 4))
    assert (MM.matmul.launches, FA.flash_attention.launches,
            CM.matmul_ar_fused.launches) == before
