"""The bf16 SSM scan (``RunConfig.ssm_scan_dtype="bfloat16"``, ROADMAP
A10e) against the JAX package on the CPU.

JAX's ``selective_scan_chunked(scan_dtype=bfloat16)`` is XLA, not Pallas:
``a_bar``, ``bx`` and the ``h·c`` operands rounded to bf16, the affine
composition scanned in bf16 by ``lax.associative_scan``, the carry in f32.
The port runs the same terms in plain torch, with a copy of
``associative_scan``'s odd/even recursion.

The parity rule: on the same inputs the bf16 terms agree bit for bit
(``associative_scan`` on a rounding combine, and the scanned state
``h``), and ``y`` within rtol 1e-6 — its Σ_n of exact bf16 products is an
f32 sum that XLA orders otherwise, and XLA may fuse the carry's multiply
and add, so the scan is not bit-exact on the CPU. Through a model
(falcon-mamba and jamba reduced, f32 weights) the scan's inputs come out
of GEMMs that torch and XLA sum in other orders, so a term may round to
the neighbouring bf16 value: there the logits and the loss are held
within 2e-2 absolute (bf16's relative step is 2^-8 = 3.9e-3), and the
gradients within 2e-2 absolute.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

import torch_parity as TP  # noqa: E402

torch.set_num_threads(1)


def _inputs(b, s, di, n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((b, s, di)) * 0.1).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, di)).astype(np.float32),
            -np.exp(rng.standard_normal((di, n))).astype(np.float32),
            rng.standard_normal((di,)).astype(np.float32),
            np.zeros((b, di, n), np.float32))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_associative_scan_rounds_like_jax(n):
    """A bf16 affine composition scanned by both recursions: bit for bit."""
    rng = np.random.default_rng(n)
    a = rng.random((2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)

    def comb(u, v):
        return (u[0] * v[0], v[0] * u[1] + v[1])

    ja, jb = jax.jit(lambda x, y: lax.associative_scan(
        comb, (x.astype(jnp.bfloat16), y.astype(jnp.bfloat16)), axis=1))(
            a, b)
    ta, tb = TS.associative_scan(
        comb, (torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()),
        1)
    np.testing.assert_array_equal(ta.float().numpy(),
                                  np.asarray(ja.astype(jnp.float32)))
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))


@pytest.mark.parametrize("shape,chunk,dtype", [
    ((2, 16, 8, 4), 8, "float32"), ((2, 13, 8, 4), 8, "float32"),
    ((1, 32, 16, 4), 32, "bfloat16"), ((2, 24, 8, 4), 8, "bfloat16")])
def test_bf16_scan_matches_jax(shape, chunk, dtype):
    dt, bb, cc, x, a, d, h0 = _inputs(*shape, seed=sum(shape))
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jy, jh = jax.jit(lambda *z: JS.selective_scan_chunked(
        *z, chunk=chunk, scan_dtype=jnp.bfloat16))(
        *(jnp.asarray(v, jd) for v in (dt, bb, cc, x)), a, d, h0)
    ty, th = TS.selective_scan_chunked_bf16(
        *(torch.from_numpy(v).to(td) for v in (dt, bb, cc, x)),
        torch.from_numpy(a), torch.from_numpy(d), torch.from_numpy(h0),
        chunk=chunk)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-6 * np.abs(jy).max())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_bf16_scan_model_matches_jax(arch):
    """forward_prefill logits and forward_train loss and gradients with the
    bf16 scan, no mesh and on (1, 4), against JAX's."""
    for mesh in (None, (1, 4)):
        j, t = TP.both(arch, mesh, ssm_scan_dtype="bfloat16")
        bt = TP.batch(3)
        jl = jax.jit(lambda p, x: JT.forward_prefill(
            p, x, j["cfg"], j["run"], j["rules"]))(
                j["params"], {"tokens": jnp.asarray(bt["tokens"])})
        with torch.no_grad():
            tl = T.forward_prefill(t["params"],
                                   {"tokens": torch.from_numpy(bt["tokens"])},
                                   t["cfg"], t["run"], t["rules"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2,
                                   rtol=0)
        TP.assert_matches(j, t, bt, atol_loss=2e-2, atol_grad=2e-2)


def test_bf16_scan_differs_from_f32():
    """The setting is read: the bf16 scan is not the f32 kernel's result."""
    dt, bb, cc, x, a, d, h0 = (torch.from_numpy(v)
                               for v in _inputs(2, 16, 8, 4, seed=7))
    y16, _ = TS.selective_scan_chunked_bf16(dt, bb, cc, x, a, d, h0, chunk=8)
    y32, _ = TS.selective_scan_chunked(dt, bb, cc, x, a, d, h0, chunk=8)
    assert not torch.equal(y16, y32)
    torch.testing.assert_close(y16, y32, atol=5e-2, rtol=5e-2)
