"""The grouped GEMM's gradients in bf16 against ``jax.vjp``, bit for bit.

The MoE path calls ``grouped_matmul(x, w, out_dtype=torch.float32)`` with
bf16 operands, as the JAX model's ``_expert_ffn`` computes
``einsum("gck,gkn->gcn", x, w, preferred_element_type=f32)``. JAX's VJP
of that einsum takes its products from the f32 cotangent and rounds only
the results to x's and w's dtypes; the port's backward must do the same.
Inputs are numpy-seeded; the comparison is exact (``np.array_equal``) on
the CPU, where both sides take one f32 product per element and round it
once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import grouped_matmul as GM  # noqa: E402

torch.set_num_threads(1)


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16(a: np.ndarray):
    """The same bf16 values for both packages: (torch tensor, jax array)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _as_np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("broadcast", [False, True])
def test_grouped_matmul_bf16_grads_equal_jax_vjp(broadcast):
    """bf16 x (4, 8, 64) — or one (8, 64) slab broadcast to the 4 groups,
    the group-stride-0 operand the wrapper takes — w (4, 64, 32), an f32
    cotangent: dx and dw equal JAX's bit for bit."""
    g, c, k, n = 4, 8, 64, 32
    tx, jx = _bf16(_np(1 if broadcast else g, c, k, seed=0))
    tw, jw = _bf16(_np(g, k, n, seed=1) * k ** -0.5)
    gy = _np(g, c, n, seed=2)
    if broadcast:
        tx = tx.expand(g, c, k)
        jx = jnp.broadcast_to(jx, (g, c, k))
        assert tx.stride(0) == 0
    tx = tx.detach().requires_grad_(True)
    tw = tw.detach().requires_grad_(True)

    out = GM.grouped_matmul(tx, tw, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(gy))

    def f(x, w):
        return jnp.einsum("gck,gkn->gcn", x, w,
                          preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(f, jx, jw)
    jdx, jdw = vjp(jnp.asarray(gy))
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert jdx.dtype == jdw.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(_as_np(dx), _as_np(jdx))
    assert np.array_equal(_as_np(dw), _as_np(jdw))
