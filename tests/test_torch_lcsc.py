"""The port's ring all-gather on the LCSC template against the JAX package.

``repro_torch/kernels/lcsc.py::lcsc_ring_all_gather`` on CPU tensors runs
its plain version; it is held bit for bit against the Pallas
``repro/kernels/lcsc.py::lcsc_ring_all_gather`` (the template's demo) in TPU
interpret mode under ``shard_map`` on R in {2, 4} emulated devices, and
against the port's ring all-gather of ``pk_comm.py`` (a copy is exact).
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.kernels import lcsc as jlcsc  # noqa: E402
from repro_torch.kernels import lcsc as LC  # noqa: E402
from repro_torch.kernels import pk_comm as PK  # noqa: E402


def _pallas(r, x):
    if not compat.tpu_kernels_supported():
        pytest.skip("this JAX has no TPU interpret mode for the kernels")
    mesh = compat.make_mesh((r,), ("x",))
    f = jax.jit(compat.shard_map(
        lambda a: jlcsc.lcsc_ring_all_gather(a[0], "x")[None], mesh=mesh,
        in_specs=JP("x"), out_specs=JP("x"), check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("shape,dtype", [((8, 16), np.float32),
                                         ((3, 5, 7), np.float32),
                                         ((6, 10), np.int32)])
def test_lcsc_plain_matches_pallas_kernel(r, shape, dtype):
    rng = np.random.default_rng(r)
    x = (rng.standard_normal((r, *shape)) * 100).astype(dtype)
    before = LC.lcsc_ring_all_gather.launches
    got = LC.lcsc_ring_all_gather(torch.from_numpy(x))
    assert got.shape == (r, r, *shape)
    np.testing.assert_array_equal(got.numpy(), _pallas(r, x))
    assert torch.equal(got, PK.ring_all_gather(torch.from_numpy(x)))
    assert LC.lcsc_ring_all_gather.launches == before   # no kernel on cpu


def test_lcsc_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        LC.lcsc_ring_all_gather(torch.empty(2, 4, device="meta"))
    with pytest.raises(ValueError, match="stacked"):
        LC.lcsc_ring_all_gather(torch.tensor(1.0))
