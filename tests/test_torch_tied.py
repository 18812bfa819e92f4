"""Tied embeddings on a mesh against the JAX package, in float32 on the CPU.

No registry config sets ``tie_embeddings``; the reduced tinyllama with it
set has no ``lm_head``, and its head is the embedding's transpose: in
JAX ``params["embed"].T``, in the port the tp-stacked embed (R, V/R, d),
spec ``P(tpv, fs)``, seen as (R, d, V/R) — the ``P(fs, tpv)`` layout an
untied head is stored in. ``convert.params_from_jax`` takes JAX's tied
tree as it is.

* ``forward_train`` loss and every gradient (the embedding's collects the
  head's) with no mesh and on (1, 4), (2, 2) with FSDP: atol 1e-5; the
  batch's dp halves carry the same tokens (ROADMAP C4).
* ``forward_prefill`` logits on the same meshes: atol 1e-4.
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

import torch_parity as TP  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("mesh", [None, (1, 4), (2, 2)])
def test_tied_train_and_prefill_match_jax(mesh, monkeypatch):
    import dataclasses
    from repro.configs import get_config as jc
    from repro_torch import configs as tc
    real_j, real_t = jc, tc.get_config

    def tie(get):
        return lambda a: dataclasses.replace(get(a), tie_embeddings=True)

    monkeypatch.setattr(TP, "jax_config", tie(real_j))
    monkeypatch.setattr(TP, "get_config", tie(real_t))
    j, t = TP.both("tinyllama-1.1b", mesh)
    assert "lm_head" not in t["params"] and "lm_head" not in j["params"]
    bt = TP.batch(5, equal_halves=True)
    paths = TP.assert_matches(j, t, bt, atol_loss=1e-5, atol_grad=1e-5)
    assert ("embed",) in paths
    jl = jax.jit(lambda p, x: JT.forward_prefill(
        p, x, j["cfg"], j["run"], j["rules"]))(
            j["params"], {"tokens": jnp.asarray(bt["tokens"])})
    with torch.no_grad():
        tl = T.forward_prefill(t["params"],
                               {"tokens": torch.from_numpy(bt["tokens"])},
                               t["cfg"], t["run"], t["rules"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
