"""The port's MoE training against the JAX package's, in float32 on the CPU.

moonshot-v1-16b-a3b and grok-1-314b ``.reduced()`` (2 layers, d = 64, 4
heads of 16, 4 experts, top-2, every layer MoE; grok's activation is gelu)
are initialised by the JAX package and converted with
``convert.params_from_jax``; both packages get the same numpy batch.

* ``forward_train``'s total (loss + 0.01·aux), its loss and its aux loss
  within 1e-5, and every gradient of the total within atol 1e-5 against
  ``jax.value_and_grad``: with no mesh (the MoE island is the dense oracle
  in both packages), on (1, 4) (EP over the tp axis), and on (2, 2) and
  (2, 4) with FSDP (the island runs once per dp group on the group's
  capacity plan; the expert weights are FSDP-gathered and their gradients
  reduce-scattered). Each is held against JAX on its own mesh, never
  across meshes: the capacity dispatch drops other tokens than the dense
  oracle (ROADMAP C). On dp > 1 the batch's dp halves carry the same
  tokens (JAX's FSDP embedding mixes the dp ranks' batches, ROADMAP C4);
  every row's tokens are distinct with no mesh and on (1, 4).
* The tokens and the router are replicated over the tp ranks: their
  gradients reach the global leaves once (the embedding's and the
  router's gradients above), not once a rank.
* ``forward_prefill`` logits within 1e-4 with no mesh and on (1, 4).
* ``build_and_train`` trains the reduced moonshot on (2, 4), batch 4, seq
  32 (JAX's ``test_system.py`` case), with a finite loss and aux loss.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

import torch_parity as TP  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
MOE_ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b")


@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_train_matches_jax(arch, mesh_shape):
    j, t = TP.both(arch, mesh_shape)
    dp = mesh_shape is not None and mesh_shape[0] > 1
    bt = TP.batch(seed=1, equal_halves=dp)
    paths = TP.assert_matches(j, t, bt, atol_loss=ATOL, atol_grad=ATOL)
    # the router's and every expert weight's gradients are among them
    assert {p[-1] for p in paths if "moe" in p} == {"norm", "router", "w1",
                                                     "w2", "w3"}


def test_aux_loss_reaches_the_router_once():
    """The aux loss alone (weights 0: no cross-entropy) on (1, 4): its
    gradient is the router's and the tokens' only, and equals JAX's — a
    gradient counted once a rank would be 4 times as large."""
    j, t = TP.both(MOE_ARCHS[0], (1, 4))
    bt = TP.batch(seed=2)
    bt["weights"][:] = 0.0
    paths = TP.assert_matches(j, t, bt, atol_loss=ATOL, atol_grad=ATOL)
    assert ("blocks", "pos0", "moe", "router") in paths


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_forward_prefill_matches_jax(mesh_shape):
    j, t = TP.both(MOE_ARCHS[0], mesh_shape)
    bt = TP.batch(seed=4)
    toks = {"tokens": bt["tokens"]}
    want = jax.jit(partial(JT.forward_prefill, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))(
        j["params"], {k: jnp.asarray(v) for k, v in toks.items()})
    prefill = TS.make_prefill_step(t["cfg"], t["run"], t["rules"])
    with torch.no_grad():
        got = prefill(t["params"], {k: torch.from_numpy(v)
                                    for k, v in toks.items()})
    assert got.shape == (TP.B, 1, TP.VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_build_and_train_moe(tmp_path, capsys):
    _, log = launch.build_and_train(
        MOE_ARCHS[0], steps=2, reduced=True, mesh_shape=(2, 4), batch=4,
        seq=32, ckpt_dir=str(tmp_path), log_every=1, device="cpu")
    assert len(log) == 2
    for m in log:
        assert np.isfinite(m["loss"]) and np.isfinite(m["aux_loss"])
        assert m["aux_loss"] > 0
    assert "aux_loss" in capsys.readouterr().out
