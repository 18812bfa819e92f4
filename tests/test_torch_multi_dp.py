"""FSDP over several dp axes against the JAX package, in float32 on the CPU.

The reduced tinyllama (2 layers, d = 64) on the multi-pod layout (2, 2, 2)
over ("pod", "data", "model") with ``dp_axes=("pod", "data")`` and FSDP,
as JAX's multi-pod dry-run cells set it. The FSDP gather and the
gradients' reduce-scatter run over the flattened (pod, data) group,
pod-major, and every island other than the long-context decode runs once
per dp group (4 of them).

* ``forward_train`` loss and every gradient against JAX's with FSDP on
  (4, 2) over ("data", "model"), the same ranks in the same order, atol
  1e-5, with the fused (ring-kernel) and the bulk gathers; the batch's 4
  dp blocks carry the same tokens (JAX's FSDP embedding mixes the dp
  ranks' batches, ROADMAP C4).
* JAX on (2, 2, 2) itself is no reference: ``maybe_allgather`` and the
  embedding island gather a dim sharded over ("pod", "data") one axis at
  a time, pod first, which concatenates the shards data-major — block
  ``data·2 + pod`` lands where shard ``pod·2 + data`` belongs (ROADMAP
  C16). JAX's FSDP loss on (2, 2, 2) differs from its own loss with no
  mesh; the port's equals it.
* Two ``make_train_step`` steps on (2, 2, 2) against the same steps on
  (4, 2): loss, grad norm and every parameter bit for bit — the flattened
  group holds the same ranks in the same order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import template  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.step import TrainState, make_train_step  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
POD = ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))
FLAT = ((4, 2), ("data", "model"), ("data",))
B, S = 8, 32


def _batch(seed=0):
    """Tokens, targets, weights; the 4 dp blocks of 2 rows carry the same
    tokens and targets (the weights differ)."""
    rng = np.random.default_rng(seed)
    tok = np.tile(rng.integers(0, 256, (2, S)), (4, 1)).astype(np.int32)
    tgt = np.tile(rng.integers(0, 256, (2, S)), (4, 1)).astype(np.int32)
    w = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": tok, "targets": tgt, "weights": w}


def _port(layout, backend="fused"):
    shape, axes, dp_axes = layout
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    run = RunConfig(fsdp=True, dp_axes=dp_axes, comm_backend=backend)
    return cfg, run, ShardingRules(VirtualMesh(shape, axes), run)


def _jax(layout, fsdp=True):
    shape, axes, dp_axes = layout
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    jrun = JaxRun(fsdp=fsdp, dp_axes=dp_axes)
    jmesh = compat.make_mesh(shape, axes)
    jrules = JaxRules(jmesh, jrun)
    tmpl = JT.param_template(jcfg, jrun, jrules)
    jparams = jax.tree.map(
        jax.device_put, JT.init_params(tmpl, jax.random.PRNGKey(0),
                                       jcfg.d_model),
        JSP.named(jmesh, JT.param_specs(tmpl)))
    f = jax.jit(jax.value_and_grad(lambda p, x: JT.forward_train(
        p, x, jcfg, jrun, jrules)[0]))
    loss, grads = f(jparams, {k: jnp.asarray(v) for k, v in _batch().items()})
    return jparams, float(loss), grads


@pytest.fixture(scope="module")
def jax_flat():
    """JAX's parameters, loss and gradients with FSDP on (4, 2)."""
    return _jax(FLAT)


def _port_loss_grads(params, cfg, run, rules):
    for _, leaf in T.leaves(params):
        leaf.requires_grad_(True)
    loss, _ = T.forward_train(params, {k: torch.from_numpy(v)
                                       for k, v in _batch().items()},
                              cfg, run, rules)
    loss.backward()
    grads: dict = {}
    for path, leaf in T.leaves(params):
        T.set_path(grads, path, leaf.grad)
    return float(loss.detach()), convert.tree_to_numpy(
        grads, T.param_template(cfg, run, rules), rules)


@pytest.mark.parametrize("backend", ["fused", "bulk"])
def test_forward_train_over_pod_and_data_matches_jax(jax_flat, backend):
    jparams, jloss, jgrads = jax_flat
    cfg, run, rules = _port(POD, backend)
    # the global parameters are the same whatever the mesh
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     cfg, run, rules)
    loss, got = _port_loss_grads(params, cfg, run, rules)
    assert abs(loss - jloss) <= 1e-5
    n = 0
    for path, g in T.leaves(got):
        w = jgrads
        for k in path:
            w = w[k]
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg="/".join(path))
        n += 1
    assert n >= 10


def test_jax_gathers_pod_and_data_shards_data_major(jax_flat):
    """ROADMAP C16: JAX's FSDP loss on (2, 2, 2) is not its own loss on
    (4, 2) or without FSDP; the port's is. JAX's gather of a dim sharded
    over ("pod", "data") one axis at a time puts the shards data-major."""
    _, flat_loss, _ = jax_flat
    _, pod_loss, _ = _jax(POD)
    _, nofsdp_loss, _ = _jax(POD, fsdp=False)
    assert abs(nofsdp_loss - flat_loss) <= 1e-5
    assert abs(pod_loss - flat_loss) > 1e-2
    mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = jax.device_put(jnp.arange(4.0), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("pod", "data"))))
    from repro.core.template import maybe_allgather
    out = compat.shard_map(
        lambda t: maybe_allgather(t, ("pod", "data"), 0, 4), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(("pod", "data")),
        out_specs=jax.sharding.PartitionSpec(), check_vma=False)(x)
    assert np.asarray(out).tolist() == [0.0, 2.0, 1.0, 3.0]
    cfg, run, rules = _port(POD)
    params = T.init_params(T.param_template(cfg, run, rules),
                           torch.Generator().manual_seed(0), cfg.d_model,
                           rules=rules, device="cpu")
    emb = params["embed"]                          # (R_tp, V/R_tp, d)
    spec = T.param_template(cfg, run, rules)["embed"].spec
    copies = template.fsdp_gather(emb, spec, rules, run, dim=1)
    assert copies.shape == (4, *emb.shape)
    assert all(torch.equal(c, emb) for c in copies)     # pod-major


def _steps(layout):
    cfg, run, rules = _port(layout)
    assert template.dp_groups(rules)[1] == 4
    params = T.init_params(T.param_template(cfg, run, rules),
                           torch.Generator().manual_seed(0), cfg.d_model,
                           rules=rules, device="cpu")
    opt = AdamW()
    state = TrainState(params, opt.init(params))
    step = make_train_step(cfg, run, rules, opt)
    out = []
    for i in range(2):
        bt = {k: torch.from_numpy(v) for k, v in _batch(seed=i).items()}
        state, m = step(state, bt)
        out.append((m["loss"], m["grad_norm"],
                    [p.detach().clone() for _, p in T.leaves(state.params)]))
    return out


def test_train_steps_over_pod_and_data_equal_flat_dp_bit_for_bit():
    for (la, ga, pa), (lb, gb, pb) in zip(_steps(POD), _steps(FLAT)):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
