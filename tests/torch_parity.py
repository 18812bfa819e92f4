"""Shared set-up of the MoE, SSM and hybrid training tests
(``tests/test_torch_moe_train.py``, ``tests/test_torch_ssm_train.py``): one
reduced architecture in float32, initialised by the JAX package and
converted with ``convert.params_from_jax``, the same numpy batch for both
packages, and the loss, aux loss and every gradient of ``forward_train``
from each."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import compat
from repro.configs import get_config as jax_config
from repro.configs.base import RunConfig as JaxRun
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro.models.sharding import ShardingRules as JaxRules
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.pgl import VirtualMesh
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules

B, S, VOCAB = 4, 16, 256


def both(arch, mesh_shape, *, fsdp=None, **run_kw):
    """(jax side, port side): cfg, run, rules, params (and the JAX mesh).
    FSDP on a mesh with a data axis larger than 1, as the launchers set
    it, with the port's gathers and reduce-scatters on the ring kernels'
    plain versions (``comm_backend="fused"``)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if fsdp is None:
        fsdp = mesh_shape is not None and mesh_shape[0] > 1
    backend = run_kw.pop("comm_backend", "fused" if fsdp else None)
    kw = dict(fsdp=fsdp, decode_seq_shard=mesh_shape is not None, **run_kw)
    jrun, trun = JaxRun(**kw), RunConfig(comm_backend=backend, **kw)
    jmesh = (compat.make_mesh(mesh_shape, ("data", "model"))
             if mesh_shape else None)
    jrules = JaxRules(jmesh, jrun) if jmesh is not None else None
    trules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
              if mesh_shape else None)
    jtmpl = JT.param_template(jcfg, jrun, jrules)
    jparams = JT.init_params(jtmpl, jax.random.PRNGKey(0), jcfg.d_model)
    if jrules is not None:
        jparams = jax.tree.map(jax.device_put, jparams,
                               JSP.named(jmesh, JT.param_specs(jtmpl)))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, trun, trules)
    return (dict(cfg=jcfg, run=jrun, rules=jrules, params=jparams,
                 mesh=jmesh),
            dict(cfg=tcfg, run=trun, rules=trules, params=tparams))


def batch(seed=0, *, equal_halves=False, b=B, s=S):
    """Tokens, targets and weights; ``equal_halves``: the second half of
    the batch repeats the first's tokens and targets (JAX's FSDP embedding
    mixes the dp ranks' batches, ROADMAP C4, so a dp > 1 comparison feeds
    both dp halves the same tokens)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    if equal_halves:
        for a in (tok, tgt):
            a[b // 2:] = a[:b // 2]
    return {"tokens": tok, "targets": tgt,
            "weights": (rng.random((b, s)) > 0.1).astype(np.float32)}


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_loss_grads(j, bt):
    """(total, loss, aux_loss, gradients of the total) from JAX."""
    f = jax.jit(jax.value_and_grad(lambda p, x: JT.forward_train(
        p, x, j["cfg"], j["run"], j["rules"]), has_aux=True))
    (total, m), grads = f(j["params"], {k: jnp.asarray(v)
                                        for k, v in bt.items()})
    return float(total), float(m["loss"]), float(m["aux_loss"]), grads


def port_loss_grads(t, bt):
    """(total, loss, aux_loss, gradients of the total as numpy in JAX's
    layout) from the port."""
    for _, leaf in T.leaves(t["params"]):
        leaf.requires_grad_(True)
    total, m = T.forward_train(
        t["params"], {k: torch.from_numpy(v) for k, v in bt.items()},
        t["cfg"], t["run"], t["rules"])
    total.backward()
    grads: dict = {}
    for path, leaf in T.leaves(t["params"]):
        T.set_path(grads, path, leaf.grad)
        leaf.grad = None
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    return (float(total.detach()), float(m["loss"].detach()),
            float(m["aux_loss"].detach()),
            convert.tree_to_numpy(grads, tmpl, t["rules"]))


def assert_matches(j, t, bt, *, atol_loss, atol_grad):
    """The port's total, loss, aux loss and every gradient against JAX's;
    returns the gradient paths."""
    jt, jl, ja, jg = jax_loss_grads(j, bt)
    tt, tl, ta, tg = port_loss_grads(t, bt)
    for got, want in ((tt, jt), (tl, jl), (ta, ja)):
        assert abs(got - want) <= atol_loss, (tt, tl, ta, jt, jl, ja)
    paths = []
    for path, g in T.leaves(tg):
        np.testing.assert_allclose(g, np.asarray(get(jg, path)),
                                   atol=atol_grad, rtol=0,
                                   err_msg="/".join(path))
        paths.append(path)
    return paths
