"""Every decoder arch of the registry the port runs, against the JAX
package, in float32 on the CPU.

h2o-danube-3-4b (sliding window, head_dim 120 in full, 16 reduced),
starcoder2-15b (gelu, ungated MLP, rope theta 1e5), internlm2-20b,
internvl2-26b (vision frontend stub) and grok-1-314b (MoE, 4 experts top 2
reduced) at ``.reduced()``, initialised by the JAX package and converted
with ``convert.params_from_jax``, with no mesh and on (1, 4) with FSDP on
(as JAX's launcher sets it; the data axis has one rank, so nothing is
gathered):

* a batched prefill of 24 tokens (prompt lengths 24 and 17; the window
  of 16 is crossed), then 4 greedy decode steps: logits and every cache
  leaf within atol 1e-4 of JAX's ``prefill_step`` and ``decode_step``
  (sums in another order). grok's MoE island is the dense oracle with no
  mesh and the capacity dispatch on the mesh, in both packages.
* one ``forward_train`` loss within 1e-5 and every gradient within 1e-5
  of ``jax.value_and_grad(forward_train)``; internvl2's batch carries its
  ``frontend_embeds``; grok's total carries its MoE aux loss, and its
  router's and experts' gradients are among them.
"""

import dataclasses
from functools import partial

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
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["h2o-danube-3-4b", "starcoder2-15b", "internlm2-20b",
         "internvl2-26b", "grok-1-314b"]
MESHES = [None, (1, 4)]
ATOL_SERVE, ATOL_TRAIN = 1e-4, 1e-5
B, S, S_MAX = 2, 24, 32


def _both(arch, mesh_shape):
    """(jax side, port side): cfg, run, rules, params (and the JAX mesh)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(fsdp=mesh_shape is not None,
              decode_seq_shard=mesh_shape is not None)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_cache(j):
    tmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], batch=B,
                             s_max=S_MAX, slot_pos=True)
    tree = jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), tmpl,
                        is_leaf=lambda x: isinstance(x, JT.PD))
    if j["rules"] is not None:
        tree = jax.tree.map(jax.device_put, tree,
                            JSP.named(j["mesh"], JT.param_specs(tmpl)))
    return tree


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, mesh_shape):
    j, t = _both(arch, mesh_shape)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    lens = np.array([S, 17], np.int32)
    jpre = jax.jit(partial(JT.prefill_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    jdec = jax.jit(partial(JT.decode_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    tmpl = T.cache_template(t["cfg"], t["run"], t["rules"], batch=B,
                            s_max=S_MAX, slot_pos=True)
    jl, jc = jpre(j["params"], _jax_cache(j), tokens, lens)
    with torch.no_grad():
        tl, tc = T.prefill_step(t["params"], T.zeros(tmpl, t["rules"], "cpu"),
                                torch.from_numpy(tokens),
                                torch.from_numpy(lens), t["cfg"], t["run"],
                                t["rules"])
    for step in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_SERVE, rtol=0,
                                   err_msg=f"logits after step {step}")
        for path, leaf in T.leaves(convert.tree_to_numpy(tc, tmpl,
                                                         t["rules"])):
            np.testing.assert_allclose(leaf, np.asarray(_get(jc, path)),
                                       atol=ATOL_SERVE, rtol=0,
                                       err_msg="/".join(path))
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, jc = jdec(j["params"], jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(t["params"], tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch, mesh_shape):
    j, t = _both(arch, mesh_shape)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "targets": rng.integers(0, 256, (B, S)).astype(np.int32),
             "weights": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if t["cfg"].frontend == "vision":
        batch["frontend_embeds"] = rng.standard_normal(
            (B, t["cfg"].n_frontend_tokens, t["cfg"].d_model)).astype(
                np.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: JT.forward_train(
        p, bt, j["cfg"], j["run"], j["rules"])[0]))(
            j["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    for _, leaf in T.leaves(t["params"]):
        leaf.requires_grad_(True)
    loss, _ = T.forward_train(t["params"], tbatch, t["cfg"], t["run"],
                              t["rules"])
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= ATOL_TRAIN, (loss, float(jl))
    grads: dict = {}
    for path, leaf in T.leaves(t["params"]):
        T.set_path(grads, path, leaf.grad)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    for path, g in T.leaves(convert.tree_to_numpy(grads, tmpl, t["rules"])):
        np.testing.assert_allclose(g, np.asarray(_get(jg, path)),
                                   atol=ATOL_TRAIN, rtol=0,
                                   err_msg="/".join(path))
