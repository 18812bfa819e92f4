"""The port's MoE decoder against the JAX package's, in float32 on the CPU.

The reduced moonshot-v1-16b-a3b (2 layers, d = 64, 4 heads of 16, 4
experts, top-2, every layer MoE) is initialised by the JAX package,
converted with ``convert.params_from_jax`` and run by both: prefill and
decode logits agree within atol 1e-4 with no mesh (the dense oracle, in
both packages) and on (1, 4) (EP) and (1, 8) (EP×TP, tp_ff = 2), where
the port's MoE island runs the replicated capacity dispatch on stacked
virtual ranks and JAX's under ``shard_map``. The engine's greedy tokens
equal the JAX engine's on the same trace. The port is held against JAX
mesh by mesh: with no mesh the MoE island is the dense oracle (no capacity
drop), on a mesh the capacity dispatch, so the two give other tokens.
Continuous batching does not equal one request at a time for MoE, in JAX
either (per-expert capacity depends on the other rows of the batch), so
nothing here asserts it.
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
from repro.configs.base import ServeConfig as JaxServe  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime.serving import ServingEngine  # noqa: E402

torch.set_num_threads(1)

ARCH = "moonshot-v1-16b-a3b"
ATOL = 1e-4
B, S_MAX = 4, 16
SERVE = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                    max_new_tokens=4)


def _cfgs():
    return (dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32"),
            dataclasses.replace(get_config(ARCH).reduced(), dtype="float32"))


def _both(mesh_shape, **run_kw):
    """(jax side, port side): each a dict of cfg, run, rules, params."""
    jcfg, tcfg = _cfgs()
    kw = dict(fsdp=False, decode_seq_shard=mesh_shape is not None, **run_kw)
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


def _jax_cache(j, batch):
    tmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], batch=batch,
                             s_max=S_MAX, slot_pos=True)
    tree = jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), tmpl,
                        is_leaf=lambda x: isinstance(x, JT.PD))
    if j["rules"] is not None:
        tree = jax.tree.map(jax.device_put, tree,
                            JSP.named(j["mesh"], JT.param_specs(tmpl)))
    return tree


@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (1, 8)])
def test_moe_params_round_trip(mesh_shape):
    """The MoE leaves (norm, f32 router, device-major w1/w3/w2) cross over
    bit for bit and come back; on a mesh the experts are stored stacked
    per rank, (n_layers, R, 1, E_loc, ...)."""
    j, t = _both(mesh_shape)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    back = convert.tree_to_numpy(t["params"], tmpl, t["rules"])
    for path, leaf in T.leaves(back):
        want = j["params"]
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    m = t["params"]["blocks"]["pos0"]["moe"]
    assert m["router"].dtype == torch.float32
    if mesh_shape == (1, 8):        # ep 4, tp_ff 2: one expert, half its ff
        assert m["w1"].shape == (2, 8, 1, 1, 64, 64)
        assert m["w2"].shape == (2, 8, 1, 1, 64, 64)
    elif mesh_shape is None:
        assert m["w1"].shape == (2, 1, 4, 64, 128)


@pytest.mark.parametrize("mesh_shape,ring", [(None, False), ((1, 4), False),
                                             ((1, 4), True), ((1, 8), False)])
def test_moe_prefill_and_decode_match_jax(mesh_shape, ring):
    j, t = _both(mesh_shape, pk_ring_psum=ring)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, 8)).astype(np.int32)
    lens = np.array([5, 8, 2, 7], np.int32)
    jpre = jax.jit(partial(JT.prefill_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    jdec = jax.jit(partial(JT.decode_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    jl, jc = jpre(j["params"], _jax_cache(j, B), tokens, lens)
    tc = T.zeros(T.cache_template(t["cfg"], t["run"], t["rules"], batch=B,
                                  s_max=S_MAX, slot_pos=True),
                 t["rules"], "cpu")
    with torch.no_grad():
        tl, tc = T.prefill_step(t["params"], tc, torch.from_numpy(tokens),
                                torch.from_numpy(lens), t["cfg"], t["run"],
                                t["rules"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jdec(j["params"], jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(t["params"], tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (1, 8)])
def test_moe_block_matches_jax(mesh_shape):
    """One MoE sub-layer: the island's (out, aux) tuple reassembled from
    the body over stacked ranks (or the dense reference with no mesh)
    against JAX ``moe_block``."""
    j, t = _both(mesh_shape)
    x = np.random.default_rng(3).standard_normal((B, 6, 64)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], j["params"]["blocks"]["pos0"]["moe"])
    want, jaux = jax.jit(partial(JL.moe_block, cfg=j["cfg"], run=j["run"],
                                 rules=j["rules"]))(jp, x)
    tp = {k: v[0] for k, v in t["params"]["blocks"]["pos0"]["moe"].items()}
    with torch.no_grad():
        got, aux = L.moe_block(tp, torch.from_numpy(x), t["cfg"], t["run"],
                               t["rules"])
    assert got.shape == (B, 6, 64) and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_moe_greedy_tokens_match_jax_engine(mesh_shape):
    """The port's engine and the JAX engine on one trace: the same tokens
    and the same schedule (prefill groups and decode ticks over a pool
    whose empty slots take part in the capacity selection, in both)."""
    j, t = _both(mesh_shape)
    jeng = JaxEngine(j["cfg"], j["run"], j["rules"], j["params"],
                     JaxServe(max_batch=4, prefill_batch=2,
                              bucket_edges=(8, 16), max_new_tokens=4))
    teng = ServingEngine(t["cfg"], t["run"], t["rules"], t["params"], SERVE,
                         device="cpu")
    trace = launch.synthetic_trace(5, SERVE, t["cfg"].vocab_size, seed=1)
    want = {c.rid: c.tokens for c in jeng.run(trace)}
    got = {c.rid: c.tokens for c in teng.run(trace)}
    assert got == want
    assert teng.step_kinds == jeng.step_kinds


@pytest.mark.parametrize("mesh_shape,moe_chunks", [((1, 4), 1),
                                                   ((1, 8), 0)])
def test_moe_island_plans_match_jax(mesh_shape, moe_chunks):
    """The same islands in the same order for a serving bucket's prefill,
    its decode step and a whole forward (JAX's sequence-parallel island
    off: it is ROADMAP A8); ``moe_chunks = 0`` resolves through the
    port's analytic a2a chunk policy."""
    kw = dict(sp_attention="none", moe_chunks=moe_chunks)
    j, t = _both(mesh_shape, **kw)
    for phase in ("prefill", "decode", "all"):
        want = JL.island_plans(j["cfg"], j["run"], j["rules"], batch=4,
                               seq=16, phase=phase)
        got = L.island_plans(t["cfg"], t["run"], t["rules"], batch=4,
                             seq=16, phase=phase)
        assert [p.island for p in got] == [p.island for p in want]
        moe_plan = [p for p in got if p.island == "moe"][0]
        assert not moe_plan.fallback and moe_plan.op == "psum"
        assert moe_plan.n_chunks >= 1


def test_moe_run_options_not_ported_raise(tmp_path):
    _, tcfg = _cfgs()
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model")),
                          RunConfig(fsdp=False, serve_moe_tp_data=True))
    with pytest.raises(NotImplementedError, match="A9c"):
        T.param_template(tcfg, rules.run, rules)
    with pytest.raises(NotImplementedError, match="A9c"):
        L.moe_island(tcfg, rules.run, rules, B, 8)
    # MoE training (once ROADMAP A9b) runs, with no mesh
    _, log = train_launch.build_and_train(ARCH, reduced=True, steps=1,
                                          batch=2, seq=8, mesh_shape=None,
                                          ckpt_dir=str(tmp_path),
                                          device="cpu")
    assert np.isfinite(log[-1]["loss"]) and log[-1]["aux_loss"] > 0
