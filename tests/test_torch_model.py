"""The port's model against the JAX package's, in float32 on the CPU.

The reduced tinyllama (2 layers, d = 64, 4 heads of 16, 2 KV heads) is
initialised by the JAX package, converted with ``convert.params_from_jax``
and run by both: prefill and decode logits and KV caches agree within
atol 1e-4 with no mesh and on (1, R) meshes, where the port's islands run
on stacked virtual ranks and the JAX islands under ``shard_map`` on the
emulated devices. The sums differ only in order, hence a tolerance.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4
B, S_MAX = 2, 16


def _cfgs():
    return (dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                dtype="float32"))


def _both(mesh_shape, jax_backend=None, port_backend=None,
          attn_island=False):
    """(jax side, port side): each a dict of cfg, run, rules, params."""
    jcfg, tcfg = _cfgs()
    kw = dict(fsdp=False, decode_seq_shard=mesh_shape is not None,
              pk_attn_out_island=attn_island)
    jrun = JaxRun(comm_backend=jax_backend, **kw)
    trun = RunConfig(comm_backend=port_backend, **kw)
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


def _port_cache_np(t, cache, batch):
    tmpl = T.cache_template(t["cfg"], t["run"], t["rules"], batch=batch,
                            s_max=S_MAX, slot_pos=True)
    return convert.tree_to_numpy(cache, tmpl, t["rules"])


def _assert_cache_close(port_np, jax_cache):
    for path, leaf in T.leaves(port_np):
        want = jax_cache
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf, np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg="/".join(path))


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_params_round_trip(mesh_shape):
    j, t = _both(mesh_shape)
    back = convert.tree_to_numpy(
        t["params"], T.param_template(t["cfg"], t["run"], t["rules"]),
        t["rules"])
    for path, leaf in T.leaves(back):
        want = j["params"]
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    if mesh_shape is not None:          # tp-sharded leaves are stored stacked
        w1 = t["params"]["blocks"]["pos0"]["mlp"]["w1"]
        assert w1.shape == (2, 4, 64, 32) and w1.is_contiguous()


@pytest.mark.parametrize("mesh_shape,jax_backend,port_backend,attn_island", [
    (None, None, None, False),
    ((1, 4), None, None, False),
    ((1, 4), "ring", "ring", True),
    ((1, 4), "bulk", "fused", True),
    ((1, 2), None, "fused", False),
])
def test_prefill_and_decode_match_jax(mesh_shape, jax_backend, port_backend,
                                      attn_island):
    j, t = _both(mesh_shape, jax_backend, port_backend, attn_island)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, 8)).astype(np.int32)
    lens = np.array([5, 8], np.int32)

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
    assert tl.shape == (B, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_close(_port_cache_np(t, tc, B), jc)

    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jdec(j["params"], jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(t["params"], tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _assert_cache_close(_port_cache_np(t, tc, B), jc)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("port_backend", [None, "ring", "fused"])
def test_mlp_island_matches_jax(port_backend):
    j, t = _both((1, 4), port_backend=port_backend)
    x = np.random.default_rng(1).standard_normal((B, 6, 64)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], j["params"]["blocks"]["pos0"]["mlp"])
    want = jax.jit(partial(JL.mlp_block, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))(jp, x)
    tp = {k: v[0] for k, v in t["params"]["blocks"]["pos0"]["mlp"].items()}
    island = L.mlp_island(t["cfg"], t["run"], t["rules"], B, 6)
    assert island.fallback_reason() is None
    with torch.no_grad():
        got = L.mlp_block(tp, torch.from_numpy(x), t["cfg"], t["run"],
                          t["rules"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_decode_island_matches_jax():
    """One-token decode over a random sequence-sharded cache, per-slot
    positions: the rank-local write and the log-sum-exp merge."""
    j, t = _both((1, 4))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((B, 2, S_MAX, 16)).astype(np.float32)
    cv = rng.standard_normal((B, 2, S_MAX, 16)).astype(np.float32)
    pos = np.array([3, 11], np.int32)
    ja = jax.tree.map(lambda a: a[0], j["params"]["blocks"]["pos0"]["attn"])
    spec = JSP.named(j["mesh"], j["rules"].kv_cache(2, B))
    jout, jk, jv = jax.jit(partial(
        JL.decode_attention, cfg=j["cfg"], run=j["run"], rules=j["rules"]))(
            ja, x, jax.device_put(ck, spec), jax.device_put(cv, spec), pos)
    island = L.decode_island(t["cfg"], t["run"], t["rules"], B, S_MAX,
                             long_ctx=False, pos=torch.from_numpy(pos),
                             kv_len=None, window=None)
    assert island.fallback_reason() is None
    tspec, mesh = t["rules"].kv_cache(2, B), t["rules"].mesh

    def stacked(a):
        return pgl.layout(torch.from_numpy(a), tspec, mesh,
                          "model").contiguous()

    ta = {k: v[0] for k, v in t["params"]["blocks"]["pos0"]["attn"].items()}
    with torch.no_grad():
        out, tk, tv = L.decode_attention(ta, torch.from_numpy(x), stacked(ck),
                                         stacked(cv),
                                         torch.from_numpy(pos).long(),
                                         t["cfg"], t["run"], t["rules"])
    assert tk.shape == (4, B, 2, S_MAX // 4, 16)     # still stacked per rank
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(
            pgl.assemble(got, tspec, mesh, "model").numpy(), np.asarray(want),
            atol=ATOL, rtol=0)


def test_dense_only_and_data_axis_raise():
    _, tcfg = _cfgs()
    run = RunConfig(fsdp=False)
    # MoE and SSM models train (ROADMAP A9b, A10b; held against JAX in
    # tests/test_torch_moe_train.py and tests/test_torch_ssm_train.py): a
    # finite loss from random parameters, the aux loss only where there
    # are experts
    rng = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 256, (2, 8), generator=rng),
             "targets": torch.randint(0, 256, (2, 8), generator=rng),
             "weights": torch.ones(2, 8)}
    for arch in ("moonshot-v1-16b-a3b", "falcon-mamba-7b"):
        cfg = get_config(arch).reduced()
        params = T.init_params(T.param_template(cfg, run, None),
                               torch.Generator().manual_seed(0),
                               cfg.d_model, device="cpu")
        total, m = T.forward_train(params, batch, cfg, run, None)
        assert torch.isfinite(total)
        assert (float(m["aux_loss"]) > 0) == cfg.is_moe
    # data axes larger than 1 run (below); what still raises on them: a
    # dim sharded over dp and tp at once, and per-rank (serving) outputs
    mesh = VirtualMesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="A8"):
        pgl.layout(torch.zeros(4, 4), pgl.P(("data", "model"), None), mesh,
                   "model")
    rules = ShardingRules(mesh, RunConfig(fsdp=False))
    write = L.prefill_write_island(tcfg, rules.run, rules, B, 8)
    with pytest.raises(NotImplementedError, match="A7c"):
        write(cache=torch.zeros(B, 2, S_MAX, 16), new=torch.zeros(B, 2, 8, 16))


def test_forward_train_on_data_axis_mesh():
    """A (2, 2) mesh with FSDP off: each dp group's islands run on its own
    tp ranks; the loss equals JAX's on the same mesh."""
    j, t = _both((2, 2))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 256, (B, 8)).astype(np.int32),
             "targets": rng.integers(0, 256, (B, 8)).astype(np.int32),
             "weights": np.ones((B, 8), np.float32)}
    want, _ = jax.jit(partial(JT.forward_train, cfg=j["cfg"], run=j["run"],
                              rules=j["rules"]))(
        j["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = T.forward_train(
            t["params"], {k: torch.from_numpy(v) for k, v in batch.items()},
            t["cfg"], t["run"], t["rules"])
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)
