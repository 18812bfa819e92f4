"""The port's SSM and hybrid decoders against the JAX package's, in float32
on the CPU.

falcon-mamba-7b ``.reduced()`` (2 mamba layers, d = 64, d_inner 128, N =
8, dt_rank 8, conv 4) and jamba-1.5-large-398b ``.reduced()`` (8 layers:
attention at position 0, mamba elsewhere, MoE every second layer) are
initialised by the JAX package and converted with
``convert.params_from_jax``: prefill logits, both SSM cache leaves (h, conv
tail) and the logits of 3 decode steps agree within atol 1e-4 with no mesh
and on (1, 2) and (1, 4), where the port stores every tp-sharded mamba leaf
and the state stacked per rank. The engines give JAX's greedy tokens on one
trace with exact buckets (one bucket per prompt length), with no mesh and
on (1, 4). The hybrid is held against JAX mesh by mesh: its MoE island is
the dense oracle with no mesh and the capacity dispatch on a mesh.
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
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime.serving import ServingEngine  # noqa: E402

torch.set_num_threads(1)

SSM, HYBRID = "falcon-mamba-7b", "jamba-1.5-large-398b"
ATOL = 1e-4
B, L, S_MAX = 4, 8, 16
SERVE = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                    max_new_tokens=4, exact_buckets=True)
JSERVE = JaxServe(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                  max_new_tokens=4, exact_buckets=True)


def _both(arch, mesh_shape):
    """(jax side, port side): each a dict of cfg, run, rules, params."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=mesh_shape is not None)
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


def _port_cache_tmpl(t, batch):
    return T.cache_template(t["cfg"], t["run"], t["rules"], batch=batch,
                            s_max=S_MAX, slot_pos=True)


@pytest.mark.parametrize("mesh_shape", [None, (1, 2), (1, 4)])
def test_ssm_params_round_trip(mesh_shape):
    """Every mamba leaf — the f32 A_log, dt_bias and D among them — crosses
    over bit for bit and comes back; on a mesh the tp-sharded leaves are
    stored stacked per rank."""
    j, t = _both(SSM, mesh_shape)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    back = convert.tree_to_numpy(t["params"], tmpl, t["rules"])
    for path, leaf in T.leaves(back):
        want = j["params"]
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    m = t["params"]["blocks"]["pos0"]["mamba"]
    assert set(m) == {"norm", "in_proj", "conv_w", "conv_b", "x_proj",
                      "dt_proj", "dt_bias", "A_log", "D", "out_proj"}
    assert "mlp" not in t["params"]["blocks"]["pos0"]
    r = mesh_shape[1] if mesh_shape else 1
    if mesh_shape:
        assert m["in_proj"].shape == (2, r, 64, 256 // r)
        assert m["dt_proj"].shape == (2, r, 8, 128 // r)
        assert m["out_proj"].shape == (2, r, 128 // r, 64)
        assert m["A_log"].shape == (2, r, 128 // r, 8)
    for k in ("A_log", "dt_bias", "D"):
        assert m[k].dtype == torch.float32


def _prefill_decode(arch, mesh_shape):
    j, t = _both(arch, mesh_shape)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, L)).astype(np.int32)
    lens = np.full((B,), L, np.int32)        # SSM state: exact lengths
    jpre = jax.jit(partial(JT.prefill_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    jdec = jax.jit(partial(JT.decode_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))
    jl, jc = jpre(j["params"], _jax_cache(j, B), tokens, lens)
    tmpl = _port_cache_tmpl(t, B)
    tc = T.zeros(tmpl, t["rules"], "cpu")
    with torch.no_grad():
        tl, tc = T.prefill_step(t["params"], tc, torch.from_numpy(tokens),
                                torch.from_numpy(lens), t["cfg"], t["run"],
                                t["rules"])
    steps = [(tl, tc, jl, jc)]
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jdec(j["params"], jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(t["params"], tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"])
        steps.append((tl, tc, jl, jc))
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    return t, tmpl, steps


@pytest.mark.parametrize("mesh_shape", [None, (1, 2), (1, 4)])
def test_ssm_prefill_and_decode_match_jax(mesh_shape):
    """Prefill logits and cache, then 3 decode steps' logits and caches:
    the state h (f32) and the conv tail of every layer, compared as global
    arrays (the port's stored stacked per rank on a mesh)."""
    t, tmpl, steps = _prefill_decode(SSM, mesh_shape)
    for tl, tc, jl, jc in steps:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        got = convert.tree_to_numpy(tc, tmpl, t["rules"])
        for i in range(len(t["cfg"].layer_pattern())):
            for leaf in ("h", "conv"):
                np.testing.assert_allclose(
                    got["blocks"][f"pos{i}"][leaf],
                    np.asarray(jc["blocks"][f"pos{i}"][leaf]), atol=ATOL,
                    rtol=0)
        np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    h = tc["blocks"]["pos0"]["h"]
    r = mesh_shape[1] if mesh_shape else None
    assert h.dtype == torch.float32
    assert h.shape == ((2, r, B, 128 // r, 8) if r else (2, B, 128, 8))


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_hybrid_prefill_and_decode_match_jax(mesh_shape):
    """jamba reduced: attention, mamba and MoE layers in one period, the
    layers run period by period in pattern order, as JAX scans them."""
    t, _, steps = _prefill_decode(HYBRID, mesh_shape)
    pattern = t["cfg"].layer_pattern()
    assert {sp.mixer for sp in pattern} == {"attn", "mamba"}
    assert {sp.mlp for sp in pattern} == {"dense", "moe"}
    for tl, _, jl, _ in steps:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch,mesh_shape", [(SSM, None), (SSM, (1, 4)),
                                             (HYBRID, None),
                                             (HYBRID, (1, 4))])
def test_greedy_tokens_match_jax_engine(arch, mesh_shape):
    """The port's engine and the JAX engine on one trace with exact
    buckets: the same tokens and the same schedule."""
    j, t = _both(arch, mesh_shape)
    jeng = JaxEngine(j["cfg"], j["run"], j["rules"], j["params"], JSERVE)
    teng = ServingEngine(t["cfg"], t["run"], t["rules"], t["params"], SERVE,
                         device="cpu")
    trace = launch.synthetic_trace(5, SERVE, t["cfg"].vocab_size, seed=1)
    want = {c.rid: c.tokens for c in jeng.run(trace)}
    got = {c.rid: c.tokens for c in teng.run(trace)}
    assert got == want
    assert teng.step_kinds == jeng.step_kinds
    assert teng.compiled_buckets == sorted({len(p) for p in trace})


def _engine(mesh_shape, serve, arch=SSM):
    return launch.build_engine(arch, reduced=True, mesh_shape=mesh_shape,
                               serve=serve, device="cpu")


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_exact_buckets_required_for_ssm(mesh_shape):
    """The JAX engine's guard (tests/test_serving.py): padded buckets raise;
    with exact buckets continuous batching equals one request at a time,
    and empty pool slots do not leak into live ones."""
    padded = dataclasses.replace(SERVE, exact_buckets=False)
    with pytest.raises(ValueError, match="exact_buckets"):
        _engine(mesh_shape, padded)
    eng = _engine(mesh_shape, SERVE)
    rng = np.random.RandomState(0)
    prompts = [tuple(int(t) for t in rng.randint(0, eng.cfg.vocab_size,
                                                 size=n)) for n in (5, 5, 3)]
    done = eng.run(prompts)
    for c in done:
        solo = _engine(mesh_shape, SERVE)
        assert c.tokens == solo.run([prompts[c.rid]])[0].tokens
    # build_engine's default for SSM archs is exact buckets
    assert launch.build_engine(SSM, reduced=True,
                               device="cpu").serve.exact_buckets


def test_static_ssm_batches_need_uniform_lengths():
    eng = _engine((1, 4), SERVE)
    rng = np.random.RandomState(1)
    mixed = [tuple(rng.randint(0, 256, size=n)) for n in (6, 4)]
    with pytest.raises(ValueError, match="uniform prompt lengths"):
        eng.generate_static(mixed, 3)
    same = [tuple(rng.randint(0, 256, size=6)) for _ in range(3)]
    static = eng.generate_static(same, 3)
    for p, toks in zip(same, static):
        assert _engine((1, 4), SERVE).run([p])[0].tokens[:3] == toks


def test_init_params_ssm_leaves():
    """A_log is log(1..N) along the state dim as in JAX; softplus(dt_bias)
    lies in [1e-3, 1e-1]; D is ones and the conv bias zeros."""
    cfg = get_config(SSM).reduced()
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model")),
                          RunConfig(fsdp=False))
    tmpl = T.param_template(cfg, rules.run, rules)
    params = T.init_params(tmpl, torch.Generator().manual_seed(0),
                           cfg.d_model, rules=rules, device="cpu")
    g = convert.tree_to_numpy(params, tmpl, rules)["blocks"]["pos0"]["mamba"]
    jcfg = jax_config(SSM).reduced()
    jp = JT.init_params(JT.param_template(jcfg, JaxRun(fsdp=False), None),
                        jax.random.PRNGKey(0), jcfg.d_model)
    # the port's A_log is log(1..N) correctly rounded to f32, bit for bit;
    # XLA's f32 log on the CPU rounds log(7) the other way (1 ulp), so
    # JAX's is held to it within one ulp
    exact = np.log(np.arange(1, cfg.ssm_state + 1, dtype=np.float64))
    np.testing.assert_array_equal(
        g["A_log"], np.broadcast_to(exact.astype(np.float32),
                                    g["A_log"].shape))
    np.testing.assert_array_max_ulp(
        g["A_log"], np.asarray(jp["blocks"]["pos0"]["mamba"]["A_log"]),
        maxulp=1)
    u = torch.nn.functional.softplus(torch.from_numpy(g["dt_bias"]))
    assert float(u.min()) >= 1e-3 and float(u.max()) <= 1e-1
    assert float(u.max()) - float(u.min()) > 0.05        # drawn, not fixed
    assert (g["D"] == 1).all() and not g["conv_b"].any()


def test_ssm_training_raises_a10b(tmp_path):
    from repro_torch.launch import train as train_launch
    cfg = get_config(SSM).reduced()
    with pytest.raises(NotImplementedError, match="A10b"):
        T.forward_train({}, {}, cfg, RunConfig(fsdp=False), None)
    with pytest.raises(NotImplementedError, match="A10b"):
        train_launch.build_and_train(SSM, reduced=True, steps=1, batch=2,
                                     seq=8, mesh_shape=None,
                                     ckpt_dir=str(tmp_path), device="cpu")
