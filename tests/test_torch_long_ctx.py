"""Long-context decode over (dp × tp) (ROADMAP A8) against the JAX package,
in float32 on the CPU, with JAX's parameters converted.

The cache of ``cache_template(long_ctx=True)`` shards its sequence over
``("data", "model")`` at once; the port stores it stacked over the
flattened ranks (flat rank r holds positions r·s_loc … (r+1)·s_loc − 1)
and its decode island runs once over all of them, not once per dp group.
Both packages start from the same seeded cache, filled up to a position
near its end, and take 3 chained ``decode_step(long_ctx=True)`` steps:
logits within 1e-4 of JAX's, the bf16-layout (here f32) caches within
1e-5 and the int8 caches equal but for rounding ties (as the int8 serving
tests hold them), on (2, 4) and (2, 2), for h2o-danube-3-4b (sliding
window 16 in its reduced form) and jamba's reduced hybrid (one attention
layer, mamba layers with their SSM caches, MoE).
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
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core.pgl import P, VirtualMesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

S_MAX = 64
START = 52          # the first position decoded: the cache holds 0..51


def _case(arch, mesh_shape):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=True)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jmesh = compat.make_mesh(mesh_shape, ("data", "model"))
    jrules = JaxRules(jmesh, jrun)
    trules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
    tmpl = JT.param_template(jcfg, jrun, jrules)
    jparams = JT.init_params(tmpl, jax.random.PRNGKey(0), jcfg.d_model)
    jparams = jax.tree.map(jax.device_put, jparams,
                           JSP.named(jmesh, JT.param_specs(tmpl)))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, trun, trules)
    return (dict(cfg=jcfg, run=jrun, rules=jrules, mesh=jmesh,
                 params=jparams),
            dict(cfg=tcfg, run=trun, rules=trules, params=tparams))


def _seeded_cache(tmpl, seed):
    """Global numpy leaves for a cache template: K/V (and an SSM state)
    random up to ``START``, zero after; int8 K/V with scales; pos = START."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, pd in T.leaves(tmpl):
        name = path[-1]
        shape = tuple(pd.shape)
        if name == "pos":
            a = np.array(START, np.int32)
        elif name in ("k", "v") and pd.dtype == torch.int8:
            a = rng.integers(-127, 128, shape).astype(np.int8)
            a[..., START:, :] = 0
        elif name in ("k_scale", "v_scale"):
            a = (rng.random(shape) * 0.02).astype(np.float32)
            a[..., START:] = 0
        elif name in ("k", "v"):
            a = rng.standard_normal(shape).astype(np.float32)
            a[..., START:, :] = 0
        else:                                   # SSM state and conv tail
            a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        T.set_path(out, path, a)
    return out


def _caches_agree(got_np, want):
    for path, leaf in T.leaves(got_np):
        w = np.asarray(convert._get(want, path))
        if leaf.dtype == np.int8:
            d = np.abs(leaf.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, "/".join(path)
        else:
            np.testing.assert_allclose(leaf, w, atol=1e-5, rtol=1e-5,
                                       err_msg="/".join(path))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "jamba-1.5-large-398b"])
def test_long_ctx_decode_matches_jax(arch, mesh_shape, kv_dtype):
    j, t = _case(arch, mesh_shape)
    kw = dict(batch=1, s_max=S_MAX, long_ctx=True, kv_dtype=kv_dtype)
    jtmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], **kw)
    ttmpl = T.cache_template(t["cfg"], t["run"], t["rules"], **kw)
    seeded = _seeded_cache(ttmpl, 1)
    jc = jax.tree.map(lambda pd, a: jax.device_put(
        jnp.asarray(a, pd.dtype), jax.sharding.NamedSharding(j["mesh"],
                                                             pd.spec)),
        jtmpl, seeded, is_leaf=lambda x: isinstance(x, JT.PD))
    tc = convert.tree_from_numpy(seeded, ttmpl, t["rules"])
    n_ranks = mesh_shape[0] * mesh_shape[1]
    k0 = tc["blocks"]["pos0"]["k"]
    assert k0.shape[1] == n_ranks and k0.shape[-2] == S_MAX // n_ranks
    jdec = jax.jit(partial(JT.decode_step, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"], long_ctx=True))
    tok = np.array([[7]], np.int32)
    for _ in range(3):
        jl, jc = jdec(j["params"], jc, tok)
        with torch.no_grad():
            tl, tc = T.decode_step(t["params"], tc,
                                   torch.from_numpy(tok).long(), t["cfg"],
                                   t["run"], t["rules"], long_ctx=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(
            np.int32)[:, None]
    assert int(tc["pos"]) == START + 3
    _caches_agree(convert.tree_to_numpy(tc, ttmpl, t["rules"]), jc)


def test_long_ctx_specs_and_island():
    """The cache spec is JAX's; the island spans dp × tp and runs once."""
    run = RunConfig(decode_seq_shard=True)
    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model")), run)
    assert rules.kv_cache(2, 1, long_ctx=True) == P(None, None,
                                                    ("data", "model"), None)
    assert pgl.stack_axis(rules.kv_cache(2, 1, long_ctx=True), rules.mesh,
                          "model") == ("data", "model")
    cfg = get_config("h2o-danube-3-4b").reduced()
    isl = L.decode_island(cfg, run, rules, 1, S_MAX, long_ctx=True, pos=3,
                          kv_len=4, window=None)
    assert isl.spans_dp and isl.axis_size == 8
    assert isl.fallback_reason() is None
    short = L.decode_island(cfg, run, rules, 2, S_MAX, long_ctx=False,
                            pos=3, kv_len=4, window=None)
    assert not short.spans_dp and short.axis_size == 4
    # a flat rank's slice: rank r holds positions r·s_loc ... (r+1)·s_loc-1
    x = torch.arange(S_MAX).view(1, 1, S_MAX, 1).float()
    st = pgl.layout(x, P(None, None, ("data", "model"), None), rules.mesh,
                    ("data", "model"))
    assert st.shape == (8, 1, 1, S_MAX // 8, 1)
    assert torch.equal(st[3].flatten(), torch.arange(24, 32).float())


def test_windowed_fallback_decode_reads_every_key_as_in_jax():
    """ROADMAP C17: the no-mesh decode (and any island's fallback) calls
    ``_full_attention(q_offset=0)``, which measures the sliding window
    from position 0 and so keeps every cached key once the position
    passes the window; the sequence-sharded island windows at the decoded
    position. JAX's two paths disagree on h2o-danube's window (16 in its
    reduced form); the port's follow them, each within 1e-4."""
    j, t = _case("h2o-danube-3-4b", (1, 4))
    kw = dict(batch=1, s_max=S_MAX)
    outs = {}
    for mesh in (True, False):
        jrules = j["rules"] if mesh else None
        trules = t["rules"] if mesh else None
        jtmpl = JT.cache_template(j["cfg"], j["run"], jrules, **kw)
        ttmpl = T.cache_template(t["cfg"], t["run"], trules, **kw)
        seeded = _seeded_cache(ttmpl, 2)
        jc = jax.tree.map(lambda pd, a: jnp.asarray(a, pd.dtype), jtmpl,
                          seeded, is_leaf=lambda x: isinstance(x, JT.PD))
        if mesh:
            jc = jax.tree.map(lambda pd, a: jax.device_put(
                a, jax.sharding.NamedSharding(j["mesh"], pd.spec)), jtmpl, jc,
                is_leaf=lambda x: isinstance(x, JT.PD))
        jp = j["params"] if mesh else jax.device_get(j["params"])
        tp = t["params"] if mesh else convert.params_from_jax(
            jax.tree.map(np.asarray, j["params"]), t["cfg"], t["run"], None)
        jl, _ = jax.jit(partial(JT.decode_step, cfg=j["cfg"], run=j["run"],
                                rules=jrules))(jp, jc, np.array([[7]],
                                                                np.int32))
        with torch.no_grad():
            tl, _ = T.decode_step(tp, convert.tree_from_numpy(
                seeded, ttmpl, trules), torch.tensor([[7]]), t["cfg"],
                t["run"], trules)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        outs[mesh] = np.asarray(jl)
    assert np.abs(outs[True] - outs[False]).max() > 1e-2
