"""The port's int8 KV cache (``ServeConfig.kv_dtype="int8"``) against the
JAX package, in float32 on the CPU, with the reduced tinyllama (2 layers,
d = 64, 4 heads of 16, 2 KV heads) and JAX's parameters converted.

* The islands that write the cache — the slab decode island and prefill
  write, the head-sharded decode that quantizes outside any island, the
  paged decode and prefill islands — on the same inputs as JAX's: int8
  caches and f32 scale planes bit for bit, outputs within 1e-5; no mesh,
  (1, 4) and (2, 2).
* ``prefill_step`` / ``prefill_paged_step`` and 4 chained ``decode_step``
  calls, slab, head-sharded slab and paged, with no mesh and on (1, 4) and
  (2, 2): logits within 1e-4 of JAX's. The models' own K/V come out of
  GEMMs that torch and XLA sum in other orders, so there the int8 caches
  agree but for entries a rounding tie tips by one step (at most 0.1% of
  them), and the scales within rtol 1e-5; the island tests above hold the
  quantization itself bit for bit.
* The engines' greedy tokens, ``events`` and ``cache_stats()`` equal to
  the JAX engine's on the trace of JAX's
  ``test_int8_kv_matches_own_sequential``, slab and paged on (2, 2);
  continuous == sequential inside the port.
* Cache bytes: (hd + 4) / (2·hd) of bf16's — 0.531 for tinyllama-1.1b;
  the bf16 templates are unchanged by the int8 axis; the int8 templates'
  shapes, dtypes and specs are JAX's; the plan record's ``kv_dtype`` and
  ``comm_wire``.
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
from repro.runtime import paging as JP  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core.pgl import P, VirtualMesh  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import paging  # noqa: E402
from repro_torch.runtime import serving as S  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
B, S_MAX = 4, 16
SLAB8 = dict(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
             max_new_tokens=4, kv_dtype="int8")
PAGED8 = dict(SLAB8, cache_layout="paged", page_size=8, prefill_chunk=8)
MESHES = [None, (1, 4), (2, 2)]


def _case(mesh_shape, seq_shard=True, **run_kw):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=seq_shard and mesh_shape
              is not None, **run_kw)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jmesh = (compat.make_mesh(mesh_shape, ("data", "model"))
             if mesh_shape else None)
    jrules = JaxRules(jmesh, jrun) if jmesh is not None else None
    trules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
              if mesh_shape else None)
    return (dict(cfg=jcfg, run=jrun, rules=jrules, mesh=jmesh),
            dict(cfg=tcfg, run=trun, rules=trules))


def _params(j, t):
    tmpl = JT.param_template(j["cfg"], j["run"], j["rules"])
    params = JT.init_params(tmpl, jax.random.PRNGKey(0), j["cfg"].d_model)
    if j["rules"] is not None:
        params = jax.tree.map(jax.device_put, params,
                              JSP.named(j["mesh"], JT.param_specs(tmpl)))
    return params, convert.params_from_jax(jax.tree.map(np.asarray, params),
                                           t["cfg"], t["run"], t["rules"])


def _jax_zeros(j, tmpl):
    tree = jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), tmpl,
                        is_leaf=lambda x: isinstance(x, JT.PD))
    if j["rules"] is not None:
        tree = jax.tree.map(jax.device_put, tree,
                            JSP.named(j["mesh"], JT.param_specs(tmpl)))
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _caches_agree(got_np: dict, want) -> None:
    """int8 K/V equal but for rounding ties tipped by one step; scales
    within rtol 1e-5; every other leaf within 1e-4."""
    n_int8 = 0
    for path, leaf in T.leaves(got_np):
        w = np.asarray(_get(want, path))
        if leaf.dtype == np.int8:
            n_int8 += 1
            d = np.abs(leaf.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
                ("/".join(path), d.max(), (d > 0).mean())
        elif path[-1].endswith("_scale"):
            np.testing.assert_allclose(leaf, w, rtol=1e-5, atol=0,
                                       err_msg="/".join(path))
        else:
            np.testing.assert_allclose(leaf, w, atol=1e-4, rtol=0,
                                       err_msg="/".join(path))
    assert n_int8 >= 2


# ---------------------------------------------------------------------------
# the islands that write the cache: the quantization bit for bit
# ---------------------------------------------------------------------------

def _stored(t, a, spec):
    x = torch.from_numpy(a)
    if t["rules"] is None:
        return x
    return pgl.layout(x, spec, t["rules"].mesh, "model",
                      expand=False).contiguous()


def _global(t, x, spec):
    if t["rules"] is None:
        return x.numpy()
    return pgl.assemble(x, spec, t["rules"].mesh, "model").numpy()


def _int8_cache(cfg, shape, seed):
    """A random int8 cache of ``shape`` (B, Hkv, S, hd) and its scales."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            (rng.random(shape[:-1]) * 0.02).astype(np.float32))


@pytest.mark.parametrize("mesh_shape,seq_shard", [(None, True), ((1, 4), True),
                                                  ((2, 2), True),
                                                  ((1, 4), False)])
def test_slab_decode_quantizes_like_jax(mesh_shape, seq_shard):
    """``decode_attention`` in int8 mode over a random int8 cache: the
    sequence-sharded island (or, head-sharded, the write outside any
    island), per-slot positions."""
    j, t = _case(mesh_shape, seq_shard)
    jparams, tparams = _params(j, t)
    cfg = t["cfg"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, cfg.n_kv_heads, S_MAX, cfg.hd)
    ck, ks = _int8_cache(cfg, shape, 3)
    cv, vs = _int8_cache(cfg, shape, 4)
    pos = np.array([3, 11, 0, 15], np.int32)
    ja = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    # JAX's own template: the K/V spec and, from it, the scale planes'
    jtmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], batch=B,
                              s_max=S_MAX, slot_pos=True, kv_dtype="int8")
    jblk = jtmpl["blocks"]["pos0"]
    args = [ck, cv, ks, vs]
    if j["rules"] is not None:
        args = [jax.device_put(a, JSP.named(j["mesh"], type(jblk[n].spec)(
                    *jblk[n].spec[1:])))
                for a, n in zip(args, ("k", "v", "k_scale", "v_scale"))]
    jout, *jc = jax.jit(partial(
        JL.decode_attention, cfg=j["cfg"], run=j["run"], rules=j["rules"]))(
            ja, x, args[0], args[1], pos, k_scale=args[2], v_scale=args[3])
    ttmpl = T.cache_template(cfg, t["run"], t["rules"], batch=B, s_max=S_MAX,
                             slot_pos=True, kv_dtype="int8")["blocks"]["pos0"]
    specs = [P(*ttmpl[n].spec[1:]) for n in ("k", "v", "k_scale", "v_scale")]
    ta = {k: v[0] for k, v in tparams["blocks"]["pos0"]["attn"].items()}
    with torch.no_grad():
        out, *tc = L.decode_attention(
            ta, torch.from_numpy(x), *[_stored(t, a, s) for a, s in
                                       zip((ck, cv), specs[:2])],
            torch.from_numpy(pos).long(), cfg, t["run"], t["rules"],
            k_scale=_stored(t, ks, specs[2]), v_scale=_stored(t, vs, specs[3]))
    assert tc[0].dtype == torch.int8 and tc[2].dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)
    # the new token's K/V are the model's (GEMM-rounded): quantized
    # independently by each package; the cache's other cells stay put
    for got, want, spec, old in zip(tc, jc, specs, (ck, cv, ks, vs)):
        got = _global(t, got, spec)
        keep = np.ones(S_MAX, bool)
        for b, p in enumerate(pos):
            keep[:] = True
            keep[p] = False
            np.testing.assert_array_equal(got[b][:, keep], old[b][:, keep])
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - np.asarray(want).astype(int)
                          ).max() <= 1
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_decode_island_quantizes_bit_for_bit(mesh_shape):
    """The slab decode island on given q and new K/V: caches and scales
    bit for bit."""
    j, t = _case(mesh_shape)
    cfg = t["cfg"]
    rng = np.random.default_rng(5)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rng.standard_normal((B, hq, 1, hd)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, 1, hd)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, 1, hd)).astype(np.float32)
    shape = (B, hkv, S_MAX, hd)
    ck, ks = _int8_cache(cfg, shape, 6)
    cv, vs = _int8_cache(cfg, shape, 7)
    pos = np.array([3, 11, 0, 15], np.int32)
    jisl = JL.decode_island(j["cfg"], j["run"], j["rules"], B, S_MAX,
                            long_ctx=False, pos=jnp.asarray(pos),
                            kv_len=None, window=None, quant=True)
    jo, *jc = jax.jit(lambda *a: jisl(
        q=a[0], cache_k=a[1], cache_v=a[2], k_new=a[3], v_new=a[4],
        cache_ks=a[5], cache_vs=a[6], pos=a[7]))(q, ck, cv, kn, vn, ks, vs,
                                                 pos)
    tisl = L.decode_island(cfg, t["run"], t["rules"], B, S_MAX,
                           long_ctx=False, pos=torch.from_numpy(pos).long(),
                           kv_len=None, window=None, quant=True)
    assert (tisl.fallback_reason() is None) == (mesh_shape is not None)
    kv_spec = (t["rules"].kv_cache(hkv, B) if t["rules"] is not None
               else None)
    specs = [kv_spec, kv_spec] + [P(*kv_spec[:3]) if kv_spec else None] * 2
    with torch.no_grad():
        to, *tc = tisl(
            q=torch.from_numpy(q), k_new=torch.from_numpy(kn),
            v_new=torch.from_numpy(vn), pos=torch.from_numpy(pos).long(),
            **{n: _stored(t, a, s) for n, a, s in zip(
                ("cache_k", "cache_v", "cache_ks", "cache_vs"),
                (ck, cv, ks, vs), specs)})
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    for got, want, spec in zip(tc, jc, specs):
        np.testing.assert_array_equal(_global(t, got, spec), np.asarray(want))


@pytest.mark.parametrize("mesh_shape,seq_shard", [(None, True), ((1, 4), True),
                                                  ((2, 2), True),
                                                  ((2, 2), False)])
def test_prefill_write_quantizes_bit_for_bit(mesh_shape, seq_shard):
    j, t = _case(mesh_shape, seq_shard)
    cfg = t["cfg"]
    rng = np.random.default_rng(8)
    L_ = 10
    new = rng.standard_normal((B, cfg.n_kv_heads, L_, cfg.hd)).astype(
        np.float32)
    qn, sn = jax.jit(JL._kv_quantize)(new)
    tq, ts = L._kv_quantize(torch.from_numpy(new))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(qn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(sn))
    shape = (B, cfg.n_kv_heads, S_MAX, cfg.hd)
    ck, ks = _int8_cache(cfg, shape, 9)
    jw = JL.prefill_write_island(j["cfg"], j["run"], j["rules"], B, L_,
                                 quant=True)
    jc, js = jax.jit(lambda *a: jw(cache=a[0], scale=a[1], new=a[2],
                                   new_s=a[3]))(ck, ks, qn, sn)
    tw = L.prefill_write_island(cfg, t["run"], t["rules"], B, L_, quant=True)
    spec = (t["rules"].kv_cache(cfg.n_kv_heads, B)
            if t["rules"] is not None and seq_shard else None)
    sspec = P(*spec[:3]) if spec is not None else None
    st = (lambda a, s: _stored(t, a, s) if s is not None
          else torch.from_numpy(a))
    gl = (lambda x, s: _global(t, x, s) if s is not None else x.numpy())
    tc, tsc = tw(cache=st(ck, spec), scale=st(ks, sspec), new=tq, new_s=ts)
    np.testing.assert_array_equal(gl(tc, spec), np.asarray(jc))
    np.testing.assert_array_equal(gl(tsc, sspec), np.asarray(js))
    np.testing.assert_array_equal(gl(tc, spec)[:, :, L_:], ck[:, :, L_:])


PS, N_PAGES, PMAX = 4, 16, 6
BT = np.array([[0, 1, 2, 3, 4, 5], [-1] * 6, [8, 9, 10, 11, 12, 13],
               [14, 15, -1, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_paged_islands_quantize_bit_for_bit(kind, mesh_shape):
    j, t = _case(mesh_shape)
    cfg = t["cfg"]
    rng = np.random.default_rng(11)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq = 1 if kind == "decode" else 8
    q = rng.standard_normal((B, hq, sq, hd)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, sq, hd)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, sq, hd)).astype(np.float32)
    pshape = (N_PAGES, hkv, PS, hd)
    pk, pks = _int8_cache(cfg, pshape, 12)
    pv, pvs = _int8_cache(cfg, pshape, 13)
    pools = dict(pool_k=pk, pool_v=pv, pool_ks=pks, pool_vs=pvs)
    if kind == "decode":
        extra = dict(pos=np.array([21, 0, 13, 9], np.int32))
        jisl = JL.paged_decode_island(j["cfg"], j["run"], j["rules"], B, PS,
                                      window=None, quant=True)
        tisl = L.paged_decode_island(cfg, t["run"], t["rules"], B, PS,
                                     window=None, quant=True)
    else:
        extra = dict(c0=np.int32(8), wf=np.array([10, 0, 8, 13], np.int32))
        jisl = JL.paged_prefill_island(j["cfg"], j["run"], j["rules"], B, sq,
                                       PS, window=None, quant=True)
        tisl = L.paged_prefill_island(cfg, t["run"], t["rules"], B, sq, PS,
                                      window=None, quant=True)
    names = list(pools) + list(extra)
    jo, *jp = jax.jit(lambda q, kn, vn, bt, *a: jisl(
        q=q, k_new=kn, v_new=vn, bt=bt, **dict(zip(names, a))))(
            q, kn, vn, BT, *pools.values(), *extra.values())
    pspec = t["rules"].kv_pool(B) if t["rules"] is not None else None
    specs = [pspec, pspec] + [P(*pspec[:3]) if pspec else None] * 2
    with torch.no_grad():
        to, *tp = tisl(
            q=torch.from_numpy(q), k_new=torch.from_numpy(kn),
            v_new=torch.from_numpy(vn), bt=torch.from_numpy(BT),
            base=L._dp_pool_base(t["rules"], B, N_PAGES, "cpu"),
            **{n: _stored(t, a, s) for (n, a), s in zip(pools.items(),
                                                        specs)},
            **{n: torch.as_tensor(a).long() if a.ndim else torch.tensor(
                int(a)) for n, a in extra.items()})
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    for got, want, spec, old in zip(tp, jp, specs, pools.values()):
        got = _global(t, got, spec)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got != old).any()


# ---------------------------------------------------------------------------
# the model's steps: prefill + 4 decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,seq_shard", [
    (None, True), ((1, 4), True), ((2, 2), True), ((1, 4), False),
    ((2, 2), False)])
def test_slab_steps_match_jax(mesh_shape, seq_shard):
    j, t = _case(mesh_shape, seq_shard)
    jparams, tparams = _params(j, t)
    kw = dict(batch=B, s_max=S_MAX, slot_pos=True, kv_dtype="int8")
    jtmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], **kw)
    ttmpl = T.cache_template(t["cfg"], t["run"], t["rules"], **kw)
    jc = _jax_zeros(j, jtmpl)
    tc = T.zeros(ttmpl, t["rules"], "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(B, 8)).astype(np.int32)
    lens = np.array([5, 8, 2, 7], np.int32)
    jkw = dict(cfg=j["cfg"], run=j["run"], rules=j["rules"])
    jl, jc = jax.jit(partial(JT.prefill_step, **jkw))(jparams, jc, tokens,
                                                      lens)
    with torch.no_grad():
        tl, tc = T.prefill_step(tparams, tc, torch.from_numpy(tokens),
                                torch.from_numpy(lens), t["cfg"], t["run"],
                                t["rules"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jdec = jax.jit(partial(JT.decode_step, **jkw))
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, jc = jdec(jparams, jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(tparams, tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    assert tc["blocks"]["pos0"]["k"].dtype == torch.int8
    _caches_agree(convert.tree_to_numpy(tc, ttmpl, t["rules"]), jc)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_paged_steps_match_jax(mesh_shape):
    j, t = _case(mesh_shape)
    jparams, tparams = _params(j, t)
    parts = 2 if mesh_shape == (2, 2) else 1
    jg = JP.PageGeometry(PS, N_PAGES, PMAX, parts)
    tg = paging.PageGeometry(PS, N_PAGES, PMAX, parts)
    jtmpl = JP.paged_cache_template(j["cfg"], j["run"], j["rules"], batch=B,
                                    geom=jg, kv_dtype="int8")
    ttmpl = paging.paged_cache_template(t["cfg"], t["run"], t["rules"],
                                        batch=B, geom=tg, kv_dtype="int8")
    jc = jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), jtmpl,
                      is_leaf=lambda x: isinstance(x, JT.PD))
    jc["block_tables"] = jnp.full((B, PMAX), -1, jnp.int32)
    tc = convert.tree_from_numpy(jax.tree.map(np.asarray, jc), ttmpl,
                                 t["rules"])
    rng = np.random.default_rng(7)
    lens = np.array([13, 1, 16, 5], np.int32)
    tokens = rng.integers(0, 256, (B, 16)).astype(np.int32)
    wf = np.zeros(B, np.int32)
    jkw = dict(cfg=j["cfg"], run=j["run"], rules=j["rules"])
    jpre = jax.jit(partial(JT.prefill_paged_step, **jkw))
    for c0 in (0, 8):
        jl, jc = jpre(jparams, jc, tokens[:, c0:c0 + 8], BT, lens,
                      jnp.int32(c0), wf)
        with torch.no_grad():
            tl, tc = T.prefill_paged_step(
                tparams, tc, torch.from_numpy(tokens[:, c0:c0 + 8]),
                torch.from_numpy(BT), torch.from_numpy(lens), c0,
                torch.from_numpy(wf), t["cfg"], t["run"], t["rules"],
                page_size=PS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    bt_live = BT.copy()
    bt_live[1] = -1
    jc = {**jc, "block_tables": jnp.asarray(bt_live),
          "pos": jnp.asarray(lens)}
    tc["block_tables"] = torch.from_numpy(bt_live)
    tc["pos"] = torch.from_numpy(lens)
    jdec = jax.jit(partial(JT.decode_step, **jkw))
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, jc = jdec(jparams, jc, nxt[:, None])
        with torch.no_grad():
            tl, tc = T.decode_step(tparams, tc,
                                   torch.from_numpy(nxt[:, None]).long(),
                                   t["cfg"], t["run"], t["rules"],
                                   page_size=PS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    _caches_agree(convert.tree_to_numpy(tc, ttmpl, t["rules"]), jc)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _pair(mesh_shape, serve: dict):
    j, t = _case(mesh_shape)
    jparams, tparams = _params(j, t)
    jeng = JS.ServingEngine(j["cfg"], j["run"], j["rules"], jparams,
                            JaxServe(**serve))
    teng = S.ServingEngine(t["cfg"], t["run"], t["rules"], tparams,
                           ServeConfig(**serve), device="cpu")
    return jeng, teng


def _tokens(done):
    return {c.rid: c.tokens for c in done}


@pytest.mark.parametrize("serve", [SLAB8, PAGED8], ids=["slab", "paged"])
def test_engine_matches_jax_and_own_sequential(serve):
    """The trace of JAX's ``test_int8_kv_matches_own_sequential``: the
    same tokens, events, step kinds and cache stats as the JAX engine; and
    continuous batching equals one request at a time."""
    jeng, teng = _pair((2, 2), serve)
    trace = launch.synthetic_trace(4, ServeConfig(**serve),
                                   teng.cfg.vocab_size, seed=0)
    done = teng.run(trace)
    assert _tokens(done) == _tokens(jeng.run(trace))
    assert teng.events == jeng.events
    assert teng.step_kinds == jeng.step_kinds
    assert teng.cache_stats() == jeng.cache_stats()
    assert teng.cache_stats()["kv_dtype"] == "int8"
    for c in done[:2]:
        solo = S.ServingEngine(teng.cfg, teng.base_run, teng.rules,
                               teng.params, ServeConfig(**serve),
                               device="cpu")
        assert solo.run([trace[c.rid]])[0].tokens == c.tokens


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_int8_engine_on_other_meshes_matches_sequential(layout):
    serve = SLAB8 if layout == "slab" else PAGED8
    trace = launch.synthetic_trace(5, ServeConfig(**serve), 256, seed=3)
    for mesh_shape in (None, (1, 4), (2, 4)):
        eng = launch.build_engine(ARCH, reduced=True, mesh_shape=mesh_shape,
                                  serve=ServeConfig(**serve), device="cpu")
        got = _tokens(eng.run(trace))
        solo = launch.build_engine(ARCH, reduced=True, mesh_shape=mesh_shape,
                                   serve=ServeConfig(**serve), device="cpu")
        assert solo.run([trace[1]])[0].tokens == got[1]


# ---------------------------------------------------------------------------
# templates, bytes, plan record, CLI
# ---------------------------------------------------------------------------

def test_cache_bytes_at_int8():
    full = get_config(ARCH)
    assert paging.slab_hbm_bytes(full, 8, 1024, kv_dtype="int8") / \
        paging.slab_hbm_bytes(full, 8, 1024) == (64 + 4) / 128 == 0.53125
    eng8 = launch.build_engine(ARCH, reduced=True, mesh_shape=(1, 4),
                               serve=ServeConfig(**PAGED8), device="cpu")
    eng16 = launch.build_engine(
        ARCH, reduced=True, mesh_shape=(1, 4), device="cpu",
        serve=ServeConfig(**dict(PAGED8, kv_dtype="bf16")))
    hd = eng8.cfg.hd
    for key in ("hbm_bytes", "slab_bytes"):
        assert eng8.cache_stats()[key] * (2 * hd) == \
            eng16.cache_stats()[key] * (hd + 4)
    # the stored pools hold exactly those bytes
    held = sum(x.numel() * x.element_size()
               for x in T.leaves(eng8.cache["blocks"]) for x in [x[1]])
    assert held == eng8.cache_stats()["hbm_bytes"]


@pytest.mark.parametrize("mesh_shape,seq_shard", [(None, True), ((2, 2), True),
                                                  ((2, 2), False)])
def test_templates_match_jax_and_bf16_unchanged(mesh_shape, seq_shard):
    j, t = _case(mesh_shape, seq_shard)
    kw = dict(batch=B, s_max=S_MAX, slot_pos=True)
    a = T.cache_template(t["cfg"], t["run"], t["rules"], **kw)
    b = T.cache_template(t["cfg"], t["run"], t["rules"], kv_dtype="bf16",
                         **kw)
    assert a == b
    assert all("scale" not in "/".join(p) for p, _ in T.leaves(a))
    geom = paging.PageGeometry(PS, N_PAGES, PMAX,
                               2 if mesh_shape == (2, 2) else 1)
    jgeom = JP.PageGeometry(PS, N_PAGES, PMAX, geom.n_partitions)
    assert paging.paged_cache_template(
        t["cfg"], t["run"], t["rules"], batch=B, geom=geom) == \
        paging.paged_cache_template(t["cfg"], t["run"], t["rules"], batch=B,
                                    geom=geom, kv_dtype="bf16")
    for tt, jt in (
            (T.cache_template(t["cfg"], t["run"], t["rules"],
                              kv_dtype="int8", **kw),
             JT.cache_template(j["cfg"], j["run"], j["rules"],
                               kv_dtype="int8", **kw)),
            (paging.paged_cache_template(t["cfg"], t["run"], t["rules"],
                                         batch=B, geom=geom,
                                         kv_dtype="int8"),
             JP.paged_cache_template(j["cfg"], j["run"], j["rules"],
                                     batch=B, geom=jgeom, kv_dtype="int8"))):
        blk = tt["blocks"]["pos0"]
        assert set(blk) == {"k", "v", "k_scale", "v_scale"}
        assert blk["k"].dtype == torch.int8
        assert blk["k_scale"].dtype == torch.float32
        assert blk["k_scale"].shape == blk["k"].shape[:-1]
        for path, pd in T.leaves(tt):
            w = _get(jt, path)
            assert pd.shape == w.shape, path
            assert str(pd.dtype).split(".")[-1] == np.dtype(w.dtype).name, \
                path
            if seq_shard or path[0] != "blocks":
                assert tuple(pd.spec) == tuple(w.spec), path
            else:      # head-sharded: stored global (JAX shards the heads)
                assert pd.spec[3] is None, path


def test_plan_record_reports_wire_and_kv():
    j, t = _case((2, 2), comm_wire="int8")
    serve = dict(SLAB8)
    got = S.serving_plan_record(t["cfg"], t["run"], t["rules"],
                                ServeConfig(**serve))
    want = JS.serving_plan_record(j["cfg"], j["run"], j["rules"],
                                  JaxServe(**serve))
    assert got["comm_wire"] == want["comm_wire"] == "int8"
    assert got["cache"] == want["cache"]
    assert got["cache"]["kv_dtype"] == "int8"
    assert got["cache"]["scale_bytes_per_pos"] == \
        t["cfg"].n_layers * t["cfg"].n_kv_heads * 2 * 4
    for name, bp in got["buckets"].items():
        assert [(p["island"], p["backend"], p["wire"]) for p in
                bp["islands"]] == [(p["island"], p["backend"], p["wire"])
                                   for p in want["buckets"][name]["islands"]]


def test_cli_kv_dtype_and_comm_wire(capsys):
    launch.main(["--arch", ARCH, "--reduced", "--mode", "continuous",
                 "--mesh-shape", "1", "4", "--requests", "3", "--tokens",
                 "3", "--kv-dtype", "int8", "--comm-wire", "int8",
                 "--comm-backend", "ring", "--cache-layout", "paged", "--page-size", "4",
                 "--prefill-chunk", "8", "--device", "cpu"])
    launch.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
                 "5", "--tokens", "3", "--kv-dtype", "int8", "--comm-wire",
                 "int8_sr", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[cache] layout=paged kv=int8" in out
    assert "3 requests, 9 tokens" in out
    assert "wire=int8" in out
