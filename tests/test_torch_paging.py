"""The port's paged KV cache on the CPU, held against the JAX package:

* ``runtime/paging.py`` call for call against JAX's ``paging``: geometry
  and its padding, the undersized-pool and misaligned-chunk refusals, the
  allocator's order and refcounts, the prefix cache's register / lookup /
  evict, the pool specs and the cache template (SSM and encoder-decoder
  refused);
* the paged islands (``paged_decode_island``, ``paged_prefill_island``)
  on no mesh, (1, 4) and (2, 2), on random pools: outputs within 1e-5 and
  pools bit for bit, with −1 block-table rows, a partly unmapped row,
  nonzero ``write_from`` floors and the windowed ``h2o-danube`` config;
  the blocks around them (projections, RoPE, out-projection) within 1e-5;
* ``prefill_paged_step`` over two chunks and the paged ``decode_step``
  against JAX's, logits and pools within 1e-4.
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
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core import pgl  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import paging  # noqa: E402

torch.set_num_threads(1)

SERVE = dict(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
             max_new_tokens=4, cache_layout="paged", page_size=4)


def _serves(**kw):
    return JaxServe(**dict(SERVE, **kw)), ServeConfig(**dict(SERVE, **kw))


def _geom_tuple(g):
    return (g.page_size, g.n_pages, g.pages_per_slot, g.n_partitions,
            g.pages_per_partition, [g.pages_for(n) for n in (0, 1, 4, 5, 9)],
            [g.slot_partition(s, 4) for s in range(4)],
            [g.resident_capacity(n, b) for n in (1, 8, 20) for b in (4, 100)])


# ---------------------------------------------------------------------------
# paging.py against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,s_max,tp,parts", [
    ({}, 20, 1, 1), (dict(page_size=6), 24, 4, 1), (dict(n_pages=11), 8, 1, 2),
    (dict(n_pages=30, page_size=3), 36, 2, 2),
    (dict(prefill_chunk=8, page_size=4), 20, 1, 1)])
def test_geometry_matches_jax(kw, s_max, tp, parts):
    js, ts = _serves(**kw)
    want = JP.resolve_page_geometry(js, s_max=s_max, tp_size=tp,
                                    n_partitions=parts)
    got = paging.resolve_page_geometry(ts, s_max=s_max, tp_size=tp,
                                       n_partitions=parts)
    assert _geom_tuple(got) == _geom_tuple(want)


@pytest.mark.parametrize("kw,s_max,tp", [
    (dict(n_pages=4), 20, 1),                   # undersized pool
    (dict(prefill_chunk=4, page_size=4), 20, 8)])  # tp pads the page to 8
def test_geometry_refusals_match_jax(kw, s_max, tp):
    js, ts = _serves(**kw)
    with pytest.raises(ValueError) as want:
        JP.resolve_page_geometry(js, s_max=s_max, tp_size=tp)
    with pytest.raises(ValueError) as got:
        paging.resolve_page_geometry(ts, s_max=s_max, tp_size=tp)
    assert str(got.value) == str(want.value)


def _script(mod, geom_kw):
    """One sequence of allocator and prefix-cache calls; every result."""
    a = mod.PageAllocator(mod.PageGeometry(**geom_kw))
    pc = mod.PrefixCache(a, max_entries=2)
    hi = geom_kw["n_partitions"] - 1             # the last partition
    out = [a.alloc(0, 2), a.alloc(hi, 1), a.alloc(0, 13), a.free_pages(0),
           a.resident_pages]
    pages = a.alloc(0, 2)
    a.retain(pages)
    out += [a.release(pages), a.refcount(pages[0]), a.release(pages),
            a.resident_pages, a.alloc(0, 1)]
    pages = a.alloc(hi, 3)
    pc.register(hi, (1, 2, 3, 4, 5, 6, 7, 8, 9), pages, ("chunk", 8))
    pc.register(hi, (1, 2, 3, 4, 5, 6, 7, 8, 9), pages, ("chunk", 8))
    out += [a.release(pages), a.resident_pages]
    m, ent = pc.lookup(hi, (1, 2, 3, 4, 5, 99), ("chunk", 8))
    out += [m, ent.pages, pc.lookup(hi, (1, 2, 3), ("chunk", 4)),
            pc.lookup(0, (7, 2, 3), ("chunk", 8))]
    for seed in (50, 60):
        pg = a.alloc(hi, 1)
        pc.register(hi, (seed,), pg, ("chunk", 8))
        out.append(a.release(pg))
    out += [len(pc), a.refcount(pages[0]), pc.evict_one(hi),
            pc.evict_one(hi), pc.evict_one(hi), a.resident_pages,
            [a.free_pages(p) for p in range(hi + 1)]]
    return out


@pytest.mark.parametrize("parts", [1, 2])
def test_allocator_and_prefix_cache_match_jax(parts):
    kw = dict(page_size=4, n_pages=12, pages_per_slot=3, n_partitions=parts)
    assert _script(paging, kw) == _script(JP, kw)


def test_pool_specs_and_template_match_jax(mesh22):
    for seq_shard in (True, False):
        jcfg = jax_config("tinyllama-1.1b").reduced()
        tcfg = get_config("tinyllama-1.1b").reduced()
        kw = dict(dp_axes=("data",), fsdp=False, decode_seq_shard=seq_shard)
        jrun, trun = JaxRun(**kw), RunConfig(**kw)
        jrules = JaxRules(mesh22, jrun)
        trules = ShardingRules(VirtualMesh((2, 2), ("data", "model")), trun)
        js, ts = _serves()
        jg = JP.resolve_page_geometry(
            js, s_max=20, tp_size=2,
            n_partitions=JP.page_partitions(jrules, 4))
        tg = paging.resolve_page_geometry(
            ts, s_max=20, tp_size=2,
            n_partitions=paging.page_partitions(trules, 4))
        assert _geom_tuple(tg) == _geom_tuple(jg) and tg.n_partitions == 2
        jspec = tuple(JP.paged_kv_pool_spec(jrules, 2, 4, jg))
        # the port stores a head-sharded pool unsplit over tp
        assert tuple(trules.kv_pool(4)) == (
            jspec if seq_shard else (jspec[0], None, None, None))
        want = JP.paged_cache_template(jcfg, jrun, jrules, batch=4, geom=jg)
        got = paging.paged_cache_template(tcfg, trun, trules, batch=4,
                                          geom=tg)
        jleaves = dict(jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, JT.PD))[0])
        assert len(jleaves) == len(list(T.leaves(got)))
        for path, pd in T.leaves(got):
            w = want
            for k in path:
                w = w[k]
            assert pd.shape == w.shape, path
            if seq_shard or path[0] != "blocks":
                assert tuple(pd.spec) == tuple(w.spec), path
            else:          # head-sharded: stored global, pages over dp
                assert tuple(pd.spec) == (None, "data", None, None, None)
        assert paging.pool_hbm_bytes(tcfg, tg) == JP.pool_hbm_bytes(jcfg, jg)
        assert paging.slab_hbm_bytes(tcfg, 4, 20) == \
            JP.slab_hbm_bytes(jcfg, 4, 20)


def test_template_refuses_ssm_and_encdec():
    run = RunConfig(fsdp=False)
    geom = paging.resolve_page_geometry(ServeConfig(**SERVE), s_max=20)
    for arch, msg in (("falcon-mamba-7b", "pure-attention"),
                      ("jamba-1.5-large-398b", "pure-attention"),
                      ("whisper-medium", "encoder-decoder")):
        with pytest.raises(ValueError, match=msg):
            paging.paged_cache_template(get_config(arch).reduced(), run,
                                        None, batch=4, geom=geom)


# ---------------------------------------------------------------------------
# The paged islands and blocks against JAX's
# ---------------------------------------------------------------------------

B, PS, N_PAGES, PMAX = 4, 4, 16, 6
# rows 0-1 compute in dp group 0 (pages 0-7), rows 2-3 in group 1 (8-15)
# on (2, 2): row 1 is unmapped, row 3 mapped for its first 2 pages only
BT = np.array([[0, 1, 2, 3, 4, 5], [-1] * 6, [8, 9, 10, 11, 12, 13],
               [14, 15, -1, -1, -1, -1]], np.int32)


def _case(mesh_shape, arch, seq_shard=True):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=seq_shard)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jmesh = (compat.make_mesh(mesh_shape, ("data", "model"))
             if mesh_shape else None)
    jrules = JaxRules(jmesh, jrun) if jmesh is not None else None
    trules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
              if mesh_shape else None)
    return (dict(cfg=jcfg, run=jrun, rules=jrules, mesh=jmesh),
            dict(cfg=tcfg, run=trun, rules=trules))


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, cfg.n_kv_heads, PS, cfg.hd)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _stored(t, a):
    """A global pool as the port's island takes it."""
    x = torch.from_numpy(a)
    if t["rules"] is None:
        return x
    return pgl.layout(x, t["rules"].kv_pool(B), t["rules"].mesh, "model",
                      expand=False).contiguous()


def _global(t, x):
    if t["rules"] is None:
        return x.numpy()
    return pgl.assemble(x, t["rules"].kv_pool(B), t["rules"].mesh,
                        "model").numpy()


def _base(t):
    return L._dp_pool_base(t["rules"], B, N_PAGES, "cpu")


CASES = [(None, "tinyllama-1.1b"), ((1, 4), "tinyllama-1.1b"),
         ((2, 2), "tinyllama-1.1b"), ((1, 4), "h2o-danube-3-4b")]


@pytest.mark.parametrize("mesh_shape,arch", CASES)
def test_paged_decode_island_matches_jax(mesh_shape, arch):
    _check_decode_island(mesh_shape, arch)


@pytest.mark.parametrize("mesh_shape,arch", CASES)
def test_paged_prefill_island_matches_jax(mesh_shape, arch):
    _check_prefill_island(mesh_shape, arch)


@pytest.mark.parametrize("check", ["decode", "prefill"])
@pytest.mark.parametrize("mesh_shape,seq_shard", [((2, 2), False),
                                                  ((2, 1), True)])
def test_paged_islands_fall_back_per_dp_group(check, mesh_shape, seq_shard):
    """A paged island that falls back on a dp > 1 mesh (head-sharded
    caches; a tp axis of size 1) runs its reference once a dp group, over
    the group's pool partition with its block tables localized by
    ``base``: pools bit for bit as JAX's fallback. Row 3 attends cells of
    an unmapped page, which read the page its clamped id names: JAX's
    fallback, global, reads page 0; JAX's dp-sharded body reads its
    partition's first page, as the port does in both. So outputs match
    JAX's fallback on the other rows and JAX's sharded (2, 2) body on
    all."""
    fn = _check_decode_island if check == "decode" else _check_prefill_island
    fn(mesh_shape, "tinyllama-1.1b", seq_shard=seq_shard, rows=[0, 1, 2])
    fn(mesh_shape, "tinyllama-1.1b", seq_shard=seq_shard,
       jax_as=((2, 2), True))


def _case_pair(mesh_shape, arch, seq_shard, jax_as):
    """``_case``, with the JAX side on ``jax_as`` = (mesh, seq_shard) when
    given."""
    j, t = _case(mesh_shape, arch, seq_shard)
    if jax_as is not None:
        j = _case(jax_as[0], arch, jax_as[1])[0]
    return j, t


def _check_decode_island(mesh_shape, arch, seq_shard=True, rows=None,
                         jax_as=None):
    j, t = _case_pair(mesh_shape, arch, seq_shard, jax_as)
    cfg = t["cfg"]
    rng = np.random.default_rng(1)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rng.standard_normal((B, hq, 1, hd)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, 1, hd)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, 1, hd)).astype(np.float32)
    pk, pv = _pools(cfg, 2)
    # row 3 writes into its unmapped third page: dropped
    pos = np.array([21, 0, 13, 9], np.int32)
    win = cfg.sliding_window
    island = JL.paged_decode_island(j["cfg"], j["run"], j["rules"], B, PS,
                                    window=win)
    jo, jk, jv = jax.jit(lambda *a: island(
        q=a[0], pool_k=a[1], pool_v=a[2], k_new=a[3], v_new=a[4], bt=a[5],
        pos=a[6]))(q, pk, pv, kn, vn, BT, pos)
    tisland = L.paged_decode_island(cfg, t["run"], t["rules"], B, PS,
                                    window=win)
    assert (tisland.fallback_reason() is None) == (
        mesh_shape is not None and seq_shard and mesh_shape[1] > 1)
    with torch.no_grad():
        to, tk, tv = tisland(
            q=torch.from_numpy(q), pool_k=_stored(t, pk),
            pool_v=_stored(t, pv), k_new=torch.from_numpy(kn),
            v_new=torch.from_numpy(vn), bt=torch.from_numpy(BT),
            pos=torch.from_numpy(pos), base=_base(t))
    rows = slice(None) if rows is None else rows
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows],
                               atol=1e-5, rtol=0)
    for got, want, old in ((tk, jk, pk), (tv, jv, pv)):
        got = _global(t, got)
        np.testing.assert_array_equal(got, np.asarray(want))
        changed = np.argwhere((got != old).any(axis=(1, 3)))
        # rows 0 and 2 wrote one cell each; rows 1 and 3 dropped theirs
        assert sorted(map(tuple, changed)) == [(5, 1), (11, 1)]


def _check_prefill_island(mesh_shape, arch, seq_shard=True, rows=None,
                          jax_as=None):
    j, t = _case_pair(mesh_shape, arch, seq_shard, jax_as)
    cfg = t["cfg"]
    rng = np.random.default_rng(3)
    hq, hkv, hd, sq = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 8
    q = rng.standard_normal((B, hq, sq, hd)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, sq, hd)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, sq, hd)).astype(np.float32)
    pk, pv = _pools(cfg, 4)
    c0 = 8                                       # pages 2 and 3
    wf = np.array([10, 0, 8, 13], np.int32)      # copy-on-write floors
    win = cfg.sliding_window
    island = JL.paged_prefill_island(j["cfg"], j["run"], j["rules"], B, sq,
                                     PS, window=win)
    jo, jk, jv = jax.jit(lambda *a: island(
        q=a[0], pool_k=a[1], pool_v=a[2], k_new=a[3], v_new=a[4], bt=a[5],
        c0=a[6], wf=a[7]))(q, pk, pv, kn, vn, BT, jnp.int32(c0), wf)
    tisland = L.paged_prefill_island(cfg, t["run"], t["rules"], B, sq, PS,
                                     window=win)
    assert (tisland.fallback_reason() is None) == (
        mesh_shape is not None and seq_shard and mesh_shape[1] > 1)
    with torch.no_grad():
        to, tk, tv = tisland(
            q=torch.from_numpy(q), pool_k=_stored(t, pk),
            pool_v=_stored(t, pv), k_new=torch.from_numpy(kn),
            v_new=torch.from_numpy(vn), bt=torch.from_numpy(BT),
            c0=torch.tensor(c0), wf=torch.from_numpy(wf), base=_base(t))
    rows = slice(None) if rows is None else rows
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows],
                               atol=1e-5, rtol=0)
    for got, want, old, new in ((tk, jk, pk, kn), (tv, jv, pv, vn)):
        got = _global(t, got)
        np.testing.assert_array_equal(got, np.asarray(want))
        # row 0: cells below its floor (8, 9) keep the donor's bytes
        np.testing.assert_array_equal(got[2, :, :2], old[2, :, :2])
        np.testing.assert_array_equal(got[2, :, 2:], new[0, :, 2:4])
        # row 3's pages 2 and 3 are unmapped: nothing written anywhere else
        untouched = [p for p in range(N_PAGES) if p not in (2, 3, 10, 11)]
        np.testing.assert_array_equal(got[untouched], old[untouched])


@pytest.mark.parametrize("mesh_shape,arch", CASES[1:3])
def test_paged_blocks_match_jax(mesh_shape, arch):
    """``paged_prefill_attention_block`` then ``paged_decode_attention``,
    projections and RoPE included, with the JAX package's parameters."""
    j, t = _case(mesh_shape, arch)
    tmpl = JT.param_template(j["cfg"], j["run"], j["rules"])
    params = JT.init_params(tmpl, jax.random.PRNGKey(0), j["cfg"].d_model)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      t["cfg"], t["run"], t["rules"])
    ja = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["attn"])
    ta = {k: v[0] for k, v in tparams["blocks"]["pos0"]["attn"].items()}
    rng = np.random.default_rng(5)
    d = t["cfg"].d_model
    x = rng.standard_normal((B, 8, d)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
    pk, pv = _pools(t["cfg"], 6)
    wf = np.array([10, 0, 8, 13], np.int32)
    pos = np.array([16, 0, 14, 7], np.int32)
    kw = dict(cfg=j["cfg"], run=j["run"], rules=j["rules"])
    jo, jk, jv = jax.jit(partial(JL.paged_prefill_attention_block, **kw))(
        ja, x, pk, pv, BT, jnp.int32(8), wf)
    jo1, jk, jv = jax.jit(partial(JL.paged_decode_attention, **kw))(
        ja, x1, jk, jv, BT, pos)
    tkw = dict(cfg=t["cfg"], run=t["run"], rules=t["rules"], page_size=PS)
    with torch.no_grad():
        to, tk, tv = L.paged_prefill_attention_block(
            ta, torch.from_numpy(x), _stored(t, pk), _stored(t, pv),
            torch.from_numpy(BT), 8, torch.from_numpy(wf), **tkw)
        to1, tk, tv = L.paged_decode_attention(
            ta, torch.from_numpy(x1), tk, tv, torch.from_numpy(BT),
            torch.from_numpy(pos), **tkw)
    for got, want in ((to, jo), (to1, jo1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_global(t, got), np.asarray(want),
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# prefill_paged_step and the paged decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_paged_steps_match_jax(mesh_shape):
    j, t = _case(mesh_shape, "tinyllama-1.1b")
    tmpl = JT.param_template(j["cfg"], j["run"], j["rules"])
    params = JT.init_params(tmpl, jax.random.PRNGKey(0), j["cfg"].d_model)
    if j["rules"] is not None:
        params = jax.tree.map(jax.device_put, params,
                              JSP.named(j["mesh"], JT.param_specs(tmpl)))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      t["cfg"], t["run"], t["rules"])
    parts = 2 if mesh_shape == (2, 2) else 1
    jg = JP.PageGeometry(PS, N_PAGES, PMAX, parts)
    tg = paging.PageGeometry(PS, N_PAGES, PMAX, parts)
    jtmpl = JP.paged_cache_template(j["cfg"], j["run"], j["rules"], batch=B,
                                    geom=jg)
    ttmpl = paging.paged_cache_template(t["cfg"], t["run"], t["rules"],
                                        batch=B, geom=tg)
    jcache = jax.tree.map(lambda pd: jnp.zeros(pd.shape, pd.dtype), jtmpl,
                          is_leaf=lambda x: isinstance(x, JT.PD))
    jcache["block_tables"] = jnp.full((B, PMAX), -1, jnp.int32)
    tcache = convert.tree_from_numpy(jax.tree.map(np.asarray, jcache),
                                     ttmpl, t["rules"])
    rng = np.random.default_rng(7)
    lens = np.array([13, 1, 16, 5], np.int32)
    tokens = rng.integers(0, 256, (B, 16)).astype(np.int32)
    wf = np.zeros(B, np.int32)
    kw = dict(cfg=j["cfg"], run=j["run"], rules=j["rules"])
    jpre = jax.jit(partial(JT.prefill_paged_step, **kw))
    jdec = jax.jit(partial(JT.decode_step, **kw))
    for c0 in (0, 8):
        jl, jcache = jpre(params, jcache, tokens[:, c0:c0 + 8], BT, lens,
                          jnp.int32(c0), wf)
        with torch.no_grad():
            tl, tcache = T.prefill_paged_step(
                tparams, tcache, torch.from_numpy(tokens[:, c0:c0 + 8]),
                torch.from_numpy(BT), torch.from_numpy(lens), c0,
                torch.from_numpy(wf), t["cfg"], t["run"], t["rules"],
                page_size=PS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    # commit the group's block tables and positions, then decode twice
    bt_live = BT.copy()
    bt_live[1] = -1
    jcache = {**jcache, "block_tables": jnp.asarray(bt_live),
              "pos": jnp.asarray(lens)}
    tcache["block_tables"] = torch.from_numpy(bt_live)
    tcache["pos"] = torch.from_numpy(lens)
    nxt = rng.integers(0, 256, (B, 1)).astype(np.int32)
    for _ in range(2):
        jl, jcache = jdec(params, jcache, nxt)
        with torch.no_grad():
            tl, tcache = T.decode_step(tparams, tcache, torch.from_numpy(nxt),
                                       t["cfg"], t["run"], t["rules"],
                                       page_size=PS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    got = convert.tree_to_numpy(tcache, ttmpl, t["rules"])
    for path, leaf in T.leaves(got):
        want = jcache
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf, np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg="/".join(path))
