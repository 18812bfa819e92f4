"""The port's paged serving engine (``cache_layout="paged"``), head-sharded
caches and serving on dp > 1 meshes, on the CPU:

* paged continuous == slab continuous == one request at a time, on no
  mesh, (1, 4), (2, 2) and (2, 4) (a dp-partitioned pool, tp-striped
  pages); single-shot paged prefill == chunked;
* the port's greedy tokens, ``events`` (admit, retire, prefill_chunk, with
  their cache metrics) and ``cache_stats()`` equal to the JAX engine's on
  the same trace, with the JAX package's parameters converted, in float32
  — decode ticks between two prefill chunks of one request among them;
* copy-on-write prefix sharing, pool exhaustion as backpressure, >= 4x
  resident slots at equal cache bytes, the plan record's cache section;
* the slab engine on (2, 2) and (2, 4) against the JAX engine;
* head-sharded caches (``decode_seq_shard=False``) on (1, 4) and (2, 2),
  slab and paged, and one reduced MoE model (moonshot), token for token against
  JAX's paged engine (MoE serving is not continuous == sequential).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.configs.base import ServeConfig as JaxServe  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import paging  # noqa: E402
from repro_torch.runtime import serving as S  # noqa: E402

torch.set_num_threads(1)

SLAB = dict(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
            max_new_tokens=4)
PAGED = dict(SLAB, cache_layout="paged", page_size=4, prefill_chunk=8)
#: decode ticks land between the chunks of a 27-token prompt
INTERLEAVE = dict(max_batch=4, prefill_batch=2, bucket_edges=(8, 32),
                  max_new_tokens=6, cache_layout="paged", page_size=4,
                  prefill_chunk=8)


def _engine(mesh_shape, serve: dict, **kw):
    return launch.build_engine("tinyllama-1.1b", reduced=True,
                               mesh_shape=mesh_shape,
                               serve=ServeConfig(**serve), device="cpu", **kw)


def _trace(serve: dict, n, seed=0):
    return launch.synthetic_trace(n, ServeConfig(**serve), 256, seed=seed)


def _pair(arch, mesh_shape, serve: dict, **run_kw):
    """(JAX engine, port engine) over the same float32 parameters: JAX's,
    converted by ``convert.params_from_jax``."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=mesh_shape is not None)
    kw.update(run_kw)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jmesh = (compat.make_mesh(mesh_shape, ("data", "model"))
             if mesh_shape else None)
    jrules = JaxRules(jmesh, jrun) if jmesh is not None else None
    trules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
              if mesh_shape else None)
    tmpl = JT.param_template(jcfg, jrun, jrules)
    params = JT.init_params(tmpl, jax.random.PRNGKey(0), jcfg.d_model)
    if jrules is not None:
        params = jax.tree.map(jax.device_put, params,
                              JSP.named(jmesh, JT.param_specs(tmpl)))
    jeng = JS.ServingEngine(jcfg, jrun, jrules, params, JaxServe(**serve))
    teng = S.ServingEngine(tcfg, trun, trules, convert.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, trun, trules),
        ServeConfig(**serve), device="cpu")
    return jeng, teng


def _fresh(eng, serve: dict):
    """A new port engine over ``eng``'s model and parameters."""
    return S.ServingEngine(eng.cfg, eng.base_run, eng.rules, eng.params,
                           ServeConfig(**serve), device="cpu")


def _tokens(done):
    return {c.rid: c.tokens for c in done}


# ---------------------------------------------------------------------------
# Paged == slab == sequential; single-shot == chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (2, 2), (2, 4)])
def test_paged_matches_slab_and_sequential(mesh_shape):
    trace = _trace(SLAB, 5)
    slab = _tokens(_engine(mesh_shape, SLAB).run(trace))
    paged_eng = _engine(mesh_shape, PAGED)
    paged = _tokens(paged_eng.run(trace))
    assert paged == slab
    assert paged_eng.stats()["compiled_buckets"] == [8]   # one chunk step
    for rid in (0, 2):
        solo = _engine(mesh_shape, PAGED).run([trace[rid]])[0]
        assert paged[rid] == solo.tokens


def test_paged_single_shot_matches_chunked():
    trace = _trace(SLAB, 4)
    single = _engine(None, dict(PAGED, prefill_chunk=0))
    chunked = _engine(None, PAGED)
    assert _tokens(single.run(trace)) == _tokens(chunked.run(trace))
    assert single.stats()["compiled_buckets"] == [8, 16]


# ---------------------------------------------------------------------------
# Against the JAX engine: tokens, events, cache_stats
# ---------------------------------------------------------------------------

def _same_as_jax(jeng, teng, trace):
    assert _tokens(teng.run(trace)) == _tokens(jeng.run(trace))
    assert teng.events == jeng.events
    assert teng.step_kinds == jeng.step_kinds
    assert teng.cache_stats() == jeng.cache_stats()


@pytest.mark.parametrize("mesh_shape", [None, (2, 2), (1, 4), (2, 4)])
def test_paged_engine_matches_jax(mesh_shape):
    jeng, teng = _pair("tinyllama-1.1b", mesh_shape, PAGED)
    _same_as_jax(jeng, teng, _trace(PAGED, 5, seed=1))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_slab_engine_on_dp_meshes_matches_jax(mesh_shape):
    """The slab engine on dp > 1: each dp group's cache rows sliced and
    joined over dp (A7c), against the JAX engine."""
    jeng, teng = _pair("tinyllama-1.1b", mesh_shape, SLAB)
    _same_as_jax(jeng, teng, _trace(SLAB, 5, seed=1))


def test_decode_ticks_between_chunks_match_jax():
    """A 27-token prompt runs 4 chunks of 8; the short request admitted
    before it decodes between them. Events, step kinds and tokens equal
    JAX's, and the interleaved decode corrupts neither request."""
    jeng, teng = _pair("tinyllama-1.1b", (2, 2), INTERLEAVE)
    rng = np.random.RandomState(5)
    short = tuple(int(t) for t in rng.randint(0, 256, 6))
    long = tuple(int(t) for t in rng.randint(0, 256, 27))
    for eng in (jeng, teng):
        eng.submit(short)
        eng.submit(long)
    done = _tokens(teng.run())
    assert done == _tokens(jeng.run())
    assert teng.events == jeng.events
    assert teng.step_kinds == jeng.step_kinds
    assert teng.cache_stats() == jeng.cache_stats()
    chunk_steps = [e[1] for e in teng.events
                   if e[0] == "prefill_chunk" and 1 in e[2]]
    assert [e[3] for e in teng.events
            if e[0] == "prefill_chunk" and 1 in e[2]] == [0, 1, 2, 3]
    gaps = [range(a + 1, b) for a, b in zip(chunk_steps, chunk_steps[1:])]
    assert all(any(teng.step_kinds[s] == "decode" for s in gap)
               for gap in gaps), (chunk_steps, teng.step_kinds)
    admit = next(e for e in teng.events if e[0] == "admit" and e[2] == 1)
    assert admit[1] == chunk_steps[-1]
    assert done[1] == _fresh(teng, INTERLEAVE).run([long])[0].tokens
    assert done[0] == _fresh(teng, INTERLEAVE).run([short])[0].tokens


def test_moe_paged_engine_matches_jax():
    """moonshot ``.reduced()`` serves paged with prefix sharing off, token
    for token and event for event as JAX's paged engine."""
    serve = dict(PAGED, max_new_tokens=3)
    jeng, teng = _pair("moonshot-v1-16b-a3b", (1, 4), serve)
    assert not teng._share_ok
    trace = _trace(serve, 4, seed=2)
    assert _tokens(teng.run(trace)) == _tokens(jeng.run(trace))
    assert teng.events == jeng.events
    assert teng.cache_stats() == jeng.cache_stats()


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_head_sharded_caches_match_jax(layout):
    """``decode_seq_shard=False`` on (1, 4): the port stores the cache
    global and runs no cache island, as JAX's islands fall back."""
    serve = PAGED if layout == "paged" else SLAB
    jeng, teng = _pair("tinyllama-1.1b", (1, 4), serve,
                       decode_seq_shard=False)
    trace = _trace(serve, 4, seed=3)
    assert _tokens(teng.run(trace)) == _tokens(jeng.run(trace))
    assert teng.events == jeng.events
    k = teng.cache["blocks"]["pos0"]["k"]
    assert k.dim() == 5                           # (np, ...) global, no rank
    plans = {p.island: p for p in teng.bucket_plans["decode"].plans}
    assert plans["decode_attn"].reason == "disabled by RunConfig"


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_head_sharded_caches_on_dp_match_jax(layout):
    """``decode_seq_shard=False`` on (2, 2): the cache islands fall back
    once a dp group, over the group's cache rows or pool partition (block
    tables localized by the group's first page); tokens, events and
    ``cache_stats()`` as JAX's."""
    serve = PAGED if layout == "paged" else SLAB
    jeng, teng = _pair("tinyllama-1.1b", (2, 2), serve,
                       decode_seq_shard=False)
    _same_as_jax(jeng, teng, _trace(serve, 5, seed=4))
    if layout == "paged":
        assert teng.geom.n_partitions == 2


# ---------------------------------------------------------------------------
# Prefix sharing, backpressure, the memory story
# ---------------------------------------------------------------------------

def test_prefix_share_then_diverge_cow():
    serve = dict(PAGED, prefill_batch=1)
    eng = _engine(None, serve)
    base = tuple(range(1, 12))                   # 2 full pages + a partial
    eng.run([base])
    fork = base[:10] + (99, 98)                  # diverges inside page 2
    assert eng.prefix_match_len(fork) == 10
    done = eng.run([fork])[0]
    cs = eng.cache_stats()
    assert (cs["prefix_hits"], cs["shared_pages_reused"],
            cs["cow_copies"]) == (1, 2, 1)
    assert done.tokens == _engine(None, serve).run([fork])[0].tokens
    for part in range(eng.geom.n_partitions):
        while eng.prefix.evict_one(part):
            pass
    assert eng.allocator.resident_pages == 0


def test_prefix_share_on_a_mesh_matches_jax():
    """Share-then-diverge on (2, 2): the donor's pages and the copied
    boundary page in the dp partition of the slot, the same tokens and
    counters as JAX's."""
    serve = dict(PAGED, prefill_batch=2)
    jeng, teng = _pair("tinyllama-1.1b", (2, 2), serve)
    base = tuple(range(1, 12))
    fork = base[:10] + (99, 98)
    for eng in (jeng, teng):
        eng.run([base, base[:7] + (5,)])
    assert _tokens(teng.run([fork])) == _tokens(jeng.run([fork]))
    assert teng.cache_stats() == jeng.cache_stats()
    assert teng.cache_stats()["cow_copies"] >= 1


def test_pool_exhaustion_backpressures_admission():
    serve = dict(max_batch=4, prefill_batch=2, bucket_edges=(8,),
                 max_new_tokens=4, cache_layout="paged", page_size=4,
                 n_pages=6)                      # 2 whole requests' worth
    eng = _engine(None, serve)
    trace = _trace(serve, 6, seed=3)
    done = eng.run(trace)
    assert len(done) == len(trace)
    cs = eng.cache_stats()
    assert cs["admission_blocked"] > 0
    assert cs["peak_resident_pages"] <= 6
    assert cs["peak_resident_slots"] <= 2
    assert done[-1].tokens == _engine(None, serve).run([trace[-1]])[0].tokens


def test_paged_4x_resident_slots_at_equal_bytes():
    """A pool of the slab's bytes (one slot of 36 cells: 9 pages of 4)
    keeps 4 short requests (2 pages each) resident where the slab keeps
    one."""
    slab = dict(max_batch=1, prefill_batch=1, bucket_edges=(32,),
                max_new_tokens=4)
    paged = dict(max_batch=4, prefill_batch=4, bucket_edges=(32,),
                 max_new_tokens=4, cache_layout="paged", page_size=4,
                 n_pages=9)
    es, ep = _engine(None, slab), _engine(None, paged)
    assert paging.pool_hbm_bytes(ep.cfg, ep.geom) == \
        paging.slab_hbm_bytes(es.cfg, 1, es.s_max)
    rng = np.random.RandomState(11)
    trace = [tuple(int(t) for t in rng.randint(0, 256, 4))
             for _ in range(6)]
    assert _tokens(es.run(trace)) == _tokens(ep.run(trace))
    ss, sp = es.cache_stats(), ep.cache_stats()
    assert ss["hbm_bytes"] == sp["hbm_bytes"]
    assert ss["peak_resident_slots"] == 1
    assert sp["peak_resident_slots"] >= 4 * ss["peak_resident_slots"]


def test_plan_record_cache_section_matches_jax(mesh22):
    jcfg = jax_config("tinyllama-1.1b").reduced()
    tcfg = get_config("tinyllama-1.1b").reduced()
    kw = dict(dp_axes=("data",), fsdp=False)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    want = JS.serving_plan_record(jcfg, jrun, JaxRules(mesh22, jrun),
                                  JaxServe(**PAGED))
    got = S.serving_plan_record(
        tcfg, trun, ShardingRules(VirtualMesh((2, 2), ("data", "model")),
                                  trun), ServeConfig(**PAGED))
    assert got["cache"] == want["cache"]
    assert got["config"] == want["config"]
    assert set(got["buckets"]) == set(want["buckets"]) == \
        {"prefill@chunk8", "decode"}
    for name, bp in got["buckets"].items():
        assert [p["island"] for p in bp["islands"]] == \
            [p["island"] for p in want["buckets"][name]["islands"]]
        assert [p["fallback"] for p in bp["islands"]] == \
            [p["fallback"] for p in want["buckets"][name]["islands"]]
    assert got["cache"]["n_partitions"] == 2
    assert got["cache"]["pool_bytes"] == got["cache"]["slab_bytes"]


def test_refusals_that_stay():
    """Health and deadlines (A13), int8 caches (A11) and
    ``serve_moe_tp_data`` (A9c) serve paged now — the first two as JAX's
    paged engine does; a paged pool refuses SSM models, as JAX's template
    does."""
    for extra in (dict(health_monitor=True), dict(deadline_steps=3)):
        jeng, teng = _pair("tinyllama-1.1b", None, dict(PAGED, **extra))
        trace = _trace(PAGED, 5, seed=1)
        assert _tokens(teng.run(trace)) == _tokens(jeng.run(trace))
        assert teng.events == jeng.events
        assert teng.expired == jeng.expired
        assert teng.cache_stats() == jeng.cache_stats()
    trace = _trace(PAGED, 3)
    eng8 = _engine((1, 4), dict(PAGED, kv_dtype="int8"))
    assert eng8.cache["blocks"]["pos0"]["k_scale"].dtype == torch.float32
    assert len(eng8.run(trace)) == 3
    moe = launch.build_engine("moonshot-v1-16b-a3b", reduced=True,
                              mesh_shape=(2, 2), serve=ServeConfig(**PAGED),
                              device="cpu",
                              run_overrides={"serve_moe_tp_data": True})
    assert len(moe.run(trace)) == 3
    with pytest.raises(ValueError, match="pure-attention"):
        launch.build_engine("falcon-mamba-7b", reduced=True,
                            serve=ServeConfig(**PAGED, exact_buckets=True),
                            device="cpu")
