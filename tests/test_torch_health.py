"""Runtime health of the port (``repro_torch.runtime.health`` and the
engine's hooks) against the JAX package:

* ``CommFaultPlan``: parses, rejections, duplicates and contradictions on
  the inputs of ``tests/test_health.py``, with JAX's events and error
  texts; ``CommFaultEvent``'s checks; ``demotion_ladder``;
* ``HealthMonitor`` fed the same seeded step times, guard trips, link
  downs and ups as JAX's: the same return values, ``events``,
  ``overrides()``, levels and rungs after every call;
* the engines on ``.reduced()`` tinyllama-1.1b on (1, 4) and (1, 8), with
  JAX's parameters converted, in float32: a corrupted ring hop caught by
  the island guards and quarantined, retried, a bitflip, a corrupt decode
  step on the paged layout, a sustained stall demoting ``mlp`` and
  promoting it after probation, and ``deadline_steps`` — the quarantined
  and expired sets, ``events`` (guard trips and health events among them,
  step for step), step kinds, ``plan_record()["health_overrides"]`` after
  every step and the tokens equal JAX's. Both engines' step timers are
  pinned to 10 ms a step, so the monitor's decisions depend on the
  scripted faults only.
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
from repro.runtime import health as JH  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import health as TH  # noqa: E402
from repro_torch.runtime import serving as S  # noqa: E402

torch.set_num_threads(1)


def _ev(e):
    return dataclasses.astuple(e)


# ---------------------------------------------------------------------------
# CommFaultPlan grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "corrupt:mlp@1, stall:attn_out@3x4; linkdown:mlp@7 bitflip:embed@2",
    "corrupt:mlp@1 stall:mlp@1", "", "linkdown:*@2x5"])
def test_comm_fault_plan_parse_matches_jax(spec):
    j, t = JH.CommFaultPlan.parse(spec), TH.CommFaultPlan.parse(spec)
    assert [_ev(e) for e in t.events] == [_ev(e) for e in j.events]
    for step in range(10):
        assert [_ev(e) for e in t.at(step)] == [_ev(e) for e in j.at(step)]


@pytest.mark.parametrize("bad", [
    "boom:mlp@1", "corrupt:mlp", "corrupt:@1", "corrupt:mlp@-1",
    "stall:mlp@2x0", "corrupt:mlp@1 corrupt:mlp@1",
    "corrupt:mlp@1 bitflip:mlp@1"])
def test_comm_fault_plan_rejections_match_jax(bad):
    with pytest.raises(ValueError) as je:
        JH.CommFaultPlan.parse(bad)
    with pytest.raises(ValueError) as te:
        TH.CommFaultPlan.parse(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("args,kw", [
    (("nope", "mlp", 1), {}), (("stall", "mlp", 1), {"ticks": 0}),
    (("stall", "mlp", -1), {}), (("corrupt", "", 1), {}),
    (("corrupt", "mlp", 1), {"hop": -1})])
def test_comm_fault_event_checks_match_jax(args, kw):
    with pytest.raises(ValueError) as je:
        JH.CommFaultEvent(*args, **kw)
    with pytest.raises(ValueError) as te:
        TH.CommFaultEvent(*args, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("backend,chunks", [
    ("ring_bidir", None), ("ring_bidir", 2), ("ring", None),
    ("fused", None), ("chunked", 4), ("bulk", None)])
def test_demotion_ladder_matches_jax(backend, chunks):
    assert TH.demotion_ladder(backend, chunks) == \
        JH.demotion_ladder(backend, chunks)


def test_kinds_match_jax():
    assert TH.COMM_FAULT_KINDS == JH.COMM_FAULT_KINDS
    assert TH.PAYLOAD_FAULT_KINDS == JH.PAYLOAD_FAULT_KINDS


# ---------------------------------------------------------------------------
# HealthMonitor, call for call
# ---------------------------------------------------------------------------

_LADDERS = {"mlp": (("bulk", None),),
            "attn_out": JH.demotion_ladder("ring_bidir"),
            "a2a": JH.demotion_ladder("chunked", 4)}


@pytest.mark.parametrize("seed", range(6))
def test_monitor_matches_jax_on_seeded_feeds(seed):
    rng = np.random.RandomState(seed)
    kw = dict(factor=2.5 + seed % 3, demote_after=1 + seed % 3,
              probation=2 + seed % 4, min_samples=1 + seed % 3,
              expected={"mlp": 0.01} if seed % 2 else None)
    j, t = JH.HealthMonitor(_LADDERS, **kw), TH.HealthMonitor(_LADDERS, **kw)
    names = sorted(_LADDERS) + ["embed"]          # embed is not monitored
    for step in range(150):
        isl = names[int(rng.randint(len(names)))]
        op = rng.rand()
        if op < 0.04:
            res = [m.guard_trip(isl, step) for m in (j, t)]
        elif op < 0.07:
            res = [m.link_down(isl, step) for m in (j, t)]
        elif op < 0.10:
            res = [m.link_up(isl, step) for m in (j, t)]
        else:
            dt = float(rng.lognormal(-4.0, 0.2))
            if rng.rand() < 0.2:
                dt *= float(rng.uniform(2, 60))
            res = [m.record(isl, step, dt) for m in (j, t)]
        assert res[1] == res[0], (step, isl)
        assert t.events == j.events
        assert t.overrides() == j.overrides()
        for name in _LADDERS:
            assert t.level(name) == j.level(name)
            assert t.rung(name) == j.rung(name)
            assert t._probation_for(t._state[name]) == \
                j._probation_for(j._state[name])
    assert t.islands == j.islands


# ---------------------------------------------------------------------------
# The engines against JAX's
# ---------------------------------------------------------------------------

_PROMPTS = [tuple(range(1, 6)), tuple(range(2, 7)),
            tuple(range(3, 8)), tuple(range(4, 9))]
SERVE = dict(max_batch=4, prefill_batch=2, bucket_edges=(8,),
             max_new_tokens=4)
_PARAMS: dict = {}


class _FixedTimer:
    """A step timer whose every step took 10 ms."""

    dt = 0.01

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(JS, "StepTimer", _FixedTimer)
    monkeypatch.setattr(S, "StepTimer", _FixedTimer)


def _params(mesh_shape, jcfg, jrun, jrules):
    """JAX's parameters for a mesh, made once a module."""
    if mesh_shape not in _PARAMS:
        tmpl = JT.param_template(jcfg, jrun, jrules)
        p = JT.init_params(tmpl, jax.random.PRNGKey(0), jcfg.d_model)
        _PARAMS[mesh_shape] = (p, jax.tree.map(np.asarray, p))
    p, host = _PARAMS[mesh_shape]
    if jrules is not None:
        p = jax.tree.map(jax.device_put, p,
                         JSP.named(jrules.mesh,
                                   JT.param_specs(JT.param_template(
                                       jcfg, jrun, jrules))))
    return p, host


def _plans(events):
    """(JAX's plan, the port's) from CommFaultEvent keyword sets."""
    return (JH.CommFaultPlan(events=tuple(JH.CommFaultEvent(**e)
                                          for e in events)),
            TH.CommFaultPlan(events=tuple(TH.CommFaultEvent(**e)
                                          for e in events)))


def _pair(mesh_shape, serve: dict, faults=(), **run_kw):
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    kw = dict(fsdp=False, decode_seq_shard=True)
    kw.update(run_kw)
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jrules = JaxRules(compat.make_mesh(mesh_shape, ("data", "model")), jrun)
    trules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
    params, host = _params(mesh_shape, jcfg, jrun, jrules)
    jplan, tplan = _plans(faults)
    jeng = JS.ServingEngine(jcfg, jrun, jrules, params, JaxServe(**serve),
                            comm_faults=jplan)
    teng = S.ServingEngine(tcfg, trun, trules,
                           convert.params_from_jax(host, tcfg, trun, trules),
                           ServeConfig(**serve), comm_faults=tplan,
                           device="cpu")
    return jeng, teng


def _drive(eng, prompts):
    """Submit, then step until done; the live health overrides after every
    step."""
    for p in prompts:
        eng.submit(p)
    hov = []
    while eng.pending:
        eng.step()
        hov.append(eng.plan_record()["health_overrides"])
    return hov


_STAT_KEYS = ("steps", "prefill_steps", "decode_steps", "idle_steps",
              "tokens_generated", "quarantined", "expired", "retries",
              "guard_trips", "health_demotions")


def _same_as_jax(jeng, teng, prompts):
    jhov, thov = _drive(jeng, prompts), _drive(teng, prompts)
    assert thov == jhov
    assert {r: c.tokens for r, c in teng.completions.items()} == \
        {r: c.tokens for r, c in jeng.completions.items()}
    assert teng.quarantined == jeng.quarantined
    assert teng.expired == jeng.expired
    assert teng._retries == jeng._retries
    assert teng.events == jeng.events
    assert teng.step_kinds == jeng.step_kinds
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in _STAT_KEYS} == {k: js[k] for k in _STAT_KEYS}
    return teng


@pytest.mark.parametrize("mesh_shape", [(1, 4), (1, 8)])
def test_corrupt_hop_quarantines_like_jax(fixed_clock, mesh_shape):
    jeng, teng = _pair(mesh_shape, dict(SERVE, max_retries=0),
                       [dict(kind="corrupt", island="mlp", step=1)],
                       comm_backend="ring", island_guards=True)
    teng = _same_as_jax(jeng, teng, _PROMPTS)
    # JAX's acceptance (tests/test_health.py): the first prefill group is
    # quarantined, mlp tripped, the other requests completed
    assert set(teng.quarantined) == {0, 1}
    assert {r["reason"] for r in teng.quarantined.values()} == \
        {"prefill_nonfinite"}
    assert "mlp" in {e[2] for e in teng.events if e[0] == "guard_trip"}
    assert set(teng.completions) == {2, 3}


def test_corrupt_hop_retry_recovers_like_jax(fixed_clock):
    jeng, teng = _pair((1, 8), dict(SERVE, max_retries=1),
                       [dict(kind="corrupt", island="mlp", step=1)],
                       comm_backend="ring", island_guards=True)
    teng = _same_as_jax(jeng, teng, _PROMPTS)
    assert teng._retries == {0: 1, 1: 1} and not teng.quarantined
    assert set(teng.completions) == {0, 1, 2, 3}


def test_bitflip_with_chunks_like_jax(fixed_clock):
    """A bitflip NaNs one element a travelling chunk (2 chunks a hop):
    which rows it poisons is JAX's."""
    jeng, teng = _pair((1, 4), dict(SERVE, max_retries=0),
                       [dict(kind="bitflip", island="mlp", step=1, hop=1)],
                       comm_backend="ring", island_guards=True,
                       comm_chunks=2)
    _same_as_jax(jeng, teng, _PROMPTS)


def test_corrupt_decode_step_paged_like_jax(fixed_clock):
    """A corrupt decode tick on the paged layout: every live slot is
    quarantined at once (``decode_nonfinite``), its pages go back."""
    serve = dict(SERVE, cache_layout="paged", page_size=4, prefill_chunk=4,
                 max_retries=1)
    jeng, teng = _pair((1, 4), serve,
                       [dict(kind="corrupt", island="mlp", step=4)],
                       comm_backend="ring", island_guards=True)
    teng = _same_as_jax(jeng, teng, _PROMPTS + [tuple(range(9, 12))])
    assert "decode_nonfinite" in {r["reason"]
                                  for r in teng.quarantined.values()}
    assert teng.allocator.resident_pages == \
        jeng.allocator.resident_pages


@pytest.mark.parametrize("mesh_shape", [(1, 4), (1, 8)])
def test_stall_demotes_and_promotes_like_jax(fixed_clock, mesh_shape):
    serve = dict(SERVE, max_new_tokens=1, health_monitor=True,
                 health_demote_after=2, health_probation=4)
    jeng, teng = _pair(mesh_shape, serve,
                       [dict(kind="stall", island="mlp", step=3, ticks=4,
                             stall_dt=50.0)], comm_backend="ring")
    rng = np.random.RandomState(0)
    prompts = [tuple(int(t) for t in rng.randint(1, 256, size=5))
               for _ in range(20)]
    teng = _same_as_jax(jeng, teng, prompts)
    demotes = [e for e in teng.health.events if e[0] == "demote"]
    promotes = [e for e in teng.health.events if e[0] == "promote"]
    assert len(demotes) == 1 and len(promotes) == 1
    assert demotes[0][2:] == ("mlp", "bulk", "drift")
    assert promotes[0][1] - demotes[0][1] >= serve["health_probation"]
    # the demoted plan, as JAX reports it
    assert teng.stats()["health_demotions"] == 1


def test_linkdown_and_plan_record_like_jax(fixed_clock):
    """A linkdown pins mlp to bulk until it ends; the live plan record
    shows ``src=health`` on every bucket while it holds."""
    serve = dict(SERVE, health_monitor=True, health_probation=2)
    jeng, teng = _pair((1, 4), serve,
                       [dict(kind="linkdown", island="mlp", step=2,
                             ticks=3)], comm_backend="ring")
    for eng in (jeng, teng):
        for p in _PROMPTS:
            eng.submit(p)
    records = []
    while jeng.pending:
        jeng.step()
        teng.step()
        jr, tr = jeng.plan_record(), teng.plan_record()
        assert tr["health_overrides"] == jr["health_overrides"]
        for name, bp in tr["buckets"].items():
            got = [(p["island"], p["backend"], p["source"])
                   for p in bp["islands"]]
            assert got == [(p["island"], p["backend"], p["source"])
                           for p in jr["buckets"][name]["islands"]]
        records.append(tr["health_overrides"])
    assert ["mlp", "bulk", None, "health"] in sum(records, [])
    assert teng.events == jeng.events


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_deadlines_like_jax(layout, fixed_clock):
    serve = dict(SERVE, max_batch=2, prefill_batch=1, deadline_steps=3)
    if layout == "paged":
        serve.update(cache_layout="paged", page_size=4)
    jeng, teng = _pair((1, 4), serve)
    teng = _same_as_jax(jeng, teng, _PROMPTS + [tuple(range(5, 8))])
    assert {v["where"] for v in teng.expired.values()} == {"queued", "slot"}


# ---------------------------------------------------------------------------
# ROADMAP C15: under ring, a row's bits depend on its block
# ---------------------------------------------------------------------------

def test_ring_rows_depend_on_their_block_as_in_jax(mesh4):
    """The ring GEMM+AR's bf16 accumulator adds the ranks' partials in an
    order set by the row's block (block b starts at rank b + 1), so the
    same row computed in another block can round otherwise — in JAX's ring
    as in the port's — while bulk sums every row in rank order. So a
    request's tokens under ring depend on its slot; chip_smoke 5v corrupts
    the last prefill group, whose quarantine moves no other request."""
    from jax.sharding import PartitionSpec as JP

    from repro.core import comms as JC
    from repro_torch.core import comms as TC

    rng = np.random.RandomState(0)
    r, m, k, n = 4, 8, 64, 96
    x = rng.standard_normal((r, m, k)).astype(np.float32)
    w = rng.standard_normal((r, k, n)).astype(np.float32)
    perm = np.r_[2, 3, 0, 1, 4, 5, 6, 7]          # swap blocks 0 and 1

    def port(fn, xs):
        out = fn(torch.from_numpy(xs).bfloat16(),
                 torch.from_numpy(w).bfloat16())
        return out[0].float().numpy()

    def jax_(fn, xs):
        f = compat.shard_map(
            lambda a, b: fn(a[0], b[0], "x")[None],
            mesh=mesh4, in_specs=(JP("x"), JP("x")), out_specs=JP("x"),
            check_vma=False)
        out = f(jax.numpy.asarray(xs, jax.numpy.bfloat16),
                jax.numpy.asarray(w, jax.numpy.bfloat16))
        return np.asarray(out[0], np.float32)

    for run, ring, bulk in ((port, TC.pk_matmul_all_reduce,
                             TC.matmul_all_reduce_baseline),
                            (jax_, JC.pk_matmul_all_reduce,
                             JC.matmul_all_reduce_baseline)):
        base, moved = run(ring, x), run(ring, x[:, perm])
        assert not np.array_equal(moved, base[perm]), run
        np.testing.assert_array_equal(run(bulk, x[:, perm]),
                                      run(bulk, x)[perm])


def test_guard_registry_matches_jax():
    """``record_guard_trip`` / ``take_guard_trips`` as JAX's: a trip a
    false verdict, drained once; the port's device counters (the island
    boundary's) add to the same drain."""
    from repro.core import template as JTm
    from repro_torch.core import template as TTm
    for mod in (JTm, TTm):
        mod.take_guard_trips()
        mod.record_guard_trip("mlp", True)
        mod.record_guard_trip("mlp", False)
        mod.record_guard_trip("attn_out", np.bool_(False))
    want = JTm.take_guard_trips()
    TTm._boundary_guard("mlp", {"x": torch.tensor([1.0, float("nan")])},
                        torch.ones(2))
    TTm._boundary_guard("mlp", {"x": torch.ones(2)}, torch.ones(2))
    got = TTm.take_guard_trips()
    assert want == {"mlp": 1, "attn_out": 1}
    assert got == {"mlp": 2, "attn_out": 1}
    assert TTm.take_guard_trips() == {} == JTm.take_guard_trips()
