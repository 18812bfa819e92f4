"""The port's serving fleet (``repro_torch.runtime.fleet``) against
``repro.runtime.fleet.ServingFleet``, case for case of
``tests/test_fleet.py``: the same trace and fault plan through both fleets,
whose replicas are engines over the same float32 parameters (JAX's,
converted), and the same assignments (step, rid, replica, reason), the
same fleet events (kills, drains, snapshots, rejoins, steals, stalls,
completions, step for step) and the same completions, token for token.

Cases: ``FaultPlan`` parses and rejections with JAX's texts; routing
under ``fcfs``, ``least-loaded`` and ``cache-affinity``; the fleet against
one engine; kill mid-decode, mid-prefill-chunk and while draining; a
scripted drain, kill and rejoin; every replica dead; stealing from a
delayed replica; a comm fault delivered to a replica's engine; two
interleavings of cooperative stepping; the step budget; and a drain
snapshot rejoining onto a grown (2, 2) mesh through ``elastic_restore``.
Both packages' engine step timers are pinned to 10 ms a step, so the
watchdogs flag only scripted delays.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import FleetConfig as JaxFleetConfig  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.configs.base import ServeConfig as JaxServe  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime import fleet as JF  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (FleetConfig, RunConfig,  # noqa: E402
                                      ServeConfig)
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch.serve import synthetic_trace  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import fleet as TF  # noqa: E402
from repro_torch.runtime import serving as S  # noqa: E402

torch.set_num_threads(1)

SERVE = dict(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
             max_new_tokens=4)
PAGED = dict(SERVE, cache_layout="paged", page_size=4, prefill_chunk=8)


class _FixedTimer:
    """A step timer whose every step took 10 ms."""

    dt = 0.01

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    monkeypatch.setattr(JS, "StepTimer", _FixedTimer)
    monkeypatch.setattr(S, "StepTimer", _FixedTimer)


class _Model:
    """tinyllama-1.1b ``.reduced()`` in float32 in both packages, JAX's
    parameters and the port's conversion of them, made once a module."""

    def __init__(self):
        self.jcfg = dataclasses.replace(
            jax_config("tinyllama-1.1b").reduced(), dtype="float32")
        self.tcfg = dataclasses.replace(
            get_config("tinyllama-1.1b").reduced(), dtype="float32")
        self.kw = dict(fsdp=False, decode_seq_shard=False)
        self.jrun, self.trun = JaxRun(**self.kw), RunConfig(**self.kw)
        tmpl = JT.param_template(self.jcfg, self.jrun, None)
        self.jparams = JT.init_params(tmpl, jax.random.PRNGKey(0),
                                      self.jcfg.d_model)
        self.host = jax.tree.map(np.asarray, self.jparams)
        self.tparams = convert.params_from_jax(self.host, self.tcfg,
                                               self.trun, None)

    def jax_engine(self, serve: dict, mesh_shape=None):
        if mesh_shape is None:
            return JS.ServingEngine(self.jcfg, self.jrun, None, self.jparams,
                                    JaxServe(**serve))
        run = JaxRun(**dict(self.kw, decode_seq_shard=True))
        mesh = compat.make_mesh(mesh_shape, ("data", "model"))
        rules = JaxRules(mesh, run)
        tmpl = JT.param_template(self.jcfg, run, rules)
        params = jax.tree.map(jax.device_put, self.jparams,
                              JSP.named(mesh, JT.param_specs(tmpl)))
        return JS.ServingEngine(self.jcfg, run, rules, params,
                                JaxServe(**serve))

    def port_engine(self, serve: dict, mesh_shape=None):
        if mesh_shape is None:
            return S.ServingEngine(self.tcfg, self.trun, None, self.tparams,
                                   ServeConfig(**serve), device="cpu")
        run = RunConfig(**dict(self.kw, decode_seq_shard=True))
        rules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model")),
                              run)
        # zero stand-ins: a rejoin restores the snapshot over them
        params = convert.params_from_jax(
            jax.tree.map(lambda a: np.zeros_like(a), self.host), self.tcfg,
            run, rules)
        return S.ServingEngine(self.tcfg, run, rules, params,
                               ServeConfig(**serve), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _Model()


def _trace(n, serve=SERVE, seed=3):
    return synthetic_trace(n, ServeConfig(**serve), 64, seed=seed)


def _tokens(completions):
    return {c.rid: tuple(c.tokens) for c in completions}


def _fleets(model, serve=SERVE, plan=None, ckpt=None, **fleet_kw):
    """(JAX's fleet, the port's) over the same parameters and plan; each
    gets its own checkpoint directory under ``ckpt``."""
    jf = JF.ServingFleet(
        lambda i: model.jax_engine(serve), JaxFleetConfig(**fleet_kw),
        fault_plan=JF.FaultPlan.parse(plan) if plan else None,
        ckpt_dir=str(ckpt / "jax") if ckpt else None)
    tf = TF.ServingFleet(
        lambda i: model.port_engine(serve), FleetConfig(**fleet_kw),
        fault_plan=TF.FaultPlan.parse(plan) if plan else None,
        ckpt_dir=str(ckpt / "port") if ckpt else None)
    return jf, tf


_STAT_KEYS = ("replicas", "live", "router", "fleet_steps", "completed",
              "useful_tokens", "steals", "requeued", "assignments")


def _same(jf, tf):
    assert tf.assignments == jf.assignments
    assert tf.events == jf.events
    assert _tokens(tf.completions.values()) == \
        _tokens(jf.completions.values())
    js, ts = jf.stats(), tf.stats()
    assert {k: ts[k] for k in _STAT_KEYS} == {k: js[k] for k in _STAT_KEYS}


# ---------------------------------------------------------------------------
# FaultPlan parsing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "kill:1@5, delay:0@3x4; rejoin:1@9 drain:2@7",
    "linkdown:1.mlp@4x3 corrupt:0.attn_out@2",
    "corrupt:1.mlp@3 bitflip:1.attn_out@3", ""])
def test_fault_plan_parse_matches_jax(spec):
    j, t = JF.FaultPlan.parse(spec), TF.FaultPlan.parse(spec)
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]
    for step in range(11):
        assert len(t.at(step)) == len(j.at(step))
        assert t.rejoin_after(step) == j.rejoin_after(step)


@pytest.mark.parametrize("bad", [
    "boom:0@1", "kill:0", "delay:0@1", "kill:-1@2", "kill:0@-2",
    "corrupt:0@2", "kill:0.mlp@2", "stall:0.mlp@2 stall:0.mlp@2",
    "kill:0@2 stall:0.mlp@2", "corrupt:1.mlp@3 bitflip:1.mlp@3",
    "rejoin:1@4 drain:1@4"])
def test_fault_plan_rejections_match_jax(bad):
    with pytest.raises(ValueError) as je:
        JF.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as te:
        TF.FaultPlan.parse(bad)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# Routing, and the fleet against one engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["fcfs", "least-loaded"])
def test_routing_matches_jax(model, router):
    trace = _trace(8)
    jf, tf = _fleets(model, n_replicas=2, router=router, steal=False)
    assert len(tf.run(trace)) == len(trace)
    jf.run(trace)
    _same(jf, tf)
    assert sorted(a[1] for a in tf.assignments) == list(range(len(trace)))


def test_cache_affinity_matches_jax(model):
    jf, tf = _fleets(model, PAGED, n_replicas=2, router="cache-affinity",
                     steal=False)
    shared = tuple(range(1, 9))
    for f in (jf, tf):
        f.run([shared + (20,)])
        f.run([shared + (21,), shared + (22,)])
    _same(jf, tf)
    aff = [a for a in tf.assignments if a[3].startswith("affinity")]
    assert len(aff) == 2 and all(a[2] == tf.assignments[0][2] for a in aff)


@pytest.mark.parametrize("n", [2, 3])
def test_fleet_matches_single_engine_and_jax(model, n):
    trace = _trace(9)
    ref = _tokens(model.port_engine(SERVE).run(trace))
    jf, tf = _fleets(model, n_replicas=n)
    assert _tokens(tf.run(trace)) == ref
    jf.run(trace)
    _same(jf, tf)


def test_comm_fault_delivered_like_jax(model):
    trace = _trace(6)
    jf, tf = _fleets(model, plan="stall:1.mlp@2x2", n_replicas=2,
                     steal=False)
    jf.run(trace)
    tf.run(trace)
    _same(jf, tf)
    assert tf.replicas[1].engine.events == jf.replicas[1].engine.events
    assert any(e[0] == "comm_fault" and e[2] == "stall" and e[3] == "mlp"
               for e in tf.replicas[1].engine.events)


# ---------------------------------------------------------------------------
# The fault matrix
# ---------------------------------------------------------------------------

def test_kill_mid_decode_like_jax(model):
    trace = _trace(8)
    ref = _tokens(model.port_engine(SERVE).run(trace))
    jf, tf = _fleets(model, n_replicas=2, steal=False)
    for f in (jf, tf):
        for p in trace:
            f.submit(p)
        for _ in range(50):
            f.step()
            if any(s is not None for s in f.replicas[1].engine.slots):
                break
        f.kill(1)
        f.run()
    _same(jf, tf)
    kill = [e for e in tf.events if e[0] == "kill"]
    assert len(kill) == 1 and kill[0][3]          # work was lost
    assert _tokens(tf.completions.values()) == ref


def test_kill_mid_prefill_chunk_like_jax(model):
    trace = [tuple(range(2, 14)), tuple(range(3, 15)),
             tuple(range(4, 16)), (5, 6, 7)]
    ref = _tokens(model.port_engine(PAGED).run(trace))
    jf, tf = _fleets(model, PAGED, n_replicas=2, steal=False)
    for f in (jf, tf):
        for p in trace:
            f.submit(p)
        for _ in range(50):
            f.step()
            if f.replicas[1].engine._job is not None:
                break
        assert f.replicas[1].engine._job is not None
        f.kill(1)
        f.run()
    _same(jf, tf)
    assert _tokens(tf.completions.values()) == ref


def test_kill_while_draining_like_jax(model, tmp_path):
    trace = _trace(8)
    jf, tf = _fleets(model, ckpt=tmp_path, n_replicas=2, steal=False)
    for f in (jf, tf):
        for p in trace:
            f.submit(p)
        f.step()
        f.drain(1)
        f.step()
        f.kill(1)
        f.run()
    _same(jf, tf)
    kinds = [e[0] for e in tf.events]
    assert kinds.count("drain") == 1 and kinds.count("kill") == 1
    assert "snapshot" in kinds


def test_scripted_kill_rejoin_like_jax(model, tmp_path):
    trace = _trace(10)
    jf, tf = _fleets(model, plan="drain:1@1 kill:1@3 rejoin:1@5",
                     ckpt=tmp_path, n_replicas=2, steal=False)
    jf.run(trace)
    tf.run(trace)
    _same(jf, tf)
    assert tf.stats()["live"] == 2 and tf.requeued > 0
    # the rejoined replica serves the snapshot's parameters, bit for bit
    for a, b in zip(tf.replicas[1].engine.params["blocks"]["pos0"]["mlp"]
                    .values(),
                    model.tparams["blocks"]["pos0"]["mlp"].values()):
        assert torch.equal(a, b)


def test_all_dead_raises_like_jax(model):
    jf, tf = _fleets(model, plan="kill:0@0 kill:1@0", n_replicas=2,
                     steal=False)
    with pytest.raises(RuntimeError) as je:
        jf.run(_trace(4))
    with pytest.raises(RuntimeError) as te:
        tf.run(_trace(4))
    assert str(te.value) == str(je.value)
    assert tf.events == jf.events


def test_stealing_from_a_delayed_replica_like_jax(model):
    trace = _trace(8)
    jf, tf = _fleets(model, n_replicas=2, steal=True)
    for f in (jf, tf):
        for p in trace:
            f.submit(p)
        f.step()
        assert len(f.replicas[1].engine.queue) > 0
        f.delay(1, 8)
        f.run()
    _same(jf, tf)
    stolen = [rid for e in tf.events if e[0] == "steal" for rid in e[3]]
    assert tf.steals >= 1 and stolen
    for rid in stolen:
        routes = [a for a in tf.assignments if a[1] == rid]
        assert len(routes) == 2 and routes[-1][2] == 0


# ---------------------------------------------------------------------------
# Cooperative stepping
# ---------------------------------------------------------------------------

def test_two_interleavings_identical_like_jax(model):
    tr_a, tr_b = _trace(4, seed=5), _trace(4, seed=6)

    def run_pair(make, schedule):
        a, b = make(SERVE), make(SERVE)
        for p in tr_a:
            a.submit(p)
        for p in tr_b:
            b.submit(p)
        for name, budget in schedule:
            (a if name == "a" else b).run(step_budget=budget)
        a.run()
        b.run()
        return (_tokens(a.completions.values()),
                _tokens(b.completions.values()), a.events, b.events)

    fine = [("a", 1), ("b", 1)] * 30
    coarse = [("a", 1000), ("b", 1000)]
    t_fine = run_pair(model.port_engine, fine)
    t_coarse = run_pair(model.port_engine, coarse)
    assert t_fine[:2] == t_coarse[:2]
    j_fine = run_pair(model.jax_engine, fine)
    assert t_fine == j_fine


def test_step_budget_like_jax(model):
    trace = _trace(6)
    out = []
    for eng in (model.jax_engine(SERVE), model.port_engine(SERVE)):
        for p in trace:
            eng.submit(p)
        done = eng.run(step_budget=1)
        assert eng.pending and len(done) < 6
        rest = eng.run()
        out.append(({c.rid for c in done}, _tokens(done + rest),
                     eng.step_kinds))
    assert out[1] == out[0]
    assert out[1][1].keys() == set(range(6))


# ---------------------------------------------------------------------------
# A drain snapshot rejoining onto a grown mesh
# ---------------------------------------------------------------------------

def test_drain_snapshot_rejoins_onto_grown_mesh_like_jax(model, tmp_path):
    trace = _trace(6)
    ref = _tokens(model.port_engine(SERVE).run(trace))
    jf, tf = _fleets(model, ckpt=tmp_path, n_replicas=2, steal=False)
    for f, make in ((jf, model.jax_engine), (tf, model.port_engine)):
        for p in trace[:4]:
            f.submit(p)
        f.step()
        f.drain(1)
        f.run()
        f.rejoin(1, factory=lambda i, make=make: make(SERVE, (2, 2)))
        assert f.replicas[1].engine.rules is not None
        assert len(f.run(trace[4:])) == 2
    _same(jf, tf)
    assert _tokens(tf.completions.values()) == ref
    rejoin_step = [e for e in tf.events if e[0] == "rejoin"][0][1]
    assert any(a[2] == 1 and a[0] >= rejoin_step for a in tf.assignments)
    # the restored (2, 2) replica holds the snapshot's logical parameters
    eng = tf.replicas[1].engine
    tmpl = T.param_template(eng.cfg, eng.base_run, eng.rules)
    got = convert.tree_to_numpy(eng.params, tmpl, eng.rules)
    for path, _ in T.leaves(tmpl):
        np.testing.assert_array_equal(convert._get(got, path),
                                      convert._get(model.host, path))


# ---------------------------------------------------------------------------
# The serve CLI's fleet and health flags
# ---------------------------------------------------------------------------

def test_cli_fleet_and_health_reports(capsys, tmp_path):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--mode",
                 "continuous", "--replicas", "2", "--router", "fcfs",
                 "--fault-plan", "drain:1@1 kill:1@3 rejoin:1@5",
                 "--ckpt-dir", str(tmp_path), "--requests", "6",
                 "--tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[fleet] tinyllama-1.1b x2 (fcfs): 6 requests" in out
    assert "2/2 live" in out
    assert "fault events fired: ['snapshot', 'drain', 'kill', 'rejoin']" \
        in out
    launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--mesh-shape",
                 "1", "4", "--mode", "continuous", "--comm-backend", "ring",
                 "--island-guards", "--requests", "4", "--tokens", "3",
                 "--comm-fault-plan", "corrupt:mlp@1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[health] quarantined=0 retries=" in out
    assert "'guard_trip'" in out and "'retry'" in out
