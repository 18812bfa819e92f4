"""Measured dispatch through the port's islands, plans and serving buckets,
against the JAX package's on the CPU:

* ``island_comm_sweeps`` (the ``calibrate --per-island`` specs) equal JAX's
  for tinyllama (ring and Ulysses) and moonshot on (1, 4) and (2, 2);
* every ``island_plans`` entry, prefill, decode and a whole forward, under
  ``comm_policy="measured"`` with a table: backend, ``n_chunks``,
  ``chunk_dim``, ``source`` and ``wire`` equal, the hidden fraction within
  1e-12 (JAX's contexts priced at H100_SXM, the port's default);
* JAX's serving acceptance loop: per-bucket measured plans, their
  overrides reaching each bucket's contexts, and the engine's greedy tokens
  equal to JAX's in float32;
* the Ulysses and MoE auto chunk counts from measured a2a rows.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.template as JTm  # noqa: E402
import repro.models.layers as JL  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.configs.base import ServeConfig as JaxServe  # noqa: E402
from repro.core import autotune as JA  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core.comms import CommContext  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.core.template import island_override  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime.serving import ServingEngine  # noqa: E402

torch.set_num_threads(1)

CORR = {"ici_bandwidth": 3.7e9, "remote_sync_s": 2e-5,
        "gemm_efficiency": 3e-5, "kernel_launch_s": 9e-6}


@pytest.fixture(autouse=True)
def _fresh_caches():
    JA.clear_caches()
    TA.clear_caches()
    yield
    JA.clear_caches()
    TA.clear_caches()


@pytest.fixture
def jax_h100(monkeypatch):
    """Every JAX island context priced at H100_SXM (the port's default
    spec), so analytic fallbacks compare like for like."""
    orig = JTm.comm_context

    def cc(run, axis, mesh=None, **kw):
        kw.setdefault("hw", jcm.H100_SXM)
        return orig(run, axis, mesh=mesh, **kw)

    monkeypatch.setattr(JTm, "comm_context", cc)
    monkeypatch.setattr(JL, "comm_context", cc)


def _both(arch, mesh_shape, **run_kw):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jrun, trun = JaxRun(**run_kw), RunConfig(**run_kw)
    jrules = JaxRules(compat.make_mesh(mesh_shape, ("data", "model")), jrun)
    trules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
    return (jcfg, jrun, jrules), (tcfg, trun, trules)


def _tuples(sweeps):
    return [tuple(dataclasses.astuple(s)) for s in sweeps]


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch,sp", [("tinyllama-1.1b", "ring"),
                                     ("tinyllama-1.1b", "ulysses"),
                                     ("moonshot-v1-16b-a3b", "none")])
def test_island_comm_sweeps_equal_jax(mesh_shape, arch, sp):
    kw = dict(dp_axes=("data",), fsdp=False, pk_attn_out_island=True,
              sp_attention=sp)
    (jcfg, jrun, jrules), (tcfg, trun, trules) = _both(arch, mesh_shape,
                                                       **kw)
    n = 0
    for phase, batch, seq in (("all", 8, 32), ("prefill", 4, 16),
                              ("decode", 8, 40)):
        want = JL.island_comm_sweeps(jcfg, jrun, jrules, batch=batch,
                                     seq=seq, phase=phase)
        got = L.island_comm_sweeps(tcfg, trun, trules, batch=batch, seq=seq,
                                   phase=phase)
        assert _tuples(got) == _tuples(want), phase
        n += len(got)
        if sp == "ulysses" and phase == "all":
            assert any(s.island == "attn_ulysses|all_to_all|b2" for s in got)
        if arch.startswith("moonshot"):
            assert any(s.island.startswith("moe_dispatch|") for s in got)
    assert n >= 4


def _rows_for(sweeps, axis_size: int, seed: int, cover: float = 0.75):
    """Seeded rows at each sweep's exact coordinates (some sweeps left
    without rows, so the analytic fallback is reached too)."""
    rng = np.random.RandomState(seed)
    rows = []
    for sw in sweeps:
        if rng.rand() > cover:
            continue
        if sw.op == "all_to_all":
            cases = [("bulk", 1), ("chunked", 2), ("chunked", 4)]
        else:
            cases = [("bulk", 1)] + [("ring", c) for c in (1, 2, 4)]
            if sw.op == "all_gather_matmul":
                cases += [("ring_bidir", c) for c in (1, 2)]
            cases += [("fused", c) for c in (1, 2)]
        for be, c in cases:
            if be != "bulk" and rng.rand() < 0.15:
                continue
            rows.append({"op": sw.op, "backend": be, "axis_size": axis_size,
                         "m": sw.m, "n": sw.n, "k": sw.k,
                         "dtype_bytes": sw.dtype_bytes, "n_chunks": c,
                         "island": sw.island,
                         "us": float(rng.randint(10, 400))})
    return rows


def _tables(rows, jmesh, tmesh, tmp_path):
    jt = JA.CalibrationTable(
        fingerprint=JA.live_fingerprint("h100_sxm", jmesh),
        corrections=dict(CORR), measurements=rows)
    tt = TA.CalibrationTable(
        fingerprint=TA.live_fingerprint("h100_sxm", tmesh),
        corrections=dict(CORR), measurements=rows)
    return (str(jt.save(tmp_path / "jax.json")),
            str(tt.save(tmp_path / "port.json")))


def _assert_plans_equal(got, want, ctx):
    assert [p.island for p in got] == [p.island for p in want], ctx
    for a, b in zip(got, want):
        assert (a.fallback, a.op, a.backend, a.n_chunks, a.chunk_dim,
                a.source, a.wire) == \
            (b.fallback, b.op, b.backend, b.n_chunks, b.chunk_dim,
             b.source, b.wire), (ctx, a, b)
        if b.hidden_fraction is None:
            assert a.hidden_fraction is None
        else:
            assert abs(a.hidden_fraction - b.hidden_fraction) <= 1e-12, \
                (ctx, a, b)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_island_plans_measured_equal_jax(mesh_shape, wire, seed, tmp_path,
                                         jax_h100):
    axis = mesh_shape[1]
    base = dict(dp_axes=("data",), fsdp=False, pk_attn_out_island=True,
                sp_attention="ulysses", ulysses_chunks=0, comm_wire=wire)
    (jcfg, jrun, jrules), (tcfg, trun, trules) = _both(
        "tinyllama-1.1b", mesh_shape, **base)
    shapes = (("prefill", 4, 16), ("decode", 8, 40), ("all", 8, 32))
    sweeps = []
    for phase, b, s in shapes:
        sweeps += L.island_comm_sweeps(tcfg, trun, trules, batch=b, seq=s,
                                       phase=phase)
    rows = _rows_for(sweeps, axis, seed)
    jpath, tpath = _tables(rows, jrules.mesh, trules.mesh, tmp_path)
    jrun = dataclasses.replace(jrun, comm_policy="measured",
                               calibration_path=jpath)
    trun = dataclasses.replace(trun, comm_policy="measured",
                               calibration_path=tpath)
    jrules, trules = JaxRules(jrules.mesh, jrun), ShardingRules(trules.mesh,
                                                                trun)
    sources = set()
    for phase, b, s in shapes:
        want = JL.island_plans(jcfg, jrun, jrules, batch=b, seq=s,
                               phase=phase)
        got = L.island_plans(tcfg, trun, trules, batch=b, seq=s, phase=phase)
        _assert_plans_equal(got, want, (phase, mesh_shape, wire))
        sources |= {p.source for p in got if not p.fallback}
    assert "measured" in sources


def test_moe_plans_measured_equal_jax(tmp_path, jax_h100):
    """moonshot with ``moe_chunks = 0``: the MoE island's dispatch chunk
    count from the ``moe_dispatch`` rows, the same in both packages."""
    kw = dict(dp_axes=("data",), fsdp=False, sp_attention="none",
              moe_chunks=0, pk_attn_out_island=True)
    (jcfg, jrun, jrules), (tcfg, trun, trules) = _both(
        "moonshot-v1-16b-a3b", (1, 4), **kw)
    sweeps = L.island_comm_sweeps(tcfg, trun, trules, batch=4, seq=16,
                                  phase="prefill")
    key = [s for s in sweeps if s.island.startswith("moe_dispatch|")][0]
    rows = []
    for be, c, us in (("bulk", 1, 300.0), ("chunked", 2, 100.0),
                      ("chunked", 4, 200.0)):
        rows.append({"op": "all_to_all", "backend": be, "axis_size": 4,
                     "m": key.m, "n": key.n, "k": key.k,
                     "dtype_bytes": key.dtype_bytes, "n_chunks": c,
                     "island": key.island, "us": us})
    jpath, tpath = _tables(rows, jrules.mesh, trules.mesh, tmp_path)
    runs = []
    for run, path in ((jrun, jpath), (trun, tpath)):
        runs.append(dataclasses.replace(run, comm_policy="measured",
                                        calibration_path=path))
    jisl = JL.moe_island(jcfg, runs[0], JaxRules(jrules.mesh, runs[0]), 4,
                         16)
    tisl = L.moe_island(tcfg, runs[1], ShardingRules(trules.mesh, runs[1]),
                        4, 16)
    assert tisl.comm.n_chunks == jisl.comm.n_chunks
    want = JL.island_plans(jcfg, runs[0], JaxRules(jrules.mesh, runs[0]),
                           batch=4, seq=16, phase="prefill")
    got = L.island_plans(tcfg, runs[1], ShardingRules(trules.mesh, runs[1]),
                         batch=4, seq=16, phase="prefill")
    _assert_plans_equal(got, want, "moe")
    # the measured argmin: 2 chunks
    assert tisl.comm.n_chunks == 2


def test_island_key_and_context():
    cfg = get_config("tinyllama-1.1b").reduced()
    mesh = VirtualMesh((1, 4), ("data", "model"))
    run = RunConfig(fsdp=False, pk_attn_out_island=True)
    rules = ShardingRules(mesh, run)
    isl = L.mlp_island(cfg, run, rules, 4, 16)
    assert isl.island_key == "mlp|matmul_all_reduce|b2"
    assert isl.make_context().island == isl.island_key
    wrun = dataclasses.replace(run, comm_wire="int8")
    assert L.mlp_island(cfg, wrun, ShardingRules(mesh, wrun), 4,
                        16).island_key == "mlp|matmul_all_reduce|b1"


# ---------------------------------------------------------------------------
# JAX's serving acceptance loop, port against JAX
# ---------------------------------------------------------------------------

def _acceptance_rows(dtype_bytes: int):
    """The prefill bucket's MLP measures ring-with-2-sub-chunks fastest, the
    decode bucket's bulk (JAX tests/test_serving.py's table), at the
    model's element width."""
    key = TA.island_key("mlp", "matmul_all_reduce", dtype_bytes)

    def rows(m, us_by, n_chunks=1):
        return [{"op": "matmul_all_reduce", "backend": be, "axis_size": 4,
                 "m": m, "n": 64, "k": 32, "dtype_bytes": dtype_bytes,
                 "n_chunks": n_chunks, "island": key, "us": us}
                for be, us in us_by.items()]

    return (rows(64, {"bulk": 100.0, "ring": 10.0})
            + rows(64, {"ring": 4.0}, n_chunks=2)
            + rows(8, {"bulk": 5.0, "ring": 400.0}))


def test_per_bucket_plans_consumed_and_distinct(tmp_path, jax_h100):
    """Per-bucket measured plans equal JAX's, their overrides reach each
    bucket's contexts, and the engine's greedy tokens equal JAX's in f32."""
    serve = ServeConfig(max_batch=8, prefill_batch=4, bucket_edges=(16,),
                        max_new_tokens=4)
    jserve = JaxServe(max_batch=8, prefill_batch=4, bucket_edges=(16,),
                      max_new_tokens=4)
    rows = _acceptance_rows(4)           # float32 model: b4 rows
    jmesh = compat.make_mesh((1, 4), ("data", "model"))
    tmesh = VirtualMesh((1, 4), ("data", "model"))
    jpath, tpath = _tables(rows, jmesh, tmesh, tmp_path)
    kw = dict(fsdp=False, decode_seq_shard=True, comm_policy="measured")
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    jrun = JaxRun(calibration_path=jpath, **kw)
    trun = RunConfig(calibration_path=tpath, **kw)
    jrules, trules = JaxRules(jmesh, jrun), ShardingRules(tmesh, trun)
    tmpl = JT.param_template(jcfg, jrun, jrules)
    params = JT.init_params(tmpl, jax.random.PRNGKey(0), jcfg.d_model)
    params = jax.tree.map(jax.device_put, params,
                          JSP.named(jmesh, JT.param_specs(tmpl)))
    jeng = JaxEngine(jcfg, jrun, jrules, params, jserve)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                      trun, trules)
    teng = ServingEngine(tcfg, trun, trules, tparams, serve, device="cpu")

    assert list(teng.bucket_plans) == list(jeng.bucket_plans)
    for name, bp in teng.bucket_plans.items():
        _assert_plans_equal(bp.plans, jeng.bucket_plans[name].plans, name)
        assert [tuple(o) for o in bp.overrides] == \
            [tuple(o) for o in jeng.bucket_plans[name].overrides], name

    pre = {p.island: p for p in teng.bucket_plans["prefill@16"].plans}
    dec = {p.island: p for p in teng.bucket_plans["decode"].plans}
    assert pre["mlp"].backend == "ring" and pre["mlp"].source == "measured"
    assert pre["mlp"].n_chunks == 4 * 2          # ring steps x sub-chunks
    assert dec["mlp"].backend == "bulk" and dec["mlp"].source == "measured"
    assert ("mlp", "ring", 2) in teng.bucket_plans["prefill@16"].overrides
    assert ("mlp", "bulk", None) in teng.bucket_plans["decode"].overrides
    run_pre, run_dec = teng._runs["prefill@16"], teng._runs["decode"]
    assert island_override(run_pre, "mlp") == ("ring", 2, "plan")
    assert island_override(run_dec, "mlp") == ("bulk", None, "plan")
    ctx_pre = L.mlp_island(tcfg, run_pre, trules, 4, 16).make_context()
    ctx_dec = L.mlp_island(tcfg, run_dec, trules, 8, 1).make_context()
    assert ctx_pre.backend == "ring" and ctx_pre.chunks == 2
    assert ctx_dec.backend == "bulk"

    trace = launch.synthetic_trace(5, serve, tcfg.vocab_size, seed=1)
    want = {c.rid: c.tokens for c in jeng.run(trace)}
    got = {c.rid: c.tokens for c in teng.run(trace)}
    assert got == want
    assert teng.step_kinds == jeng.step_kinds


def test_serving_plan_record_reports_measured(tmp_path):
    from repro_torch.runtime.serving import serving_plan_record
    tmesh = VirtualMesh((1, 4), ("data", "model"))
    tt = TA.CalibrationTable(
        fingerprint=TA.live_fingerprint("h100_sxm", tmesh),
        corrections=dict(CORR),
        measurements=_acceptance_rows(2))
    run = RunConfig(fsdp=False, decode_seq_shard=True,
                    comm_policy="measured",
                    calibration_path=str(tt.save(tmp_path / "t.json")))
    cfg = get_config("tinyllama-1.1b").reduced()
    serve = ServeConfig(max_batch=8, prefill_batch=4, bucket_edges=(16,),
                        max_new_tokens=4)
    rec = serving_plan_record(cfg, run, ShardingRules(tmesh, run), serve)
    assert rec["comm_policy"] == "measured"
    mlp = [p for p in rec["buckets"]["prefill@16"]["islands"]
           if p["island"] == "mlp"][0]
    assert mlp["source"] == "measured" and mlp["backend"] == "ring"


def test_serve_cli_comm_policy(tmp_path, monkeypatch, capsys):
    """``--comm-policy measured`` with no table for this device warns once
    and serves on the analytic policy."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="falling back to analytic"):
        launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--mode",
                     "continuous", "--mesh-shape", "1", "4", "--requests",
                     "2", "--tokens", "2", "--device", "cpu",
                     "--comm-policy", "measured"])
    out = capsys.readouterr().out
    assert "[plan] comm_policy=measured" in out
    assert "2 requests, 4 tokens" in out
    # and a table of this device makes the plans measured
    tmesh = VirtualMesh((1, 4), ("data", "model"))
    rows = []
    for m in (4 * 8, 4 * 16, 4 * 32, 8):
        rows += [{"op": "matmul_all_reduce", "backend": be, "axis_size": 4,
                  "m": m, "n": 64, "k": 32, "dtype_bytes": 2, "n_chunks": 1,
                  "island": "mlp|matmul_all_reduce|b2", "us": us}
                 for be, us in (("bulk", 9.0), ("ring", 3.0))]
    TA.CalibrationTable(
        fingerprint=TA.live_fingerprint("h100_sxm", tmesh),
        corrections=dict(CORR), measurements=rows).save(
            TA.cache_path(TA.live_fingerprint("h100_sxm", device="cpu")))
    TA.clear_caches()
    eng = launch.build_engine("tinyllama-1.1b", reduced=True,
                              mesh_shape=(1, 4), device="cpu",
                              run_overrides={"comm_policy": "measured"},
                              serve=ServeConfig(max_batch=8, prefill_batch=4,
                                                bucket_edges=(8, 16, 32),
                                                max_new_tokens=2))
    for bp in eng.bucket_plans.values():
        mlp = [p for p in bp.plans if p.island == "mlp"][0]
        assert (mlp.source, mlp.backend) == ("measured", "ring"), bp
    assert len(eng.run(launch.synthetic_trace(3, eng.serve, 256))) == 3


# ---------------------------------------------------------------------------
# Ulysses and MoE auto chunk counts from measured a2a rows
# ---------------------------------------------------------------------------

def test_ulysses_auto_chunks_consume_a2a_rows(tmp_path):
    """``ulysses_chunks = 0``: the island's a2a count from its measured rows,
    and the chunked island equals the dense reference."""
    cfg = get_config("tinyllama-1.1b").reduced()
    mesh = VirtualMesh((2, 2), ("data", "model"))
    b, s = 4, 16
    shape = (2, cfg.n_heads, 8, cfg.hd)
    m, n, k = CommContext.a2a_coords(shape, 1, 2)
    key = TA.island_key("attn_ulysses", "all_to_all", 2)

    def r(be, c, us):
        return {"op": "all_to_all", "backend": be, "axis_size": 2,
                "m": m, "n": n, "k": k, "dtype_bytes": 2, "n_chunks": c,
                "island": key, "us": us}

    t = TA.CalibrationTable(
        fingerprint=TA.live_fingerprint("h100_sxm", mesh),
        corrections=dict(CORR),
        measurements=[r("bulk", 1, 500.0), r("chunked", 2, 100.0),
                      r("chunked", 4, 400.0)])
    run = RunConfig(dp_axes=("data",), fsdp=False, sp_attention="ulysses",
                    ulysses_chunks=0, comm_policy="measured",
                    calibration_path=str(t.save(tmp_path / "ul.json")))
    rules = ShardingRules(mesh, run)
    plan = L.sp_attention_island(cfg, run, rules, b, s).plan()
    assert (plan.backend, plan.n_chunks, plan.source) == \
        ("chunked", 2, "measured")

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, cfg.n_heads, s, cfg.hd, generator=gen)
    kk = torch.randn(b, cfg.n_kv_heads, s, cfg.hd, generator=gen)
    v = torch.randn(b, cfg.n_kv_heads, s, cfg.hd, generator=gen)

    def reference(q, k, v):
        return L._full_attention(q, k, v, causal=True, window=None)

    isl = L.sp_attention_island(cfg, run, rules, b, s, reference=reference)
    torch.testing.assert_close(isl(q=q, k=kk, v=v), reference(q, kk, v),
                               rtol=2e-4, atol=2e-4)
