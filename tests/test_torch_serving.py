"""The port's continuous-batching engine on the CPU.

* continuous batching == one request at a time, token for token (as
  ``tests/test_serving.py`` holds the JAX engine), on no mesh and (1, R);
* the port's greedy tokens equal the JAX engine's on the same trace, with
  the JAX package's parameters converted, in float32;
* the entry points run on the GPU unless told otherwise: with no GPU and
  no device they raise, with ``device="cpu"`` they run.
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

SERVE = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                    max_new_tokens=4)


def _engine(mesh_shape, **kw):
    return launch.build_engine("tinyllama-1.1b", reduced=True,
                               mesh_shape=mesh_shape, serve=SERVE,
                               device="cpu", **kw)


@pytest.mark.parametrize("mesh_shape,backend", [(None, None), ((1, 4), None),
                                                ((1, 4), "fused"),
                                                ((1, 2), "ring")])
def test_continuous_matches_sequential(mesh_shape, backend):
    over = {"comm_backend": backend, "pk_attn_out_island": True}
    eng = _engine(mesh_shape, run_overrides=over)
    trace = launch.synthetic_trace(5, SERVE, eng.cfg.vocab_size)
    done = eng.run(trace)
    assert len(done) == len(trace)
    assert eng.stats()["prefill_steps"] >= 2
    for c in done:
        assert len(c.tokens) == SERVE.max_new_tokens
        solo = _engine(mesh_shape, run_overrides=over).run([trace[c.rid]])[0]
        assert c.tokens == solo.tokens, (c.rid, c.tokens, solo.tokens)


def test_continuous_matches_static_batch():
    eng = _engine((1, 4))
    trace = launch.synthetic_trace(4, SERVE, eng.cfg.vocab_size)
    done = {c.rid: c.tokens for c in eng.run(trace)}
    static = eng.generate_static(trace, SERVE.max_new_tokens)
    for rid, toks in enumerate(static):
        assert done[rid] == toks


def test_admission_events_deterministic():
    runs = []
    for _ in range(2):
        eng = _engine((1, 4))
        eng.run(launch.synthetic_trace(6, SERVE, eng.cfg.vocab_size, seed=3))
        runs.append((eng.events, eng.step_kinds))
    assert runs[0] == runs[1]
    admits = [e for e in runs[0][0] if e[0] == "admit"]
    assert [a[2] for a in admits] == sorted(a[2] for a in admits)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_greedy_tokens_match_jax_engine(mesh_shape):
    kw = dict(fsdp=False, decode_seq_shard=mesh_shape is not None)
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
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
    jserve = JaxServe(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                      max_new_tokens=4)
    jeng = JaxEngine(jcfg, jrun, jrules, params, jserve)
    teng = ServingEngine(tcfg, trun, trules, convert.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, trun, trules), SERVE,
        device="cpu")
    trace = launch.synthetic_trace(5, SERVE, tcfg.vocab_size, seed=1)
    want = {c.rid: c.tokens for c in jeng.run(trace)}
    got = {c.rid: c.tokens for c in teng.run(trace)}
    assert got == want
    assert teng.step_kinds == jeng.step_kinds


def test_reference_mode_matches_islands():
    """RunConfig.reference_mode routes every island to its dense reference:
    stacked weights and caches are reassembled for it and the KV cache is
    stored back per rank — same tokens, logits within f32 sum order."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    mesh = VirtualMesh((1, 4), ("data", "model"))
    engines = []
    for ref in (False, True):
        run = RunConfig(fsdp=False, decode_seq_shard=True,
                        reference_mode=ref, pk_attn_out_island=True)
        rules = ShardingRules(mesh, run)
        params = T.init_params(T.param_template(cfg, run, rules),
                               torch.Generator().manual_seed(0), cfg.d_model,
                               rules=rules)
        engines.append(ServingEngine(cfg, run, rules, params, SERVE,
                                     device="cpu"))
    trace = launch.synthetic_trace(3, SERVE, cfg.vocab_size, seed=2)
    a, b = (e.prefill_logits(trace[:1]) for e in engines)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert [c.tokens for c in engines[0].run(trace)] == \
        [c.tokens for c in engines[1].run(trace)]
    plans = engines[1].bucket_plans["decode"].plans
    assert all(p.fallback and p.reason == "RunConfig.reference_mode"
               for p in plans)


def test_entry_points_need_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.build_engine("tinyllama-1.1b", reduced=True, serve=SERVE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "tinyllama-1.1b", "--reduced"])
    eng = launch.build_engine("tinyllama-1.1b", reduced=True, serve=SERVE,
                              device="cpu")
    assert eng.device.type == "cpu"
    assert len(eng.run([(1, 2, 3)])) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(eng.cfg, eng.base_run, None, eng.params, SERVE)


def test_cli_runs_on_the_cpu(capsys):
    launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--mode",
                 "continuous", "--mesh-shape", "1", "4", "--requests", "3",
                 "--tokens", "3", "--device", "cpu"])
    launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
                 "--prompt-len", "5", "--tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "tok/s, batch=2" in out


def _jax_and_port(serve: ServeConfig):
    """(JAX engine, port engine) on no mesh over JAX's float32 parameters,
    converted."""
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")
    jrun, trun = JaxRun(fsdp=False), RunConfig(fsdp=False)
    params = JT.init_params(JT.param_template(jcfg, jrun, None),
                            jax.random.PRNGKey(0), jcfg.d_model)
    jeng = JaxEngine(jcfg, jrun, None, params,
                     JaxServe(**dataclasses.asdict(serve)))
    teng = ServingEngine(tcfg, trun, None, convert.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, trun, None), serve,
        device="cpu")
    return jeng, teng


def test_not_ported_serving_options_raise():
    # the paged cache and chunked prefill are ported (ROADMAP A7,
    # tests/test_torch_paged_serving.py), int8 caches (A11,
    # tests/test_torch_int8_serving.py), and the health monitor and
    # deadlines (A13): those serve as JAX's engine does (the faults are in
    # tests/test_torch_health.py)
    assert launch.build_engine(
        "tinyllama-1.1b", reduced=True, device="cpu",
        serve=ServeConfig(cache_layout="paged", page_size=4,
                          prefill_chunk=8)).paged
    eng = launch.build_engine("tinyllama-1.1b", reduced=True, device="cpu",
                              serve=ServeConfig(kv_dtype="int8"))
    assert eng.cache["blocks"]["pos0"]["k"].dtype == torch.int8
    assert len(eng.run([(1, 2, 3)])) == 1
    for extra in (dict(health_monitor=True), dict(deadline_steps=3)):
        jeng, teng = _jax_and_port(dataclasses.replace(SERVE, **extra))
        trace = launch.synthetic_trace(6, SERVE, 256, seed=1)
        assert {c.rid: c.tokens for c in teng.run(trace)} == \
            {c.rid: c.tokens for c in jeng.run(trace)}
        assert teng.events == jeng.events
        assert teng.expired == jeng.expired
        assert teng.stats()["expired"] == jeng.stats()["expired"]
    assert teng.expired                   # the deadline run expired some
