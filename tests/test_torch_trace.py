"""The port's spans and counters (``repro_torch.core.trace``) on a reduced
MoE engine on the CPU.

* off (no profiler, no ``enable()``) nothing is recorded and no profiler
  range is constructed;
* under ``torch.profiler`` one record per engine step taken inside it,
  every name declared, the islands inside the forward, one queue wait an
  admission, the cache's occupancy in (0, 1];
* tracing changes no token and no engine event;
* ``stats()`` takes tokens over wall time, gaps between steps included;
* the straggler watchdog logs and counts, and prints nothing;
* decode attention counts the path each call took.
"""

import dataclasses
import logging
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.core import comms, trace  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402

torch.set_num_threads(1)

SERVE = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(8, 16),
                    max_new_tokens=4)
#: the benchmark cell's run settings (fused GEMM+AR sites, attn_out island)
CELL_RUN = {"comm_backend": "fused", "pk_attn_out_island": True}


def _engine(run_overrides=None):
    return launch.build_engine("moonshot-v1-16b-a3b", reduced=True,
                               mesh_shape=(1, 4), serve=SERVE, device="cpu",
                               run_overrides=run_overrides)


def _submit(eng, n=5):
    for p in launch.synthetic_trace(n, SERVE, eng.cfg.vocab_size):
        eng.submit(p)


def _drain(eng) -> int:
    n = 0
    while eng.step() is not None:
        n += 1
    return n


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    trace.disable()
    yield
    trace.reset()
    trace.disable()


def _traced_run(run_overrides=None):
    eng = _engine(run_overrides)
    _submit(eng)
    with profile(activities=[ProfilerActivity.CPU]):
        _drain(eng)
    return eng, trace.snapshot()


def test_off_records_nothing_and_constructs_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range or event was constructed")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    eng = _engine(CELL_RUN)
    _submit(eng)
    assert _drain(eng) > 0
    assert trace.snapshot() == []
    assert trace.span("engine", "step") is trace.IDLE
    assert not trace.tracing()


def test_enable_traces_without_a_profiler_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was constructed")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    eng = _engine()
    _submit(eng)
    trace.enable()
    n = _drain(eng)
    recs = trace.snapshot()
    assert len(recs) == n
    assert all(r["stream_ms"] == {} for r in recs)      # no CUDA device


def test_one_record_per_step_inside_the_profile():
    eng = _engine()
    _submit(eng, 6)
    before = 0
    while before < 2:
        eng.step()
        before += 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = [eng.step() for _ in range(4)]
    _drain(eng)                                        # after: untraced
    recs = trace.snapshot()
    assert [r["step_no"] for r in recs] == list(range(before, before + 4))
    assert [r["kind"] for r in recs] == inside
    assert [eng.step_kinds[r["step_no"]] for r in recs] == inside
    ranges = [e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX)]
    assert ranges.count(trace.PREFIX + "engine.step") == 4


@pytest.mark.parametrize("run_overrides", [None, CELL_RUN,
                                           {"comm_backend": "ring"}],
                         ids=["default", "cell", "ring"])
def test_every_name_is_declared(run_overrides):
    _, recs = _traced_run(run_overrides)
    names = {n for r in recs for n in (*r["host_ms"], *r["counters"])}
    assert names <= set(trace.NAMES), names - set(trace.NAMES)
    assert {"engine.step", "engine.schedule", "engine.forward",
            "engine.read", "engine.bookkeep", "island.moe",
            "island.decode_attn", "engine.kv_live_tokens"} <= names
    assert any(n.startswith("comm.") for n in names)
    assert len(set(trace.NAMES)) == len(trace.NAMES)


def test_declared_names_cover_every_comm_op_and_backend():
    declared = set(trace.NAMES)
    for op, backends in comms.OP_BACKENDS.items():
        assert f"comm.{op}.bytes" in declared
        for be in backends:
            assert f"comm.{op}.{be}" in declared


def test_islands_lie_inside_the_forward():
    _, recs = _traced_run(CELL_RUN)
    assert recs
    for r in recs:
        h = r["host_ms"]
        islands = sum(t for n, t in h.items() if n.startswith("island."))
        assert 0 < islands <= h["engine.forward"] <= h["engine.step"]
        assert r["kind"] in ("prefill", "decode")


def test_one_queue_wait_an_admission():
    eng, recs = _traced_run()
    waits = [w for r in recs for w in r["queue_wait_s"]]
    admits = [e for e in eng.events if e[0] == "admit"]
    assert len(waits) == len(admits) == 5
    assert all(w >= 0 for w in waits)
    for r in recs:
        n_admit = sum(e[1] == r["step_no"] for e in admits)
        assert len(r["queue_wait_s"]) == n_admit
        if r["queue_wait_s"]:
            assert r["counters"][trace.QUEUE_WAIT] == pytest.approx(
                sum(r["queue_wait_s"]))


def test_cache_occupancy_is_a_share():
    eng, recs = _traced_run()
    decode = [r for r in recs if r["kind"] == "decode"]
    assert decode
    for r in decode:
        c = r["counters"]
        assert c["engine.kv_slot_tokens"] == SERVE.max_batch * eng.s_max
        assert 0 < c["engine.kv_live_tokens"] / c["engine.kv_slot_tokens"] \
            <= 1


@pytest.mark.parametrize("run_overrides", [None, CELL_RUN],
                         ids=["default", "cell"])
def test_tracing_changes_no_token_and_no_event(run_overrides):
    def run(traced):
        eng = _engine(run_overrides)
        _submit(eng)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _drain(eng)
        else:
            _drain(eng)
        events = [tuple(e) for e in eng.events]
        return {r: c.tokens for r, c in eng.completions.items()}, events

    off, on = run(False), run(True)
    assert trace.snapshot()                 # the traced run did record
    assert on == off


def test_spans_nest_and_sum_by_name():
    trace.enable()
    trace.begin_step()
    with trace.span("engine", "step"):
        for _ in range(3):
            with trace.span("island.moe"):
                time.sleep(0.001)
        trace.count("engine.kv_live_tokens", 5)
        trace.count("engine.kv_live_tokens", 7)
    trace.end_step(4, "decode")
    trace.begin_step()
    trace.end_step(5, None)                 # a step that did no work
    (rec,) = trace.snapshot()
    assert rec["step_no"] == 4 and rec["kind"] == "decode"
    assert rec["host_ms"]["island.moe"] >= 3.0
    assert rec["host_ms"]["engine.step"] >= rec["host_ms"]["island.moe"]
    assert rec["counters"] == {"engine.kv_live_tokens": 12}
    assert rec["queue_wait_s"] == []
    assert not trace.tracing()              # off between steps
    trace.reset()
    assert trace.snapshot() == []


def test_stats_take_tokens_over_wall_time():
    eng = _engine()
    _submit(eng, 3)
    eng.step()
    time.sleep(0.3)                         # an idle gap between steps
    _drain(eng)
    st = eng.stats()
    assert st["step_s"] == pytest.approx(sum(eng.step_times))
    assert st["wall_s"] >= st["step_s"] + 0.3
    assert st["tokens_per_s"] == pytest.approx(
        st["tokens_generated"] / st["wall_s"])


class _FixedTimer:
    """A 10 ms step, whatever the host did."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.dt = 0.01


def test_straggler_is_logged_and_counted_not_printed(monkeypatch, caplog,
                                                     capsys):
    monkeypatch.setattr(serving, "StepTimer", _FixedTimer)
    eng = _engine()
    _submit(eng, 8)
    for _ in range(6):                      # the watchdog's warm-up
        eng.step()
    eng.inject_step_delay(1.0)
    with caplog.at_level(logging.WARNING, logger=serving.__name__), \
            profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    assert "STRAGGLER" not in capsys.readouterr().out
    assert [r.getMessage() for r in caplog.records
            if "STRAGGLER" in r.getMessage()] == [
        f"[serve] STRAGGLER step 7 ({eng.step_kinds[6]}): 1.010s "
        f"(deadline 0.030s)"]
    assert len(eng.watchdog.events) == 1
    assert eng.stats()["straggler_events"] == 1
    (rec,) = trace.snapshot()
    assert rec["counters"]["engine.straggler_steps"] == 1


@pytest.mark.parametrize("kv_dtype,path", [("bf16", "inplace"),
                                           ("int8", "slab")])
def test_decode_attention_counts_the_path_taken(kv_dtype, path):
    """Every decode step's decode attention calls, one a layer, count the
    path they took: the one-pass kernel over the stored bf16 slab, or the
    rewrite of the slab an int8 cache keeps."""
    eng = launch.build_engine("moonshot-v1-16b-a3b", reduced=True,
                              mesh_shape=(1, 4),
                              serve=dataclasses.replace(SERVE,
                                                        kv_dtype=kv_dtype),
                              device="cpu")
    _submit(eng)
    with profile(activities=[ProfilerActivity.CPU]):
        _drain(eng)
    recs = trace.snapshot()
    other = "slab" if path == "inplace" else "inplace"
    decode = [r["counters"] for r in recs if r["kind"] == "decode"]
    assert decode
    for c in decode:
        assert c[f"decode_attn.{path}_calls"] == eng.cfg.n_layers
        assert f"decode_attn.{other}_calls" not in c
    assert not any("decode_attn.inplace_calls" in r["counters"]
                   or "decode_attn.slab_calls" in r["counters"]
                   for r in recs if r["kind"] != "decode")
