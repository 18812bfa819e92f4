"""The readers of the port's own spans and counters on a hand-made
snapshot: each number by hand, and None where there is nothing to read
(a training run, a port without ``repro_torch.core.trace``, a run on the
CPU that has no stream times)."""

import sys

import pkbench_tiny  # noqa: F401
import pytest

from pkbench.harness import spec

NEW = ("decode_attn_device_ms.serve", "moe_device_ms.serve",
       "model_self_device_ms.serve", "comm_device_ms.serve",
       "decode_enqueue_ms.serve", "queue_wait_p90_ms.serve",
       "kv_occupancy.serve", "comm_mb.serve", "straggler_steps.serve")


def _read(name, record):
    return spec.module("metrics", name).read(record)


def _decode(attn, moe, fwd, comm, host_fwd, live, wait=()):
    return {"step_no": 0, "kind": "decode",
            "host_ms": {"engine.forward": host_fwd, "engine.step": 99.0},
            "stream_ms": {"engine.forward": fwd, "island.decode_attn": attn,
                          "island.moe": moe, "island.attn_out": 1.0,
                          "comm.psum.bulk": comm,
                          "comm.matmul_all_reduce.fused": 1.0,
                          "engine.step": fwd + 1},
            "counters": {"engine.kv_live_tokens": live,
                         "engine.kv_slot_tokens": 1000,
                         "comm.psum.bytes": 2e6,
                         "comm.matmul_all_reduce.bytes": 1e6},
            "queue_wait_s": list(wait)}


SNAPSHOT = [
    _decode(60.0, 5.0, 90.0, 0.5, 20.0, 400),
    {"step_no": 1, "kind": "prefill", "host_ms": {"engine.forward": 30.0},
     "stream_ms": {"engine.forward": 93.0, "island.moe": 50.0},
     "counters": {"engine.queue_wait_s": 0.3,
                  "engine.straggler_steps": 1},
     "queue_wait_s": [0.1, 0.2]},
    _decode(70.0, 7.0, 100.0, 1.5, 22.0, 420),
    _decode(80.0, 9.0, 110.0, 2.5, 24.0, 440, wait=[0.05]),
]


@pytest.fixture
def snapshot(monkeypatch):
    from repro_torch.core import trace
    monkeypatch.setattr(trace, "snapshot", lambda: SNAPSHOT)


def test_each_reader_by_hand(snapshot):
    r = {"mode": "serve"}
    assert _read("decode_attn_device_ms.serve", r) == 70.0
    assert _read("moe_device_ms.serve", r) == 7.0
    # forward less decode_attn, moe and attn_out: 24, 22, 20
    assert _read("model_self_device_ms.serve", r) == 22.0
    assert _read("comm_device_ms.serve", r) == 2.5
    assert _read("decode_enqueue_ms.serve", r) == 22.0
    # the waits of every step's admissions: 0.05, 0.1, 0.2
    assert _read("queue_wait_p90_ms.serve", r) == pytest.approx(180.0)
    assert _read("kv_occupancy.serve", r) == pytest.approx(42.0)
    assert _read("comm_mb.serve", r) == pytest.approx(3.0)
    assert _read("straggler_steps.serve", r) == 1


def test_the_islands_and_the_self_time_add_up_to_the_forward(snapshot):
    r = {"mode": "serve"}
    parts = sum(_read(n, r) for n in ("decode_attn_device_ms.serve",
                                      "moe_device_ms.serve",
                                      "model_self_device_ms.serve"))
    # the residue is the other islands (attn_out: 1 ms a step)
    assert parts + 1.0 == pytest.approx(100.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(monkeypatch, name):
    from repro_torch.core import trace
    assert _read(name, {"mode": "train"}) is None
    monkeypatch.setattr(trace, "snapshot", lambda: [])
    assert _read(name, {"mode": "serve"}) is None
    # a port without the module: the parent commit of the spans
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch.core"], "trace")
    assert _read(name, {"mode": "serve"}) is None


def test_cpu_records_have_no_stream_time(monkeypatch):
    from repro_torch.core import trace
    cpu = [dict(s, stream_ms={}) for s in SNAPSHOT]
    monkeypatch.setattr(trace, "snapshot", lambda: cpu)
    r = {"mode": "serve"}
    for name in NEW[:4]:
        assert _read(name, r) is None
    assert _read("decode_enqueue_ms.serve", r) == 22.0


def test_every_new_metric_is_declared_for_the_cell():
    bench = spec.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == ["moonshot-serve-longdoc"]
        assert m["source"] in ("program_span", "program_counter")
    names = {m["name"] for m in spec.metrics_for(
        bench, "moonshot-serve-longdoc", 1)}
    assert set(NEW) <= names
