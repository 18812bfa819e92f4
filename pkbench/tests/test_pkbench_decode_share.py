"""The reader of ``decode_attn_inplace_share.serve`` on hand-made
snapshots: the share by hand, prefill steps left out, and None where the
port counts neither path (a training run, no snapshot, a port without
``repro_torch.core.trace``, or one whose decode island counts nothing: the
parent of the one-pass path)."""

import sys

import pkbench_tiny  # noqa: F401
import pytest

from pkbench.harness import spec

NAME = "decode_attn_inplace_share.serve"


def _read(record):
    return spec.module("metrics", NAME).read(record)


def _step(kind, **counts):
    return {"step_no": 0, "kind": kind, "host_ms": {}, "stream_ms": {},
            "counters": {f"decode_attn.{k}_calls": v
                         for k, v in counts.items()},
            "queue_wait_s": []}


@pytest.mark.parametrize("steps,want", [
    ([_step("decode", inplace=4), _step("decode", inplace=4)], 100.0),
    ([_step("decode", inplace=4), _step("decode", inplace=2, slab=2),
      _step("prefill", slab=8)], 75.0),
    ([_step("decode", slab=4)], 0.0),
])
def test_share_by_hand(monkeypatch, steps, want):
    from repro_torch.core import trace
    monkeypatch.setattr(trace, "snapshot", lambda: steps)
    assert _read({"mode": "serve"}) == pytest.approx(want)


def test_nothing_to_read_is_none(monkeypatch):
    from repro_torch.core import trace
    assert _read({"mode": "train"}) is None
    monkeypatch.setattr(trace, "snapshot", lambda: [_step("decode")])
    assert _read({"mode": "serve"}) is None
    monkeypatch.setattr(trace, "snapshot", lambda: [])
    assert _read({"mode": "serve"}) is None
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch.core"], "trace")
    assert _read({"mode": "serve"}) is None


def test_declared_for_the_cell():
    bench = spec.benchmark()
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["moonshot-serve-longdoc"]
    assert (m["source"], m["layer"], m["moves"], m["better"]) == (
        "program_counter", "models and islands", "serve_tokens_per_s",
        "higher")
    assert NAME in {m["name"] for m in spec.metrics_for(
        bench, "moonshot-serve-longdoc", 1)}
