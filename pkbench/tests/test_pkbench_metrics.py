"""Each metric's arithmetic on a hand-made record: the rates take all the
work of the whole window, the tails all its samples; the trace's
reduction on hand-made events."""

import statistics

import numpy as np
import pkbench_tiny  # noqa: F401
import pytest

from pkbench.harness import readers, spec, trace
from pkbench.work import _common


def _read(name, record):
    return spec.module("metrics", name).read(record)


def _serve_record():
    cfg = pkbench_tiny.config("falcon-mamba-7b-16l")
    ttft = list(np.linspace(0.01, 1.0, 100))
    itl = [0.02] * 90 + [0.5] * 10
    return {
        "mode": "serve", "window_s": 4.0, "setup_s": 3.5,
        "config": cfg, "cell": {"run": {}}, "mix": {},
        "trace": None,
        "serve": {"tokens_in_window": 1000, "ttft_s": ttft, "itl_s": itl,
                  "decode_step_s": [0.02, 0.03, 0.01],
                  "prefill_step_s": [0.1, 0.3],
                  "decode_tokens": [8, 8, 7],
                  "prefill_prompts": [[10, 20], [5]],
                  "prefill_tokens": [30, 5],
                  "decode_contexts": [11, 12]}}


def test_serving_rates_and_tails_take_the_whole_window():
    r = _serve_record()
    assert _read("serve_tokens_per_s", r) == 1000 / 4.0
    assert _read("setup_s", r) == 3.5
    # the whole window's samples, not a median of chunks
    assert _read("ttft_p90_ms", r) == pytest.approx(
        1e3 * np.percentile(r["serve"]["ttft_s"], 90))
    chunks = [np.percentile(c, 90) for c in np.array_split(
        r["serve"]["ttft_s"], 4)]
    assert _read("ttft_p90_ms", r) != pytest.approx(
        1e3 * statistics.median(chunks))
    assert _read("itl_p95_ms", r) == pytest.approx(500.0)
    assert _read("decode_step_ms.serve", r) == pytest.approx(20.0)
    assert _read("prefill_step_ms.serve", r) == pytest.approx(200.0)
    assert _read("train_tokens_per_s", r) is None


def test_mfu_serve_by_hand():
    r = _serve_record()
    dm = _common.dims(r)
    d, v, L = dm["d"], dm["vocab"], dm["layers"]
    di, n, dtr, ck = dm["di"], dm["n"], dm["dtr"], dm["ck"]
    layer = 2 * (d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d) \
        + 7 * di * n + 2 * di * ck
    head = 2 * d * v
    total = 35 * L * layer + 3 * head + 2 * (L * layer + head)
    assert _read("mfu.serve", r) == pytest.approx(
        100 * total / 4.0 / 989e12)


def test_mfu_train_by_hand():
    r = {"mode": "train", "tokens": 8192, "window_s": 2.0,
         "mix": {"batch": 8, "seq": 512},
         "config": spec.load("configs", "moonshot-v1-16b-a3b-4l")}
    d, v, hd, h, ff = 2048, 163840, 128, 16, 1408
    layer = 2 * d * 4 * h * hd + 2 * d * 64 + 2 * 6 * 3 * d * ff \
        + 4 * h * hd * 256.5
    per_token = 3 * (4 * layer + 2 * d * v)
    assert per_token == pytest.approx(3.69e9, rel=0.01)
    assert _read("mfu.train", r) == pytest.approx(
        100 * per_token * 4096 / 989e12)


class _Ev:
    def __init__(self, name, start, dur, cuda):
        import torch.autograd
        self._n, self._s, self._d = name, start, dur
        self._t = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


class _Prof:
    def __init__(self, evs):
        class K:
            def events(self_inner):
                return evs

        class P:
            kineto_results = K()
        self.profiler = P()


def test_trace_reduction_by_hand():
    evs = [_Ev("pkbench.window", 0, 1000, False),
           _Ev("aten::mm", 100, 50, False),
           _Ev("cudaStreamSynchronize", 300, 400, False),
           _Ev("kernel_a", 100, 100, True),      # 100-200
           _Ev("kernel_b", 150, 100, True),      # 150-250, overlaps
           _Ev("kernel_a", 700, 100, True),      # 700-800
           _Ev("kernel_c", 2000, 100, True),     # after the window
           _Ev("pkbench.optimizer", 650, 200, True)]
    s = trace.summarize(_Prof(evs), spans=("pkbench.optimizer",))
    assert s["busy_s"] == pytest.approx(250e-9)      # 100-250, 700-800
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["kernels"]["kernel_a"] == [pytest.approx(200e-9), 2]
    assert "kernel_c" not in s["kernels"]
    assert s["spans"]["pkbench.optimizer"] == pytest.approx(100e-9)
    assert s["span_counts"]["pkbench.optimizer"] == 1
    # the one gap (250-700) is named by the innermost host event at 475
    assert s["idle_gaps"] == [["cudaStreamSynchronize",
                               pytest.approx(450e-9)]]
    r = {"trace": s, "mode": "serve"}
    assert readers.idle_share(r) == pytest.approx(75.0)


def test_roofline_share_sums_bounds_over_device_time(monkeypatch):
    class Fam:
        NAMES = ("kernel_a",)

        @staticmethod
        def work(record):
            return 989e12 * 1e-7, 0.0, 989e12     # a bound of 100 ns

    class Other:
        NAMES = ("kernel_z",)

        @staticmethod
        def work(record):
            return 1.0, 1.0, 1.0

    monkeypatch.setattr(spec, "families",
                        lambda: [("fam", Fam), ("other", Other)])
    r = {"mode": "train", "trace": {"kernels": {"kernel_a": [200e-9, 2]}}}
    # the family that ran: 100 ns of bound over 200 ns of its kernels; the
    # family that did not run is left out
    assert readers.roofline_share(r) == pytest.approx(50.0)
    assert readers.roofline_share(r, only=("other",)) is None
    assert readers.roofline_share({"mode": "train", "trace": None}) is None


def test_each_cell_reports_its_metrics():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], 0)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics_for(bench, w["name"], 1)
        assert layers and all(m["moves"] in e2e for m in layers)
