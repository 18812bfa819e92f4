"""The port's spans on the card (marked ``gpu``: skipped without one), on a
reduced MoE engine with the benchmark cell's run settings, traced under
``torch.profiler`` as a ``--trace 1`` window is:

* every step's stream times are read, and a decode step's islands lie
  inside its forward;
* the spans' profiler ranges stay on the host: no device-typed event is
  named ``repro_torch.*``, so the harness's trace reduction counts none
  of them as device work.

Run on the card with ``python -m pytest -m gpu pkbench/tests``."""

import pkbench_tiny  # noqa: F401
import pytest


@pytest.fixture(scope="module")
def traced():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core import trace
    from repro_torch.launch import serve as launch

    serve = ServeConfig(max_batch=8, prefill_batch=1,
                        bucket_edges=(64, 128), max_new_tokens=8)
    eng = launch.build_engine(
        "moonshot-v1-16b-a3b", reduced=True, mesh_shape=(1, 4),
        serve=serve,
        run_overrides={"comm_backend": "fused", "pk_attn_out_island": True})
    prompts = launch.synthetic_trace(8, serve, eng.cfg.vocab_size)
    eng.run(prompts)                        # builds every kernel, untraced
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(prompts)
    torch.cuda.synchronize()
    recs = trace.snapshot()
    trace.reset()
    return recs, prof.profiler.kineto_results.events()


@pytest.mark.gpu
def test_stream_times_are_read_and_islands_lie_inside_the_forward(traced):
    recs, _ = traced
    assert {r["kind"] for r in recs} == {"prefill", "decode"}
    for r in recs:
        st = r["stream_ms"]
        assert set(st) == set(r["host_ms"])
        assert st["engine.forward"] > 0
        assert st["engine.step"] >= st["engine.forward"]
        islands = sum(t for n, t in st.items() if n.startswith("island."))
        assert 0 < islands <= st["engine.forward"] + 1e-3, r
        if r["kind"] == "decode":
            assert st["island.decode_attn"] > 0 and st["island.moe"] > 0
            assert any(n.startswith("comm.") for n in st)


@pytest.mark.gpu
def test_no_device_event_is_named_after_a_span(traced):
    from torch.autograd import DeviceType

    from repro_torch.core import trace
    _, events = traced
    host = [e.name() for e in events if e.name().startswith(trace.PREFIX)
            and e.device_type() != DeviceType.CUDA]
    device = [e.name() for e in events if e.name().startswith(trace.PREFIX)
              and e.device_type() == DeviceType.CUDA]
    assert host                             # the ranges were opened
    assert device == []
