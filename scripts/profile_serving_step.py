#!/usr/bin/env python3
"""Where a serving step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_serving_step.py [--arch ARCH]
        [--cache-layout paged] [--out FILE]

Serves a serving run of ``chip_smoke.py`` (``--arch`` tinyllama-1.1b, the
default, moonshot-v1-16b-a3b or falcon-mamba-7b, at full width and depth,
4 virtual ranks, 8 requests of ``synthetic_trace`` seed 0, every GEMM+AR
site on the fused kernel; exact buckets for the SSM model; with
``--cache-layout paged`` phase 5o's paged cache, pages of 16 tokens and
prefill chunks of 128, the profiled run on a fresh engine over the same
parameters, so that the warm-up's prefix registry shares nothing) once
to warm up, then again
under ``torch.profiler`` with each engine step in its own
``record_function`` range. For each step kind (prefill, decode) it prints
one JSON object with the median of, over the steps of that kind:

- ``wall_ms``: the step's host wall time (the profiler's CPU range);
- ``device_busy_ms``: the union of the device activities (kernels, copies,
  memsets) that fall in that range, and ``device_idle_share`` = 1 - busy /
  wall;
- ``device_ops``: the number of device activities;
- ``wall_ms_unprofiled``: the step's wall time in the warm-up run, without
  the profiler, for the profiler's own cost;

each step's wall and busy time in step order (``*_each``), the mean
device time per step by group — the port's hand-written kernels
(``pk_*``, ``hg::hg_gemm_kernel``, the Hopper mainloop of B1, B4, B5,
B6 and B9, and ``fa::flash_kernel``, B7), GEMMs of the vendor library,
copies and memsets, and
everything else (elementwise, reductions, softmax) — and the device ops
that take the most time, with their time and calls per step. Exits 1 if
the profiler recorded no device activity.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

GEMM_MARKS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas",
              "s16816", "s1688")
TOP = 12


def group_of(name: str) -> str:
    low = name.lower().removeprefix("void ").removeprefix(
        "(anonymous namespace)::")
    # hg::: the Hopper mainloop; fa::: flash attention and its hop
    if low.startswith(("pk_", "hg::", "fa::")):
        return "pk_kernels"
    if any(s in low for s in GEMM_MARKS):
        return "library_gemm"
    if low.startswith(("memcpy", "memset")):
        return "copy_memset"
    return "other"


def busy_us(spans) -> float:
    """Length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events, labels, unprofiled) -> list[dict] | None:
    """One JSON object a step kind from a profile whose steps ran in
    ``record_function`` ranges: ``labels`` are (range name, kind) pairs,
    ``unprofiled`` the kind's median wall seconds without the profiler
    (see the module docstring); None when no device activity was
    recorded."""
    from torch.autograd import DeviceType

    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU
              and e.name.startswith("engine_step_")}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("engine_step_")]
    if not device:
        return None

    per_kind: dict[str, list[dict]] = {}
    for label, kind in labels:
        lo, hi = ranges[label]
        inside = [e for e in device
                  if e.time_range.start >= lo and e.time_range.end <= hi]
        groups: dict[str, float] = {}
        names: dict[str, list] = {}
        for e in inside:
            dt = e.time_range.end - e.time_range.start
            g = group_of(e.name)
            groups[g] = groups.get(g, 0.0) + dt
            n = names.setdefault(e.name[:80], [0.0, 0])
            n[0] += dt
            n[1] += 1
        per_kind.setdefault(kind, []).append({
            "wall_us": hi - lo,
            "busy_us": busy_us((e.time_range.start, e.time_range.end)
                               for e in inside),
            "ops": len(inside), "groups": groups, "names": names})

    lines = []
    for kind, steps in sorted(per_kind.items()):
        wall = statistics.median(s["wall_us"] for s in steps)
        busy = statistics.median(s["busy_us"] for s in steps)
        names = sorted({g for s in steps for g in s["groups"]})
        by_name: dict[str, list] = {}
        for st in steps:
            for n, (us, cnt) in st["names"].items():
                acc = by_name.setdefault(n, [0.0, 0])
                acc[0] += us
                acc[1] += cnt
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        lines.append({
            "kind": kind, "steps": len(steps),
            "wall_ms": wall / 1e3,
            "wall_ms_unprofiled": unprofiled[kind] * 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall,
            "wall_ms_each": [s["wall_us"] / 1e3 for s in steps],
            "device_busy_ms_each": [s["busy_us"] / 1e3 for s in steps],
            "device_ops": statistics.median(s["ops"] for s in steps),
            "device_ms_per_step_by_group": {
                g: sum(s["groups"].get(g, 0.0) for s in steps)
                / len(steps) / 1e3 for g in names},
            "top_device_ops": [
                {"name": n, "group": group_of(n),
                 "ms_per_step": us / len(steps) / 1e3,
                 "calls_per_step": cnt / len(steps)}
                for n, (us, cnt) in top]})
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=["tinyllama-1.1b", "moonshot-v1-16b-a3b",
                             "falcon-mamba-7b"],
                    help="the served model (chip_smoke.py's phase 4, 4c or "
                         "4e)")
    ap.add_argument("--cache-layout", default="slab",
                    choices=["slab", "paged"],
                    help="paged: chip_smoke.py's phase 5o cache (pages of "
                         "16 tokens, prefill chunks of 128)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON objects to this file")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu rehearses the script and exits "
                         "1, with no device activity to read")
    args = ap.parse_args()

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.compat import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.transformer import has_ssm
    from repro_torch.runtime.serving import ServingEngine

    dev = resolve_device(args.device)
    paged = args.cache_layout == "paged"
    serve = ServeConfig(max_batch=8, prefill_batch=4, bucket_edges=(128, 512),
                        max_new_tokens=32,
                        exact_buckets=has_ssm(get_config(args.arch)),
                        **(dict(cache_layout="paged", page_size=16,
                                prefill_chunk=128) if paged else {}))
    eng = build_engine(args.arch, reduced=args.reduced,
                       mesh_shape=(1, 4), serve=serve, seed=0, device=dev,
                       run_overrides={"comm_backend": "fused",
                                      "pk_attn_out_island": True})
    trace = synthetic_trace(8, serve, eng.cfg.vocab_size, seed=0)
    eng.run(trace)                                   # warm-up
    unprofiled = {k: statistics.median(
        t for kk, t in zip(eng.step_kinds, eng.step_times) if kk == k)
        for k in set(eng.step_kinds)}
    if paged:
        eng = ServingEngine(eng.cfg, eng.base_run, eng.rules, eng.params,
                            serve, device=dev)
    for p in trace:
        eng.submit(p)
    labels = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while True:
            label = f"engine_step_{len(labels)}"
            with record_function(label):
                kind = eng.step()
            if kind is None:
                break
            labels.append((label, kind))

    lines = summarize(prof.events(), labels, unprofiled)
    if lines is None:
        print("profile_serving_step: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
