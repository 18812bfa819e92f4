"""The device trace of a ``--trace 1`` run, read in memory.

``torch.profiler`` records the window with CPU and CUDA activity; nothing
is written to disk. From its raw events this module takes the device's
work (kernels, copies, memsets), its union over the window (busy time),
each kernel name's total, the device-side span of each of the
benchmark's own ranges (``record_function``), and the longest idle gaps,
each named by the innermost host event running at its middle.

The union of device activity over a range is the method of the port's
``scripts/profile_train_step.py`` and ``scripts/profile_serving_step.py``
(``busy_us``), copied here.
"""

from __future__ import annotations

import contextlib

import numpy as np

TOP = 10
NAME = 120   # characters of a name kept in the breakdown


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields the profiler (None when not tracing)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()


PREFIX = "pkbench."
WINDOW = PREFIX + "window"


def summarize(prof, spans=()) -> dict:
    """The trace's aggregates over the benchmark's window (its host range
    ``WINDOW``, which ends in a synchronize). ``spans`` names benchmark
    ranges whose device-side busy time is wanted (summed over their
    occurrences)."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    work, host, annot = [], [], {}
    lo = hi = None
    for e in evs:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # the device side of the benchmark's own ranges, or device work
            if name.startswith(PREFIX):
                annot.setdefault(name, []).append((s, end))
            else:
                work.append((s, end, name))
        else:
            if name == WINDOW:
                lo, hi = s, end
            host.append((s, end, name))
    if lo is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    work = [(max(a, lo), min(b, hi), n) for a, b, n in work
            if b > lo and a < hi]
    if not work:
        return {"busy_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": [], "spans": {}, "span_counts": {},
                "window_s": (hi - lo) * 1e-9}
    merged = union((a, b) for a, b, _ in work)
    kernels: dict[str, list] = {}
    for a, b, n in work:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-9
        k[1] += 1
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    hs = np.array([a for a, _, _ in host], dtype=np.int64)
    he = np.array([b for _, b, _ in host], dtype=np.int64)
    named: dict[str, float] = {}
    for length, a, b in gaps[:TOP]:
        mid = (a + b) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = "no host event"
        if len(inside):
            i = inside[np.argmin(he[inside] - hs[inside])]
            name = host[i][2]
        named[name] = named.get(name, 0.0) + length * 1e-9
    ms = np.array([a for a, _ in merged], dtype=np.int64)
    me = np.array([b for _, b in merged], dtype=np.int64)
    span_busy = {}
    for n in spans:
        span_busy[n] = int(sum(
            np.clip(np.minimum(me, b) - np.maximum(ms, a), 0, None).sum()
            for a, b in annot.get(n, ())))
    return {
        "busy_s": sum(b - a for a, b in merged) * 1e-9,
        "window_s": (hi - lo) * 1e-9,
        "kernels": kernels,
        "device_ops": [[n[:NAME], t] for n, (t, _) in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "idle_gaps": [[n[:NAME], t] for n, t in sorted(named.items(),
                                                 key=lambda kv: -kv[1])],
        "spans": {n: t * 1e-9 for n, t in span_busy.items()},
        "span_counts": {n: len(annot.get(n, ())) for n in spans},
    }


def family_time(kernels: dict, names) -> float:
    """Device seconds of the kernels whose name holds any of ``names``."""
    return sum(t for n, (t, _) in kernels.items()
               if any(s in n for s in names))
