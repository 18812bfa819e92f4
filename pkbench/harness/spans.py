"""The port's own spans and counters of a traced serving window, for the
metric readers.

``repro_torch.core.trace`` records one entry per engine step that ran
while the window's profiler recorded (its spans' host and stream ms by
name, its counters, the queue waits of the requests it admitted); the
readers take them in the same process, after the window. A port without
that module (a commit before it) has nothing to read, and every reader
returns None.
"""

from __future__ import annotations

import statistics


def steps(record: dict, kind: str | None = "decode"):
    """The window's step records of ``kind`` (every kind: None), or None
    when the run is no serving run or the port records none."""
    if record["mode"] != "serve":
        return None
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    out = [s for s in trace.snapshot() if kind is None or s["kind"] == kind]
    return out or None


def timed(recs) -> list[dict]:
    """The records with stream times (a CUDA run's)."""
    return [s for s in recs or () if "engine.forward" in s["stream_ms"]]


def median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def stream_median(record: dict, name: str):
    """Median over the window's decode steps of span ``name``'s stream ms
    (summed over its occurrences in the step)."""
    return median(s["stream_ms"].get(name)
                  for s in timed(steps(record)))


def stream_sum(step: dict, prefix: str) -> float:
    """A step's stream ms summed over every span named ``prefix...``."""
    return sum(t for n, t in step["stream_ms"].items()
               if n.startswith(prefix))
