"""Spans and counters inside the port's serving path.

Tracing is on for one engine step at a time: :func:`begin_step`, called at
the top of ``ServingEngine.step()``, turns it on while a
``torch.profiler`` records in this thread (or after :func:`enable`), and
:func:`end_step` turns it off and keeps the step's record. Off,
:func:`span` and :func:`count` are one test of a module flag: ``span``
returns a shared null context, and nothing is constructed, recorded or
launched. The sites are the chokepoints the port already has: the
engine's phases (``runtime/serving.py``), ``Island.__call__``
(``core/template.py``) and each ``CommContext`` op (``core/comms.py``).

On, a span

* opens a host range ``repro_torch.<name>`` while a profiler records,
  with ``_RecordFunctionFast``: the profiler keeps it as a CPU op, not as
  a ``user_annotation``, so Kineto mirrors no device-typed event of it on
  the GPU timeline, and a reduction of the trace that counts every
  device-typed event as device work counts none of it;
* keeps its host duration (``perf_counter_ns``);
* on a CUDA device, records a timing event on the current stream at
  either end: its stream time, the device time from the work queued
  before its start to the work queued before its end. A step's events are
  read by :func:`resolve_finished` once the last of them has completed
  (``Event.query``; the port queues everything on one stream) — the
  engine calls it while the device runs a later step's forward, so the
  reading hides behind device work — or by :func:`snapshot`, which waits
  for them: never a wait inside a step.

:func:`snapshot` returns one record per traced engine step: ``step_no``
(the index into the engine's ``step_kinds``), ``kind``, ``host_ms`` and
``stream_ms`` by span name (summed over the name's occurrences in the
step; ``stream_ms`` is empty off CUDA), ``counters`` by name (summed) and
``queue_wait_s``, the wait of each request the step admitted. Every name
the module emits is in :data:`NAMES`.
"""

from __future__ import annotations

import time

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["NAMES", "PREFIX", "IDLE", "span", "count", "tracing", "enable",
           "disable", "begin_step", "end_step", "resolve_finished",
           "snapshot", "reset"]

PREFIX = "repro_torch."

#: the islands of the port's models (``models/layers.py``,
#: ``train/pipeline.py``)
_ISLANDS = ("embed", "attn_out", "attn_sp", "attn_ring", "attn_ulysses",
            "decode_attn", "cross_decode_attn", "prefill_write",
            "paged_prefill_attn", "mlp", "moe", "lm_loss", "gpipe")
#: ``CommContext``'s ops and their backends (``comms.OP_BACKENDS``)
_COMMS = (("all_gather_matmul", ("bulk", "ring", "ring_bidir", "fused")),
          ("matmul_reduce_scatter", ("bulk", "ring", "fused")),
          ("matmul_all_reduce", ("bulk", "ring", "fused")),
          ("all_to_all", ("bulk", "chunked")),
          ("psum", ("bulk", "ring")),
          ("pmax", ("bulk",)),
          ("all_gather", ("bulk", "fused")),
          ("reduce_scatter", ("bulk", "fused")),
          ("ring_shift", ("bulk", "fused")))

QUEUE_WAIT = "engine.queue_wait_s"

#: every span and counter name the port emits (without ``PREFIX``)
NAMES = (("engine.step", "engine.schedule", "engine.forward", "engine.read",
          "engine.insert", "engine.bookkeep")
         + tuple(f"island.{n}" for n in _ISLANDS)
         + tuple(f"comm.{op}.{be}" for op, bes in _COMMS for be in bes)
         + tuple(f"comm.{op}.bytes" for op, _ in _COMMS)
         + (QUEUE_WAIT, "engine.kv_live_tokens", "engine.kv_slot_tokens",
            "engine.straggler_steps", "decode_attn.inplace_calls",
            "decode_attn.slab_calls"))


class _Idle:
    """The shared null context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


IDLE = _Idle()

_OPERATOR = False          # enable() was called
_ON = False                # tracing the current engine step
_PROFILING = False         # ... and a profiler records it
_CUDA = False              # ... and the engine runs on a CUDA device
_STEP: "_Step | None" = None
_RECORDS: list["_Step"] = []
_UNRESOLVED: list["_Step"] = []     # records whose events are pending
_POOL: list = []                    # timing events free for reuse


class _Step:
    __slots__ = ("step_no", "kind", "host_ns", "stream_ms", "counts",
                 "events")

    def __init__(self):
        self.step_no = -1
        self.kind = None
        self.host_ns: dict[str, int] = {}
        self.stream_ms: dict[str, float] = {}
        self.counts: dict[str, list] = {}
        self.events: list[tuple] = []      # (name, start, end), exit order

    def resolve(self, wait: bool) -> bool:
        """Turn the events into stream ms; False (nothing done) while the
        last of them has not completed and ``wait`` is false."""
        if self.events:
            last = self.events[-1][2]
            if wait:
                last.synchronize()
            elif not last.query():
                return False
        for name, a, b in self.events:
            self.stream_ms[name] = (self.stream_ms.get(name, 0.0)
                                    + a.elapsed_time(b))
            _POOL.extend((a, b))
        self.events = []
        return True

    def as_dict(self) -> dict:
        return {"step_no": self.step_no, "kind": self.kind,
                "host_ms": {n: t * 1e-6 for n, t in self.host_ns.items()},
                "stream_ms": dict(self.stream_ms),
                "counters": {n: sum(v) for n, v in self.counts.items()},
                "queue_wait_s": list(self.counts.get(QUEUE_WAIT, ()))}


def _event():
    if _POOL:
        return _POOL.pop()
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "range", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _PROFILING:
            self.range = _RecordFunctionFast(PREFIX + self.name)
            self.range.__enter__()
        self.start = None
        if _CUDA:
            self.start = _event()
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        rec = _STEP
        if self.start is not None:
            end = _event()
            end.record()
            rec.events.append((self.name, self.start, end))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        rec.host_ns[self.name] = rec.host_ns.get(self.name, 0) + dt
        return False


def span(*name: str):
    """A span named by the parts of ``name`` joined with dots (joined only
    when tracing is on)."""
    if not _ON:
        return IDLE
    return _Span(".".join(name))


def count(name: str, value) -> None:
    """Add ``value`` to the current step's counter ``name``."""
    if _ON:
        _STEP.counts.setdefault(name, []).append(value)


def tracing() -> bool:
    """Is the current engine step traced? (Guards a counter whose value
    costs something to compute.)"""
    return _ON


def enable() -> None:
    """Trace every engine step from now on, with or without a profiler."""
    global _OPERATOR
    _OPERATOR = True


def disable() -> None:
    global _OPERATOR
    _OPERATOR = False


def begin_step(device=None) -> None:
    """Start an engine step on ``device``: traced while a profiler records
    or after :func:`enable`."""
    global _ON, _PROFILING, _CUDA, _STEP
    _PROFILING = torch.autograd._profiler_enabled()
    _ON = _OPERATOR or _PROFILING
    if _ON:
        _CUDA = device is not None and torch.device(device).type == "cuda"
        _STEP = _Step()


def end_step(step_no: int, kind: str | None) -> None:
    """End the engine step: keep its record (none for a step that did no
    work, ``kind`` None)."""
    global _ON, _STEP
    if not _ON:
        return
    rec, _ON, _STEP = _STEP, False, None
    if kind is not None:
        rec.step_no, rec.kind = step_no, kind
        _RECORDS.append(rec)
        _UNRESOLVED.append(rec)


def resolve_finished() -> None:
    """Read the stream times of every earlier step whose events have
    completed, without waiting."""
    while _UNRESOLVED and _UNRESOLVED[0].resolve(wait=False):
        _UNRESOLVED.pop(0)


def snapshot() -> list[dict]:
    """One record per traced engine step since the last :func:`reset`,
    every stream time resolved (waiting for the device if need be)."""
    for rec in _UNRESOLVED:
        rec.resolve(wait=True)
    _UNRESOLVED.clear()
    return [r.as_dict() for r in _RECORDS]


def reset() -> None:
    """Drop every record."""
    for rec in _UNRESOLVED:
        rec.resolve(wait=True)
    _UNRESOLVED.clear()
    _RECORDS.clear()
