"""Collective bytes from the comm trace — the twin of
``repro/roofline/hlo.py`` (the name kept so that a reader finds it).

JAX parses the compiled HLO text for its collective ops; the port has no
HLO. Its ``CommContext`` records every collective it runs, under every
backend, on the active step counter (``roofline/counters.py``): the kind,
the output bytes of a rank in the wire's true dtype, the group size N and
the number of groups the stacked call runs at once. :func:`ring_bytes`
prices a record with JAX's per-kind ring formulas, and
:func:`collective_bytes` sums them a device.

JAX halves the bytes of an f32 all-reduce or reduce-scatter fed by a
convert, undoing XLA:CPU's promotion of bf16 reductions to f32. The port
records the dtype its wire carries, so nothing is halved here.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

#: the kinds, JAX's HLO op names
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    """A device's collective traffic, bytes: kind -> (bytes, ops)."""
    by_kind: dict
    total_bytes: float
    op_count: int

    def summary(self) -> str:
        parts = [f"{k}: {v/1e6:.1f} MB ({c} ops)"
                 for k, (v, c) in sorted(self.by_kind.items())]
        return "; ".join(parts) or "none"


def ring_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes a device moves for one collective whose output on it is
    ``out_bytes``, over a group of ``n`` (JAX's formulas): all-gather
    S·(N−1)/N of the gathered output, reduce-scatter S·(N−1) of the
    scattered shard, all-reduce 2S·(N−1)/N, all-to-all S·(N−1)/N, permute
    S."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-to-all":
        return out_bytes * (n - 1) / n
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_bytes(trace, n_devices: int) -> CollectiveStats:
    """A device's bytes and ops over a comm trace (``CommRecord``s) of a
    step on a mesh of ``n_devices``: a call over groups of N, ``lanes`` of
    them at once, is taken part in by N·lanes devices, so it adds
    ``ring_bytes`` · N · lanes / n_devices to a device's bytes and N ·
    lanes / n_devices to its ops (the dp groups' calls of an island on
    their tp ranks together make one op a device)."""
    acc = defaultdict(lambda: [0.0, 0.0])
    for rec in trace:
        if rec.n <= 1:
            continue
        share = rec.n * rec.lanes / n_devices
        acc[rec.kind][0] += ring_bytes(rec.kind, rec.out_bytes, rec.n) * share
        acc[rec.kind][1] += share
    by_kind = {k: (v, int(round(c))) for k, (v, c) in acc.items()}
    return CollectiveStats(by_kind=by_kind,
                           total_bytes=sum(v for v, _ in by_kind.values()),
                           op_count=sum(c for _, c in by_kind.values()))
