"""Straggler watchdogs and the step timer — the twin of
``repro/runtime/straggler.py``.

``StragglerWatchdog`` keeps an EMA of step wall times and flags a step that
takes longer than ``factor`` times it. On a real pod that drives
mitigation (re-slot the slow host); here the detection is what runs.

``FleetWatchdog`` is the serving fleet's feed (``runtime/fleet.py``): one
``StragglerWatchdog`` a replica, plus a comparison across replicas — a
replica whose EMA exceeds ``factor`` times the median EMA of its live peers
is a fleet straggler even when its own deadline never fires (a uniformly
slow replica looks healthy to itself). The fleet router steals queued
requests from flagged replicas.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StragglerWatchdog:
    factor: float = 3.0          # deadline = factor × EMA
    ema_decay: float = 0.9
    min_samples: int = 5
    ema: float = 0.0
    n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        is_straggler = (self.n >= self.min_samples
                        and dt > self.factor * self.ema)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:  # stragglers don't poison the EMA
            self.ema = (dt if self.n == 0
                        else self.ema_decay * self.ema
                        + (1 - self.ema_decay) * dt)
            self.n += 1
        return is_straggler

    @property
    def deadline(self) -> float:
        return (self.factor * self.ema if self.n >= self.min_samples
                else float("inf"))


class FleetWatchdog:
    """Per-replica straggler feed for the serving fleet.

    Each replica's fleet turn records ONE sample (the wall time of the
    engine steps it ran, plus any injected fault delay) into that replica's
    ``StragglerWatchdog``. ``stragglers()`` then flags a replica when

    * its own watchdog flagged the most recent sample (deadline blown), or
    * its EMA exceeds ``factor`` x the median EMA across the live replicas
      (relative slowness its own deadline cannot see).

    ``min_samples=1`` on the per-replica feeds: a replica's first sample
    seeds its EMA, so scripted delays are visible at once."""

    def __init__(self, n_replicas: int, factor: float = 3.0,
                 ema_decay: float = 0.9):
        self.factor = factor
        self.ema_decay = ema_decay
        self.feeds = {r: StragglerWatchdog(factor=factor,
                                           ema_decay=ema_decay,
                                           min_samples=1)
                      for r in range(n_replicas)}
        self._last_flag = {r: False for r in range(n_replicas)}

    def record(self, replica: int, step: int, dt: float) -> bool:
        flagged = self.feeds[replica].record(step, dt)
        self._last_flag[replica] = flagged
        return flagged

    def reset(self, replica: int) -> None:
        """Fresh feed for a rejoining replica (its old EMA means nothing
        after a restore)."""
        self.feeds[replica] = StragglerWatchdog(factor=self.factor,
                                                ema_decay=self.ema_decay,
                                                min_samples=1)
        self._last_flag[replica] = False

    def ema(self, replica: int) -> float:
        return self.feeds[replica].ema

    def stragglers(self, live=None) -> list[int]:
        rs = sorted(self.feeds if live is None else live)
        emas = sorted(self.feeds[r].ema for r in rs if self.feeds[r].n > 0)
        med = emas[len(emas) // 2] if emas else 0.0
        out = []
        for r in rs:
            feed = self.feeds[r]
            if self._last_flag[r] or (len(emas) >= 2 and med > 0.0
                                      and feed.n > 0
                                      and feed.ema > self.factor * med):
                out.append(r)
        return out


class StepTimer:
    """Host wall time of a ``with`` block (``dt`` seconds). The block must
    end in a device->host read or a synchronize to time device work."""

    def __init__(self):
        self.t0 = None
        self.dt = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.dt = time.perf_counter() - self.t0
