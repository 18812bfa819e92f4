"""Straggler watchdog and step timer — the part of
``repro/runtime/straggler.py`` the training driver uses.

``StragglerWatchdog`` keeps an EMA of step wall times and flags a step that
takes longer than ``factor`` times it. On a real pod that drives
mitigation (re-slot the slow host); here the detection is what runs. The
fleet feed (``FleetWatchdog``) belongs to the serving fleet, ROADMAP item
13.
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
