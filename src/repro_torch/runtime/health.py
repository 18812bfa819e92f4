"""Runtime health: scripted comm faults and island health monitoring — the
twin of ``repro/runtime/health.py``.

Three pieces, all consumed by ``runtime.serving.ServingEngine`` (and, one
level up, by ``runtime.fleet.ServingFleet`` through its extended fault
grammar):

* ``CommFaultPlan`` — a deterministic script of comms-level faults
  (``kind:island@step[xticks]``), the grammar of the fleet's replica-level
  ``FaultPlan``. Kinds:

  - ``corrupt``  — NaN the targeted island's ring-hop payload (whole hop);
  - ``bitflip``  — NaN one element of each travelling chunk of the hop;
  - ``stall``    — add synthetic per-step stall time to the island's steps
                   while its dispatch still runs a ring-family backend
                   (a demotion to ``bulk`` routes around the slow link,
                   which is what the monitor's recovery is measured by);
  - ``linkdown`` — mark the island's link down: the monitor pins the island
                   to the bottom rung until the event expires.

  ``corrupt``/``bitflip`` act on the step's computation: the engine runs
  the step with ``RunConfig.comm_fault`` set, and ``core.comms``' rings
  poison the hop payload after its shift. ``stall``/``linkdown`` are host
  timing and dispatch only.

* ``HealthMonitor`` — per-island EMA drift tracking on the
  ``StragglerWatchdog`` rule. After ``demote_after`` consecutive flagged
  samples (at once on a guard trip or a linkdown) the island's backend goes
  one rung down its ladder (ring_bidir -> ring -> bulk, fused -> bulk,
  chunked -> 1-chunk bulk); after ``probation`` consecutive clean samples
  it is promoted one rung. Every demotion doubles that island's probation
  window — hysteresis against flapping. Its decisions are
  ``island_overrides`` 4-tuples tagged ``"health"``, layered above measured
  dispatch: the calibration table is never changed.

* The guard-trip drain, re-exported from ``core.template``'s registry (the
  guards are finite checks at the island boundary, emitted when
  ``RunConfig.island_guards`` is set, counted on the device).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.template import (  # noqa: F401 (re-export)
    record_guard_trip, take_guard_trips)
from repro_torch.runtime.straggler import StragglerWatchdog

COMM_FAULT_KINDS = ("corrupt", "bitflip", "stall", "linkdown")

# payload faults change the step's computation (the engine runs it with
# RunConfig.comm_fault); the rest are host timing and dispatch
PAYLOAD_FAULT_KINDS = ("corrupt", "bitflip")


@dataclasses.dataclass(frozen=True)
class CommFaultEvent:
    """One scripted comms-level fault: at engine step ``step``, apply
    ``kind`` to ``island`` for ``ticks`` consecutive steps."""

    kind: str
    island: str
    step: int
    ticks: int = 1
    hop: int = 0                 # ring hop index for payload faults
    stall_dt: float = 1.0        # synthetic seconds per step for "stall"

    def __post_init__(self):
        if self.kind not in COMM_FAULT_KINDS:
            raise ValueError(f"unknown comm fault kind {self.kind!r}; "
                             f"one of {COMM_FAULT_KINDS}")
        if not self.island:
            raise ValueError("comm fault needs an island name ('*' = all)")
        if self.step < 1:
            raise ValueError(f"comm fault step must be >= 1, got {self.step}")
        if self.ticks < 1:
            raise ValueError(f"comm fault ticks must be >= 1, got {self.ticks}")
        if self.hop < 0:
            raise ValueError(f"comm fault hop must be >= 0, got {self.hop}")


@dataclasses.dataclass(frozen=True)
class CommFaultPlan:
    """Deterministic comms-fault schedule, ``FaultPlan``'s sibling.

    Spec grammar (comma/semicolon/space separated)::

        kind:island@step[xticks]

        corrupt:mlp@3          NaN mlp's ring hop payload at engine step 3
        stall:mlp@5x6          stall mlp's link for steps 5..10
        linkdown:attn_out@2x4  mark attn_out's link down for steps 2..5

    Duplicate events (same kind+island+step) and contradictory events
    (two payload faults on one island at one step) are rejected with
    named errors at parse time, not silently merged.
    """

    events: tuple[CommFaultEvent, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "CommFaultPlan":
        events = []
        for item in spec.replace(";", ",").replace(" ", ",").split(","):
            if not item:
                continue
            try:
                kind, rest = item.split(":", 1)
                island, sloc = rest.split("@", 1)
                ticks = 1
                if "x" in sloc:
                    sloc, tloc = sloc.split("x", 1)
                    ticks = int(tloc)
                events.append(CommFaultEvent(kind=kind, island=island,
                                             step=int(sloc), ticks=ticks))
            except ValueError as e:
                raise ValueError(
                    f"bad comm fault spec {item!r} (want "
                    f"kind:island@step[xticks], kind in {COMM_FAULT_KINDS}): "
                    f"{e}") from e
        return cls(events=cls._checked(events))

    @staticmethod
    def _checked(events) -> tuple[CommFaultEvent, ...]:
        seen = set()
        payload_at = {}
        for ev in events:
            key = (ev.kind, ev.island, ev.step)
            if key in seen:
                raise ValueError(
                    f"duplicate fault event: {ev.kind}:{ev.island}@{ev.step} "
                    "appears more than once")
            seen.add(key)
            if ev.kind in PAYLOAD_FAULT_KINDS:
                prior = payload_at.get((ev.island, ev.step))
                if prior is not None:
                    raise ValueError(
                        f"contradictory fault events: {prior} and {ev.kind} "
                        f"both target {ev.island}@{ev.step} — one hop "
                        "payload cannot be poisoned two ways")
                payload_at[(ev.island, ev.step)] = ev.kind
        return tuple(sorted(events, key=lambda e: (e.step, e.island, e.kind)))

    def at(self, step: int) -> list[CommFaultEvent]:
        return [e for e in self.events if e.step == step]


# ---------------------------------------------------------------------------
# Health monitor
# ---------------------------------------------------------------------------


def demotion_ladder(backend: str, n_chunks: int | None = None):
    """Rungs below a planned backend, most-capable first. Each rung is a
    ``(backend, n_chunks)`` pair; ``None`` chunks = leave to dispatch."""
    if backend == "ring_bidir":
        return (("ring", n_chunks), ("bulk", None))
    if backend in ("ring", "fused"):
        return (("bulk", None),)
    if backend == "chunked":
        # chunked a2a -> the 1-chunk bulk exchange
        return (("bulk", 1),)
    return ()


@dataclasses.dataclass
class _IslandHealth:
    ladder: tuple                  # ((backend, chunks), ...) below planned
    level: int = 0                 # 0 = planned backend, len(ladder) = bottom
    bad: int = 0                   # consecutive flagged samples
    clean: int = 0                 # consecutive clean samples
    demotions: int = 0             # lifetime demotions (hysteresis doubling)
    forced_down: bool = False      # linkdown pins the bottom rung


class HealthMonitor:
    """Per-island drift detector + backend demotion state machine.

    ``record(island, step, dt)`` feeds one step timing for one island; the
    flagging rule is ``StragglerWatchdog``'s (dt > factor * EMA after
    ``min_samples`` warm-up samples). Returns True when the island changed
    rung — the caller (the serving engine) then layers ``overrides()`` onto
    its per-bucket RunConfigs and rebuilds its step functions.

    State machine per island::

        planned --(demote_after consecutive flags | guard trip)--> rung+1
        rung>0 --(probation * 2**(demotions-1) consecutive clean)--> rung-1
        linkdown --> bottom rung pinned until link_up, then probation

    EMA feeds reset on every rung transition: timings measured under the
    old backend are not evidence about the new one.
    """

    def __init__(self, ladders: dict, *, factor: float = 3.0,
                 demote_after: int = 2, probation: int = 6,
                 ema_decay: float = 0.9, min_samples: int = 3,
                 expected: dict | None = None):
        self.factor = factor
        self.demote_after = demote_after
        self.probation = probation
        self.ema_decay = ema_decay
        self.min_samples = min_samples
        self._state = {name: _IslandHealth(ladder=tuple(ladder))
                       for name, ladder in ladders.items()}
        self._feeds = {name: self._fresh_feed(expected and expected.get(name))
                       for name in self._state}
        self.events: list[tuple] = []

    def _fresh_feed(self, expected_dt=None) -> StragglerWatchdog:
        feed = StragglerWatchdog(factor=self.factor,
                                 ema_decay=self.ema_decay,
                                 min_samples=self.min_samples)
        if expected_dt:
            # seed the EMA from the calibrated expectation so drift is
            # measured against what dispatch promised, not a cold start
            feed.ema, feed.n = float(expected_dt), 1
        return feed

    # -- queries ------------------------------------------------------------

    @property
    def islands(self):
        return tuple(self._state)

    def level(self, island: str) -> int:
        return self._state[island].level

    def rung(self, island: str):
        """(backend, chunks) the island currently runs, or None = planned."""
        st = self._state[island]
        return None if st.level == 0 else st.ladder[st.level - 1]

    def overrides(self) -> tuple:
        """``island_overrides`` 4-tuples for every demoted island, tagged
        with source ``"health"`` so plan records show ``src=health``."""
        out = []
        for name, st in self._state.items():
            if st.level > 0:
                be, chunks = st.ladder[st.level - 1]
                out.append((name, be, chunks, "health"))
        return tuple(out)

    def _probation_for(self, st: _IslandHealth) -> int:
        return self.probation * (2 ** max(0, st.demotions - 1))

    # -- transitions ---------------------------------------------------------

    def record(self, island: str, step: int, dt: float) -> bool:
        """Feed one sample; True iff the island changed rung."""
        st = self._state.get(island)
        if st is None:
            return False
        flagged = self._feeds[island].record(step, dt)
        if st.forced_down:
            return False
        if flagged:
            st.bad += 1
            st.clean = 0
            if st.bad >= self.demote_after:
                return self._demote(island, step, "drift")
        else:
            st.clean += 1
            st.bad = 0
            if st.level > 0 and st.clean >= self._probation_for(st):
                return self._promote(island, step)
        return False

    def guard_trip(self, island: str, step: int) -> bool:
        """A finite-check tripped at this island's boundary: demote now."""
        st = self._state.get(island)
        if st is None or st.forced_down:
            return False
        return self._demote(island, step, "guard")

    def link_down(self, island: str, step: int) -> bool:
        """Pin the island to the bottom rung until ``link_up``."""
        st = self._state.get(island)
        if st is None or not st.ladder or st.forced_down:
            return False
        st.forced_down = True
        changed = st.level != len(st.ladder)
        if changed:
            st.level = len(st.ladder)
            st.demotions += 1
            self._feeds[island] = self._fresh_feed()
            be, _ = st.ladder[st.level - 1]
            self.events.append(("demote", step, island, be, "linkdown"))
        st.bad = st.clean = 0
        return changed

    def link_up(self, island: str, step: int) -> None:
        """Link restored: unpin; promotion now runs through probation."""
        st = self._state.get(island)
        if st is None or not st.forced_down:
            return
        st.forced_down = False
        st.bad = st.clean = 0
        self._feeds[island] = self._fresh_feed()
        self.events.append(("link_up", step, island))

    def _demote(self, island: str, step: int, reason: str) -> bool:
        st = self._state[island]
        st.bad = st.clean = 0
        if st.level >= len(st.ladder):
            return False               # already at the bottom rung
        st.level += 1
        st.demotions += 1
        self._feeds[island] = self._fresh_feed()
        be, _ = st.ladder[st.level - 1]
        self.events.append(("demote", step, island, be, reason))
        return True

    def _promote(self, island: str, step: int) -> bool:
        st = self._state[island]
        st.bad = st.clean = 0
        st.level -= 1
        self._feeds[island] = self._fresh_feed()
        be = "planned" if st.level == 0 else st.ladder[st.level - 1][0]
        self.events.append(("promote", step, island, be))
        return True


__all__ = [
    "COMM_FAULT_KINDS",
    "PAYLOAD_FAULT_KINDS",
    "CommFaultEvent",
    "CommFaultPlan",
    "HealthMonitor",
    "demotion_ladder",
    "record_guard_trip",
    "take_guard_trips",
]
