"""Multi-replica elastic serving fleet — the twin of
``repro/runtime/fleet.py``: N data-parallel ``ServingEngine`` replicas
behind a deterministic router, with scripted fault injection.

One fast engine is not a service: the fleet gives throughput that grows
with the replica count and tail latency that survives losing a replica.
Replicas are plain ``ServingEngine`` objects in one process, stepped in
turn (on one card they share the device), so every scheduling decision is
a pure function of the submitted trace and the fault plan.

Routing reads each replica's state at every fleet step: queue depth + live
slots + prefill job rows (``engine.load()``), built buckets
(``engine.compiled_buckets``), tokens/s (``engine.stats()``) and the paged
prefix cache (``engine.prefix_match_len``). Policies: ``fcfs`` (fixed
rotation over healthy replicas), ``least-loaded`` (argmin load, lowest
index breaks ties), ``cache-affinity`` (the replica whose ``PrefixCache``
holds the longest prefix; least-loaded among equals and when nothing
matches).

Straggler-aware stealing: each replica's fleet turn records one sample into
a ``FleetWatchdog`` feed. A replica flagged by its own deadline, by the
EMA-against-median rule, or serving a scripted stall has its queued (never
in-flight) requests pulled back to the fleet backlog and routed to healthy
peers.

Elasticity — drain, kill, rejoin::

    drain r   stop admitting on r; queued requests return to the backlog;
              slots finish; r's parameters are saved to the fleet
              checkpoint (the rejoin seed) with r's tp size and mesh in
              the checkpoint's extra
    kill r    harvest r's finished completions first, then take_undone()
              pops every request not completed exactly once (queued,
              prefill job rows, live slots) onto the backlog front; the
              engine is dropped
    rejoin r  rebuild through the replica factory, restore the parameters
              from the fleet checkpoint (``elastic_restore``: onto any
              mesh, the MoE device-major layout converted on the way),
              fresh watchdog feed

Faults are scripted, not raced: ``FaultPlan.parse("kill:1@5 delay:0@3x4")``
fires events at exact fleet steps, and injected delays add to recorded
step times (``engine.inject_step_delay``) instead of sleeping, so a fault
run is reproducible. A kill-one-replica run completes every request
exactly once, token for token the no-fault run's, because an engine's
output does not depend on how requests are batched and the router
requeues lost work exactly once.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.configs.base import FleetConfig
from repro_torch.runtime.health import COMM_FAULT_KINDS
from repro_torch.runtime.serving import Completion, Request, ServingEngine
from repro_torch.runtime.straggler import FleetWatchdog, StepTimer

__all__ = ["FaultEvent", "FaultPlan", "ServingFleet"]


# --------------------------------------------------------------------------
# fault plans
# --------------------------------------------------------------------------

_COMM_KINDS = COMM_FAULT_KINDS
_KINDS = ("kill", "delay", "drain", "rejoin") + _COMM_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: do ``kind`` to ``replica`` at fleet ``step``.

    ``ticks`` is kind-specific: for ``delay`` it is how many fleet ticks the
    replica stalls (its turns pass without engine steps, each recording a
    synthetic ``FleetConfig.stall_dt`` watchdog sample); for comms-level
    kinds it is how many ENGINE steps the fault stays active on the target
    replica; other kinds ignore it.

    Comms-level kinds (``runtime.health.COMM_FAULT_KINDS``) target one
    island INSIDE a replica — spec location ``replica.island``, e.g.
    ``linkdown:1.mlp@4`` or ``corrupt:0.attn_out@2`` — and are delivered via
    ``ServingEngine.inject_comm_fault``."""

    kind: str
    replica: int
    step: int
    ticks: int = 0
    island: str | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.replica < 0 or self.step < 0:
            raise ValueError(f"replica/step must be >= 0: {self}")
        if self.kind == "delay" and self.ticks < 1:
            raise ValueError(f"delay needs ticks >= 1 (spec 'xK'): {self}")
        if self.kind in _COMM_KINDS and not self.island:
            raise ValueError(
                f"comm fault {self.kind!r} targets an island inside the "
                f"replica: spec location is replica.island "
                f"(e.g. {self.kind}:1.mlp@4)")
        if self.kind not in _COMM_KINDS and self.island:
            raise ValueError(
                f"replica-level fault {self.kind!r} takes no island "
                f"(got {self.replica}.{self.island})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered script of ``FaultEvent``s, parseable from the CLI spec
    ``kind:replica[.island]@step[xticks]`` (comma/space/semicolon
    separated)::

        FaultPlan.parse("kill:1@5, rejoin:1@9")
        FaultPlan.parse("delay:0@3x4 drain:2@7")
        FaultPlan.parse("linkdown:1.mlp@4x3 corrupt:0.attn_out@2")

    Duplicate events (same kind+target+step) and contradictory pairs at one
    (replica, step) — ``kill`` plus anything else, ``rejoin`` plus
    ``drain``, or two payload poisons on one island — are rejected with
    named errors at parse time rather than silently racing at fire time.
    """

    events: tuple[FaultEvent, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        evs = []
        for item in spec.replace(";", ",").replace(" ", ",").split(","):
            item = item.strip()
            if not item:
                continue
            try:
                kind, rest = item.split(":", 1)
                rloc, sloc = rest.split("@", 1)
                island = None
                if "." in rloc:
                    rloc, island = rloc.split(".", 1)
                ticks = 0
                if "x" in sloc:
                    sloc, t = sloc.split("x", 1)
                    ticks = int(t)
                evs.append(FaultEvent(kind, int(rloc), int(sloc), ticks,
                                      island=island))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {item!r} (want kind:replica[.island]"
                    f"@step[xticks], kind in {_KINDS}): {e}") from e
        return cls(cls._checked(evs))

    @staticmethod
    def _checked(evs) -> tuple[FaultEvent, ...]:
        seen = set()
        by_loc: dict[tuple, list] = {}
        for ev in evs:
            key = (ev.kind, ev.replica, ev.island, ev.step)
            if key in seen:
                raise ValueError(
                    f"duplicate fault event: {ev.kind}:{ev.replica}"
                    f"{'.' + ev.island if ev.island else ''}@{ev.step} "
                    "appears more than once")
            seen.add(key)
            by_loc.setdefault((ev.replica, ev.step), []).append(ev)
        for (rep, step), group in by_loc.items():
            kinds = [e.kind for e in group]
            if "kill" in kinds and len(group) > 1:
                raise ValueError(
                    f"contradictory fault events at replica {rep} step "
                    f"{step}: kill cannot combine with {sorted(kinds)}")
            if "rejoin" in kinds and "drain" in kinds:
                raise ValueError(
                    f"contradictory fault events at replica {rep} step "
                    f"{step}: rejoin and drain cancel each other")
            payload = {}
            for e in group:
                if e.kind in ("corrupt", "bitflip"):
                    prior = payload.get(e.island)
                    if prior is not None:
                        raise ValueError(
                            f"contradictory fault events: {prior} and "
                            f"{e.kind} both poison replica {rep} island "
                            f"{e.island!r} at step {step}")
                    payload[e.island] = e.kind
        return tuple(sorted(evs, key=lambda e: (e.step, e.replica)))

    def at(self, step: int) -> list[FaultEvent]:
        return [e for e in self.events if e.step == step]

    def rejoin_after(self, step: int) -> bool:
        return any(e.kind == "rejoin" and e.step >= step
                   for e in self.events)


# --------------------------------------------------------------------------
# fleet
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: ServingEngine | None
    alive: bool = True
    draining: bool = False
    stall: int = 0                   # remaining scripted stall ticks


class ServingFleet:
    """N serving replicas behind one deterministic router.

    ``factory(i) -> ServingEngine`` builds replica ``i`` — all replicas must
    share the same ``ServeConfig`` and parameters (data-parallel serving:
    any replica can serve any request). The fleet owns the request backlog;
    replicas only ever see requests the router assigned to them.

    One ``step()`` is: fire scripted faults → steal from flagged/stalled
    replicas → route the backlog → give each live replica one turn of at
    most ``FleetConfig.step_budget`` engine steps (index order — the
    deterministic interleave) → harvest completions.
    """

    def __init__(self, factory: Callable[[int], ServingEngine],
                 fleet: FleetConfig | None = None,
                 fault_plan: FaultPlan | None = None,
                 ckpt_dir: str | None = None):
        self.factory = factory
        self.cfg = fleet if fleet is not None else FleetConfig()
        self.plan = fault_plan if fault_plan is not None else FaultPlan()
        self.replicas = [_Replica(i, factory(i))
                         for i in range(self.cfg.n_replicas)]
        self._serve = self.replicas[0].engine.serve
        self.watchdog = FleetWatchdog(self.cfg.n_replicas,
                                      factor=self.cfg.steal_factor)
        self.backlog: collections.deque[Request] = collections.deque()
        self.completions: dict[int, Completion] = {}
        self.assignments: list[tuple] = []   # (step, rid, replica, reason)
        self.events: list[tuple] = []
        self.step_no = 0
        self.step_times: list[float] = []
        self.steals = 0
        self.requeued = 0
        self._next_rid = 0
        self._rr = 0                         # fcfs rotation cursor
        # checkpoint-backed rejoin: lazy manager, created on first drain
        self._ckpt_dir = ckpt_dir
        self._ckpt = None
        self._ckpt_tp = 1                    # tp size the snapshot was cut at
        self._ckpt_no = 0

    # -- intake ------------------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: int | None = None,
               rid: int | None = None) -> int:
        """Queue a request on the FLEET backlog (routing happens at the
        next ``step()``). Validation mirrors ``ServingEngine.submit``."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        self._serve.bucket_for(len(prompt))
        mx = max_new_tokens if max_new_tokens is not None \
            else self._serve.max_new_tokens
        if not 1 <= mx <= self._serve.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, "
                f"{self._serve.max_new_tokens}]; got {mx}")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self.backlog.append(Request(rid, prompt, mx))
        return rid

    # -- lifecycle ---------------------------------------------------------

    def drain(self, idx: int) -> None:
        """Stop admitting on replica ``idx``: queued requests return to the
        backlog front, in-flight slots finish on their own, and the
        replica's params are snapshotted as the fleet's rejoin seed."""
        rep = self.replicas[idx]
        if not rep.alive or rep.draining:
            return
        rep.draining = True
        rep.engine.drain()
        if self._ckpt_dir is not None:
            self._snapshot(rep.engine)
        queued = rep.engine.take_queued()
        self.requeued += len(queued)
        self.backlog.extendleft(reversed(queued))
        self.events.append(("drain", self.step_no, idx,
                            tuple(r.rid for r in queued)))

    def kill(self, idx: int) -> None:
        """Drop replica ``idx`` mid-step. Finished completions are
        harvested FIRST (they survive — completions live on the host), then
        every not-yet-completed request is popped exactly once and requeued
        at the backlog front, so lost work re-routes before new work."""
        rep = self.replicas[idx]
        if not rep.alive:
            return
        self._harvest_replica(rep)
        undone = rep.engine.take_undone()
        self.requeued += len(undone)
        self.backlog.extendleft(reversed(undone))
        rep.alive = False
        rep.draining = False
        rep.stall = 0
        rep.engine = None
        self.events.append(("kill", self.step_no, idx,
                            tuple(r.rid for r in undone)))

    def delay(self, idx: int, ticks: int) -> None:
        """Stall replica ``idx`` for ``ticks`` fleet turns: its turns pass
        without engine steps, each recording a synthetic
        ``FleetConfig.stall_dt`` sample — the deterministic straggler."""
        rep = self.replicas[idx]
        if rep.alive:
            rep.stall += ticks
            self.events.append(("delay", self.step_no, idx, ticks))

    def rejoin(self, idx: int,
               factory: Callable[[int], ServingEngine] | None = None) -> None:
        """Bring a dead (or drained) replica back: rebuild the engine via
        the factory — possibly on a DIFFERENT mesh than the fleet started
        with — and restore params from the fleet checkpoint when one was
        cut (``elastic_restore`` assembles each stored leaf under the
        snapshot's mesh, converts the MoE device-major layout to the new tp
        size and stores it for the new mesh)."""
        rep = self.replicas[idx]
        eng = (factory or self.factory)(idx)
        params = self._restored_params(eng)
        if params is not None:
            eng.params = params
        rep.engine = eng
        rep.alive = True
        rep.draining = False
        rep.stall = 0
        self.watchdog.reset(idx)
        self.events.append(("rejoin", self.step_no, idx))

    def _snapshot(self, engine: ServingEngine) -> None:
        from repro_torch.ckpt.manager import CheckpointManager
        if self._ckpt is None:
            self._ckpt = CheckpointManager(self._ckpt_dir, async_save=False)
        mesh = engine.rules.mesh if engine.rules is not None else None
        self._ckpt_tp = mesh.shape[engine.rules.tp] if mesh else 1
        self._ckpt_no += 1
        self._ckpt.save(self._ckpt_no, engine.params, extra={
            "tp": self._ckpt_tp,
            "mesh_shape": list(mesh.shape.values()) if mesh else None,
            "mesh_axes": list(mesh.axis_names) if mesh else None})
        self.events.append(("snapshot", self.step_no, self._ckpt_no))

    def _restored_params(self, eng: ServingEngine):
        """The fleet checkpoint's parameters laid out for ``eng``'s mesh
        (or none) on its device; None before any snapshot."""
        if self._ckpt is None:
            return None
        from repro_torch.runtime.elastic import elastic_restore
        params, _ = elastic_restore(
            str(self._ckpt.dir), eng.cfg, eng.base_run,
            eng.rules.mesh if eng.rules is not None else None,
            device=eng.device)
        return params

    # -- routing -----------------------------------------------------------

    def _flagged(self) -> set[int]:
        live = [r.idx for r in self.replicas if r.alive]
        return set(self.watchdog.stragglers(live)) if self.cfg.steal \
            else set()

    def _healthy(self, flagged: set[int]) -> list[_Replica]:
        return [r for r in self.replicas
                if r.alive and not r.draining and r.stall == 0
                and r.idx not in flagged]

    def _steal(self, flagged: set[int]) -> None:
        """Pull QUEUED (never in-flight) requests off stalled/flagged
        replicas back onto the backlog front — only when a healthy
        destination exists, else stealing would just bounce them back."""
        for rep in self.replicas:
            if not rep.alive or not (rep.stall > 0 or rep.idx in flagged):
                continue
            if not rep.engine.queue:
                continue
            if not any(h.idx != rep.idx for h in self._healthy(flagged)):
                continue
            stolen = rep.engine.take_queued()
            self.steals += 1
            self.requeued += len(stolen)
            self.backlog.extendleft(reversed(stolen))
            self.events.append(("steal", self.step_no, rep.idx,
                                tuple(r.rid for r in stolen)))

    def _route(self, flagged: set[int]) -> None:
        """Assign the whole backlog, head first. Per-request feedback
        (load, prefix match) is re-read per pick, so a burst spreads out
        instead of dogpiling the replica that was least loaded at step
        start. No healthy candidate → the backlog waits (stalls expire,
        drains finish, rejoin events fire)."""
        while self.backlog:
            cands = self._healthy(flagged)
            if not cands:
                return
            req = self.backlog.popleft()
            rep, reason = self._pick(req, cands)
            rep.engine.submit(req.prompt, req.max_new_tokens, rid=req.rid)
            self.assignments.append((self.step_no, req.rid, rep.idx, reason))

    def _pick(self, req: Request,
              cands: list[_Replica]) -> tuple[_Replica, str]:
        if self.cfg.router == "fcfs":
            rep = cands[self._rr % len(cands)]
            self._rr += 1
            return rep, "fcfs"
        loads = {r.idx: r.engine.load() for r in cands}
        if self.cfg.router == "cache-affinity":
            match = {r.idx: r.engine.prefix_match_len(req.prompt)
                     for r in cands}
            best = max(match.values())
            if best > 0:
                hit = [r for r in cands if match[r.idx] == best]
                rep = min(hit, key=lambda r: (loads[r.idx], r.idx))
                return rep, f"affinity:{best}"
        rep = min(cands, key=lambda r: (loads[r.idx], r.idx))
        return rep, f"least-loaded:{loads[rep.idx]}"

    # -- stepping ----------------------------------------------------------

    def _fire(self, ev: FaultEvent) -> None:
        if ev.kind in _COMM_KINDS:
            rep = self.replicas[ev.replica]
            if rep.alive:
                rep.engine.inject_comm_fault(ev.kind, ev.island,
                                             ticks=ev.ticks or 1)
                self.events.append(("comm_fault", self.step_no, ev.replica,
                                    ev.kind, ev.island))
            return
        {"kill": lambda: self.kill(ev.replica),
         "drain": lambda: self.drain(ev.replica),
         "rejoin": lambda: self.rejoin(ev.replica),
         "delay": lambda: self.delay(ev.replica, ev.ticks)}[ev.kind]()

    def step(self) -> bool:
        """One fleet step; returns True if any replica made progress (ran
        engine steps or burned a stall tick)."""
        for ev in self.plan.at(self.step_no):
            self._fire(ev)
        flagged = self._flagged()
        if self.cfg.steal:
            self._steal(flagged)
        self._route(flagged)
        progressed = False
        with StepTimer() as t:
            for rep in self.replicas:
                if not rep.alive:
                    continue
                if rep.stall > 0:
                    rep.stall -= 1
                    self.watchdog.record(rep.idx, self.step_no,
                                         self.cfg.stall_dt)
                    self.events.append(("stall", self.step_no, rep.idx))
                    progressed = True
                    continue
                n0 = rep.engine.step_no
                rep.engine.run(step_budget=self.cfg.step_budget)
                ran = rep.engine.step_no - n0
                if ran:
                    self.watchdog.record(
                        rep.idx, self.step_no,
                        sum(rep.engine.step_times[-ran:]))
                    progressed = True
        self._harvest()
        self.step_times.append(t.dt)
        self.step_no += 1
        return progressed

    def _harvest_replica(self, rep: _Replica) -> None:
        for rid, c in rep.engine.completions.items():
            if rid not in self.completions:
                self.completions[rid] = c
                self.events.append(("complete", self.step_no, rep.idx, rid))

    def _harvest(self) -> None:
        for rep in self.replicas:
            if rep.alive:
                self._harvest_replica(rep)

    @property
    def pending(self) -> bool:
        return bool(self.backlog) or any(
            rep.alive and rep.engine.pending for rep in self.replicas)

    def _check_liveness(self) -> None:
        if self.plan.rejoin_after(self.step_no):
            return                       # a scripted rejoin can still save us
        if not any(rep.alive for rep in self.replicas):
            raise RuntimeError(
                "fleet dead: every replica killed with work pending and no "
                "rejoin scheduled")
        if self.backlog and not any(rep.alive and not rep.draining
                                    for rep in self.replicas):
            raise RuntimeError(
                "fleet backlog unroutable: every live replica is draining "
                "and no rejoin is scheduled")

    def run(self, requests=None, max_steps: int = 100_000) -> list[Completion]:
        """Drain the backlog (plus ``requests``, submitted first) through
        the fleet; returns completions finished during THIS call in rid
        order. Deterministic: same trace + same fault plan → same
        assignment log, same completions, token for token."""
        done_before = set(self.completions)
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r.prompt, r.max_new_tokens, rid=r.rid)
            else:
                self.submit(r)
        for _ in range(max_steps):
            if not self.pending and not self.plan.rejoin_after(self.step_no):
                break
            self._check_liveness()
            self.step()
            if not self.pending and not self.plan.rejoin_after(self.step_no):
                break
        else:
            raise RuntimeError(f"fleet did not drain in {max_steps} steps")
        return [self.completions[k] for k in sorted(self.completions)
                if k not in done_before]

    # -- feedback / stats --------------------------------------------------

    def replica_feedback(self) -> dict[int, dict]:
        """The router's live per-replica view — what admission steers on."""
        out: dict[int, dict] = {}
        for rep in self.replicas:
            if not rep.alive:
                out[rep.idx] = {"alive": False}
                continue
            eng = rep.engine
            s = eng.stats()
            out[rep.idx] = {
                "alive": True, "draining": rep.draining,
                "stalled": rep.stall,
                "queue_depth": len(eng.queue), "load": eng.load(),
                "compiled_buckets": s["compiled_buckets"],
                "tokens_per_s": s["tokens_per_s"],
                "watchdog_ema": self.watchdog.ema(rep.idx),
                "cache": eng.cache_stats(),
            }
        return out

    def stats(self) -> dict[str, Any]:
        total = sum(self.step_times)
        useful = sum(len(c.tokens) for c in self.completions.values())
        return {
            "replicas": self.cfg.n_replicas,
            "live": sum(r.alive for r in self.replicas),
            "router": self.cfg.router,
            "fleet_steps": self.step_no,
            "wall_s": total,
            "completed": len(self.completions),
            "useful_tokens": useful,
            "tokens_per_s": useful / total if total else 0.0,
            "steals": self.steals,
            "requeued": self.requeued,
            "assignments": len(self.assignments),
            "per_replica": self.replica_feedback(),
        }
