"""Continuous-batching serving engine — the twin of
``repro/runtime/serving.py``.

The plan loop is the JAX engine's: per shape bucket, ``island_plans()``
resolves every island's backend and chunk count, ``plan_overrides`` freezes
the decisions into ``RunConfig.island_overrides``, and that bucket's step
function builds its islands from them. Prefill buckets run the
cache-building forward at (prefill_batch, bucket_len); the decode pool's
one-token step runs over every slot with a per-slot position vector.

SSM and hybrid models need ``ServeConfig(exact_buckets=True)``: their
recurrent state scans right-padding it cannot mask, so each distinct prompt
length is its own bucket (the engine raises otherwise, as JAX's does).

Scheduling is prefill-priority: each engine step prefills one bucket group
when a slot is free and the queue is not empty, else runs one decode tick
over the pool. Admission, eviction and greedy token choice are pure
functions of the submitted trace, so continuous-batched output equals
one-request-at-a-time output.

Memory: ``ServeConfig.cache_layout`` picks the dense per-slot slab or the
paged pool (``runtime/paging.py``): a fixed page pool, per-slot block
tables and a host-side refcounting allocator, with copy-on-write prefix
sharing and page-aligned chunked prefill (``prefill_chunk``), so that a
long prompt's prefill is split over engine steps and decode ticks run
between its chunks. Paged admission allocates a request's whole page span
up front; an exhausted pool shows as admission backpressure (the step
decodes instead, draining pages), never as an error. MoE models serve
paged with prefix sharing off: capacity dropping makes their K/V depend on
the batch, so a donor's pages are not reusable bit for bit.

``ServeConfig.kv_dtype="int8"`` stores either layout's K/V as int8 with
per-(token, head) f32 scales (quantized on write, dequantized on read, as
in JAX): (hd + 4) bytes a (position, head, K|V) against 2·hd.

Runtime health (``runtime/health.py``), as in JAX: a ``CommFaultPlan``
fires scripted comm faults at engine steps — a corrupt or bitflip step runs
with ``RunConfig.comm_fault`` set, through step functions kept apart from
the per-bucket ones, so that the engine launches exactly what it launched
before once the fault ends; a stall adds synthetic time to a step while the
island still runs a ring-family backend; a linkdown pins the island to
``bulk``. A request whose logits are not finite is retried after a backoff
(``max_retries``, ``retry_backoff``) or quarantined
(``prefill_nonfinite``; ``decode_nonfinite`` quarantines at once).
``deadline_steps`` expires requests, queued or in a slot. With
``health_monitor`` a ``HealthMonitor`` reads each island's step times and
the island guards' trips (drained once a step, beside the token read-back)
and demotes a drifting island's backend, layering ``"health"`` overrides
above every bucket's plan; ``plan_record()`` shows the live plans.

Fleet hooks (``runtime/fleet.py`` steps N engines as replicas):
``run(step_budget=k)`` runs at most k steps and returns; ``drain()`` stops
admission and ``take_queued()`` hands the queue back; ``take_undone()``
pops every request not completed (queued, in a prefill job, in a slot)
exactly once, in rid order; ``load()`` is the router's feedback;
``inject_step_delay(dt)`` adds to the next recorded step time, which feeds
the engine's ``StragglerWatchdog`` and the fleet's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig, ServeConfig
from repro_torch.core.template import IslandPlan, plan_overrides, render_plans
from repro_torch.models import transformer as T
from repro_torch.models.layers import island_plans
from repro_torch.models.sharding import ShardingRules
from repro_torch.runtime import paging
from repro_torch.runtime.health import (COMM_FAULT_KINDS, PAYLOAD_FAULT_KINDS,
                                        CommFaultPlan, HealthMonitor,
                                        demotion_ladder, take_guard_trips)
from repro_torch.runtime.straggler import StepTimer, StragglerWatchdog
from repro_torch.train.step import (make_paged_prefill_step,
                                    make_prefill_cache_step, make_serve_step)

__all__ = ["Request", "Completion", "BucketPlan", "ServingEngine",
           "padded_s_max", "resolve_page_geometry", "resolve_serving_plans",
           "render_serving_plans", "serving_plan_record"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids, greedy for
    ``max_new_tokens`` tokens."""

    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    bucket: int
    tokens: list[int]
    admitted_step: int
    finished_step: int
    slot: int


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The resolved overlap schedule for one bucket's step program."""

    phase: str                       # "prefill" | "decode"
    bucket: int
    batch: int
    seq: int
    plans: tuple[IslandPlan, ...]
    overrides: tuple                 # frozen RunConfig.island_overrides

    def asdict(self) -> dict:
        return {"phase": self.phase, "bucket": self.bucket,
                "batch": self.batch, "seq": self.seq,
                "islands": [p.asdict() for p in self.plans],
                "overrides": [list(o) for o in self.overrides]}


def padded_s_max(serve: ServeConfig, rules: ShardingRules | None) -> int:
    """Slot-cache length: worst prompt + generation, rounded up so the
    sequence-sharded cache divides the tp axis."""
    tp = rules.mesh.shape[rules.tp] if rules is not None else 1
    return -(-serve.s_max // tp) * tp


def resolve_page_geometry(serve: ServeConfig,
                          rules: ShardingRules | None) -> paging.PageGeometry:
    """The engine's page-pool geometry for this (serve, mesh) pair: the
    page padded to the tp stripe, the pool partitioned with the slot
    batch."""
    tp = rules.mesh.shape[rules.tp] if rules is not None else 1
    return paging.resolve_page_geometry(
        serve, s_max=padded_s_max(serve, rules), tp_size=tp,
        n_partitions=paging.page_partitions(rules, serve.max_batch))


def resolve_serving_plans(cfg: ArchConfig, run: RunConfig,
                          rules: ShardingRules | None,
                          serve: ServeConfig) -> dict[str, BucketPlan]:
    """``island_plans()`` per shape bucket: one prefill entry per bucket
    edge at (prefill_batch, L) plus the decode pool's one-token entry. In
    the paged layout the decode entry resolves the paged decode island
    (same name and ``Comm``), and with ``prefill_chunk`` every bucket shares
    one chunk-shaped prefill step: a single ``prefill@chunk{cl}`` entry at
    (prefill_batch, chunk)."""
    paged = serve.cache_layout == "paged"
    ps = resolve_page_geometry(serve, rules).page_size if paged else 0
    out: dict[str, BucketPlan] = {}
    if paged and serve.prefill_chunk:
        cl = serve.prefill_chunk
        edges = [(f"prefill@chunk{cl}", cl)]
    else:
        edges = [(f"prefill@{e}", e) for e in serve.bucket_edges]
    for name, seq in edges:
        plans = tuple(island_plans(cfg, run, rules,
                                   batch=serve.prefill_batch, seq=seq,
                                   phase="prefill", page_size=ps))
        out[name] = BucketPlan("prefill", seq, serve.prefill_batch, seq,
                               plans, plan_overrides(plans))
    plans = tuple(island_plans(cfg, run, rules, batch=serve.max_batch,
                               seq=padded_s_max(serve, rules),
                               phase="decode", page_size=ps))
    out["decode"] = BucketPlan("decode", serve.max_batch, serve.max_batch,
                               1, plans, plan_overrides(plans))
    return out


def render_serving_plans(table: dict[str, BucketPlan]) -> str:
    """Printable per-bucket island table (the serve CLI shows this)."""
    lines = []
    for name, bp in table.items():
        lines.append(f"[{name}] batch={bp.batch} seq={bp.seq}")
        lines.append(render_plans(bp.plans))
    return "\n".join(lines)


def serving_plan_record(cfg: ArchConfig, run: RunConfig,
                        rules: ShardingRules | None,
                        serve: ServeConfig) -> dict:
    """JSON-able per-bucket plan table with the cache's geometry: the whole
    serving schedule resolved without building the engine (JAX
    ``serving_plan_record``)."""
    table = resolve_serving_plans(cfg, run, rules, serve)
    s_max = padded_s_max(serve, rules)
    kv_dt = serve.kv_dtype
    cache: dict[str, Any] = {"layout": serve.cache_layout,
                             "s_max": s_max,
                             "kv_dtype": kv_dt,
                             "scale_bytes_per_pos": (
                                 cfg.n_layers * cfg.n_kv_heads * 2 * 4
                                 if kv_dt == "int8" else 0),
                             "slab_bytes": paging.slab_hbm_bytes(
                                 cfg, serve.max_batch, s_max,
                                 kv_dtype=kv_dt)}
    if serve.cache_layout == "paged":
        geom = resolve_page_geometry(serve, rules)
        cache.update({
            "page_size": geom.page_size, "n_pages": geom.n_pages,
            "pages_per_slot": geom.pages_per_slot,
            "n_partitions": geom.n_partitions,
            "prefill_chunk": serve.prefill_chunk,
            "pool_bytes": paging.pool_hbm_bytes(cfg, geom, kv_dtype=kv_dt),
            # per-bucket resident slots at a full span (L + max_new)
            "resident_capacity": {
                str(e): geom.resident_capacity(e + serve.max_new_tokens,
                                               serve.max_batch)
                for e in serve.bucket_edges}})
    else:
        cache["resident_capacity"] = {str(e): serve.max_batch
                                      for e in serve.bucket_edges}
    return {"config": {"max_batch": serve.max_batch,
                       "prefill_batch": serve.prefill_batch,
                       "bucket_edges": list(serve.bucket_edges),
                       "max_new_tokens": serve.max_new_tokens,
                       "queue_policy": serve.queue_policy},
            "comm_policy": run.comm_policy,
            "comm_wire": run.comm_wire or "bf16",
            "cache": cache,
            "buckets": {name: bp.asdict() for name, bp in table.items()}}


@dataclasses.dataclass
class _Slot:
    rid: int
    last_token: int
    remaining: int
    tokens: list[int]
    admitted_step: int
    bucket: int
    prompt_len: int


@dataclasses.dataclass
class _PrefillJob:
    """One in-flight chunked paged prefill: a bucket group whose chunks run
    over engine steps, decode ticks between them. Group rows are
    partition-aligned: row ``p*rows_per_part + i`` computes in dp group
    ``p`` and writes that group's pool partition."""

    bucket: int
    chunk_len: int
    n_chunks: int                    # ceil(bucket / chunk_len)
    next_chunk: int                  # resumes past fully shared chunks
    end_chunk: int                   # last chunk any row needs
    reqs: list                       # Request | None per group row
    slot_ids: list                   # int | None per group row
    tokens: np.ndarray               # (G, n_chunks*cl) right-padded prompts
    lens: np.ndarray                 # (G,) real lengths (1 for pad rows)
    write_from: np.ndarray           # (G,) shared-prefix write floor
    group_bt: np.ndarray             # (G, pages_per_slot) global page ids
    pages: list                      # per row: owned page list (refs held)
    logit_chunk: list                # per row: chunk containing L-1
    first_token: list                # per row: its greedy first token
    poisoned: list                   # per row: non-finite logits seen
    started_step: int


class ServingEngine:
    """Continuous-batching engine over one (cfg, run, rules, params).

    The caller builds and lays out the parameters (``launch.serve.
    build_engine``); the engine owns the slot cache, the request queue, the
    per-bucket step functions and the schedule. It runs on ``device`` —
    the GPU unless the caller names another, raising without one — where
    the parameters must already live."""

    def __init__(self, cfg: ArchConfig, run: RunConfig,
                 rules: ShardingRules | None, params,
                 serve: ServeConfig | None = None,
                 comm_faults: CommFaultPlan | str | None = None, *,
                 device=None):
        self.cfg = cfg
        self.serve = serve if serve is not None else ServeConfig()
        if cfg.encoder_decoder:
            raise NotImplementedError(
                "the continuous-batching engine covers decoder-only models")
        if T.has_ssm(cfg) and not self.serve.exact_buckets:
            raise ValueError(
                "SSM state cannot mask right-padded prompts; use "
                "ServeConfig(exact_buckets=True) for SSM/hybrid archs")
        self.base_run = run
        self.rules = rules
        self.params = params
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        # --- per-bucket plan resolution (the startup plan loop) ----------
        self.bucket_plans = resolve_serving_plans(cfg, run, rules, self.serve)
        self._runs = {name: dataclasses.replace(run,
                                                island_overrides=bp.overrides)
                      for name, bp in self.bucket_plans.items()}
        # --- decode pool state -------------------------------------------
        b = self.serve.max_batch
        self.s_max = padded_s_max(self.serve, rules)
        self.paged = self.serve.cache_layout == "paged"
        if self.paged:
            self.geom = resolve_page_geometry(self.serve, rules)
            if self.serve.prefill_batch % self.geom.n_partitions:
                raise ValueError(
                    f"paged prefill groups are partition-aligned: "
                    f"prefill_batch ({self.serve.prefill_batch}) must be a "
                    f"multiple of the pool partition count "
                    f"({self.geom.n_partitions})")
            self._cache_tmpl = paging.paged_cache_template(
                cfg, self._runs["decode"], rules, batch=b, geom=self.geom,
                kv_dtype=self.serve.kv_dtype)
            self.cache = T.zeros(self._cache_tmpl, rules, self.device)
            # block tables start unmapped (-1), never all zeros: a zero row
            # would alias every free slot onto physical page 0
            self.cache["block_tables"].fill_(-1)
            self.allocator = paging.PageAllocator(self.geom)
            self.prefix = paging.PrefixCache(self.allocator)
            self._share_ok = all(sp.mlp == "dense"
                                 for sp in cfg.layer_pattern())
            self._slot_pages: list[list[int] | None] = [None] * b
        else:
            self.geom = None
            self._cache_tmpl = T.cache_template(
                cfg, self._runs["decode"], rules, batch=b, s_max=self.s_max,
                slot_pos=True, kv_dtype=self.serve.kv_dtype)
            self.cache = T.zeros(self._cache_tmpl, rules, self.device)
        self._job: _PrefillJob | None = None
        self._decode_fn = make_serve_step(
            cfg, self._runs["decode"], rules,
            page_size=self.geom.page_size if self.paged else 0)
        self._prefill_fns: dict[int, Any] = {}
        self._prefill_tmpls: dict[int, Any] = {}
        self._static_fns: dict[tuple[int, int], tuple] = {}
        # --- host-side scheduler state -----------------------------------
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[_Slot | None] = [None] * b
        self.completions: dict[int, Completion] = {}
        self.events: list[tuple] = []
        self.step_no = 0
        self.step_kinds: list[str] = []
        self.watchdog = StragglerWatchdog()
        self.step_times: list[float] = []
        self.tokens_generated = 0
        self._next_rid = 0
        # fleet hooks: the Request of every live rid (a killed replica's
        # work is requeued from it), the admission gate, injected delay
        self._requests: dict[int, Request] = {}
        self.draining = False
        self._injected_delay = 0.0
        # cache-memory accounting (both layouts track peak residency)
        self.prefix_hits = 0
        self.shared_pages_reused = 0
        self.cow_copies = 0
        self.admission_blocked = 0
        self._peak_pages = 0
        self._peak_slots = 0
        # --- runtime health (runtime/health.py) ---------------------------
        if isinstance(comm_faults, str):
            comm_faults = CommFaultPlan.parse(comm_faults)
        self.comm_faults = comm_faults if comm_faults is not None \
            else CommFaultPlan()
        self._active_faults: list[dict] = []
        self._current_fault: tuple | None = None   # (kind, island, hop)
        self._fault_fns: dict[tuple, Any] = {}     # faulted step functions
        self._base_plans = dict(self.bucket_plans)  # as resolved, no health
        self._hov: tuple = ()                      # live health overrides
        self._retries: dict[int, int] = {}
        self._not_before: dict[int, int] = {}      # retry backoff gate
        self._submit_step: dict[int, int] = {}
        self.quarantined: dict[int, dict] = {}
        self.expired: dict[int, dict] = {}
        self.health: HealthMonitor | None = None
        self._health_ev_seen = 0
        if self.serve.health_monitor:
            self.health = HealthMonitor(
                self._health_ladders(),
                factor=self.serve.health_factor,
                demote_after=self.serve.health_demote_after,
                probation=self.serve.health_probation)

    # -- plumbing ----------------------------------------------------------

    def _batch_dim(self, pd: T.PD) -> int:
        """Index of the slot dim of a stored cache leaf (the page dim of a
        page pool)."""
        if not pd.periods:
            return 0
        stacked = len(T.stored_shape(pd, self.rules)) > len(pd.shape)
        return 2 if stacked else 1

    def _mem_metrics(self) -> dict:
        """Cache-memory snapshot attached to every admit/retire event."""
        live = sum(s is not None for s in self.slots)
        self._peak_slots = max(self._peak_slots, live)
        m: dict[str, Any] = {"resident_slots": live}
        if self.paged:
            rp = self.allocator.resident_pages
            self._peak_pages = max(self._peak_pages, rp)
            m["resident_pages"] = rp
            m["free_pages"] = self.geom.n_pages - rp
        return m

    def _greedy(self, logits) -> np.ndarray:
        """Next token per slot (argmax over the real vocab; the first
        maximum wins, as in ``jnp.argmax``)."""
        return logits[:, -1, :self.cfg.vocab_size].argmax(dim=-1) \
            .to(torch.int32).cpu().numpy()

    def _read_rows(self, logits) -> tuple[np.ndarray, np.ndarray]:
        """(greedy token, finite) per batch row, in one device->host copy:
        the ``_greedy`` rule, and whether the row's last-position logits
        over the real vocab are all finite — the poison detector (NaN and
        ±inf both trip it)."""
        last = logits[:, -1, :self.cfg.vocab_size]
        both = torch.stack([last.argmax(dim=-1),
                            torch.isfinite(last).all(dim=-1).long()]).cpu()
        return (both[0].to(torch.int32).numpy(),
                both[1].numpy().astype(bool))

    def _prefill_fn(self, bucket: int):
        if bucket not in self._prefill_fns:
            name = f"prefill@{bucket}"
            if name not in self.bucket_plans:
                run = self.base_run
                plans = tuple(island_plans(
                    self.cfg, run, self.rules, batch=self.serve.prefill_batch,
                    seq=bucket, phase="prefill"))
                self.bucket_plans[name] = BucketPlan(
                    "prefill", bucket, self.serve.prefill_batch, bucket,
                    plans, plan_overrides(plans))
                self._base_plans[name] = self.bucket_plans[name]
                # live health demotions layer above a fresh plan too
                self._runs[name] = dataclasses.replace(
                    run, island_overrides=(
                        self.bucket_plans[name].overrides + self._hov))
            run = self._runs[name]
            self._prefill_fns[bucket] = make_prefill_cache_step(
                self.cfg, run, self.rules)
            self._prefill_tmpls[bucket] = T.cache_template(
                self.cfg, run, self.rules, batch=self.serve.prefill_batch,
                s_max=self.s_max, slot_pos=True,
                kv_dtype=self.serve.kv_dtype)
        return self._prefill_fns[bucket]

    def _paged_prefill_fn(self, bucket: int):
        """The chunk step, keyed by chunk length: with ``prefill_chunk``
        every bucket shares one (G, cl) step; single-shot paged prefill
        (chunk = bucket) has one a bucket, as the slab path."""
        cl = self.serve.prefill_chunk or bucket
        if cl not in self._prefill_fns:
            name = (f"prefill@chunk{cl}" if self.serve.prefill_chunk
                    else f"prefill@{bucket}")
            if name not in self.bucket_plans:
                run = self.base_run
                plans = tuple(island_plans(
                    self.cfg, run, self.rules,
                    batch=self.serve.prefill_batch, seq=cl, phase="prefill",
                    page_size=self.geom.page_size))
                self.bucket_plans[name] = BucketPlan(
                    "prefill", bucket, self.serve.prefill_batch, cl,
                    plans, plan_overrides(plans))
                self._base_plans[name] = self.bucket_plans[name]
                self._runs[name] = dataclasses.replace(
                    run, island_overrides=(
                        self.bucket_plans[name].overrides + self._hov))
            self._prefill_fns[cl] = make_paged_prefill_step(
                self.cfg, self._runs[name], self.rules, self.geom.page_size)
        return self._prefill_fns[cl]

    @property
    def compiled_buckets(self) -> list[int]:
        """Prefill buckets (chunk lengths, paged) a step function has been
        built for."""
        return sorted(self._prefill_fns)

    # -- runtime health ----------------------------------------------------

    def _health_ladders(self) -> dict:
        """island -> demotion ladder, from the planned backends (the first
        bucket declaring an island wins: a ladder needs only the backend
        family, which is the same in every bucket)."""
        ladders: dict[str, tuple] = {}
        for bp in self.bucket_plans.values():
            for p in bp.plans:
                if p.fallback or p.backend is None or p.island in ladders:
                    continue
                lad = demotion_ladder(p.backend)
                if lad:
                    ladders[p.island] = lad
        return ladders

    def inject_comm_fault(self, kind: str, island: str, ticks: int = 1,
                          hop: int = 0, stall_dt: float = 1.0) -> None:
        """Start a comms-level fault now, for ``ticks`` engine steps — the
        entry point of the fleet and of the scripted ``CommFaultPlan``."""
        if kind not in COMM_FAULT_KINDS:
            raise ValueError(f"unknown comm fault kind {kind!r}; one of "
                             f"{COMM_FAULT_KINDS}")
        self._active_faults.append({"kind": kind, "island": island,
                                    "hop": int(hop),
                                    "remaining": max(1, int(ticks)),
                                    "stall_dt": float(stall_dt)})
        self.events.append(("comm_fault", self.step_no, kind, island,
                            max(1, int(ticks))))
        if kind == "linkdown" and self.health is not None:
            if self.health.link_down(island, self.step_no):
                self._refresh_health_overrides()

    def _fire_comm_faults(self) -> None:
        """Start the scripted events of the step about to run, then pick the
        payload fault (if any) this step's computation carries."""
        for ev in self.comm_faults.at(self.step_no + 1):
            self.inject_comm_fault(ev.kind, ev.island, ticks=ev.ticks,
                                   hop=ev.hop, stall_dt=ev.stall_dt)
        self._current_fault = None
        for f in self._active_faults:
            if f["kind"] in PAYLOAD_FAULT_KINDS:
                self._current_fault = (f["kind"], f["island"], f["hop"])
                break

    def _tick_comm_faults(self) -> None:
        still = []
        for f in self._active_faults:
            f["remaining"] -= 1
            if f["remaining"] > 0:
                still.append(f)
            else:
                self.events.append(("comm_fault_end", self.step_no,
                                    f["kind"], f["island"]))
                if f["kind"] == "linkdown" and self.health is not None:
                    # the link is back; promotion earns its way through
                    # the probation window, not at once
                    self.health.link_up(f["island"], self.step_no)
        self._active_faults = still

    def _faulted_fn(self, key: tuple, fault: tuple):
        """The step function whose ``RunConfig.comm_fault`` poisons the
        targeted ring hop, cached per (step, fault) apart from the
        per-bucket steps, which never see a fault (JAX re-jits the same
        variant)."""
        k = (key, fault)
        if k not in self._fault_fns:
            phase, bucket = key
            if phase == "decode":
                run = dataclasses.replace(self._runs["decode"],
                                          comm_fault=fault)
                fn = make_serve_step(
                    self.cfg, run, self.rules,
                    page_size=self.geom.page_size if self.paged else 0)
            elif phase == "paged":
                self._paged_prefill_fn(bucket)     # resolves the plan
                cl = self.serve.prefill_chunk or bucket
                name = (f"prefill@chunk{cl}" if self.serve.prefill_chunk
                        else f"prefill@{bucket}")
                run = dataclasses.replace(self._runs[name], comm_fault=fault)
                fn = make_paged_prefill_step(self.cfg, run, self.rules,
                                             self.geom.page_size)
            else:
                self._prefill_fn(bucket)           # resolves the plan
                run = dataclasses.replace(self._runs[f"prefill@{bucket}"],
                                          comm_fault=fault)
                fn = make_prefill_cache_step(self.cfg, run, self.rules)
            self._fault_fns[k] = fn
        return self._fault_fns[k]

    def _stall_applies(self, island: str, kind: str) -> bool:
        """A scripted link stall costs a step only while the island's
        current backend still rides the slow link (a ring-family schedule);
        a health demotion to bulk routes around it — the recovery the
        monitor's demotion buys."""
        names = ([n for n, bp in self.bucket_plans.items()
                  if bp.phase == "prefill"] if kind == "prefill"
                 else ["decode"])
        for n in names:
            for p in self.bucket_plans[n].plans:
                if p.fallback or p.island != island:
                    continue
                # health overrides patch bucket_plans, so p.backend
                # already shows any demotion
                if p.backend in ("ring", "ring_bidir", "chunked", "fused"):
                    return True
        return False

    def _refresh_health_overrides(self) -> None:
        """Layer the monitor's demotions (source ``"health"``) above every
        bucket's frozen overrides, patch the live plan records and rebuild
        the step functions. The calibration table and measured dispatch
        below are never touched: a promotion is the override going away."""
        hov = self.health.overrides() if self.health is not None else ()
        self._hov = hov
        by_island = {o[0]: o for o in hov}
        for name, base in self._base_plans.items():
            plans = tuple(
                dataclasses.replace(
                    p, backend=by_island[p.island][1],
                    n_chunks=(by_island[p.island][2]
                              if by_island[p.island][2] is not None
                              else p.n_chunks),
                    source="health",
                    reason=f"health demotion -> {by_island[p.island][1]}")
                if (not p.fallback and p.island in by_island) else p
                for p in base.plans)
            ov = base.overrides + hov
            self.bucket_plans[name] = dataclasses.replace(
                base, plans=plans, overrides=ov)
            self._runs[name] = dataclasses.replace(
                self.base_run, island_overrides=ov)
        self._decode_fn = make_serve_step(
            self.cfg, self._runs["decode"], self.rules,
            page_size=self.geom.page_size if self.paged else 0)
        self._prefill_fns.clear()
        self._fault_fns.clear()

    def _drain_health_events(self) -> None:
        if self.health is None:
            return
        for ev in self.health.events[self._health_ev_seen:]:
            self.events.append(("health_" + ev[0],) + tuple(ev[1:]))
        self._health_ev_seen = len(self.health.events)

    def plan_record(self) -> dict:
        """The live per-bucket plan table: unlike ``serving_plan_record()``,
        which resolves from the config, it shows runtime health demotions
        (``src=health`` islands and the layered overrides)."""
        return {"buckets": {n: bp.asdict()
                            for n, bp in self.bucket_plans.items()},
                "health_overrides": [list(o) for o in self._hov]}

    def _poisoned(self, req: Request, reason: str) -> None:
        """Retry after a backoff, or quarantine once the retries are
        spent."""
        attempt = self._retries.get(req.rid, 0)
        if attempt < self.serve.max_retries:
            self._retries[req.rid] = attempt + 1
            self._not_before[req.rid] = (
                self.step_no + self.serve.retry_backoff * (2 ** attempt))
            self.queue.append(req)
            self.events.append(("retry", self.step_no, req.rid, attempt + 1))
        else:
            self.quarantined[req.rid] = {"prompt_len": len(req.prompt),
                                         "step": self.step_no,
                                         "reason": reason}
            self._requests.pop(req.rid, None)
            self.events.append(("quarantine", self.step_no, req.rid))

    def _evict_slot(self, slot: int) -> None:
        """Drop a live slot without a completion (quarantine, deadline).
        Slab cache rows left behind are inert: the next admission into the
        slot writes every position it will attend to."""
        s = self.slots[slot]
        self._requests.pop(s.rid, None)
        self.slots[slot] = None
        if self.paged:
            self.cache["block_tables"][slot] = -1
            self.allocator.release(self._slot_pages[slot] or [])
            self._slot_pages[slot] = None

    def _expire_deadlines(self) -> None:
        dl = self.serve.deadline_steps
        if not dl:
            return
        for r in [r for r in self.queue
                  if self.step_no - self._submit_step.get(r.rid,
                                                          self.step_no) >= dl]:
            self.queue.remove(r)
            self._requests.pop(r.rid, None)
            self.expired[r.rid] = {"tokens": [], "step": self.step_no,
                                   "where": "queued"}
            self.events.append(("deadline", self.step_no, r.rid))
        for i, s in enumerate(self.slots):
            if s is not None and (self.step_no - self._submit_step.get(
                    s.rid, self.step_no)) >= dl:
                self.expired[s.rid] = {"tokens": list(s.tokens),
                                       "step": self.step_no, "where": "slot"}
                self.events.append(("deadline", self.step_no, s.rid))
                self._evict_slot(i)

    # -- fleet hooks -------------------------------------------------------

    @property
    def pending(self) -> bool:
        """True while a submitted request has not completed yet."""
        return (bool(self.queue) or self._job is not None
                or any(s is not None for s in self.slots))

    def drain(self) -> None:
        """Stop admitting: queued requests stay queued (the fleet's router
        takes them with ``take_queued``), slots finish."""
        if not self.draining:
            self.draining = True
            self.events.append(("drain", self.step_no))

    def take_queued(self) -> list[Request]:
        """Pop every queued (not admitted) request, in queue order; nothing
        on the device refers to them."""
        out = list(self.queue)
        self.queue.clear()
        return out

    def take_undone(self) -> list[Request]:
        """Pop every request not completed — queued, in a prefill job, in a
        decode slot — exactly once, in rid order. The kill hook: the engine
        is dead afterwards, and the router requeues what this returns."""
        undone: dict[int, Request] = {r.rid: r for r in self.queue}
        self.queue.clear()
        if self._job is not None:
            for r in self._job.reqs:
                if r is not None:
                    undone[r.rid] = r
            self._job = None
        for i, s in enumerate(self.slots):
            if s is not None:
                undone[s.rid] = self._requests[s.rid]
                self.slots[i] = None
        return [undone[k] for k in sorted(undone)]

    def load(self) -> int:
        """Router feedback: queued + live decode slots + prefill job rows,
        everything this replica still owes compute to."""
        job_rows = 0 if self._job is None \
            else sum(r is not None for r in self._job.reqs)
        return (len(self.queue) + sum(s is not None for s in self.slots)
                + job_rows)

    def inject_step_delay(self, dt: float) -> None:
        """Add ``dt`` seconds to the next recorded step time (a scripted
        fault feeding the watchdog and the fleet's straggler signal, with
        no sleep)."""
        self._injected_delay += dt

    def prefix_match_len(self, prompt: Sequence[int]) -> int:
        """Longest prefix of ``prompt`` the paged ``PrefixCache`` already
        holds (0 for the slab layout or when sharing is off)."""
        if not self.paged or not self._share_ok:
            return 0
        prompt = tuple(int(t) for t in prompt)
        sched = ("chunk", self.serve.prefill_chunk
                 or self.serve.bucket_for(len(prompt)))
        return max(self.prefix.lookup(p, prompt, sched)[0]
                   for p in range(self.geom.n_partitions))

    # -- request intake ----------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int | None = None,
               rid: int | None = None) -> int:
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        self.serve.bucket_for(len(prompt))       # validate length up front
        mx = max_new_tokens if max_new_tokens is not None \
            else self.serve.max_new_tokens
        if not 1 <= mx <= self.serve.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, "
                f"{self.serve.max_new_tokens}] (ServeConfig sized the "
                f"cache); got {mx}")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid, prompt, mx)
        self._requests[rid] = req
        self._submit_step[rid] = self.step_no    # the deadline clock
        self.queue.append(req)
        return rid

    # -- scheduling --------------------------------------------------------

    def _next_group(self):
        """(bucket, requests, slot_ids) to prefill next, or None."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        # retry backoff: a poisoned request waits until its gate opens
        eligible = [r for r in self.queue
                    if self._not_before.get(r.rid, 0) <= self.step_no]
        if self.draining or not free or not eligible:
            return None
        cap = min(len(free), self.serve.prefill_batch)
        head_bucket = self.serve.bucket_for(len(eligible[0].prompt))
        group = []
        if self.serve.queue_policy == "fcfs":
            for r in eligible:
                if len(group) == cap or \
                        self.serve.bucket_for(len(r.prompt)) != head_bucket:
                    break
                group.append(r)
        else:                                    # bucket-greedy
            for r in eligible:
                if len(group) == cap:
                    break
                if self.serve.bucket_for(len(r.prompt)) == head_bucket:
                    group.append(r)
        for r in group:
            self.queue.remove(r)
        return head_bucket, group, free[:len(group)]

    # -- paged scheduling --------------------------------------------------

    def _next_group_paged(self):
        """Paged admission: place queued head-bucket requests into
        partition-aligned group rows, allocating each request's whole page
        span (prompt + max_new: no allocation mid-decode) up front, with a
        prefix-share lookup in the registry. Stops at the first request
        that fits nowhere (strict order: deterministic backpressure);
        returns (bucket, placements) or None. A placement is (request,
        slot, row, pages, n_shared, cow_src, write_from)."""
        if self.draining or self._job is not None or not self.queue:
            return None
        eligible = [r for r in self.queue
                    if self._not_before.get(r.rid, 0) <= self.step_no]
        if not eligible:
            return None
        geom, serve = self.geom, self.serve
        b_loc = serve.max_batch // geom.n_partitions
        rows_per_part = serve.prefill_batch // geom.n_partitions
        free = {p: [i for i in range(p * b_loc, (p + 1) * b_loc)
                    if self.slots[i] is None]
                for p in range(geom.n_partitions)}
        if not any(free.values()):
            return None
        head_bucket = serve.bucket_for(len(eligible[0].prompt))
        if serve.queue_policy == "fcfs":
            cands = []
            for r in eligible:
                if serve.bucket_for(len(r.prompt)) != head_bucket:
                    break
                cands.append(r)
        else:                                    # bucket-greedy
            cands = [r for r in eligible
                     if serve.bucket_for(len(r.prompt)) == head_bucket]
        sched = ("chunk", serve.prefill_chunk or head_bucket)
        placements, used = [], {p: 0 for p in range(geom.n_partitions)}
        blocked = False
        for r in cands:
            if len(placements) == serve.prefill_batch:
                break
            need = geom.pages_for(len(r.prompt) + r.max_new_tokens)
            placed = False
            for p in range(geom.n_partitions):
                if not free[p] or used[p] >= rows_per_part:
                    continue
                shared, cow_src, wf = [], None, 0
                if self._share_ok:
                    m, ent = self.prefix.lookup(p, r.prompt, sched)
                    if ent is not None and m:
                        nfull = m // geom.page_size
                        shared = list(ent.pages[:nfull])
                        if m % geom.page_size and nfull < len(ent.pages):
                            cow_src = ent.pages[nfull]
                        wf = m
                # retain before evicting, so that evicting the donor entry
                # cannot free the pages about to be shared
                self.allocator.retain(shared)
                if cow_src is not None:
                    self.allocator.retain([cow_src])
                while True:
                    fresh = self.allocator.alloc(p, need - len(shared))
                    if fresh is not None or not self.prefix.evict_one(p):
                        break
                if fresh is None:
                    self.allocator.release(shared)
                    if cow_src is not None:
                        self.allocator.release([cow_src])
                    continue
                slot = free[p].pop(0)
                row = p * rows_per_part + used[p]
                used[p] += 1
                placements.append((r, slot, row, shared + fresh,
                                   len(shared), cow_src, wf))
                placed = True
                break
            if not placed:
                blocked = True
                break
        if not placements:
            if blocked:
                self.admission_blocked += 1
            return None
        for pl in placements:
            self.queue.remove(pl[0])
        return head_bucket, placements

    def _start_prefill_job(self, bucket: int, placements: list) -> None:
        geom, serve = self.geom, self.serve
        g = serve.prefill_batch
        cl = serve.prefill_chunk or bucket
        n_chunks = -(-bucket // cl)
        job = _PrefillJob(
            bucket=bucket, chunk_len=cl, n_chunks=n_chunks,
            next_chunk=n_chunks - 1, end_chunk=0,
            reqs=[None] * g, slot_ids=[None] * g,
            tokens=np.zeros((g, n_chunks * cl), np.int64),
            lens=np.ones((g,), np.int64),
            write_from=np.zeros((g,), np.int64),
            group_bt=np.full((g, geom.pages_per_slot), -1, np.int32),
            pages=[[] for _ in range(g)],
            logit_chunk=[0] * g, first_token=[None] * g,
            poisoned=[False] * g, started_step=self.step_no)
        copies = []
        for (r, slot, row, pages, nsh, cow_src, wf) in placements:
            length = len(r.prompt)
            job.reqs[row], job.slot_ids[row] = r, slot
            job.tokens[row, :length] = r.prompt
            job.lens[row] = length
            job.write_from[row] = wf
            job.group_bt[row, :len(pages)] = pages
            job.pages[row] = pages
            if cow_src is not None:
                # the boundary page: copy the donor's into the first fresh
                copies.append((cow_src, pages[nsh]))
                self.cow_copies += 1
            if wf:
                self.prefix_hits += 1
                self.shared_pages_reused += nsh
            lc = (length - 1) // cl
            job.logit_chunk[row] = lc
            job.end_chunk = max(job.end_chunk, lc)
            # a fully shared prefix still owes the chunk of its logits
            job.next_chunk = min(job.next_chunk, min(wf // cl, lc))
        if copies:
            self._cow_device_copy(copies)
        for (_, _, _, _, _, cow_src, _) in placements:
            if cow_src is not None:
                self.allocator.release([cow_src])   # admission's retain
        self._job = job

    def _cow_device_copy(self, copies: list[tuple[int, int]]) -> None:
        """Copy donor boundary pages into fresh ones in every layer's K and
        V pool, in place. The page dim of a stored pool follows the period
        dim, and the rank axis where the pool is stacked; src and dst share
        a partition, as they share a dp group."""
        src = torch.as_tensor([s_ for s_, _ in copies], device=self.device)
        dst = torch.as_tensor([d for _, d in copies], device=self.device)
        for path, pd in T.leaves(self._cache_tmpl):
            if path[0] != "blocks":
                continue
            x = self.cache
            for k in path:
                x = x[k]
            dim = self._batch_dim(pd)
            x.index_copy_(dim, dst, x.index_select(dim, src))

    def _prefill_chunk_step(self) -> None:
        """Run the job's next chunk; the live cache's block-table rows stay
        at the -1 sentinel until ``_finish_prefill_job`` commits them, so
        decode ticks between chunks cannot touch half-built pages."""
        job = self._job
        c = job.next_chunk
        c0 = c * job.chunk_len
        fn = self._paged_prefill_fn(job.bucket)
        if self._current_fault is not None:
            fn = self._faulted_fn(("paged", job.bucket), self._current_fault)
        dev = self.device
        with torch.no_grad():
            logits, self.cache = fn(
                self.params, self.cache,
                torch.from_numpy(job.tokens[:, c0:c0 + job.chunk_len])
                .to(dev),
                torch.from_numpy(job.group_bt).to(dev),
                torch.from_numpy(job.lens).to(dev), c0,
                torch.from_numpy(job.write_from).to(dev))
        first, finite = self._read_rows(logits)
        for row, r in enumerate(job.reqs):
            if r is not None and job.logit_chunk[row] == c:
                if not finite[row]:
                    job.poisoned[row] = True
                job.first_token[row] = int(first[row])
        self.events.append(
            ("prefill_chunk", self.step_no,
             tuple(r.rid for r in job.reqs if r is not None),
             c, job.n_chunks))
        job.next_chunk += 1
        if job.next_chunk > job.end_chunk:
            self._finish_prefill_job()

    def _finish_prefill_job(self) -> None:
        """Last chunk done: commit block-table rows and positions into the
        live cache, open the slots, register the prompts for prefix
        sharing."""
        job, geom = self._job, self.geom
        self._job = None
        # poisoned rows never commit: their block-table rows stay -1, their
        # pages go back to the pool, the request retries or quarantines
        for i in [i for i, r in enumerate(job.reqs)
                  if r is not None and job.poisoned[i]]:
            self.allocator.release(job.pages[i])
            self._poisoned(job.reqs[i], "prefill_nonfinite")
        rows = [i for i, r in enumerate(job.reqs)
                if r is not None and not job.poisoned[i]]
        if not rows:
            return
        idx = torch.as_tensor([job.slot_ids[i] for i in rows],
                              device=self.device)
        self.cache["block_tables"][idx] = torch.from_numpy(
            job.group_bt[rows]).to(self.device)
        self.cache["pos"][idx] = torch.from_numpy(job.lens[rows]).to(
            device=self.device, dtype=self.cache["pos"].dtype)
        for i in rows:
            r, slot = job.reqs[i], job.slot_ids[i]
            self._slot_pages[slot] = job.pages[i]
            if self._share_ok:
                part = geom.slot_partition(slot, self.serve.max_batch)
                self.prefix.register(
                    part, r.prompt,
                    job.pages[i][:geom.pages_for(len(r.prompt))],
                    ("chunk", job.chunk_len))
            tok = job.first_token[i]
            self.slots[slot] = _Slot(
                rid=r.rid, last_token=tok, remaining=r.max_new_tokens - 1,
                tokens=[tok], admitted_step=job.started_step,
                bucket=job.bucket, prompt_len=len(r.prompt))
            self.tokens_generated += 1
            self.events.append(("admit", self.step_no, r.rid, slot,
                                job.bucket, self._mem_metrics()))
            if self.slots[slot].remaining == 0:
                self._retire(slot)

    def _run_prefill(self, bucket: int, prompts: Sequence[Sequence[int]],
                     fn=None):
        """One bucket group's prefill step (``fn``, the bucket's by
        default) on a fresh group cache: returns (logits (prefill_batch, 1,
        V), group cache). Rows past ``len(prompts)`` are inert one-token
        pads."""
        g = self.serve.prefill_batch
        bucket_fn = self._prefill_fn(bucket)
        fn = bucket_fn if fn is None else fn
        tokens = np.zeros((g, bucket), np.int64)
        lens = np.ones((g,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lens[i] = len(p)
        gcache = T.zeros(self._prefill_tmpls[bucket], self.rules,
                         self.device)
        with torch.no_grad():
            return fn(self.params, gcache,
                      torch.from_numpy(tokens).to(self.device),
                      torch.from_numpy(lens).to(self.device))

    def prefill_logits(self, prompts: Sequence[Sequence[int]]):
        """Next-token logits of one prefill group (at most prefill_batch
        prompts of one bucket), computed by the engine's own bucket step
        without admitting anything: (len(prompts), 1, V) f32."""
        bucket = self.serve.bucket_for(max(len(p) for p in prompts))
        if len(prompts) > self.serve.prefill_batch or any(
                self.serve.bucket_for(len(p)) != bucket for p in prompts):
            raise ValueError("prompts must form one bucket group")
        return self._run_prefill(bucket, prompts)[0][:len(prompts)]

    def _prefill(self, bucket: int, reqs: list[Request],
                 slot_ids: list[int]) -> None:
        fn = None
        if self._current_fault is not None:
            fn = self._faulted_fn(("prefill", bucket), self._current_fault)
        logits, gcache = self._run_prefill(bucket, [r.prompt for r in reqs],
                                           fn)
        first, finite = self._read_rows(logits)
        # only finite rows go into the live cache and open slots; poisoned
        # rows retry or quarantine, and every slot's cache row is its own,
        # so the others' tokens do not change
        ok = [i for i in range(len(reqs)) if finite[i]]
        bad = [i for i in range(len(reqs)) if not finite[i]]
        if ok:
            idx = torch.as_tensor([slot_ids[i] for i in ok],
                                  device=self.device)
            rows = torch.as_tensor(ok, device=self.device)
            for path, pd in T.leaves(self._cache_tmpl):
                dst, src = self.cache, gcache
                for k in path:
                    dst, src = dst[k], src[k]
                dim = self._batch_dim(pd)
                dst.index_copy_(dim, idx, src.index_select(dim, rows))
        for i in ok:
            r, slot = reqs[i], slot_ids[i]
            self.slots[slot] = _Slot(
                rid=r.rid, last_token=int(first[i]),
                remaining=r.max_new_tokens - 1,
                tokens=[int(first[i])], admitted_step=self.step_no,
                bucket=bucket, prompt_len=len(r.prompt))
            self.events.append(("admit", self.step_no, r.rid, slot, bucket,
                                self._mem_metrics()))
            self.tokens_generated += 1
            if self.slots[slot].remaining == 0:
                self._retire(slot)
        for i in bad:
            self._poisoned(reqs[i], "prefill_nonfinite")

    def _retire(self, slot: int) -> None:
        s = self.slots[slot]
        self._requests.pop(s.rid, None)
        self.completions[s.rid] = Completion(
            rid=s.rid, prompt_len=s.prompt_len, bucket=s.bucket,
            tokens=list(s.tokens), admitted_step=s.admitted_step,
            finished_step=self.step_no, slot=slot)
        self.slots[slot] = None
        if self.paged:
            # unmap before releasing: a freed page may be allocated again
            # next step, and this slot keeps decoding inertly (its writes
            # must hit the -1 sentinel and drop, never a recycled page)
            self.cache["block_tables"][slot] = -1
            self.allocator.release(self._slot_pages[slot] or [])
            self._slot_pages[slot] = None
        self.events.append(("retire", self.step_no, s.rid, slot,
                            self._mem_metrics()))

    def _decode_tick(self) -> None:
        tokens = np.zeros((self.serve.max_batch, 1), np.int64)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i, 0] = s.last_token
        fn = self._decode_fn
        if self._current_fault is not None:
            fn = self._faulted_fn(("decode", 0), self._current_fault)
        with torch.no_grad():
            logits, self.cache = fn(self.params, self.cache,
                                    torch.from_numpy(tokens).to(self.device))
        nxt, finite = self._read_rows(logits)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if not finite[i]:
                # poisoned mid-decode: the slot's cache row may hold bad
                # K/V, so quarantine at once — a partial generation cannot
                # be replayed from poisoned state
                self.quarantined[s.rid] = {"prompt_len": s.prompt_len,
                                           "step": self.step_no,
                                           "reason": "decode_nonfinite"}
                self.events.append(("quarantine", self.step_no, s.rid))
                self._evict_slot(i)
                continue
            s.last_token = int(nxt[i])
            s.tokens.append(s.last_token)
            s.remaining -= 1
            self.tokens_generated += 1
            if s.remaining == 0:
                self._retire(i)

    def step(self) -> str | None:
        """One engine step: a bucket prefill when admission is possible,
        else a decode tick over the pool; None when fully idle. The step
        time is host wall time around work that ends in a device->host
        copy of the chosen tokens.

        The paged layout runs ONE prefill chunk a prefill step and
        alternates with decode ticks while a job is in flight (chunk,
        decode, chunk, ...), so a decode waits for one chunk at most. An
        exhausted pool shows here as no group with a queue left: the step
        decodes instead, draining pages. Before the work, the step starts
        its scripted comm faults and expires deadlines; a step whose every
        queued request waits out a retry backoff is an idle step."""
        self._fire_comm_faults()
        self._expire_deadlines()
        active = any(s is not None for s in self.slots)
        if self.paged:
            group = self._next_group_paged()
            if group is None and self._job is None and not active:
                if self.queue and not self.draining:
                    if any(self._not_before.get(r.rid, 0) <= self.step_no
                           for r in self.queue):
                        raise RuntimeError(
                            "paged admission deadlock: queue non-empty but "
                            "no slots/pages can ever free (pool undersized?)")
                    # every queued request backs off after a retry: an idle
                    # step lets the gates open
                    return self._record_step("idle", 0.0)
                return None
            with StepTimer() as t:
                if group is not None:
                    self._start_prefill_job(*group)
                    self._prefill_chunk_step()
                    kind = "prefill"
                elif self._job is not None and not (
                        active and self.step_kinds
                        and self.step_kinds[-1] == "prefill"):
                    self._prefill_chunk_step()
                    kind = "prefill"
                else:
                    self._decode_tick()
                    kind = "decode"
            return self._record_step(kind, t.dt)
        group = self._next_group()
        if group is None and not active:
            if self.queue and not self.draining:
                # every queued request backs off after a retry: idle step
                return self._record_step("idle", 0.0)
            return None
        with StepTimer() as t:
            if group is not None:
                self._prefill(*group)
                kind = "prefill"
            else:
                self._decode_tick()
                kind = "decode"
        return self._record_step(kind, t.dt)

    def _record_step(self, kind: str, dt: float) -> str:
        """Step accounting, JAX's order: an injected delay is added to the
        recorded time (the watchdog and the fleet see it; nothing sleeps),
        a scripted stall adds its synthetic time to the step and to the
        stalled island's health sample, the guards' trips are drained (the
        step's one read of them), and the monitor's verdicts re-layer the
        plans."""
        dt += self._injected_delay
        self._injected_delay = 0.0
        # a stall costs only while the island's current backend still
        # rides the slow link (after a demotion the step routes around it)
        stall: dict[str, float] = {}
        if kind in ("prefill", "decode"):
            for f in self._active_faults:
                if f["kind"] == "stall" and \
                        self._stall_applies(f["island"], kind):
                    stall[f["island"]] = (stall.get(f["island"], 0.0)
                                          + f["stall_dt"])
        dt += sum(stall.values())
        self.step_no += 1
        self.step_kinds.append(kind)
        self.step_times.append(dt)
        if kind != "idle" and self.watchdog.record(self.step_no, dt):
            print(f"[serve] STRAGGLER step {self.step_no} ({kind}): "
                  f"{dt:.3f}s (deadline {self.watchdog.deadline:.3f}s)")
        # the island guards that tripped during this step's device work
        changed = False
        for island, n in sorted(take_guard_trips().items()):
            self.events.append(("guard_trip", self.step_no, island, n))
            if self.health is not None:
                changed |= self.health.guard_trip(island, self.step_no)
        # per-island health samples: the step's own time plus the island's
        # stall
        if self.health is not None and kind in ("prefill", "decode"):
            base = dt - sum(stall.values())
            for island in self.health.islands:
                changed |= self.health.record(
                    island, self.step_no, base + stall.get(island, 0.0))
        if changed:
            self._refresh_health_overrides()
        self._drain_health_events()
        self._tick_comm_faults()
        return kind

    def run(self, requests=None, max_steps: int = 100_000,
            step_budget: int | None = None) -> list[Completion]:
        """Drain the queue (plus ``requests``, submitted first); returns the
        completions finished during this call, in rid order.
        ``step_budget`` makes the call cooperative: at most that many steps,
        then return what finished (no error for a queue left over) — the
        fleet steps its replicas this way, in a fixed rotation."""
        done_before = set(self.completions)
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r.prompt, r.max_new_tokens, rid=r.rid)
            else:
                self.submit(r)
        limit = max_steps if step_budget is None else min(max_steps,
                                                          step_budget)
        drained = False
        for _ in range(limit):
            if self.step() is None:
                drained = True
                break
        if not drained and step_budget is None:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return [self.completions[k] for k in sorted(self.completions)
                if k not in done_before]

    # -- static baseline + stats ------------------------------------------

    def _static_step_fns(self, n: int, bucket: int) -> tuple:
        key = (n, bucket)
        if key not in self._static_fns:
            run = self.base_run
            pre = plan_overrides(island_plans(self.cfg, run, self.rules,
                                              batch=n, seq=bucket,
                                              phase="prefill"))
            dec = plan_overrides(island_plans(self.cfg, run, self.rules,
                                              batch=n, seq=self.s_max,
                                              phase="decode"))
            run_pre = dataclasses.replace(run, island_overrides=pre)
            run_dec = dataclasses.replace(run, island_overrides=dec)
            tmpl = T.cache_template(self.cfg, run_dec, self.rules, batch=n,
                                    s_max=self.s_max, slot_pos=True,
                                    kv_dtype=self.serve.kv_dtype)
            self._static_fns[key] = (
                make_prefill_cache_step(self.cfg, run_pre, self.rules),
                make_serve_step(self.cfg, run_dec, self.rules), tmpl)
        return self._static_fns[key]

    def generate_static(self, prompts: Sequence[Sequence[int]],
                        max_new_tokens: int | None = None) -> list[list[int]]:
        """Static-batch baseline: every prompt padded to one bucket,
        prefilled as one batch, decoded in lockstep; same math and greedy
        rule as the engine."""
        mx = max_new_tokens if max_new_tokens is not None \
            else self.serve.max_new_tokens
        if not 1 <= mx <= self.serve.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, "
                f"{self.serve.max_new_tokens}] (ServeConfig sized the "
                f"cache); got {mx}")
        n = len(prompts)
        bucket = self.serve.bucket_for(max(len(p) for p in prompts))
        if T.has_ssm(self.cfg) and any(len(p) != bucket for p in prompts):
            # the invariant the constructor's guard protects: the SSM state
            # scans right-padding it cannot mask
            raise ValueError(
                "static SSM batches require uniform prompt lengths equal "
                f"to the bucket ({bucket}); got "
                f"{sorted({len(p) for p in prompts})}")
        prefill, decode, tmpl = self._static_step_fns(n, bucket)
        cache = T.zeros(tmpl, self.rules, self.device)
        tokens = np.zeros((n, bucket), np.int64)
        lens = np.zeros((n,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = list(p)
            lens[i] = len(p)
        with torch.no_grad():
            logits, cache = prefill(self.params, cache,
                                    torch.from_numpy(tokens).to(self.device),
                                    torch.from_numpy(lens).to(self.device))
            last = self._greedy(logits)
            out = [[int(t)] for t in last]
            for _ in range(mx - 1):
                logits, cache = decode(
                    self.params, cache,
                    torch.from_numpy(last[:, None].astype(np.int64))
                    .to(self.device))
                last = self._greedy(logits)
                for i in range(n):
                    out[i].append(int(last[i]))
        return [seq[:mx] for seq in out]

    def cache_stats(self) -> dict:
        """The cache's memory: layout, pool bytes against the slab
        equivalent, residency peaks, prefix-sharing and backpressure
        counters (JAX's keys; the byte counts are K/V's, by
        ``paging.slab_hbm_bytes`` and ``pool_hbm_bytes``)."""
        slab = paging.slab_hbm_bytes(self.cfg, self.serve.max_batch,
                                     self.s_max,
                                     kv_dtype=self.serve.kv_dtype)
        out: dict[str, Any] = {
            "layout": self.serve.cache_layout,
            "kv_dtype": self.serve.kv_dtype,
            "peak_resident_slots": self._peak_slots,
            "slab_bytes": slab,
        }
        if not self.paged:
            out["hbm_bytes"] = slab
            return out
        g = self.geom
        out.update({
            "hbm_bytes": paging.pool_hbm_bytes(self.cfg, g,
                                               kv_dtype=self.serve.kv_dtype),
            "page_size": g.page_size, "n_pages": g.n_pages,
            "pages_per_slot": g.pages_per_slot,
            "n_partitions": g.n_partitions,
            "resident_pages": self.allocator.resident_pages,
            "peak_resident_pages": self._peak_pages,
            "peak_pool_occupancy": self._peak_pages / g.n_pages,
            "prefix_hits": self.prefix_hits,
            "shared_pages_reused": self.shared_pages_reused,
            "cow_copies": self.cow_copies,
            "admission_blocked": self.admission_blocked,
        })
        return out

    def stats(self) -> dict:
        total = sum(self.step_times)
        return {
            "steps": self.step_no,
            "prefill_steps": self.step_kinds.count("prefill"),
            "decode_steps": self.step_kinds.count("decode"),
            "idle_steps": self.step_kinds.count("idle"),
            "tokens_generated": self.tokens_generated,
            "wall_s": total,
            "tokens_per_s": self.tokens_generated / total if total else 0.0,
            "straggler_events": len(self.watchdog.events),
            "compiled_buckets": self.compiled_buckets,
            "cache": self.cache_stats(),
            "quarantined": len(self.quarantined),
            "expired": len(self.expired),
            "retries": sum(self._retries.values()),
            "guard_trips": sum(e[0] == "guard_trip" for e in self.events),
            "health_demotions": (
                sum(e[0] == "demote" for e in self.health.events)
                if self.health is not None else 0),
        }
