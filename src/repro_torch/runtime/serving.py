"""Continuous-batching serving engine, slab KV layout — the twin of
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

Not ported (each raises when ``ServeConfig`` asks for it): the paged cache
and chunked prefill (ROADMAP A7), the int8 KV cache (A11), the health
monitor, retries, deadlines and comm faults, and the fleet hooks (A13).
Non-finite logits raise ``FloatingPointError`` instead of being retried.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig, ServeConfig
from repro_torch.core.template import IslandPlan, plan_overrides, render_plans
from repro_torch.models import transformer as T
from repro_torch.models.layers import island_plans
from repro_torch.models.sharding import ShardingRules
from repro_torch.train.step import make_prefill_cache_step, make_serve_step

__all__ = ["Request", "Completion", "BucketPlan", "ServingEngine",
           "padded_s_max", "resolve_serving_plans", "render_serving_plans"]


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


def resolve_serving_plans(cfg: ArchConfig, run: RunConfig,
                          rules: ShardingRules | None,
                          serve: ServeConfig) -> dict[str, BucketPlan]:
    """``island_plans()`` per shape bucket: one prefill entry per bucket
    edge at (prefill_batch, L) plus the decode pool's one-token entry."""
    out: dict[str, BucketPlan] = {}
    for edge in serve.bucket_edges:
        plans = tuple(island_plans(cfg, run, rules,
                                   batch=serve.prefill_batch, seq=edge,
                                   phase="prefill"))
        out[f"prefill@{edge}"] = BucketPlan(
            "prefill", edge, serve.prefill_batch, edge, plans,
            plan_overrides(plans))
    plans = tuple(island_plans(cfg, run, rules, batch=serve.max_batch,
                               seq=padded_s_max(serve, rules),
                               phase="decode"))
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


def _check_serve(serve: ServeConfig) -> None:
    if serve.cache_layout != "slab" or serve.prefill_chunk:
        raise NotImplementedError(
            "the paged KV cache and chunked prefill are ROADMAP item A7")
    if serve.kv_dtype != "bf16":
        raise NotImplementedError("the int8 KV cache is ROADMAP item A11")
    if serve.health_monitor or serve.deadline_steps:
        raise NotImplementedError(
            "the health monitor and request deadlines are ROADMAP item A13")


@dataclasses.dataclass
class _Slot:
    rid: int
    last_token: int
    remaining: int
    tokens: list[int]
    admitted_step: int
    bucket: int
    prompt_len: int


class ServingEngine:
    """Continuous-batching engine over one (cfg, run, rules, params).

    The caller builds and lays out the parameters (``launch.serve.
    build_engine``); the engine owns the slot cache, the request queue, the
    per-bucket step functions and the schedule. It runs on ``device`` —
    the GPU unless the caller names another, raising without one — where
    the parameters must already live."""

    def __init__(self, cfg: ArchConfig, run: RunConfig,
                 rules: ShardingRules | None, params,
                 serve: ServeConfig | None = None, *, device=None):
        self.cfg = cfg
        self.serve = serve if serve is not None else ServeConfig()
        if cfg.encoder_decoder:
            raise NotImplementedError(
                "the continuous-batching engine covers decoder-only models")
        _check_serve(self.serve)
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
        self._cache_tmpl = T.cache_template(
            cfg, self._runs["decode"], rules, batch=b, s_max=self.s_max,
            slot_pos=True)
        self.cache = T.zeros(self._cache_tmpl, rules, self.device)
        self._decode_fn = make_serve_step(cfg, self._runs["decode"], rules)
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
        self.step_times: list[float] = []
        self.tokens_generated = 0
        self._next_rid = 0
        self._peak_slots = 0

    # -- plumbing ----------------------------------------------------------

    def _batch_dim(self, pd: T.PD) -> int:
        """Index of the slot dim of a stored cache leaf."""
        if not pd.periods:
            return 0
        stacked = len(T.stored_shape(pd, self.rules)) > len(pd.shape)
        return 2 if stacked else 1

    def _mem_metrics(self) -> dict:
        live = sum(s is not None for s in self.slots)
        self._peak_slots = max(self._peak_slots, live)
        return {"resident_slots": live}

    def _greedy(self, logits) -> np.ndarray:
        """Next token per slot (argmax over the real vocab; the first
        maximum wins, as in ``jnp.argmax``)."""
        return logits[:, -1, :self.cfg.vocab_size].argmax(dim=-1) \
            .to(torch.int32).cpu().numpy()

    def _check_finite(self, logits) -> None:
        if not bool(torch.isfinite(logits[:, -1, :self.cfg.vocab_size])
                    .all()):
            raise FloatingPointError(
                f"non-finite logits at engine step {self.step_no}; request "
                "retry and quarantine are ROADMAP item A13")

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
                self._runs[name] = dataclasses.replace(
                    run, island_overrides=self.bucket_plans[name].overrides)
            run = self._runs[name]
            self._prefill_fns[bucket] = make_prefill_cache_step(
                self.cfg, run, self.rules)
            self._prefill_tmpls[bucket] = T.cache_template(
                self.cfg, run, self.rules, batch=self.serve.prefill_batch,
                s_max=self.s_max, slot_pos=True)
        return self._prefill_fns[bucket]

    @property
    def compiled_buckets(self) -> list[int]:
        """Prefill buckets a step function has been built for."""
        return sorted(self._prefill_fns)

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
        self.queue.append(Request(rid, prompt, mx))
        return rid

    # -- scheduling --------------------------------------------------------

    def _next_group(self):
        """(bucket, requests, slot_ids) to prefill next, or None."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return None
        cap = min(len(free), self.serve.prefill_batch)
        head_bucket = self.serve.bucket_for(len(self.queue[0].prompt))
        group = []
        if self.serve.queue_policy == "fcfs":
            for r in self.queue:
                if len(group) == cap or \
                        self.serve.bucket_for(len(r.prompt)) != head_bucket:
                    break
                group.append(r)
        else:                                    # bucket-greedy
            for r in self.queue:
                if len(group) == cap:
                    break
                if self.serve.bucket_for(len(r.prompt)) == head_bucket:
                    group.append(r)
        for r in group:
            self.queue.remove(r)
        return head_bucket, group, free[:len(group)]

    def _run_prefill(self, bucket: int, prompts: Sequence[Sequence[int]]):
        """One bucket group's prefill step on a fresh group cache: returns
        (logits (prefill_batch, 1, V), group cache). Rows past
        ``len(prompts)`` are inert one-token pads."""
        g = self.serve.prefill_batch
        fn = self._prefill_fn(bucket)
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
        logits, gcache = self._run_prefill(bucket, [r.prompt for r in reqs])
        self._check_finite(logits)
        first = self._greedy(logits)
        idx = torch.as_tensor(slot_ids, device=self.device)
        rows = torch.arange(len(reqs), device=self.device)
        for path, pd in T.leaves(self._cache_tmpl):
            dst, src = self.cache, gcache
            for k in path:
                dst, src = dst[k], src[k]
            dim = self._batch_dim(pd)
            dst.index_copy_(dim, idx, src.index_select(dim, rows))
        for i, r in enumerate(reqs):
            slot = slot_ids[i]
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

    def _retire(self, slot: int) -> None:
        s = self.slots[slot]
        self.completions[s.rid] = Completion(
            rid=s.rid, prompt_len=s.prompt_len, bucket=s.bucket,
            tokens=list(s.tokens), admitted_step=s.admitted_step,
            finished_step=self.step_no, slot=slot)
        self.slots[slot] = None
        self.events.append(("retire", self.step_no, s.rid, slot,
                            self._mem_metrics()))

    def _decode_tick(self) -> None:
        tokens = np.zeros((self.serve.max_batch, 1), np.int64)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i, 0] = s.last_token
        with torch.no_grad():
            logits, self.cache = self._decode_fn(
                self.params, self.cache,
                torch.from_numpy(tokens).to(self.device))
        live = [i for i, s in enumerate(self.slots) if s is not None]
        self._check_finite(logits[live])
        nxt = self._greedy(logits)
        for i in live:
            s = self.slots[i]
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
        copy of the chosen tokens."""
        group = self._next_group()
        if group is None and not any(s is not None for s in self.slots):
            return None
        t0 = time.perf_counter()
        if group is not None:
            self._prefill(*group)
            kind = "prefill"
        else:
            self._decode_tick()
            kind = "decode"
        self.step_no += 1
        self.step_kinds.append(kind)
        self.step_times.append(time.perf_counter() - t0)
        return kind

    def run(self, requests=None, max_steps: int = 100_000) -> list[Completion]:
        """Drain the queue (plus ``requests``, submitted first); returns the
        completions finished during this call, in rid order."""
        done_before = set(self.completions)
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r.prompt, r.max_new_tokens, rid=r.rid)
            else:
                self.submit(r)
        for _ in range(max_steps):
            if self.step() is None:
                break
        else:
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
                                    s_max=self.s_max, slot_pos=True)
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
        nbytes = sum(t.numel() * t.element_size()
                     for _, t in T.leaves(self.cache))
        return {"layout": "slab", "kv_dtype": self.serve.kv_dtype,
                "peak_resident_slots": self._peak_slots,
                "hbm_bytes": nbytes}

    def stats(self) -> dict:
        total = sum(self.step_times)
        return {
            "steps": self.step_no,
            "prefill_steps": self.step_kinds.count("prefill"),
            "decode_steps": self.step_kinds.count("decode"),
            "tokens_generated": self.tokens_generated,
            "wall_s": total,
            "tokens_per_s": self.tokens_generated / total if total else 0.0,
            "compiled_buckets": self.compiled_buckets,
            "cache": self.cache_stats(),
        }
