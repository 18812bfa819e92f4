"""A serving cell: the port's ``ServingEngine`` under closed-loop clients,
and the tokens it served held to the reference.

Set-up draws the weights from the seed, lays them out for the port and
builds the engine as ``launch/serve.py::build_engine`` does (parameters
laid out once, the cell's ``RunConfig`` and ``ServeConfig``). Each client
then submits its first request, and the engine steps until every one has
been prefilled and the pool has decoded twice (the warm-up: every bucket
the first requests fall in, and the decode step at a full pool); a client
whose request completes submits its next one at once. The window opens
there. In the window each ``engine.step()`` is timed by the harness's
clock when it returns (a step ends in a device->host read), and a client
submits again as soon as its request completes. After the window the
engine steps on, without new requests, until every request submitted in
the window has its first token, so that each counts in the TTFT tail.

A request's first token is the end of the step that prefilled it
(``Completion.admitted_step``, or the engine's ``admit`` event while it
is in flight) and each later token the end of the next decode step up to
``finished_step``.

The check: a sample drawn from the seed of the requests that finished
(the longest among them), the engine freed, and the reference's logits
over each prompt with its served tokens; at each served position the gap
by which the served token's logit lies below the reference's largest.
"""

from __future__ import annotations

import gc
import importlib
import math
import time

import numpy as np

from pkbench.harness import trace, weights as W
from pkbench.families import port


def build(cell: dict, config: dict, seed: int, device):
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.runtime import serving

    ref = importlib.import_module(f"pkbench.reference.{config['family']}")
    fam = port.family(config["family"])
    dm = ref.dims(config)
    cfg = fam.arch(config, dm)
    run = RunConfig(**cell["run"])
    rules = (ShardingRules(VirtualMesh(tuple(cell["mesh"]),
                                       ("data", "model"), device), run)
             if cell.get("mesh") else None)
    w = W.make(ref.param_specs(dm), seed, dm["d"], device)
    params = port.to_port(w, fam, cfg, run, rules, device)
    sv = dict(cell["serve"])
    sv["bucket_edges"] = tuple(sv["bucket_edges"])
    return serving.ServingEngine(cfg, run, rules, params, ServeConfig(**sv),
                                 device=params["embed"].device), dm


class Clients:
    """The closed loop: one request in flight a client."""

    def __init__(self, engine, gen, n: int):
        self.engine, self.gen = engine, gen
        self.submit_t: dict[int, float] = {}
        self.prompt_len: dict[int, int] = {}
        self.prompts: dict[int, list[int]] = {}
        self.inflight: set[int] = set()
        self.admit_step: dict[int, int] = {}
        self.client: dict[int, int] = {}
        self.n_events = 0
        for c in range(n):
            self.submit(c)

    def submit(self, client: int) -> None:
        prompt, n_out = self.gen.next(client)
        rid = self.engine.submit(prompt, n_out)
        self.client[rid] = client
        self.submit_t[rid] = time.perf_counter()
        self.prompt_len[rid] = len(prompt)
        self.prompts[rid] = prompt
        self.inflight.add(rid)

    def after_step(self, resubmit: bool) -> None:
        """Read the step's admissions; with ``resubmit``, each client whose
        request completed sends its next one."""
        ev = self.engine.events
        for e in ev[self.n_events:]:
            if e[0] == "admit":
                self.admit_step[e[2]] = e[1]
        self.n_events = len(ev)
        done = [r for r in self.inflight
                if r in self.engine.completions
                or r in self.engine.quarantined or r in self.engine.expired]
        for r in done:
            self.inflight.discard(r)
            if resubmit:
                self.submit(self.client[r])


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace_on: bool, device, setup_t0: float) -> dict:
    import torch
    from pkbench.traffic import closed_loop

    engine, dm = build(cell, config, seed, device)
    gen = closed_loop.ClosedLoop(mix, dm["vocab"], seed)
    clients = Clients(engine, gen, mix["clients"])
    end_t: dict[int, float] = {}

    def step(resubmit: bool) -> str | None:
        kind = engine.step()
        end_t[engine.step_no - 1] = time.perf_counter()
        clients.after_step(resubmit)
        return kind

    decodes = 0
    while engine.queue or decodes < 2:
        decodes += step(True) == "decode"
    gc.collect()
    gc.freeze()
    setup_s = time.time() - setup_t0

    first_step = engine.step_no
    gen0 = engine.tokens_generated
    with trace.profiled(trace_on) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            t0 = time.perf_counter()
            n_sub = len(clients.submit_t)
            while True:
                with torch.profiler.record_function("pkbench.engine_step"):
                    step(True)
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
    gc.unfreeze()
    window_s = t1 - t0
    last_step = engine.step_no
    tokens_in_window = engine.tokens_generated - gen0
    window_rids = set(list(clients.submit_t)[n_sub:])
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    summary = (trace.summarize(prof, spans=()) if trace_on else None)
    del prof
    deadline = time.perf_counter() + 60.0
    while any(r not in clients.admit_step for r in window_rids
              if r in clients.inflight) and time.perf_counter() < deadline:
        step(False)

    kinds = engine.step_kinds
    times = engine.step_times
    win = range(first_step, last_step)
    admits: dict[int, list[int]] = {}
    for r, k in clients.admit_step.items():
        admits.setdefault(k, []).append(r)
    decode_tokens, decode_s, prefill_prompts = [], [], []
    gen_by_step = _generated_by_step(engine, clients, first_step, last_step)
    for k in win:
        if kinds[k] == "decode":
            decode_tokens.append(gen_by_step.get(k, 0))
            decode_s.append(times[k])
        elif kinds[k] == "prefill":
            prefill_prompts.append([clients.prompt_len[r]
                                    for r in admits.get(k, [])])
    token_times = _token_times(engine, clients, end_t)
    ttft = [token_times[r][0] - clients.submit_t[r] for r in window_rids
            if token_times.get(r)]
    itl, contexts = [], []
    for r, ts in token_times.items():
        for i in range(1, len(ts)):
            if t0 <= ts[i] <= t1:
                itl.append(ts[i] - ts[i - 1])
                contexts.append(clients.prompt_len[r] + i)
    failed = sum(1 for r in window_rids
                 if r in engine.quarantined or r in engine.expired
                 or r not in token_times)
    serve_rec = {
        "tokens_in_window": tokens_in_window,
        "decode_tokens": decode_tokens, "decode_step_s": decode_s,
        "prefill_prompts": prefill_prompts,
        "prefill_tokens": [sum(p) for p in prefill_prompts],
        "prefill_step_s": [times[k] for k in win if kinds[k] == "prefill"],
        "decode_contexts": contexts, "ttft_s": ttft, "itl_s": itl,
        "requests_in_window": len(window_rids)}
    finished = {r: c for r, c in engine.completions.items()
                if r in clients.prompt_len
                and first_step <= c.finished_step < last_step}
    sample = _sample(finished, cell["check"], seed)
    prompts = {r: clients.prompts[r] for r in sample}
    tokens = {r: list(finished[r].tokens) for r in sample}
    del engine, clients, gen, finished
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(config, cell["check"], seed, device, prompts,
                          tokens)
    return {
        "mode": "serve", "setup_s": setup_s, "window_s": window_s,
        "memory_peak_bytes": peak, "attempted": len(window_rids),
        "failed": failed, "trace": summary, "serve": serve_rec,
        "compared": compared(gaps),
        "checked": dict(gap_stats(gaps), requests=len(sample)),
        "sample": {"prompts": prompts, "tokens": tokens}}


def compared(gaps) -> dict:
    """The numbers a serving cell's ``limits`` may name, over the gaps of
    the sampled served tokens: the widest, the mean, and the share of
    positions whose gap is over 0.1 of a logit (a fault that touches a
    few tokens in ten moves it, however small its mean)."""
    names = ("served_logit_gap", "served_logit_gap_mean",
             "served_logit_gap_share_over_0.1")
    if not gaps:
        return dict.fromkeys(names, math.inf)
    g = np.asarray(gaps)
    return dict(zip(names, (float(g.max()), float(g.mean()),
                            float((g > 0.1).mean()))))


def gap_stats(gaps) -> dict:
    """Quantiles of the served-token gaps and the share of positions whose
    served token is not the reference's first."""
    if not gaps:
        return {"tokens": 0}
    g = np.asarray(gaps)
    q = np.quantile(g, [0.5, 0.9, 0.99])
    return {"tokens": len(g), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": float(g.max()),
            "mean": float(g.mean()), "share_over_0": float((g > 0).mean()),
            "share_over_0.1": float((g > 0.1).mean())}


def _token_times(engine, clients, end_t) -> dict[int, list[float]]:
    """Host time of each token of every admitted request."""
    kinds = engine.step_kinds
    decode = [k for k, kind in enumerate(kinds) if kind == "decode"]
    out = {}
    for r, adm in clients.admit_step.items():
        c = engine.completions.get(r)
        fin = c.finished_step if c is not None else len(kinds) - 1
        lo = np.searchsorted(decode, adm, side="right")
        hi = np.searchsorted(decode, fin, side="right")
        out[r] = [end_t[adm]] + [end_t[k] for k in decode[lo:hi]]
    return out


def _generated_by_step(engine, clients, first: int, last: int) -> dict:
    """Live requests decoded in each step of [first, last)."""
    live = np.zeros(last - first + 1, dtype=np.int64)
    n = len(engine.step_kinds)
    for r, adm in clients.admit_step.items():
        c = engine.completions.get(r)
        fin = c.finished_step if c is not None else n - 1
        a, b = max(adm + 1, first), min(fin, last - 1)
        if a <= b:
            live[a - first] += 1
            live[b - first + 1] -= 1
    counts = np.cumsum(live)
    return {first + i: int(counts[i]) for i in range(last - first)}


def _sample(finished: dict, check: dict, seed: int) -> list[int]:
    """The longest finished request and others drawn from the seed, until
    ``served_tokens`` served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    rids = sorted(finished)
    size = {r: finished[r].prompt_len + len(finished[r].tokens) for r in rids}
    longest = max(rids, key=lambda r: (size[r], -r))
    rng = np.random.default_rng(W.derive(seed, "sample"))
    out = [longest]
    served = len(finished[longest].tokens)
    for i in rng.permutation(len(rids)):
        r = rids[int(i)]
        if served >= check["served_tokens"] or \
                len(out) >= check["max_requests"]:
            break
        if r != longest:
            out.append(r)
            served += len(finished[r].tokens)
    return out


def reference_gaps(config: dict, check: dict, seed: int, device, prompts,
                   tokens, prec: str = "f32", pick=None) -> list[float]:
    """At every served position of the sampled requests, the reference's
    largest logit minus its logit of the served token (or, with ``pick``,
    of the token that ``pick``'s logits put first: the control). Requests
    go through the reference ``check["reference_batch"]`` at a time,
    right-padded (every layer is causal, so padding changes nothing
    before it)."""
    import torch

    ref = importlib.import_module(f"pkbench.reference.{config['family']}")
    dm = ref.dims(config)
    p = W.as_f32(W.make(ref.param_specs(dm), seed, dm["d"], device))
    v = dm["vocab"]
    rids = list(prompts)
    nb = check.get("reference_batch", 1)
    gaps: list[float] = []
    with torch.no_grad():
        for i in range(0, len(rids), nb):
            grp = rids[i:i + nb]
            seqs = [prompts[r] + tokens[r][:-1] for r in grp]
            n = max(len(x) for x in seqs)
            ids = torch.tensor([x + [0] * (n - len(x)) for x in seqs],
                               device=device)
            # the head runs only from the first served position on
            s0 = min(len(prompts[r]) for r in grp) - 1
            lg = ref.logits(p, ids, dm, start=s0)[..., :v]
            other = ref.logits(p, ids, dm, prec=pick, start=s0)[..., :v] \
                if pick else None
            for j, r in enumerate(grp):
                lo = len(prompts[r]) - 1 - s0
                rows = lg[j, lo:lo + len(tokens[r])]
                if other is None:
                    tok = torch.tensor(tokens[r], device=device)
                else:
                    tok = other[j, lo:lo + len(tokens[r])].argmax(-1)
                g = rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0]
                gaps.extend(g.tolist())
            del lg, other
    return gaps
