"""A training cell: the port's ``make_train_step`` driven on the
benchmark's batches, and its first steps held to the reference.

Set-up draws the weights from the seed, lays them out for the port, builds
one train step and one optimizer state, and drives them through steps 0-2
on batches 0-2 (every row its own). It keeps, from the optimizer's state
after step 0, each leaf's gradient as the update used it (the first
moment over ``1 - b1``), and after step 2 each leaf's change from its
initial value. The window then runs steps 3, 4, ... through the same call
until ``seconds`` have passed, and ends in a synchronize. After the window
the program's state is freed and the reference runs steps 0-2 in float32
on the same weights and batches (``reference_steps``), and
``checks.train_numbers`` compares the two.
"""

from __future__ import annotations

import gc
import importlib
import time

from pkbench.harness import checks, trace, weights as W
from pkbench.families import port


def _opt_class(record_function):
    from repro_torch.optim.adamw import AdamW

    class RangedAdamW(AdamW):
        """The port's AdamW with its update in a range of the trace."""
        def update(self, grads, state, params):
            with record_function("pkbench.optimizer"):
                return super().update(grads, state, params)

    return RangedAdamW


def build(cell: dict, config: dict, seed: int, device):
    """(step function, state, dims, port handles) for a cell."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train import step as TS

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
    o = cell["optimizer"]
    opt = _opt_class(torch.profiler.record_function)(
        lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    state = TS.TrainState(params, opt.init(params))
    return TS.make_train_step(cfg, run, rules, opt), state, dm, (cfg, run,
                                                                  rules, fam)


def _norms(tree, paths, scale: float) -> dict:
    """Each stored leaf's f32 norm, times ``scale``."""
    return {path: scale * float(port.stored(tree, path).float().norm())
            for path in paths}


def run(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
        trace_on: bool, device, setup_t0: float) -> dict:
    import torch
    from repro_torch.models import transformer as T
    from pkbench.traffic import lm_batches

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    step, state, dm, (cfg, run_cfg, rules, fam) = build(cell, config, seed,
                                                        device)
    data = lm_batches.Batches(mix, dm["vocab"], seed, device)
    tmpl = T.param_template(cfg, run_cfg, rules)
    paths = [p for p, _ in T.leaves(tmpl)]
    names = dict(fam.leaf_names(tmpl))
    b1 = cell["optimizer"]["b1"]
    first_losses, grad_norms = [], {}
    for i in range(3):
        state, m = step(state, data.batch(i))
        first_losses.append(m["loss"])
        if i == 0:
            grad_norms = _norms(state.opt.m, paths, 1 / (1 - b1))
    ref = importlib.import_module(f"pkbench.reference.{config['family']}")
    w0 = W.make(ref.param_specs(dm), seed, dm["d"], device)
    pds = dict(T.leaves(tmpl))
    change = {}
    for path in paths:
        x0 = T.to_stored(fam.to_global(w0, names[path], pds[path].shape),
                         pds[path], rules)
        change[path] = float((port.stored(state.params, path).detach().float()
                              - x0.float()).norm())
        del x0
    del w0
    first_losses = [float(x) for x in first_losses]
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.time() - setup_t0

    losses = []
    n = 0
    with trace.profiled(trace_on) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            t0 = time.perf_counter()
            while True:
                with torch.profiler.record_function("pkbench.step"):
                    state, m = step(state, data.batch(3 + n))
                losses.append(m["loss"])
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    window_losses = torch.stack([x.float() for x in losses]).cpu()
    summary = (trace.summarize(prof, spans=("pkbench.optimizer",))
               if trace_on else None)
    del state, step, m, losses, prof
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": first_losses,
               "grad_norms": {names[p]: v for p, v in grad_norms.items()},
               "change_norms": {names[p]: v for p, v in change.items()}}
    reference = reference_steps(cell, config, mix, seed, device)
    compared = checks.train_numbers(program, reference)
    compared["nonfinite_window_losses"] = float(
        (~torch.isfinite(window_losses)).sum())
    tokens_per_step = mix["batch"] * mix["seq"]
    return {
        "mode": "train", "setup_s": setup_s, "window_s": window_s,
        "steps": n, "tokens": n * tokens_per_step,
        "tokens_per_step": tokens_per_step, "memory_peak_bytes": peak,
        "attempted": n,
        "failed": int((~torch.isfinite(window_losses)).sum()),
        "trace": summary, "compared": compared,
        "program": program, "reference": reference}


def reference_steps(cell: dict, config: dict, mix: dict, seed: int, device,
                    prec: str = "f32", batch_rows=None) -> dict:
    """The reference's steps 0-2 on the cell's weights and batches: each
    step's trained total, each weight's gradient norm as step 0's update
    used it, each weight's change after step 2. ``batch_rows`` keeps only
    the first rows of every batch (a fault of the control run)."""
    import torch
    from pkbench.reference import adamw
    from pkbench.traffic import lm_batches

    ref = importlib.import_module(f"pkbench.reference.{config['family']}")
    dm = ref.dims(config)
    p = W.as_f32(W.make(ref.param_specs(dm), seed, dm["d"], device))
    for v in p.values():
        v.requires_grad_(True)
    o = cell["optimizer"]
    opt = adamw.AdamW(o["lr"], o["b1"], o["b2"], o["eps"],
                      o["weight_decay"], o["clip_norm"])
    data = lm_batches.Batches(mix, dm["vocab"], seed, device)
    nm = cell["run"].get("microbatches", 1)
    groups = cell["mesh"][0] if cell.get("mesh") else 1
    losses, grad_norms = [], {}
    for i in range(3):
        batch = data.batch(i)
        if batch_rows is not None:
            batch = {k: v[:batch_rows] for k, v in batch.items()}
        total = 0.0
        for mb in zip(*(batch[k].chunk(nm, 0) for k in ("tokens",
                                                        "targets"))):
            lo = ref.loss(p, {"tokens": mb[0], "targets": mb[1]}, dm,
                          groups=groups, prec=prec) / nm
            lo.backward()
            total += float(lo)
        grads = {k: v.grad for k, v in p.items()}
        used = opt.update(p, grads)
        if i == 0:
            grad_norms = used
        for v in p.values():
            v.grad = None
        losses.append(total)
    w0 = W.make(ref.param_specs(dm), seed, dm["d"], device)
    change = {k: float((p[k].detach() - w0[k].float()).norm()) for k in p}
    del p, w0, opt
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
