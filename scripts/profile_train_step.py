#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_train_step.py [--out FILE] [--steps N]
                                          [--seq-sharded]
                                          [--sp-attention ring|ulysses]
                                          [--arch NAME --layers N]

Builds the training run of ``chip_smoke.py`` — tinyllama-1.1b at full width
and depth on a (2, 4) virtual mesh (data x model) with FSDP, every
collective on the hand-written kernels (``comm_backend="fused"``), batch 8
x seq 512 in 2 microbatches, random weights from seed 0, AdamW — runs two
steps to warm up, then ``--steps`` more under ``torch.profiler`` with each
step in its own ``record_function`` range and the optimizer update in a
range of its own. With ``--seq-sharded`` it profiles chip_smoke's
sequence-parallel run instead: ``forward_train(seq_sharded=True)`` and its
backward (no optimizer) on (1, 4), batch 1 x seq 8192, ring attention over
the fused p2p shift (``--sp-attention ulysses``: Ulysses, as chip_smoke's
phase 5f runs it, ``ulysses_chunks=2`` on the all-to-all kernel), the
backward in a range of its own (reported as ``backward_*`` in place of
``optimizer_*``). ``--arch`` with ``--layers`` profiles another
architecture's FSDP run at full width cut to that depth, as chip_smoke's
MoE and SSM training phases run them (``--arch moonshot-v1-16b-a3b
--layers 4``: phase 5k, the attention out-projection on the GEMM+AR
island; ``--arch falcon-mamba-7b --layers 16``: phase 5l). It prints one
JSON object
with the median over the profiled steps of:

- ``wall_ms``: the step's host wall time (the profiler's CPU range), beside
  ``wall_ms_unprofiled`` (the warm-up steps, without the profiler);
- ``device_busy_ms``: the union of the device activities in that range, and
  ``device_idle_share`` = 1 - busy / wall;
- ``device_ops``: the number of device activities; ``device_copy_ops``
  and ``device_copy_ms``: those whose name says copy (``.contiguous()``,
  ``torch.cat``, memcpy) and their device time, ``copy_ops_by_name`` the
  same by kernel name (its first 160 characters); ``optimizer_wall_ms``
  and ``optimizer_device_ms`` for the update alone;

and the mean device time per step by group (the port's ``pk_*`` kernels,
vendor GEMMs, copies and memsets, everything else) and the device ops that
take the most time. Exits 1 if the profiler recorded no device activity.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_serving_step import TOP, busy_us, group_of  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    ap.add_argument("--steps", type=int, default=2,
                    help="profiled steps after the two warm-up steps")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    ap.add_argument("--seq-sharded", action="store_true",
                    help="profile the sequence-parallel forward and "
                         "backward of chip_smoke's sp-train")
    ap.add_argument("--sp-attention", choices=("ring", "ulysses"),
                    default="ring",
                    help="with --seq-sharded: ring (phase 5c) or Ulysses "
                         "attention (phase 5f)")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="the architecture of the FSDP run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the architecture to this many layers")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu rehearses the script and exits "
                         "1, with no device activity to read")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.compat import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import TrainState, make_train_step

    class RangedAdamW(AdamW):
        def update(self, grads, state, params):
            with record_function("optimizer"):
                return super().update(grads, state, params)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.seq_sharded:
        batch, seq, mesh, sub = 1, 64 if args.reduced else 8192, (1, 4), \
            "backward"
        run = RunConfig(fsdp=False, comm_backend="fused",
                        sp_attention=args.sp_attention, ulysses_chunks=2)
        config = (f"{cfg.name} mesh (1, 4) seq_sharded {args.sp_attention} "
                  f"attention, fused, batch {batch} x seq {seq}, remat, no "
                  "optimizer")
    else:
        batch, seq, mesh, sub = 8, 512, (2, 4), "optimizer"
        run = RunConfig(fsdp=True, microbatches=2, comm_backend="fused",
                        pk_attn_out_island=cfg.is_moe)
        config = (f"{cfg.name} {cfg.n_layers} layers mesh (2, 4) FSDP "
                  f"fused, batch {batch} x seq {seq}, 2 microbatches")
    rules = ShardingRules(VirtualMesh(mesh, ("data", "model"), dev), run)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch), device=dev)
    if args.seq_sharded:
        leaves = [p for _, p in T.leaves(params)]
        for p in leaves:
            p.requires_grad_(True)

        def step(state, bt):
            loss, _ = T.forward_train(params, bt, cfg, run, rules,
                                      seq_sharded=True)
            with record_function("backward"):
                torch.autograd.grad(loss, leaves)
            return state, {"loss": loss.detach()}

        state = None
    else:
        opt = RangedAdamW(lr=warmup_cosine(3e-3, 10, 100),
                          weight_decay=0.01)
        state = TrainState(params, opt.init(params))
        step = make_train_step(cfg, run, rules, opt)

    unprofiled = []
    for i in range(2):
        t0 = time.perf_counter()
        state, m = step(state, data.batch(i))
        float(m["loss"])
        unprofiled.append(time.perf_counter() - t0)
    labels = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            label = f"train_step_{i}"
            with record_function(label):
                state, m = step(state, data.batch(2 + i))
                float(m["loss"])
            labels.append(label)

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in cpu
              if e.name.startswith("train_step_")}
    opt_ranges = sorted((e.time_range.start, e.time_range.end) for e in cpu
                        if e.name == sub)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(("train_step_", sub))]
    if not device:
        print("profile_train_step: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1

    steps = []
    for label in labels:
        lo, hi = ranges[label]
        inside = [e for e in device
                  if e.time_range.start >= lo and e.time_range.end <= hi]
        o_lo, o_hi = next((a, b) for a, b in opt_ranges if lo <= a <= hi)
        in_opt = [e for e in inside if e.time_range.start >= o_lo]
        groups: dict[str, float] = {}
        names: dict[str, list] = {}
        for e in inside:
            dt = e.time_range.end - e.time_range.start
            groups[group_of(e.name)] = groups.get(group_of(e.name), 0.0) + dt
            n = names.setdefault(e.name[:160], [0.0, 0])
            n[0] += dt
            n[1] += 1
        copies = [e for e in inside if "copy" in e.name.lower()]
        steps.append({
            "wall_us": hi - lo, "ops": len(inside), "groups": groups,
            "copy_ops": len(copies),
            "copy_us": sum(e.time_range.end - e.time_range.start
                           for e in copies),
            "names": names,
            "busy_us": busy_us((e.time_range.start, e.time_range.end)
                               for e in inside),
            "opt_wall_us": o_hi - o_lo,
            "opt_busy_us": busy_us((e.time_range.start, e.time_range.end)
                                   for e in in_opt)})

    def med(key):
        return statistics.median(s[key] for s in steps) / 1e3

    by_name: dict[str, list] = {}
    for st in steps:
        for n, (us, cnt) in st["names"].items():
            acc = by_name.setdefault(n, [0.0, 0])
            acc[0] += us
            acc[1] += cnt
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    groups = sorted({g for s in steps for g in s["groups"]})
    line = {
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
        else str(dev),
        "config": config,
        "steps": len(steps),
        "wall_ms": med("wall_us"),
        "wall_ms_unprofiled": [t * 1e3 for t in unprofiled],
        "device_busy_ms": med("busy_us"),
        "device_idle_share": 1.0 - med("busy_us") / med("wall_us"),
        "device_ops": statistics.median(s["ops"] for s in steps),
        "device_copy_ops": statistics.median(s["copy_ops"] for s in steps),
        "device_copy_ms": med("copy_us"),
        "copy_ops_by_name": {
            n: {"calls_per_step": cnt / len(steps),
                "ms_per_step": us / len(steps) / 1e3}
            for n, (us, cnt) in sorted(by_name.items())
            if "copy" in n.lower()},
        f"{sub}_wall_ms": med("opt_wall_us"),
        f"{sub}_device_ms": med("opt_busy_us"),
        "device_ms_per_step_by_group": {
            g: sum(s["groups"].get(g, 0.0) for s in steps) / len(steps)
            / 1e3 for g in groups},
        "top_device_ops": [
            {"name": n[:80], "group": group_of(n),
             "ms_per_step": us / len(steps) / 1e3,
             "calls_per_step": cnt / len(steps)}
            for n, (us, cnt) in top]}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
