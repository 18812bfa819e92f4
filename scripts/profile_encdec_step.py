#!/usr/bin/env python3
"""Where the encoder-decoder's serving time goes in the PyTorch/CUDA port,
on one GPU.

    python3 scripts/profile_encdec_step.py [--out FILE]

Runs ``chip_smoke.py``'s phase 5h: whisper-medium at full width and depth
on 4 virtual ranks, ``comm_backend="fused"`` with the attention
out-projection island, random weights from seed 0, 8 rows of 1500 frames:
``encode_cross`` (the encoder and every decoder layer's cross K/V into the
cache), then one-token steps of ``decode_step_encdec`` over a self cache
of 448. A warm-up pass (one encoder pass, 4 steps) times both without the
profiler; then one encoder pass and 8 decode steps run under
``torch.profiler``, each in its own ``record_function`` range. For the
``encode`` and ``decode`` kinds it prints one JSON object each, as
``scripts/profile_serving_step.py`` does (``summarize``): host wall ms,
device busy ms and idle share, device ops, device ms by group (the port's
kernels, library GEMMs, copies and memsets, everything else) and the
device ops that take the most time. ``--reduced --device cpu`` rehearses
the script and exits 1 (no device activity).
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from profile_serving_step import summarize  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the JSON objects to this file")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a rehearsal of the script)")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu rehearses the script and exits "
                         "1, with no device activity to read")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.compat import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train.step import make_serve_step

    dev = resolve_device(args.device)
    cfg = get_config("whisper-medium")
    batch, frames, s_max = 8, 1500, 448
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        batch, frames, s_max = 2, 24, 16
    run = RunConfig(fsdp=False, comm_backend="fused", pk_attn_out_island=True)
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), dev), run)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    enc = torch.randn((batch, frames, cfg.d_model), generator=gen,
                      device=dev).to(params["embed"].dtype)
    tmpl = T.cache_template(cfg, run, rules, batch=batch, s_max=s_max,
                            enc_len=frames)
    step = make_serve_step(cfg, run, rules)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def encode():
        return T.encode_cross(params, T.zeros(tmpl, rules, dev), enc, cfg,
                              run, rules)

    with torch.no_grad():
        times: dict[str, list[float]] = {"encode": [], "decode": []}
        for _ in range(2):          # the first pass imports and plans
            t0 = time.perf_counter()
            cache = encode()
            sync()
            times["encode"].append(time.perf_counter() - t0)
        for _ in range(4):
            t0 = time.perf_counter()
            _, cache = step(params, cache, tok)
            sync()
            times["decode"].append(time.perf_counter() - t0)
        unprofiled = {"encode": times["encode"][-1],
                      "decode": statistics.median(times["decode"])}
        labels = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for kind in ["encode"] + ["decode"] * 8:
                label = f"engine_step_{len(labels)}"
                with record_function(label):
                    if kind == "encode":
                        cache = encode()
                    else:
                        _, cache = step(params, cache, tok)
                    sync()
                labels.append((label, kind))

    lines = summarize(prof.events(), labels, unprofiled)
    if lines is None:
        print("profile_encdec_step: the profiler recorded no device "
              "activity", file=sys.stderr)
        return 1
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
