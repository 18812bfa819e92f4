"""Serving launcher of the port — a thin CLI over the continuous-batching
engine (``repro_torch.runtime.serving``), the twin of
``repro/launch/serve.py``.

    # static batch, on the GPU
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mesh-shape 1 4 --batch 4 --prompt-len 8 --tokens 16

    # continuous batching over a synthetic trace, on the CPU
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mesh-shape 1 4 --mode continuous --requests 8 --device cpu

    # an SSM model (exact buckets: one bucket per prompt length)
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --reduced \
        --mesh-shape 1 4 --mode continuous --device cpu

    # the paged KV cache with chunked prefill, on a (2, 4) mesh
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mesh-shape 2 4 --mode continuous --cache-layout paged \
        --page-size 4 --prefill-chunk 8 --device cpu

    # an int8 KV cache and int8 ring payloads
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mesh-shape 1 4 --mode continuous --kv-dtype int8 \
        --comm-wire int8 --device cpu

    # backends from the calibration table of this device (one written by
    # `python -m repro_torch.autotune calibrate`, or the shipped seed)
    python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --mesh-shape 1 4 --mode continuous --comm-policy measured

    # a 2-replica fleet with a scripted kill and rejoin
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mode continuous --replicas 2 --router least-loaded \
        --fault-plan "kill:1@4 rejoin:1@8" --ckpt-dir /tmp/fleet \
        --requests 12 --device cpu

    # a corrupted ring hop caught by the island guards, and the monitor
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
        --mesh-shape 1 4 --mode continuous --comm-backend ring \
        --island-guards --health-monitor \
        --comm-fault-plan "corrupt:mlp@1 stall:mlp@5x6" --device cpu

``--replicas N`` (N > 1) serves through a ``runtime.fleet.ServingFleet`` of N
engine replicas behind ``--router``; ``--fault-plan`` scripts replica
faults (``kind:replica[.island]@step[xticks]``: kill, delay, drain, rejoin,
and the comm kinds aimed at one island of a replica) and
``--comm-fault-plan`` one engine's comm faults
(``kind:island@step[xticks]``). A rejoin restores the parameters a drain
saved under ``--ckpt-dir``.

The entry points run on ``cuda`` unless ``device`` names another device;
with no GPU and no device they raise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ServeConfig
from repro_torch.core.pgl import VirtualMesh
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules
from repro_torch.runtime.serving import ServingEngine, render_serving_plans


def build_engine(arch: str, *, reduced: bool = True, mesh_shape=None,
                 mesh_axes=("data", "model"), serve: ServeConfig | None = None,
                 seed: int = 0, comm_chunks: int | None = None,
                 run_overrides: dict | None = None,
                 comm_faults=None, device=None) -> ServingEngine:
    """Config -> parameters -> ServingEngine on one device, the ranks of
    ``mesh_shape`` virtual. Parameters come from a ``torch.Generator``
    seeded with ``seed`` on that device; every tp-sharded weight is laid
    out once as its stacked (R, *local) tensor. With no ``serve`` given,
    SSM and hybrid archs get ``ServeConfig(exact_buckets=True)``.
    ``comm_faults`` is a ``runtime.health.CommFaultPlan`` (or its spec
    string) of scripted comms-level faults."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = VirtualMesh(mesh_shape, mesh_axes, dev) if mesh_shape else None
    kw = dict(dp_axes=tuple(a for a in (mesh_axes or ()) if a != "model")
              or ("data",),
              fsdp=False, decode_seq_shard=mesh is not None,
              comm_chunks=comm_chunks)
    kw.update(run_overrides or {})
    run = RunConfig(**kw)
    rules = ShardingRules(mesh, run) if mesh is not None else None
    tmpl = T.param_template(cfg, run, rules)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(tmpl, gen, cfg.d_model, rules=rules, device=dev)
    if serve is None:
        serve = ServeConfig(exact_buckets=T.has_ssm(cfg))
    return ServingEngine(cfg, run, rules, params, serve,
                         comm_faults=comm_faults, device=dev)


def synthetic_trace(n_requests: int, serve: ServeConfig, vocab: int,
                    seed: int = 0):
    """Deterministic mixed-bucket request trace (the JAX package's): prompt
    lengths drawn over the bucket range, token ids over the vocab."""
    rng = np.random.RandomState(seed)
    lo = 2
    hi = serve.bucket_edges[-1]
    out = []
    for _ in range(n_requests):
        n = int(rng.randint(lo, hi + 1))
        out.append(tuple(int(t) for t in rng.randint(0, vocab, size=n)))
    return out


def generate(arch: str, *, reduced: bool, batch: int, prompt_len: int,
             gen_tokens: int, mesh_shape=None, mesh_axes=("data", "model"),
             seed: int = 0, comm_chunks: int | None = None,
             run_overrides=None, kv_dtype: str = "bf16",
             device=None) -> torch.Tensor:
    """Static-batch generation: ``batch`` synthetic prompts of
    ``prompt_len`` tokens, prefilled as one batch and decoded in lockstep.
    Returns the (batch, gen_tokens) ids and prints tokens/s."""
    serve = ServeConfig(bucket_edges=(max(prompt_len, 2),),
                        max_new_tokens=gen_tokens,
                        max_batch=batch, prefill_batch=min(batch, 8),
                        exact_buckets=True, kv_dtype=kv_dtype)
    eng = build_engine(arch, reduced=reduced, mesh_shape=mesh_shape,
                       mesh_axes=mesh_axes, serve=serve, seed=seed,
                       comm_chunks=comm_chunks, run_overrides=run_overrides,
                       device=device)
    if eng.rules is not None:
        print(f"[plan] comm_policy={eng.base_run.comm_policy}")
        print(render_serving_plans(eng.bucket_plans))
    rng = np.random.RandomState(seed)
    prompts = [tuple(int(t) for t in
                     rng.randint(0, eng.cfg.vocab_size, size=prompt_len))
               for _ in range(batch)]
    t0 = time.perf_counter()
    out = eng.generate_static(prompts, gen_tokens)
    dt = time.perf_counter() - t0
    total = batch * (prompt_len + gen_tokens)
    print(f"[serve] {arch} on {eng.device}: {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, batch={batch})")
    return torch.tensor(out, dtype=torch.int32)


def serve_fleet(args, serve: ServeConfig, overrides: dict) -> None:
    """Continuous mode with ``--replicas > 1``: a ServingFleet over
    identical engine replicas (same arch, serve config and seed:
    data-parallel), with scripted faults, ending in the fleet's and each
    replica's stats."""
    from repro_torch.configs.base import FleetConfig
    from repro_torch.runtime.fleet import FaultPlan, ServingFleet

    def factory(i: int) -> ServingEngine:
        return build_engine(args.arch, reduced=args.reduced,
                            mesh_shape=args.mesh_shape, serve=serve,
                            seed=args.seed, comm_chunks=args.comm_chunks,
                            run_overrides=overrides, device=args.device)

    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    fleet = ServingFleet(
        factory, FleetConfig(n_replicas=args.replicas, router=args.router),
        fault_plan=plan, ckpt_dir=args.ckpt_dir)
    trace = synthetic_trace(args.requests, serve,
                            fleet.replicas[0].engine.cfg.vocab_size,
                            seed=args.seed)
    done = fleet.run(trace)
    st = fleet.stats()
    print(f"[fleet] {args.arch} x{st['replicas']} ({st['router']}): "
          f"{len(done)} requests, {st['useful_tokens']} tokens in "
          f"{st['wall_s']:.2f}s ({st['tokens_per_s']:.1f} tok/s; "
          f"{st['fleet_steps']} fleet steps, {st['assignments']} routed, "
          f"{st['steals']} steals, {st['requeued']} requeued, "
          f"{st['live']}/{st['replicas']} live)")
    for idx, fb in sorted(st["per_replica"].items()):
        if not fb["alive"]:
            print(f"[fleet]   r{idx}: dead")
            continue
        print(f"[fleet]   r{idx}: load={fb['load']} "
              f"queue={fb['queue_depth']} "
              f"tok/s={fb['tokens_per_s']:.1f} "
              f"buckets={fb['compiled_buckets']} "
              f"ema={fb['watchdog_ema']:.3f}"
              + (" (draining)" if fb["draining"] else ""))
    if args.fault_plan:
        kinds = [e[0] for e in fleet.events
                 if e[0] in ("kill", "drain", "rejoin", "delay", "stall",
                             "steal", "snapshot", "comm_fault")]
        print(f"[fleet] fault events fired: {kinds}")


def print_health(eng) -> None:
    """The ``[health]`` report lines of one engine's run."""
    st = eng.stats()
    print(f"[health] quarantined={st['quarantined']} "
          f"retries={st['retries']} guard_trips={st['guard_trips']} "
          f"demotions={st['health_demotions']} "
          f"idle_steps={st['idle_steps']}")
    kinds = [e[0] for e in eng.events
             if e[0] in ("comm_fault", "comm_fault_end", "guard_trip",
                         "retry", "quarantine", "deadline",
                         "health_demote", "health_promote",
                         "health_link_up")]
    print(f"[health] events fired: {kinds}")
    hov = eng.plan_record()["health_overrides"]
    if eng.health is not None and any(o[3] == "health" for o in hov):
        print(f"[health] live overrides: {hov}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8,
                    help="continuous mode: synthetic trace length")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prefill-batch", type=int, default=4)
    ap.add_argument("--bucket-edges", type=int, nargs="*", default=None)
    ap.add_argument("--queue-policy", default="fcfs",
                    choices=["fcfs", "bucket-greedy"])
    ap.add_argument("--cache-layout", default="slab",
                    choices=["slab", "paged"],
                    help="KV cache layout; SSM and hybrid models refuse "
                         "paged (their recurrent state cannot be paged)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged layout: tokens per KV page")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="paged layout: pool pages (0 = slab-equivalent)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged layout: split prefill into page-aligned "
                         "chunks so decode ticks interleave (0 = off)")
    ap.add_argument("--mesh-shape", type=int, nargs="*", default=None)
    ap.add_argument("--comm-policy", default="analytic",
                    choices=["analytic", "measured", "auto"],
                    help="cost source for comm backend dispatch: measured "
                         "reads this device's calibration table "
                         "(python -m repro_torch.autotune calibrate)")
    ap.add_argument("--comm-chunks", type=int, default=None)
    ap.add_argument("--comm-backend", default=None,
                    help="pin every GEMM island's collective backend "
                         "(bulk / ring / fused)")
    ap.add_argument("--comm-wire", default=None,
                    choices=["bf16", "int8", "int8_sr"],
                    help="GEMM-collective ring wire format (int8 ships "
                         "quantized payloads + f32 scales)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="KV-cache storage dtype: int8 quantizes on write "
                         "with per-(token, head) f32 scales")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous mode: >1 runs a ServingFleet of "
                         "data-parallel engine replicas")
    ap.add_argument("--router", default="least-loaded",
                    choices=["fcfs", "least-loaded", "cache-affinity"])
    ap.add_argument("--fault-plan", default=None,
                    help="scripted fleet faults, e.g. 'kill:1@4 rejoin:1@8', "
                         "'delay:0@2x3', or comms-level "
                         "'linkdown:1.mlp@4x3' "
                         "(kind:replica[.island]@step[xticks])")
    ap.add_argument("--comm-fault-plan", default=None,
                    help="single-engine scripted comms faults, e.g. "
                         "'corrupt:mlp@3 stall:mlp@5x6' "
                         "(kind:island@step[xticks])")
    ap.add_argument("--island-guards", action="store_true",
                    help="finite checks on island inputs and outputs, "
                         "counted on the device; trips feed the health "
                         "monitor")
    ap.add_argument("--health-monitor", action="store_true",
                    help="per-island EMA health monitor: demote a drifting "
                         "island's backend with hysteresis, promote it "
                         "after probation")
    ap.add_argument("--ckpt-dir", default=None,
                    help="fleet: snapshot and rejoin checkpoint directory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    overrides = {"comm_wire": args.comm_wire,
                 "comm_policy": args.comm_policy,
                 "island_guards": args.island_guards}
    if args.comm_backend:
        overrides["comm_backend"] = args.comm_backend

    if args.mode == "static":
        generate(args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen_tokens=args.tokens,
                 mesh_shape=args.mesh_shape, comm_chunks=args.comm_chunks,
                 seed=args.seed, run_overrides=overrides,
                 kv_dtype=args.kv_dtype, device=args.device)
        return

    edges = tuple(args.bucket_edges) if args.bucket_edges else (8, 16, 32)
    serve = ServeConfig(max_batch=args.max_batch,
                        prefill_batch=args.prefill_batch,
                        bucket_edges=edges, max_new_tokens=args.tokens,
                        queue_policy=args.queue_policy,
                        exact_buckets=T.has_ssm(get_config(args.arch)),
                        cache_layout=args.cache_layout,
                        page_size=args.page_size, n_pages=args.n_pages,
                        prefill_chunk=args.prefill_chunk,
                        kv_dtype=args.kv_dtype,
                        health_monitor=args.health_monitor)
    if args.replicas > 1:
        serve_fleet(args, serve, overrides)
        return
    eng = build_engine(args.arch, reduced=args.reduced,
                       mesh_shape=args.mesh_shape, serve=serve,
                       seed=args.seed, comm_chunks=args.comm_chunks,
                       run_overrides=overrides,
                       comm_faults=args.comm_fault_plan, device=args.device)
    if eng.rules is not None:
        print(f"[plan] comm_policy={args.comm_policy}")
        print(render_serving_plans(eng.bucket_plans))
    if eng.paged:
        g = eng.geom
        print(f"[cache] paged: page={g.page_size} pool={g.n_pages} pages "
              f"x {g.n_partitions} partitions "
              f"(chunk={serve.prefill_chunk or 'off'})")
    trace = synthetic_trace(args.requests, serve, eng.cfg.vocab_size,
                            seed=args.seed)
    done = eng.run(trace)
    st = eng.stats()
    print(f"[serve] {args.arch} on {eng.device}: {len(done)} requests, "
          f"{st['tokens_generated']} tokens in {st['wall_s']:.2f}s "
          f"({st['tokens_per_s']:.1f} tok/s; "
          f"{st['prefill_steps']} prefill + {st['decode_steps']} decode "
          f"steps; buckets built: {st['compiled_buckets']})")
    cs = st["cache"]
    line = (f"[cache] layout={cs['layout']} kv={cs['kv_dtype']} "
            f"hbm={cs['hbm_bytes']/1e6:.1f}MB "
            f"(slab-equivalent {cs['slab_bytes']/1e6:.1f}MB) "
            f"peak_slots={cs['peak_resident_slots']}")
    if cs["layout"] == "paged":
        line += (f" peak_pages={cs['peak_resident_pages']}/{cs['n_pages']} "
                 f"prefix_hits={cs['prefix_hits']} "
                 f"shared_pages={cs['shared_pages_reused']} "
                 f"cow={cs['cow_copies']} "
                 f"blocked={cs['admission_blocked']}")
    print(line)
    if args.comm_fault_plan or args.island_guards or args.health_monitor:
        print_health(eng)


if __name__ == "__main__":
    main()
