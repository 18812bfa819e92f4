"""The multi-pod dry-run of the port — the twin of ``repro/launch/dryrun.py``.

JAX lowers and compiles every (architecture × shape cell) on its 16 x 16
and 2 x 16 x 16 production meshes and reads ``cost_analysis`` and
``memory_analysis``. The port has no compiler to ask. Here "lowering" a
cell is running the port's own step — the train step (AdamW in the moment
dtype), ``forward_prefill`` or ``decode_step`` (``long_ctx`` for
long_500k) — on the production mesh (``launch/mesh.py``) built on the
``meta`` device, on tensors from ``launch/specs.py``, under one
``roofline.counters.StepCounter``:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas for aten ops, and
  by each hand-written kernel's own formula at its entry;
* **bytes**: each op's inputs read once and outputs written once;
* **collective bytes** from the comm trace ``CommContext`` records,
  priced by ``roofline/hlo.py``;
* **launches** of every kernel: the wrappers' meta branches record on the
  counter what the card would launch;
* **argument bytes a device** from the specs (each leaf's bytes over the
  mesh axes its spec shards it over);
* **temp bytes a device**: the peak of the live meta storages the step
  creates, over the mesh size — an estimate, not an allocator's reading.

A step's counts are the whole mesh's (every virtual rank runs on the one
``meta`` device); a device's are those over the mesh size. Nothing is
allocated and no card is needed: the dry-run is abstract by nature, as
JAX's is, and not a CPU fallback. JAX extrapolates from 1 and 2 layer
periods because XLA counts a scan body once; the port walks every layer,
so its count at full depth is exact, and ``calibrate`` is kept as a check:
the extrapolation from 1 and 2 periods must equal the full count. The
command line (:func:`cli`, not :func:`main`) first moves the process's meta
ops to ATen's C++ meta kernels (``counters.use_native_meta_kernels``):
the same counts, ~10x faster.

    python -m repro_torch.launch.dryrun --arch all --cell all --mesh both
    python -m repro_torch.roofline.report --dir results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config
from repro_torch.configs.base import RunConfig, ServeConfig
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import island_plans
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.roofline import counters
from repro_torch.roofline import hlo as HLO
from repro_torch.roofline import model as RM
from repro_torch.roofline.report import PRODUCER
from repro_torch.train.step import (TrainState, make_prefill_step,
                                    make_serve_step, make_train_step)


def run_config_for(cfg, *, multi_pod: bool, pk_overlap: bool = True,
                   microbatches: int | None = None,
                   serving: bool = False) -> RunConfig:
    """JAX's run of a cell: serving keeps the weights resident (tp only)
    when they fit half of 16 chips' HBM; microbatches cap at the per-dp
    batch; bf16 moments past 100 B parameters; the multi-pod mesh's dp
    axes are ("pod", "data")."""
    big = cfg.param_count() > 100e9
    fits_tp_only = cfg.param_count() * 2 <= 0.5 * 16e9 * 16
    dp_size = 32 if multi_pod else 16
    mb_cap = max(1, 256 // dp_size)
    mb = microbatches if microbatches is not None else (16 if big else 8)
    return RunConfig(
        dp_axes=("pod", "data") if multi_pod else ("data",),
        fsdp=not (serving and fits_tp_only),
        pk_overlap=pk_overlap,
        microbatches=min(mb, mb_cap),
        optimizer_moment_dtype="bfloat16" if big else "float32",
    )


def build_step(cfg, cell, run: RunConfig, rules: ShardingRules,
               device="meta"):
    """(step, args, arg specs): ``step(*args)`` runs the cell's step once
    on tensors laid out from the specs on ``device``."""
    if cell.kind == "train":
        moment_dtype = (torch.bfloat16 if run.optimizer_moment_dtype
                        == "bfloat16" else torch.float32)
        sspec, _ = SP.train_state_specs(cfg, run, rules, moment_dtype)
        bspec, _ = SP.batch_specs(cfg, cell, rules)
        state = TrainState(
            SP.materialize(sspec.params, rules, device),
            AdamWState(0, SP.materialize(sspec.opt.m, rules, device),
                       SP.materialize(sspec.opt.v, rules, device)))
        step = make_train_step(cfg, run, rules,
                               AdamW(moment_dtype=moment_dtype))
        return step, (state, SP.materialize(bspec, rules, device)), \
            (sspec, bspec)
    if cell.kind == "prefill":
        sspec, _ = SP.train_state_specs(cfg, run, rules)
        bspec, _ = SP.batch_specs(cfg, cell, rules)
        step = make_prefill_step(cfg, run, rules)
        return step, (SP.materialize(sspec.params, rules, device),
                      SP.materialize(bspec, rules, device)), \
            (sspec.params, bspec)
    (pspec, cspec, tspec), _ = SP.decode_specs(cfg, run, rules, cell)
    step = make_serve_step(cfg, run, rules,
                           long_ctx=cell.name == "long_500k")
    return step, (SP.materialize(pspec, rules, device),
                  SP.materialize(cspec, rules, device),
                  SP.materialize(tspec, rules, device)), \
        (pspec, cspec, tspec)


def _tensors(tree, acc):
    if isinstance(tree, torch.Tensor):
        acc.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, acc)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, acc)
    return acc


@dataclasses.dataclass
class StepCount:
    """What one counted step gives: its FLOPs and bytes (the whole mesh's,
    exact integers), comm trace, launches a kernel (on ``meta`` those the
    wrappers' meta branches recorded on the counter, on the card the
    wrappers' ``.launches`` counts), the peak of its live storages and the
    bytes of its outputs (and of those that alias an argument)."""
    flops: int
    bytes: int
    comms: list
    launches: dict
    peak_bytes: int
    output_bytes: int
    alias_bytes: int
    seconds: float


def count_step(step, args, *, grad: bool, device: str = "meta") -> StepCount:
    """Run ``step(*args)`` once under a ``StepCounter`` of the ops on
    ``device`` (``meta``, or ``cuda`` for the same step on the card);
    serving steps run without autograd, as the engine runs them."""
    before = counters.launch_counts()
    arg_tensors = _tensors(args, [])
    arg_storages = {t.untyped_storage()._cdata for t in arg_tensors}
    t0 = time.time()
    with counters.StepCounter(device).ignore(arg_tensors) as c, \
            torch.set_grad_enabled(grad):
        out = step(*args)
    seconds = time.time() - t0
    after = counters.launch_counts()
    outs = _tensors(out, [])
    alias = [t for t in outs if t.untyped_storage()._cdata in arg_storages]
    return StepCount(
        flops=int(c.flops), bytes=int(c.bytes), comms=list(c.comms),
        launches=(dict(c.launches) if device == "meta" else
                  {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}),
        peak_bytes=c.peak_bytes,
        output_bytes=sum(counters.tensor_bytes(t) for t in outs),
        alias_bytes=sum(counters.tensor_bytes(t) for t in alias),
        seconds=seconds)


def lower_cell(arch: str, cell_name: str, *, multi_pod: bool,
               pk_overlap: bool = True, microbatches: int | None = None,
               calibrate: bool = True, run_overrides: dict | None = None,
               device="meta") -> dict:
    """Count one (arch × cell × mesh) step; returns JAX's result keys (see
    the module docstring), with ``"producer": "repro_torch"`` and the
    kernels' ``launches``. ``calibrate``: count the step at 1 and 2 layer
    periods too and check that extrapolating them to the full depth gives
    the full count exactly (JAX's correction, which the port does not
    need)."""
    cfg = get_config(arch)
    cell = SHAPES[cell_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    run = run_config_for(cfg, multi_pod=multi_pod, pk_overlap=pk_overlap,
                         microbatches=microbatches,
                         serving=cell.kind == "decode")
    if run_overrides:
        run = dataclasses.replace(run, **run_overrides)
    rules = ShardingRules(mesh, run)
    n_chips = mesh.size
    grad = cell.kind == "train"

    t0 = time.time()
    step, args, specs = build_step(cfg, cell, run, rules, device)
    full = count_step(step, args, grad=grad, device=mesh.device.type)
    del step, args
    t_count = time.time() - t0
    coll = HLO.collective_bytes(full.comms, n_chips)

    if calibrate:
        pat = len(cfg.layer_pattern())
        points = []
        for k in (1, 2):
            cfg_k = dataclasses.replace(
                cfg, n_layers=k * pat,
                n_encoder_layers=(k * pat if cfg.encoder_decoder else 0))
            st, a, _ = build_step(cfg_k, cell, run, rules, device)
            points.append(count_step(st, a, grad=grad,
                                     device=mesh.device.type))
            del st, a
        p1, p2 = points
        n_p = cfg.n_periods
        ext_flops = p1.flops + (p2.flops - p1.flops) * (n_p - 1)
        ext_bytes = p1.bytes + (p2.bytes - p1.bytes) * (n_p - 1)
        if (ext_flops, ext_bytes) != (full.flops, full.bytes):
            raise AssertionError(
                f"{arch} × {cell_name}: the count from 1 and 2 periods "
                f"extrapolates to ({ext_flops}, {ext_bytes}), the full step "
                f"counts ({full.flops}, {full.bytes})")
    flops, bytes_acc = full.flops / n_chips, full.bytes / n_chips

    arg_bytes = SP.device_bytes(specs, rules)
    temp = full.peak_bytes / n_chips
    mf = RM.model_flops(cfg, cell)
    roof = RM.build(arch, cell_name, mesh_name, flops=flops,
                    hbm_bytes=bytes_acc, coll=coll, model_flops_total=mf,
                    n_chips=n_chips, args_bytes=arg_bytes)
    result = {
        "arch": arch, "cell": cell_name, "mesh": mesh_name,
        "producer": PRODUCER, "parser_version": 2,
        "kind": cell.kind, "pk_overlap": pk_overlap,
        "microbatches": run.microbatches,
        # the counted step's wall time; nothing is compiled
        "t_lower_s": round(t_count, 1), "t_compile_s": 0.0,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": full.output_bytes / n_chips,
            "temp_bytes": temp,
            "alias_bytes": full.alias_bytes / n_chips,
            "peak_per_device_gb": round((arg_bytes + temp) / 1e9, 3),
        },
        "cost": {"flops": flops, "bytes_accessed": bytes_acc,
                 "raw_flops_uncorrected": flops,
                 "raw_bytes_uncorrected": bytes_acc},
        "collectives": {k: {"bytes": v, "ops": c}
                        for k, (v, c) in coll.by_kind.items()},
        "collective_bytes_total": coll.total_bytes,
        "comm_policy": run.comm_policy,
        "comm_wire": run.comm_wire or "bf16",
        "islands": [p.asdict() for p in island_plans(
            cfg, run, rules, batch=cell.global_batch, seq=cell.seq_len)],
        "roofline": dataclasses.asdict(roof),
        "launches": full.launches,
    }
    if cell.kind == "decode":
        from repro_torch.runtime.serving import serving_plan_record
        edges = tuple(sorted({max(cell.seq_len // 4, 1),
                              max(cell.seq_len // 2, 1), cell.seq_len}))
        serve = ServeConfig(max_batch=cell.global_batch,
                            prefill_batch=min(cell.global_batch, 32),
                            bucket_edges=edges,
                            max_new_tokens=min(cell.seq_len, 128))
        result["serving"] = serving_plan_record(cfg, run, rules, serve)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-pk", action="store_true",
                    help="baseline without PK overlapped collectives")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override key=json (e.g. "
                         "--set save_collectives=true)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cells = cells_for(arch) if args.cell == "all" else [args.cell]
        for cell in cells:
            if cell not in cells_for(arch):
                print(f"SKIP {arch} × {cell} (DESIGN §6 inapplicable)")
                n_skip += 1
                continue
            for multi_pod in meshes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                suffix = ("_nopk" if args.no_pk else "") + args.tag
                fn = outdir / f"{arch}__{cell}__{mesh_name}{suffix}.json"
                if fn.exists() and not args.force:
                    print(f"CACHED {fn.name}")
                    n_ok += 1
                    continue
                print(f"=== {arch} × {cell} × {mesh_name} "
                      f"(pk={not args.no_pk}) ===", flush=True)
                try:
                    res = lower_cell(arch, cell, multi_pod=multi_pod,
                                     pk_overlap=not args.no_pk,
                                     microbatches=args.microbatches,
                                     run_overrides=overrides or None)
                    fn.write_text(json.dumps(res, indent=1))
                    m = res["memory"]
                    r = res["roofline"]
                    print(f"  count {res['t_lower_s']}s | "
                          f"args {m['argument_bytes']/1e9:.1f}GB temp "
                          f"{m['temp_bytes']/1e9:.1f}GB | "
                          f"flops/dev {res['cost']['flops']:.2e} | "
                          f"coll {res['collective_bytes_total']/1e6:.0f}MB | "
                          f"bottleneck {r['bottleneck']} "
                          f"roofline {r['roofline_fraction']:.2f}",
                          flush=True)
                    n_ok += 1
                except Exception:
                    n_fail += 1
                    print(f"  FAILED {arch} × {cell} × {mesh_name}")
                    traceback.print_exc()
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 0 if n_fail == 0 else 1


def cli(argv=None) -> int:
    """``python -m repro_torch.launch.dryrun``: :func:`main` with this
    process's meta ops moved to ATen's C++ meta kernels first, for the rest
    of the process (the same counts, ~10x faster; ``tests/
    test_torch_dryrun.py`` holds the two paths' counts equal)."""
    counters.use_native_meta_kernels()
    return main(argv)


if __name__ == "__main__":
    raise SystemExit(cli())
