"""CLI of the port's empirical autotuner (``repro_torch.core.autotune``).

    python -m repro_torch.autotune calibrate [--devices N] [--device D]
                                             [--grid tiny|small|full]
                                             [--out PATH] [--notes TEXT]
                                             [--reps R] [--hw NAME]
                                             [--dtype bf16|int8|both]
                                             [--per-island --arch A ...]
    python -m repro_torch.autotune show [PATH]
    python -m repro_torch.autotune diff A [B]
    python -m repro_torch.autotune check [PATH] [--max-age-days D]
                                         [--drift F] [--no-probe] [--reps R]

``calibrate`` micro-benchmarks every comm backend on a mesh of ``--devices``
virtual ranks on ``--device`` (the GPU unless told otherwise) and saves the
fitted table (default: the user cache ``CommContext(policy="measured")``
searches, ``~/.cache/repro/autotune-torch-<hw>-<torch>.json``). ``show``
prints a table (the resolved one when no path is given). ``diff`` compares
two tables — or, with one argument, a table against the analytic constants
it corrects. ``check`` audits a table for staleness: its age, and a spot
re-probe of launch overhead and GEMM efficiency on the kind of device the
table was measured on; exit 1 when the table looks stale.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.core import autotune, costmodel


def _pct(new: float, old: float) -> str:
    if old == 0:
        return "n/a"
    return f"{(new - old) / old * 100.0:+.1f}%"


def _fmt_corrections(corr: dict, base) -> list[str]:
    analytic = {
        "ici_bandwidth": base.ici_bandwidth,
        "remote_sync_s": base.remote_sync_s,
        "gemm_efficiency": base.gemm_efficiency,
        "kernel_launch_s": base.kernel_launch_s,
    }
    lines = [f"  {'field':<18} {'measured':>12} {'analytic':>12} {'drift':>9}"]
    for k, v in sorted(corr.items()):
        a = analytic.get(k)
        lines.append(f"  {k:<18} {v:>12.4g} "
                     f"{a if a is None else format(a, '>12.4g')} "
                     f"{_pct(v, a) if a is not None else '':>9}")
    return lines


def _base_spec(table):
    return getattr(costmodel, table.fingerprint.hw.upper(),
                   costmodel.H100_SXM)


def _show(table, base) -> None:
    fp = table.fingerprint
    print(f"schema v{table.version}  created {table.created or '?'}  "
          f"notes: {table.notes or '-'}")
    print(f"fingerprint: hw={fp.hw} torch={fp.torch_version} "
          f"backend={fp.backend} kind={fp.device_kind!r} "
          f"devices={fp.n_devices}")
    print("corrections:")
    print("\n".join(_fmt_corrections(table.corrections, base)))
    cov = table.ops_covered()
    print(f"measurements: {len(table.measurements)} rows over "
          f"{len(cov)} ops "
          f"({', '.join(f'{k}:{v}' for k, v in sorted(cov.items()))})")
    for row in table.measurements:
        extra = ""
        if row.get("n_chunks", 1) not in (None, 1):
            extra += f" chunks={row['n_chunks']}"
        if row.get("island"):
            extra += f" island={row['island']}"
        print(f"  {row['op']}/{row['backend']}"
              f"  axis={row['axis_size']} m={row['m']} n={row['n']} "
              f"k={row['k']}  {row['us']:.1f} us{extra}")


def _island_sweeps(args):
    """IslandSweep specs for ``calibrate --per-island``: the model's island
    inventory on a (1, devices) mesh, every active GEMM-collective and a2a
    island's declared coordinates."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import island_comm_sweeps
    from repro_torch.models.sharding import ShardingRules

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_mesh((1, args.devices), ("data", "model"), args.device)
    # every GEMM island enabled so each gets measured rows; a run keeping
    # attn_out dense never queries its key. --sp-attention ulysses adds the
    # a2a re-sharding island; --phase sweeps one serving bucket's inventory
    run = RunConfig(dp_axes=("data",), fsdp=False, pk_attn_out_island=True,
                    sp_attention=args.sp_attention)
    rules = ShardingRules(mesh, run)
    sweeps = island_comm_sweeps(cfg, run, rules, batch=args.batch,
                                seq=args.seq, phase=args.phase)
    if not sweeps:
        print("warning: --per-island found no active comm islands "
              f"for {cfg.name} on this mesh", file=sys.stderr)
    return sweeps


def int8_island_sweeps(islands):
    """The GEMM island sweeps again at the int8 wire width (``--dtype
    both``/``int8``): the same (m, n, k), rows under the island's ``…|b1``
    key, so per-island measured dispatch resolves under
    ``comm_wire="int8"``. The b1 sweep excludes the fused backend."""
    return [
        dataclasses.replace(
            sw, island=sw.island.rsplit("|", 1)[0] + "|b1", dtype_bytes=1)
        for sw in islands
        if sw.op in autotune.GEMM_OPS and sw.dtype_bytes != 1]


def cmd_calibrate(args) -> int:
    from repro_torch.compat import resolve_device
    from repro_torch.launch.mesh import make_mesh

    args.device = resolve_device(args.device)
    hw = getattr(costmodel, args.hw.upper())
    dtypes = {"bf16": (2,), "int8": (1,), "both": (2, 1)}[args.dtype]
    islands = list(_island_sweeps(args)) if args.per_island else []
    if 1 in dtypes and islands:
        islands += int8_island_sweeps(islands)
    mesh = make_mesh((args.devices,), ("x",), args.device)
    table = autotune.calibrate(mesh, grid=args.grid, reps=args.reps, hw=hw,
                               notes=args.notes, verbose=True,
                               islands=islands, dtypes=dtypes)
    out = args.out or autotune.cache_path(table.fingerprint)
    path = table.save(out)
    autotune.clear_caches()
    print(f"\nwrote {path}")
    print("CommContext(policy='measured') will now dispatch from it on "
          "this device.")
    if islands:
        keys = sorted({r["island"] for r in table.measurements
                       if r.get("island")})
        print(f"island-keyed rows: {', '.join(keys) or 'none measured'}")
    return 0


def cmd_show(args) -> int:
    if args.path:
        table = autotune.CalibrationTable.load(args.path)
    else:
        table = autotune.find_table(costmodel.H100_SXM.name)
        if table is None:
            live = autotune.live_fingerprint(costmodel.H100_SXM.name)
            print("no calibration table found (searched "
                  f"{autotune.cache_path(live)} and the in-repo seeds); run "
                  "`python -m repro_torch.autotune calibrate`",
                  file=sys.stderr)
            return 1
    _show(table, _base_spec(table))
    return 0


def cmd_diff(args) -> int:
    a = autotune.CalibrationTable.load(args.a)
    base = _base_spec(a)
    if args.b is None:
        # one-sided: measured vs the analytic spec it corrects
        print(f"{args.a} vs analytic {base.name}:")
        print("\n".join(_fmt_corrections(a.corrections, base)))
        return 0
    b = autotune.CalibrationTable.load(args.b)
    if not a.fingerprint.compatible(b.fingerprint):
        print(f"fingerprints are incompatible:\n  A: {a.fingerprint}\n"
              f"  B: {b.fingerprint}", file=sys.stderr)
        return 1
    print(f"{'field':<18} {'A':>12} {'B':>12} {'B vs A':>9}")
    for k in sorted(set(a.corrections) | set(b.corrections)):
        va, vb = a.corrections.get(k), b.corrections.get(k)
        if va is None or vb is None:
            print(f"{k:<18} {'—' if va is None else format(va, '.4g'):>12} "
                  f"{'—' if vb is None else format(vb, '.4g'):>12}")
            continue
        print(f"{k:<18} {va:>12.4g} {vb:>12.4g} {_pct(vb, va):>9}")
    shared = 0
    drifts = []
    for row in a.measurements:
        us_b = b.measured_us(row["op"], row["backend"], row["m"], row["n"],
                             row["k"], axis_size=row["axis_size"],
                             max_ratio=1.01)
        if us_b is None:
            continue
        shared += 1
        drifts.append(abs(us_b - row["us"]) / max(row["us"], 1e-9))
    if shared:
        print(f"measurements: {shared} shared grid points, median drift "
              f"{sorted(drifts)[len(drifts) // 2] * 100:.1f}%")
    return 0


def cmd_check(args) -> int:
    if args.path:
        table = autotune.CalibrationTable.load(args.path)
        where = args.path
    else:
        table = autotune.find_table(costmodel.H100_SXM.name)
        if table is None:
            print("no calibration table found to check; run "
                  "`python -m repro_torch.autotune calibrate`",
                  file=sys.stderr)
            return 1
        where = "resolved table"
    age = autotune.table_age_days(table)
    print(f"checking {where}: created {table.created or '?'}"
          f"{f' ({age:.1f} days ago)' if age is not None else ''}")
    msgs = autotune.staleness(table, max_age_days=args.max_age_days,
                              drift_threshold=args.drift,
                              probe=not args.no_probe, reps=args.reps)
    if not msgs:
        print("table looks fresh (age and spot-probe drift within "
              "thresholds)" if not args.no_probe
              else "table age within threshold (spot probe skipped)")
        return 0
    for m in msgs:
        print(f"STALE: {m}", file=sys.stderr)
    print("re-run `python -m repro_torch.autotune calibrate` to refresh",
          file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autotune",
        description="measure, inspect and compare comm calibration tables")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("calibrate", help="micro-benchmark this device")
    p.add_argument("--devices", type=int, default=4,
                   help="virtual ranks of the calibration mesh")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU, which must exist)")
    p.add_argument("--grid", default="small", choices=sorted(autotune.GRIDS))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--hw", default="h100_sxm",
                   help="HardwareSpec constant to correct (h100_sxm/tpu_v5e)")
    p.add_argument("--out", default=None,
                   help="destination (default: the user cache path)")
    p.add_argument("--notes", default="")
    p.add_argument("--dtype", default="bf16",
                   choices=["bf16", "int8", "both"],
                   help="wire-width axis: bf16 sweeps full precision (b2 "
                        "rows); int8 sweeps the quantized ring wire (b1 "
                        "rows: rings run wire='int8', the bulk baseline "
                        "unquantized under the same b1 key); both runs the "
                        "grid twice")
    p.add_argument("--per-island", action="store_true",
                   help="also sweep backend x chunk count at every active "
                        "GEMM-collective and a2a island's declared "
                        "coordinates (rings x {1,2,4}; on the card also the "
                        "fused kernels x {1,2,4,8}), tagging rows with the "
                        "island key")
    p.add_argument("--arch", default="tinyllama-1.1b",
                   help="model whose islands --per-island sweeps")
    p.add_argument("--reduced", action="store_true",
                   help="use the smoke-scale config for --per-island")
    p.add_argument("--batch", type=int, default=8,
                   help="--per-island global batch")
    p.add_argument("--seq", type=int, default=128,
                   help="--per-island sequence length")
    p.add_argument("--sp-attention", default="ring",
                   choices=["ring", "ulysses", "none"],
                   help="--per-island: attention SP mode (ulysses adds the "
                        "a2a re-sharding island to the sweep)")
    p.add_argument("--phase", default="all",
                   choices=["all", "prefill", "decode"],
                   help="--per-island: sweep one serving bucket's island "
                        "inventory (prefill: full-seq shapes at --seq; "
                        "decode: one-token shapes)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("show", help="print a table (default: the resolved one)")
    p.add_argument("path", nargs="?", default=None)
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("diff", help="compare two tables (or one vs analytic)")
    p.add_argument("a")
    p.add_argument("b", nargs="?", default=None)
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("check",
                       help="audit a table for staleness (age + spot probe)")
    p.add_argument("path", nargs="?", default=None)
    p.add_argument("--max-age-days", type=float, default=30.0,
                   help="warn when 'created' is older than this (default 30)")
    p.add_argument("--drift", type=float, default=0.5,
                   help="relative drift vs the spot probe that counts as "
                        "stale (default 0.5)")
    p.add_argument("--no-probe", action="store_true",
                   help="age check only; skip the micro-benchmark probe")
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
