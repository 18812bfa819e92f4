"""Render the dry-run and roofline tables from the dry-run's JSON files —
the twin of ``repro/roofline/report.py``::

    python -m repro_torch.roofline.report [--dir results/dryrun_torch]

prints markdown. Every term is modelled from ``H100_SXM``'s published
peaks (``roofline/model.py``), not measured. The port's files say
``"producer": "repro_torch"``; a file without it is JAX's, whose
``parser_version < 2`` collective bytes ``recompute`` halves as JAX's
report does (the port records the wire's own dtype and is never halved).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

CELL_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
PRODUCER = "repro_torch"


def load(dirpath: str):
    """The rows of ``arch__cell__mesh.json`` files (no experiment tags)."""
    rows = []
    for fn in sorted(Path(dirpath).glob("*.json")):
        parts = fn.stem.split("__")
        if len(parts) != 3 or parts[2] not in ("16x16", "2x16x16"):
            continue
        rows.append(json.loads(fn.read_text()))
    rows.sort(key=lambda r: (r["arch"], CELL_ORDER.index(r["cell"]),
                             r["mesh"]))
    return rows


def dryrun_table(rows, hw=None) -> str:
    out = ["| arch | cell | mesh | count s | args GB/dev | temp GB/dev | "
           "flops/dev | HBM bytes/dev | link bytes/dev | collective mix |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        m = r["memory"]
        rf = recompute(r, hw=hw)
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} "
            f"| {r['t_lower_s']} | {m['argument_bytes']/1e9:.2f} "
            f"| {m['temp_bytes']/1e9:.2f} | {r['cost']['flops']:.2e} "
            f"| {r['cost']['bytes_accessed']:.2e} "
            f"| {rf.coll_bytes:.2e} "
            f"| {rf.coll_detail[:90]} |")
    return "\n".join(out)


def recompute(r, ici_links: int = 1, hw=None):
    """Rebuild the roofline terms from the stored fields (one source of
    truth: ``roofline/model.py``) on ``hw`` (default ``H100_SXM``). A JAX
    file of ``parser_version < 2`` counted bf16 reductions at XLA:CPU's
    promoted f32 width, and its AR/RS bytes are halved, as JAX's report
    does; the port's never are."""
    from repro_torch.roofline.hlo import CollectiveStats
    from repro_torch.roofline.model import build
    kinds = {k: [v["bytes"], v["ops"]] for k, v in r["collectives"].items()}
    if r.get("producer") != PRODUCER and r.get("parser_version", 1) < 2:
        for k in ("all-reduce", "reduce-scatter"):
            if k in kinds:
                kinds[k][0] *= 0.5
    coll = CollectiveStats(
        by_kind={k: tuple(v) for k, v in kinds.items()},
        total_bytes=sum(v[0] for v in kinds.values()),
        op_count=sum(v[1] for v in kinds.values()))
    n_chips = 512 if r["mesh"] == "2x16x16" else 256
    mf = r["roofline"]["model_flops_per_device"] * n_chips
    kw = {} if hw is None else {"hw": hw}
    return build(r["arch"], r["cell"], r["mesh"], flops=r["cost"]["flops"],
                 hbm_bytes=r["cost"]["bytes_accessed"], coll=coll,
                 model_flops_total=mf, n_chips=n_chips, ici_links=ici_links,
                 args_bytes=r["memory"]["argument_bytes"], **kw)


def roofline_table(rows, hw=None) -> str:
    out = ["| arch | cell | mesh | T_comp ms | T_mem ms | T_coll ms | "
           "bottleneck | 6ND/counted | roofline frac | what would move the "
           "dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = recompute(r, hw=hw)
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} "
            f"| {rf.t_compute*1e3:.2f} | {rf.t_memory*1e3:.2f} "
            f"| {rf.t_collective*1e3:.2f} | {rf.bottleneck} "
            f"| {rf.useful_ratio:.2f} | {rf.roofline_fraction:.3f} "
            f"| {suggestion(r)} |")
    return "\n".join(out)


def suggestion(r) -> str:
    b = r["roofline"]["bottleneck"]
    kind = max(r["collectives"].items(),
               key=lambda kv: kv[1]["bytes"])[0] if r["collectives"] else "-"
    if b == "collective":
        return (f"dominant {kind}: overlap deeper / reduce payload "
                f"(bf16 reduce, chunked ring)")
    if b == "memory":
        return ("fuse producers into consumers; fewer f32 intermediates; "
                "remat policy")
    return "larger per-step tiles; reduce remat recompute"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--section", default="both",
                    choices=["dryrun", "roofline", "both"])
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.section in ("dryrun", "both"):
        print("### Dry-run table (counted on meta; terms modelled from "
              "H100_SXM's published peaks)\n")
        print(dryrun_table(rows))
        print()
    if args.section in ("roofline", "both"):
        print("### Roofline table (modelled, not measured)\n")
        print(roofline_table(rows))


if __name__ == "__main__":
    main()
