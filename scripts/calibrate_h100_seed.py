#!/usr/bin/env python3
"""Measure the port's H100 seed calibration table on the card.

    python3 scripts/calibrate_h100_seed.py \
        --out src/repro_torch/core/calibrations/h100_sxm.json

Runs the autotuner's CLI three times on 4 virtual ranks of the GPU, at the
serving shapes of ``chip_smoke.py``'s phase 4 (tinyllama-1.1b at full width
on (1, 4): prefill groups of 4 at buckets 128 and 512, a decode pool of 8
slots with caches of 544 positions):

    python -m repro_torch.autotune calibrate --grid full --dtype both \
        --per-island --arch tinyllama-1.1b --phase prefill --batch 4 \
        --seq 128
    ... --phase prefill --batch 4 --seq 512
    ... --phase decode --batch 8 --seq 544

and merges them into one table: the first run whole (its corrections, the
full GEMM grid at both wire widths, psum, its island rows) plus the
island-keyed rows of the other two. The table's notes name the commands.
It needs a CUDA device; the table's fingerprint names the card.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BASE = ["calibrate", "--grid", "full", "--dtype", "both", "--per-island",
        "--arch", "tinyllama-1.1b"]
RUNS = (["--phase", "prefill", "--batch", "4", "--seq", "128"],
        ["--phase", "prefill", "--batch", "4", "--seq", "512"],
        ["--phase", "decode", "--batch", "8", "--seq", "544"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scratch", default=os.path.join(ROOT, "build",
                                                      "h100_seed"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch import autotune as cli
    from repro_torch.core import autotune

    if not torch.cuda.is_available():
        print("calibrate_h100_seed: no CUDA device", file=sys.stderr)
        return 2
    commands = []
    tables = []
    for i, extra in enumerate(RUNS):
        path = os.path.join(args.scratch, f"run{i}.json")
        argv_i = BASE + extra + ["--out", path]
        commands.append("python -m repro_torch.autotune " + " ".join(
            BASE + extra))
        print(f"[seed] {commands[-1]}", flush=True)
        if cli.main(argv_i) != 0:
            return 1
        tables.append(autotune.CalibrationTable.load(path))
    seed = tables[0]
    for t in tables[1:]:
        if not t.fingerprint.compatible(seed.fingerprint, strict=True):
            raise SystemExit(f"fingerprints differ: {t.fingerprint} vs "
                             f"{seed.fingerprint}")
        seed.measurements += [r for r in t.measurements if r.get("island")]
    seed.notes = ("measured on one card by the CLI at chip_smoke phase 4's "
                  "serving shapes (scripts/calibrate_h100_seed.py): "
                  + "; ".join(commands)
                  + ". Run 1 whole, plus the island rows of runs 2 and 3.")
    path = seed.save(args.out)
    print(f"[seed] wrote {path}: {len(seed.measurements)} rows, "
          f"fingerprint {seed.fingerprint}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
