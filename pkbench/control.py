#!/usr/bin/env python3
"""The readings that set a serving cell's limits: the program's and its
control's, over several seeds in one process.

    python3 pkbench/control.py --workload moonshot-serve-longdoc \
        --seeds 11 12 13 --seconds 30

For each seed: one run of the cell as ``run.py`` makes it (its window
``--seconds`` long), which gives the program's served-token gaps; then, on
the same sampled prompts and served tokens, the control: the reference
computed with every product's operands rounded to float8 e4m3
(``reference/common.py``), whose gap is that of the token it puts first at
each position, measured in the float32 reference. Both are judged by the
cell's ``limits`` as a run judges the program (``checks.judge``); the
control has to come out not correct. Prints one JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ["REPRO_CACHE_DIR"] = os.path.join(ROOT, "build", "pkbench",
                                             "autotune")
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

from pkbench.harness import checks, spec  # noqa: E402
from pkbench.modes import serve  # noqa: E402


def judge_control(cell: dict, config: dict, seed: int, device, prompts,
                  tokens) -> tuple[bool, dict, list[float]]:
    """(correct, {name: {"value", "limit"}}, gaps) of the fp8 control on
    the given prompts and served tokens, under the cell's limits."""
    g = serve.reference_gaps(config, cell["check"], seed, device, prompts,
                             tokens, pick="fp8")
    ok, judged = checks.judge(serve.compared(g), cell["limits"])
    return ok, judged, g


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cell = spec.load("workloads", args.workload)
    config = spec.load("configs", cell["config"])
    mix = spec.load("traffic", cell["traffic"])
    if cell["mode"] != "serve":
        raise SystemExit("control.py reads serving cells")
    for seed in args.seeds:
        t = time.time()
        out = serve.run(cell, config, mix, seed, args.seconds, False, "cuda",
                        time.time())
        ok, judged = checks.judge(out["compared"], cell["limits"])
        line = {"workload": args.workload, "seed": seed,
                "program_correct": ok, "program_compared": judged,
                "checked": out["checked"],
                "tokens_per_s": out["serve"]["tokens_in_window"]
                / out["window_s"]}
        s = out["sample"]
        ok, judged, g = judge_control(cell, config, seed, "cuda",
                                      s["prompts"], s["tokens"])
        line["control_correct"] = ok
        line["control_compared"] = judged
        line["control"] = serve.gap_stats(g)
        line["seconds"] = time.time() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
