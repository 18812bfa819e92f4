#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 pkbench/run.py --workload moonshot-train --seed 7 \
        --seconds 20 --trace 0

Reads the cell from ``BENCHMARK.json`` and ``pkbench/workloads/<cell>.json``,
its configuration from ``pkbench/configs/``, its traffic mix from
``pkbench/traffic/<mix>.json`` (run by the generator that file names), and
runs it on the GPU through the cell's mode (``pkbench/modes/``). Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by
``pkbench/metrics/<name>.py``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: every number that decided
``correct`` beside its limit, which also end standard error.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), without the port, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def _process_start() -> float:
    """Wall time at which this process started (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "pkbench")
# every cache the run may write, at fixed paths inside the checkout (the
# port builds its kernels into build/repro_torch/ itself)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("REPRO_CACHE_DIR", "autotune")):
    os.environ[var] = os.path.join(BUILD, sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host side of a run is one Python
# thread launching work, and idle worker pools only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from pkbench.harness import guard, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None,
                    help="also write the run's whole record (the program's "
                         "and the reference's readings, the trace's "
                         "aggregates) as JSON to this file")
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    entry = spec.workload_entry(bench, args.workload)
    cell = spec.load("workloads", args.workload)
    config = spec.load("configs", entry["config"])
    mix = spec.load("traffic", entry["traffic"])

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"pkbench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    mode = importlib.import_module(f"pkbench.modes.{cell['mode']}")
    out = mode.run(cell, config, mix, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)

    bad = guard.forbidden_loaded()
    if bad:
        print(f"pkbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = spec.result(bench, entry, cell, config, mix, out, args.trace,
                       device={"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": entry["chips"]})
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        with open(args.dump, "w") as f:
            json.dump({"line": line, "record": out}, f, default=str)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
