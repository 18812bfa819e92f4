"""The benchmark's files, found by name, and the result line.

``BENCHMARK.json`` lists the cells and metrics; a cell's details are
``pkbench/workloads/<cell>.json``, a configuration
``pkbench/configs/<config>.json``, a traffic mix
``pkbench/traffic/<mix>.json``, a metric's reader
``pkbench/metrics/<metric>.py`` (``read(record)`` -> a number, or None
where the run has nothing for it to read) and a kernel family's work
``pkbench/work/<family>.py``. Adding any of these is adding a file.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

from pkbench.harness import checks

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"pkbench: no workload {name!r} in BENCHMARK.json")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``pkbench/<kind>/<name>.py`` loaded by its path (names hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    sp = importlib.util.spec_from_file_location(
        f"pkbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def families() -> list:
    """Every kernel family of ``pkbench/work/`` (each a module with
    ``NAMES`` and ``work``)."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "work", "*.py"))):
        name = os.path.basename(path)[:-3]
        if not name.startswith("_"):
            mod = module("work", name)
            if hasattr(mod, "NAMES"):
                out.append((name, mod))
    return out


def metrics_for(bench: dict, cell: str, trace: int) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def result(bench, entry, cell, config, mix, out, trace, device) -> dict:
    record = dict(out, cell=cell, config=config, mix=mix,
                  workload=entry["name"])
    metrics = {}
    for m in metrics_for(bench, entry["name"], trace):
        v = module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, compared = checks.judge(out["compared"], cell["limits"])
    dev = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["compared"] = compared
    return line
