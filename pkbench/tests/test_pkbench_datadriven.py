"""A later change adds a cell, a traffic mix, a metric or a kernel family
as new files under pkbench/ (and entries in BENCHMARK.json) and edits no
file that is there: the harness finds each by its name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pkbench_tiny

ROOT = pkbench_tiny.ROOT

NEW_METRIC = '''
def read(record):
    return 42.0 if record["mode"] == "serve" else None
'''

NEW_FAMILY = '''
NAMES = ("my_new_kernel",)


def work(record):
    return 1e9, 1e9, 989e12
'''

CHECK = """
import json, sys
sys.path[:0] = [{root!r}]
from pkbench.harness import readers, spec
bench = spec.benchmark()
names = [m["name"] for m in spec.metrics_for(bench, "my-new-cell", 1)]
fams = [n for n, _ in spec.families()]
cell = spec.load("workloads", "my-new-cell")
mix = spec.load("traffic", cell["traffic"])
record = {{"mode": "serve", "trace": {{"kernels": {{
    "my_new_kernel<1>": [1.0, 3]}}}}}}
share = readers.roofline_share(record, only=("my_new_family",))
value = spec.module("metrics", "my_new_metric.serve").read(record)
print(json.dumps([names, fams, mix["clients"], share, value]))
"""


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_metric_and_family_are_new_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "pkbench"), tmp_path / "pkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "pkbench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pk = tmp_path / "pkbench"
    (pk / "metrics" / "my_new_metric.serve.py").write_text(NEW_METRIC)
    (pk / "work" / "my_new_family.py").write_text(NEW_FAMILY)
    mix = json.load(open(pk / "traffic" / "longdoc_64c.json"))
    mix["clients"] = 32
    (pk / "traffic" / "longdoc_32c.json").write_text(json.dumps(mix))
    cell = json.load(open(pk / "workloads" / "moonshot-serve-longdoc.json"))
    cell["traffic"] = "longdoc_32c"
    (pk / "workloads" / "my-new-cell.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "my-new-cell",
                               "config": cell["config"],
                               "traffic": "longdoc_32c", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "moonshot-serve-longdoc" in m.get("workloads", []):
            m["workloads"].append("my-new-cell")
    bench["per_layer"].append({
        "name": "my_new_metric.serve", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "serve_tokens_per_s", "workloads": ["my-new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(root=str(tmp_path))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names, fams, clients, share, value = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert "my_new_metric.serve" in names and "decode_step_ms.serve" in names
    assert "my_new_family" in fams and clients == 32
    assert share == 100.0 * (1e9 / 3.35e12) / 1.0
    assert value == 42.0
    after = _digest(tmp_path / "pkbench")
    assert {k: v for k, v in after.items() if k in before} == before
