"""What a benchmark run and its reference may import: no JAX, no JAX
package (``repro``, compared by whole top-level name: the port
``repro_torch`` is not it), and for the reference nothing of the port."""

import os
import subprocess
import sys

import pkbench_tiny

from pkbench.harness import guard

ROOT = pkbench_tiny.ROOT

RUN_IMPORTS = """
import glob, os, sys
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
from pkbench.harness import guard, spec
import pkbench.modes.serve, pkbench.modes.train, pkbench.control
import repro_torch.runtime.serving, repro_torch.train.step
import repro_torch.optim.adamw, repro_torch.models.transformer
for kind in ("metrics", "work"):
    for p in glob.glob(os.path.join({root!r}, "pkbench", kind, "*.py")):
        n = os.path.basename(p)[:-3]
        if not n.startswith("_"):
            spec.module(kind, n)
print(",".join(guard.forbidden_loaded()))
"""

REFERENCE_IMPORTS = """
import os, sys
sys.path[:0] = [{root!r}]
import pkbench.reference.moe_transformer, pkbench.reference.mamba
import pkbench.reference.adamw, pkbench.harness.weights
import pkbench.traffic.closed_loop, pkbench.traffic.lm_batches
bad = sorted({{n.split(".")[0] for n in sys.modules}}
             & {{"jax", "jaxlib", "flax", "repro", "repro_torch"}})
print(",".join(bad))
"""


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    assert _run(RUN_IMPORTS) == ""


def test_the_reference_loads_nothing_of_the_port():
    assert _run(REFERENCE_IMPORTS) == ""


def test_names_are_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reprox": 1,
            "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_loaded(mods) == []
    mods.update({"repro.core.comms": 1, "jax.numpy": 1})
    assert guard.forbidden_loaded(mods) == ["jax", "repro"]


def test_a_run_without_a_gpu_prints_no_result(tmp_path):
    """Without a CUDA device (this sandbox) the run exits non-zero and
    prints nothing on standard output; so it does in a directory that
    holds only BENCHMARK.json and the benchmark's files."""
    import shutil
    import torch
    if torch.cuda.is_available():
        return
    shutil.copytree(os.path.join(ROOT, "pkbench"), tmp_path / "pkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "pkbench/run.py", "--workload",
             "moonshot-serve-longdoc", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
