"""One run of each cell on the card, at the benchmark's ``run_seconds``
(marked ``gpu``: skipped without one; a shorter window can finish none of
the long-document requests it checks). Run on the card with
``python -m pytest -m gpu pkbench/tests``."""

import json
import os
import subprocess
import sys

import pkbench_tiny
import pytest

from pkbench.harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_a_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "pkbench/run.py", "--workload", name, "--seed",
         "77", "--seconds", str(spec.benchmark()["run_seconds"]),
         "--trace", "0"], cwd=pkbench_tiny.ROOT,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
