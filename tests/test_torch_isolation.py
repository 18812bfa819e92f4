"""The port stands alone: no module of ``src/repro_torch`` and nothing
``chip_smoke.py`` imports loads JAX or the JAX package ``repro``.

Mind the prefix: ``repro_torch`` starts with ``repro`` — the checks match
``repro`` and ``repro.*`` only.
"""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import chip_smoke  # noqa: F401  (the script's own top-level imports)
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
for name in ("chip_smoke", "repro_torch.launch.serve",
             "repro_torch.kernels._build", "repro_torch.launch.dryrun",
             "repro_torch.launch.specs", "repro_torch.roofline.counters",
             "repro_torch.roofline.hlo", "repro_torch.roofline.model",
             "repro_torch.roofline.report"):
    assert name in sys.modules, name
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "repro")
             or n.startswith(("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad)
print("COUNT", sum(n.startswith("repro_torch") for n in sys.modules))
"""


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)     # one order for every pytest-xdist worker


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
    count = int(proc.stdout.split("COUNT")[1])
    assert count >= 20          # every module of the package was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib)\b|from\s+(jax|jaxlib)\b"
    r"|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_statements(path):
    with open(path) as f:
        hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(f.read())]
    assert not hits, f"{os.path.relpath(path, ROOT)} imports {hits}"
