"""Device, dtype and toolchain helpers shared by the whole port.

* ``resolve_device(device=None)`` — the entry points run on ``cuda`` unless
  the caller names another device; with no GPU and no explicit device they
  raise instead of quietly running on the CPU.
* ``DTYPES`` — the config dtype names (``ArchConfig.dtype``) as torch dtypes.
* ``nvcc_path()`` — where the CUDA compiler is, or None. The hand-written
  kernels under ``kernels/csrc`` are built with it at first use
  (``kernels/_build.py``).
"""

from __future__ import annotations

import os
import shutil

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, which must exist.

    Raises RuntimeError when no device is given and CUDA is unavailable —
    the port's serving path is meant for the card, and a silent CPU run
    would report CPU numbers under a GPU's name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def nvcc_path() -> str | None:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None
