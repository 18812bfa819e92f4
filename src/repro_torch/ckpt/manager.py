"""Checkpoints of the port — the twin of ``repro/ckpt/manager.py``, in the
port's own format (it does not read JAX checkpoints).

A checkpoint is a directory ``step_<N>`` holding ``state.pt`` (one
``torch.save`` of the flattened state: every tensor on the CPU in its own
dtype, bf16 included, and the plain Python numbers) and ``manifest.json``
(the step, the caller's ``extra`` dict and each leaf's shape and dtype).
It is written under ``tmp_step_<N>`` and renamed into place, so a torn
write is never taken for a complete checkpoint; ``keep`` bounds how many
are kept. ``save`` copies the state to the host before it returns (the
caller may update tensors in place at once) and, with ``async_save``,
writes on a thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import torch

from repro_torch.core import pgl


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """'a/b/0'-keyed leaves of nested dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for k, v in zip(names, tree):
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _rebuild(template, flat: dict, prefix: str = ""):
    """``template``'s structure with leaves from ``flat``; tensors land on
    the template leaf's device and dtype, in padded rows where the template
    leaf's are (``pgl.aligned_rows``)."""
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, tuple):
        names = getattr(template, "_fields", range(len(template)))
        kids = [_rebuild(v, flat, f"{prefix}{k}/")
                for k, v in zip(names, template)]
        return type(template)(*kids) if hasattr(template, "_fields") \
            else tuple(kids)
    leaf = flat[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        out = leaf.to(device=template.device, dtype=template.dtype)
        return pgl.aligned_rows(out) if pgl.padded_rows(template) else out
    return leaf


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


class CheckpointManager:
    """Crash-safe checkpoints with keep-N and an optional writer thread."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---------------- save ----------------

    def save(self, step: int, state, extra: dict | None = None, *,
             block: bool = False) -> None:
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_reporting, args=(step, flat, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self) -> None:
        """Join the writer thread; re-raise what it failed with."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_reporting(self, step, flat, extra):
        try:
            self._write(step, flat, extra)
        except BaseException as e:  # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, flat: dict, extra: dict) -> None:
        tmp = self.dir / f"tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(flat, tmp / "state.pt")
        leaves = {k: ({"shape": list(v.shape), "dtype": str(v.dtype)}
                      if isinstance(v, torch.Tensor) else {"value": v})
                  for k, v in flat.items()}
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "extra": extra, "leaves": leaves}))
        if final.exists():                       # re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)                   # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_flat(self, step: int | None = None):
        """(flat state, extra) of a checkpoint as saved: 'a/b/c'-keyed
        leaves on the CPU — newest step by default; (None, None) when there
        is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = torch.load(d / "state.pt", map_location="cpu",
                          weights_only=True)
        return flat, {"step": step, **manifest.get("extra", {})}

    def restore(self, template, *, step: int | None = None):
        """(state, extra) restored into the structure of ``template`` —
        newest step by default; (None, None) when there is none."""
        flat, extra = self.load_flat(step)
        if flat is None:
            return None, None
        return _rebuild(template, flat), extra
