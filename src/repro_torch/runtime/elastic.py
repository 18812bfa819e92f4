"""Elastic scaling: restore a checkpoint onto a different mesh — the twin
of ``repro/runtime/elastic.py``.

JAX keeps parameters in their logical layout, so a restore there is a
``device_put`` with the new mesh's shardings. The port stores every
tp-sharded weight stacked, ``(R, *local)`` (``core/pgl.py``), so its
restore takes two steps: each leaf is assembled to its logical shape under
the snapshot's mesh (``pgl.assemble``), then stored again under the new
mesh's rules (``transformer.to_stored``). The MoE device-major expert
weights, whose logical shape itself names the tp size, are converted in
between, through the logical expert layout (``core/moe_layout.py``), as in
JAX.

The snapshot's layout comes from the checkpoint's ``extra``: ``tp`` (the
tp size it was cut at) and, where it was cut on a mesh, ``mesh_shape`` and
``mesh_axes`` (``runtime.fleet.ServingFleet`` writes all three).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import pgl
from repro_torch.core.moe_layout import dm_to_logical, logical_to_dm
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules

__all__ = ["moe_converter", "elastic_restore"]


def moe_converter(cfg: ArchConfig, old_m: int, new_m: int):
    """Per-leaf converter of logical leaves (numpy, keyed by their
    'a/b/c' path): reshapes the MoE device-major expert weights from tp
    size ``old_m`` to ``new_m``; None when nothing needs converting."""
    if old_m == new_m or not cfg.is_moe:
        return None

    def convert(key: str, arr: np.ndarray) -> np.ndarray:
        leaf = key.split("/")[-1]
        if "moe" not in key or leaf not in ("w1", "w2", "w3"):
            return arr
        # stacked over periods: (P, M, E_loc, ...) -> convert each period
        out = []
        for p in range(arr.shape[0]):
            logical = dm_to_logical(arr[p], cfg.n_experts, w2=(leaf == "w2"))
            out.append(logical_to_dm(logical, new_m, w2=(leaf == "w2")))
        return np.stack(out)

    return convert


def _snapshot_rules(run: RunConfig, extra: dict,
                    old_model_size: int | None) -> ShardingRules | None:
    """The rules the snapshot's leaves were stored under: its mesh from
    ``extra``, else a (1, tp) mesh for a tp size above 1, else none."""
    shape = extra.get("mesh_shape")
    if shape:
        axes = tuple(extra.get("mesh_axes") or ("data", "model"))
        return ShardingRules(pgl.VirtualMesh(shape, axes), run)
    tp = old_model_size if old_model_size is not None \
        else int(extra.get("tp", 1))
    if tp > 1:
        return ShardingRules(pgl.VirtualMesh((1, tp), ("data", "model")),
                             run)
    return None


def elastic_restore(ckpt_dir: str, cfg: ArchConfig, run: RunConfig,
                    new_mesh: pgl.VirtualMesh | None, *,
                    old_model_size: int | None = None, template=None,
                    device=None):
    """Load the newest checkpoint of ``ckpt_dir`` and store it for
    ``new_mesh`` (any mesh whose axes divide the sharded dims; None for no
    mesh), on ``device`` (the new mesh's by default). ``old_model_size``
    overrides the tp size the checkpoint's ``extra`` names. Returns
    (parameters, extra); (None, None) when there is no checkpoint."""
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    step = mgr.latest_step()
    if step is None:
        return None, None
    flat, extra = mgr.load_flat(step)
    old_rules = _snapshot_rules(run, extra, old_model_size)
    new_rules = ShardingRules(new_mesh, run) if new_mesh is not None \
        else None
    if device is None:
        device = new_mesh.device if new_mesh is not None else "cpu"
    old_m = old_rules.mesh.shape[old_rules.tp] if old_rules else 1
    new_m = new_rules.mesh.shape[new_rules.tp] if new_rules else 1
    conv = moe_converter(cfg, old_m, new_m)
    tmpl = T.param_template(cfg, run, new_rules) if template is None \
        else template
    old_pds = dict(T.leaves(T.param_template(cfg, run, old_rules)))
    out: dict = {}
    for path, pd in T.leaves(tmpl):
        key = "/".join(path)
        x = flat[key]
        old = old_pds[path]
        if old_rules is not None and x.dim() == len(old.shape) + 1:
            x = pgl.assemble(x, old.spec, old_rules.mesh, old_rules.tp,
                             lead=int(old.periods))
        if conv is not None and "moe" in key \
                and path[-1] in ("w1", "w2", "w3"):
            y = conv(key, x.float().numpy())     # bf16 -> f32 is exact
            x = torch.from_numpy(np.ascontiguousarray(y)).to(x.dtype)
        if tuple(x.shape) != tuple(pd.shape):
            raise ValueError(
                f"{key}: the checkpoint's logical shape {tuple(x.shape)} "
                f"does not fit the new mesh's {tuple(pd.shape)}")
        T.set_path(out, path, T.to_stored(
            x.to(device=device, dtype=pd.dtype), pd, new_rules))
    return out, extra
