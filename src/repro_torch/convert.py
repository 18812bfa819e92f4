"""Parameter (and cache) conversion between the JAX package and the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) and returns the port's parameters in
their stored layout — stacked per rank where the spec shards them — so both
packages compute the same function. ``tree_to_numpy`` is the inverse. Both
walk a port template (``models/transformer.py``), whose paths and global
shapes are the JAX template's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import pgl
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: widen exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                         dtype=dtype)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_from_numpy(np_tree, template, rules: ShardingRules | None,
                    device="cpu") -> dict:
    """Global numpy leaves at the template's paths -> stored torch tree."""
    out: dict = {}
    for path, pd in T.leaves(template):
        a = _get(np_tree, path)
        if tuple(np.shape(a)) != tuple(pd.shape):
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(a)} != "
                             f"template {pd.shape}")
        x = _to_tensor(a, pd.dtype, device)
        T.set_path(out, path, T.to_stored(x, pd, rules))
    return out


def tree_to_numpy(tree, template, rules: ShardingRules | None) -> dict:
    """Stored torch tree -> global numpy leaves (f32 for bf16 leaves)."""
    out: dict = {}
    for path, pd in T.leaves(template):
        x = _get(tree, path)
        if rules is not None:
            x = pgl.assemble(x, pd.spec, rules.mesh,
                             T.stack_axis(pd, rules), lead=int(pd.periods))
        if x.dtype == torch.bfloat16:
            x = x.float()
        T.set_path(out, path, x.detach().cpu().numpy())
    return out


def params_from_jax(np_tree, cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, device="cpu") -> dict:
    """The JAX package's parameters (numpy leaves) as the port's."""
    return tree_from_numpy(np_tree, T.param_template(cfg, run, rules), rules,
                           device)
