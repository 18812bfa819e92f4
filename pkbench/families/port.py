"""How the benchmark hands its weights to the port: the port's own
parameter template and layout function (``models/transformer.py``:
``param_template``, ``to_stored``), as ``convert.tree_from_numpy`` walks
the template. A family module names, for each leaf of the port's
template, the benchmark weight it holds (``PATHS``) and how that weight's
global shape maps onto the leaf's (``to_global``)."""

from __future__ import annotations

import importlib


def family(name: str):
    return importlib.import_module(f"pkbench.families.{name}")


def to_port(weights: dict, fam, cfg, run, rules, device) -> dict:
    """The port's stored parameters from the benchmark's weights: each
    leaf laid out by ``to_stored``; ``weights`` is emptied as it goes."""
    from repro_torch.models import transformer as T
    out: dict = {}
    tmpl = T.param_template(cfg, run, rules)
    names = dict(fam.leaf_names(tmpl))
    for path, pd in T.leaves(tmpl):
        x = fam.to_global(weights, names[path], pd.shape)
        if tuple(x.shape) != tuple(pd.shape) or x.dtype != pd.dtype:
            raise ValueError(f"{'/'.join(path)}: the benchmark's "
                             f"{names[path]} is {tuple(x.shape)} "
                             f"{x.dtype}, the port wants {pd.shape} "
                             f"{pd.dtype}")
        T.set_path(out, path, T.to_stored(x.to(device), pd, rules))
    weights.clear()
    return out


def stored(tree, path):
    for k in path:
        tree = tree[k]
    return tree
