"""Abstract input specs of every (arch × cell) — the twin of
``repro/launch/specs.py``, read by the dry-run (``launch/dryrun.py``).

Each leaf is a ``models.transformer.PD``: the global shape, the dtype and
the partition spec (with the layout facts the port stores by: the
layer-period dim, 16-byte rows), built from the port's templates
(``param_template``, ``cache_template``). The trees and their names are
JAX's: ``batch_specs`` -> (batch, specs), ``train_state_specs`` ->
(``TrainState``, ``TrainState`` of specs), ``decode_specs`` -> ((params,
cache, tokens), (pspecs, cspecs, tspec)).

:func:`materialize` lays such a tree out as the port stores it — stacked
per rank where a spec shards a leaf over tp (or, for the long-context
cache, over the dp and tp axes) — as ``meta`` tensors: no allocation and
no draws. JAX's ``named`` builds ``NamedSharding``s for ``jax.jit``; the
port's steps take their layout from the stored tensors themselves, so it
has no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, RunConfig, ShapeCell
from repro_torch.core.pgl import P
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState

PD = T.PD


def batch_specs(cfg: ArchConfig, cell: ShapeCell, rules: ShardingRules):
    """(abstract batch, its specs) for a train or prefill cell."""
    b, s = cell.global_batch, cell.seq_len
    dp = rules.dp
    batch = {"tokens": PD((b, s), P(dp, None), "zeros", torch.int32)}
    if cell.kind == "train":
        batch["targets"] = PD((b, s), P(dp, None), "zeros", torch.int32)
        batch["weights"] = PD((b, s), P(dp, None), "ones", torch.float32)
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = PD((b, cfg.n_frontend_tokens, cfg.d_model),
                                      P(dp, None, None), "zeros",
                                      torch.bfloat16)
    if cfg.encoder_decoder:
        batch["enc_embeds"] = PD((b, s, cfg.d_model), P(dp, None, None),
                                 "zeros", torch.bfloat16)
    return batch, {k: pd.spec for k, pd in batch.items()}


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tree.spec


def _with_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: _with_dtype(v, dtype) for k, v in tree.items()}
    return PD(tree.shape, tree.spec, "zeros", dtype, tree.periods,
              tree.aligned)


def train_state_specs(cfg: ArchConfig, run: RunConfig, rules: ShardingRules,
                      moment_dtype=torch.float32):
    """(abstract TrainState, its specs). The moments take the parameters'
    specs and layout in ``moment_dtype``."""
    params = T.param_template(cfg, run, rules)
    pspecs = _specs(params)
    moments = _with_dtype(params, moment_dtype)
    state = TrainState(params=params, opt=AdamWState(
        step=PD((), P(), "zeros", torch.int32), m=moments, v=moments))
    specs = TrainState(params=pspecs,
                       opt=AdamWState(step=P(), m=pspecs, v=pspecs))
    return state, specs


def decode_specs(cfg: ArchConfig, run: RunConfig, rules: ShardingRules,
                 cell: ShapeCell):
    """(abstract (params, cache, tokens), their specs) for a decode cell;
    long_500k takes the long-context cache (ROADMAP A8)."""
    b, s = cell.global_batch, cell.seq_len
    params = T.param_template(cfg, run, rules)
    cache = T.cache_template(cfg, run, rules, batch=b, s_max=s,
                             enc_len=s if cfg.encoder_decoder else 0,
                             long_ctx=cell.name == "long_500k")
    tokens = PD((b, 1), P(rules.dim(b, rules.dp), None), "zeros",
                torch.int32)
    return (params, cache, tokens), (_specs(params), _specs(cache),
                                      tokens.spec)


def device_bytes(tree, rules: ShardingRules) -> float:
    """A device's share of a tree's arguments: each leaf's global bytes
    divided by the mesh axes its spec shards it over — what JAX's
    ``memory_analysis().argument_size_in_bytes`` reports a device."""
    if tree is None:
        return 0
    if isinstance(tree, (dict, tuple)):
        vals = tree.values() if isinstance(tree, dict) else tree
        return sum(device_bytes(v, rules) for v in vals)
    n = 1
    for d in tree.shape:
        n *= d
    shards = 1
    for entry in tree.spec:
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in names:
            shards *= rules.mesh.shape.get(a, 1)
    return n * torch.empty((), dtype=tree.dtype).element_size() / shards


def materialize(tree, rules: ShardingRules | None, device="meta"):
    """A tree of specs as tensors in the stored layout on ``device``
    (``meta``: nothing allocated, nothing drawn). A 0-dim integer leaf (a
    decode cache's position, the optimizer's step) is a CPU zero: the
    steps read the position on the host, as JAX's are given it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: materialize(v, rules, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(materialize(v, rules, device) for v in tree))
    if tree.shape == () and not tree.dtype.is_floating_point:
        return torch.zeros((), dtype=tree.dtype)
    shape = T.stored_shape(tree, rules)
    if tree.aligned:            # rows padded to 16 bytes, as stored
        per = 16 // torch.empty((), dtype=tree.dtype).element_size()
        n = shape[-1]
        buf = torch.empty((*shape[:-1], -(-n // per) * per),
                          dtype=tree.dtype, device=device)
        return buf[..., :n]
    return torch.empty(shape, dtype=tree.dtype, device=device)
