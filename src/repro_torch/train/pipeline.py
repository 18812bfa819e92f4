"""GPipe pipeline parallelism over a ``pipe`` axis of virtual ranks — the
twin of ``repro/train/pipeline.py``.

Each pipeline rank holds a slab of stages; microbatch activations flow
stage to stage as one-hop ring shifts of the stacked ``(R, ...)`` carry
(``CommContext.ring_shift``: a roll under ``bulk``, the p2p kernel B8
under ``fused``) — the PK one-way neighbour store.

Schedule: plain GPipe — M microbatches over n ranks in M + n - 1 ticks,
bubble fraction (n - 1) / (M + n - 1). At tick t rank r works on
microbatch t - r when 0 <= t - r < M. JAX runs every rank on every tick
(the bubble ticks compute on garbage, masked); a stage function here is
not batched over ranks, so each tick calls it once per working rank and
skips the bubble ranks, whose carry stays zero — nothing non-finite can
reach a gradient. Every tick still ends in one shift of the whole carry,
M + n - 1 a forward, as JAX's ``ppermute``.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from repro_torch.core.pgl import P
from repro_torch.core.quant import tree_map
from repro_torch.core.template import Comm, Island

__all__ = ["gpipe_apply", "gpipe_island", "gpipe_forward", "gpipe_loss"]


def _leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _rank(tree, r: int):
    """Rank r's slab of a tree of stacked ``(R, ...)`` leaves."""
    return tree_map(lambda a: a[r], tree)


def gpipe_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, ctx):
    """Run ``stage_fn(params, x) -> y`` over the pipeline's ranks.

    ``stage_params``: a tree of stacked ``(R, ...)`` leaves, rank r's slab
    at index r (JAX passes each rank its own inside ``shard_map``);
    ``x_mb``: (M, mb, ...) microbatched input, which only rank 0 reads;
    ``ctx``: the ``CommContext`` of the pipe axis, whose ``ring_shift``
    hands each tick's outputs to the next rank. Returns the stacked
    (R, M, mb, ...) outputs: the last rank's hold the pipeline's result,
    every other rank's are zeros (JAX's masking). Activations keep one
    shape across stages (a residual stream does)."""
    n = ctx.axis_size
    m = x_mb.shape[0]
    zero = torch.zeros_like(x_mb[0])
    carry = [zero] * n
    outs = [zero] * m
    for t in range(m + n - 1):
        step = []
        for r in range(n):
            if not 0 <= t - r < m:
                step.append(zero)                # a bubble: skipped
                continue
            inp = x_mb[t] if r == 0 else carry[r]
            step.append(stage_fn(_rank(stage_params, r), inp))
        if t >= n - 1:
            # the last rank's tick-t output is microbatch t - (n - 1)
            outs[t - (n - 1)] = step[n - 1]
        # one-hop handoff to the next rank (PK one-way neighbour store)
        carry = list(ctx.ring_shift(torch.stack(step)).unbind(0))
    last = torch.stack(outs)
    return torch.stack([torch.zeros_like(last)] * (n - 1) + [last])


def _padded(spec: P, ndim: int) -> P:
    return P(*spec, *([None] * (ndim - len(spec))))


class _PrefixIsland(Island):
    """An Island whose declared specs are prefixes of every leaf's dims, as
    ``shard_map`` reads them (``Island.inputs`` takes one whole spec a
    tensor): each call declares its leaves' full specs, padded with
    ``None``, and its output's, which has the shape of ``x_mb``."""

    def __call__(self, **arrays):
        inner = copy.copy(self)
        inner.inputs = {
            n: tree_map(lambda t, s=self.inputs[n]: _padded(s, t.dim()), a)
            for n, a in arrays.items()}
        inner.out_specs = _padded(self.out_specs, arrays["x_mb"].dim())
        return Island.__call__(inner, **arrays)


def gpipe_island(stage_fn: Callable, mesh, *, n_microbatches: int,
                 n_stages: int | None = None, axis_name: str = "pipe",
                 run=None) -> Island:
    """The GPipe pipeline as an ``Island``.

    Declared inputs: ``stage_params`` — per-stage parameters stacked on a
    leading stage dim, sharded over ``axis_name`` (each rank sees its
    slab); ``x_mb`` — (M, mb, ...) microbatched input, replicated. With
    more stages than ranks each rank holds a contiguous slab of virtual
    stages and composes them in order within its tick — no stage is
    dropped. The body runs :func:`gpipe_apply` and gives every rank the
    last rank's outputs (JAX's masked ``psum``). The fallback (no mesh, a
    single device, reference mode, a stage count the axis does not divide)
    runs the stages in sequence: the same math, no pipeline. The handoff
    is declared ``Comm("ring_shift", backend="bulk")``, M + n - 1 shifts;
    an ``island_overrides`` entry of ``fused`` runs it through B8."""
    n = mesh.shape[axis_name] if mesh is not None else 1

    def body(ctx, stage_params, x_mb):
        n_loc = _leaves(stage_params)[0].shape[1]

        def local_stages(slab, x):
            # rank r holds stages [r*n_loc, (r+1)*n_loc): composed in order
            h = x
            for i in range(n_loc):
                h = stage_fn(tree_map(lambda a: a[i], slab), h)
            return h

        outs = gpipe_apply(local_stages, stage_params, x_mb[0], ctx)
        return outs[-1:].expand_as(outs)

    def reference(stage_params, x_mb):
        h = x_mb
        for i in range(_leaves(stage_params)[0].shape[0]):
            h = stage_fn(tree_map(lambda a: a[i], stage_params), h)
        return h

    return _PrefixIsland(
        "gpipe", mesh=mesh, axis=axis_name, run=run,
        inputs={"stage_params": P(axis_name), "x_mb": P()},
        out_specs=P(),
        body=body, reference=reference,
        # a stage count the pipe axis does not divide cannot be split:
        # the sequential reference, with a readable plan reason
        divisible=((n_stages, axis_name),) if n_stages is not None else (),
        comm=Comm("ring_shift", backend="bulk",
                  n_chunks=n_microbatches + n - 1))


def gpipe_forward(stage_fn: Callable, stage_params, x_mb, mesh, *,
                  axis_name: str = "pipe", run=None):
    """Run the GPipe Island: (M, mb, ...) -> (M, mb, ...) outputs (the
    entry the launchers and tests use)."""
    n_stages = _leaves(stage_params)[0].shape[0]
    island = gpipe_island(stage_fn, mesh, n_microbatches=x_mb.shape[0],
                          n_stages=n_stages, axis_name=axis_name, run=run)
    return island(stage_params=stage_params, x_mb=x_mb)


def gpipe_loss(stage_fn, loss_fn, stage_params, x_mb, targets_mb, ctx):
    """Forward through the pipe and ``loss_fn(outputs, targets)`` on the
    last rank (JAX masks the others' and sums over the axis): a scalar,
    differentiable — the backward flows the pipe in reverse through the
    shift's transpose (for a fused shift, the bulk roll back, C7)."""
    outs = gpipe_apply(stage_fn, stage_params, x_mb, ctx)
    return loss_fn(outs[-1], targets_mb)
