"""Step-function factories — the twins of ``make_train_step``,
``make_serve_step``, ``make_prefill_step``, ``make_prefill_cache_step`` and
``make_paged_prefill_step`` in ``repro/train/step.py``. PyTorch runs eagerly, so where JAX jits these
closures the port calls them directly (the serving engine under
``torch.no_grad``)."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import pgl
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    #: the gradient transform's state, carried from step to step (the
    #: error-feedback residual of int8 compression); None without one
    grad_state: Any = None


def _relayout(grads: dict, tmpl: dict, rules, to_global: bool) -> dict:
    """Gradients in the stored layout -> each laid out as its global weight
    (the JAX array), or back."""
    if rules is None:
        return grads
    out: dict = {}
    for path, pd in T.leaves(tmpl):
        g = grads
        for k in path:
            g = g[k]
        args = (pd.spec, rules.mesh, rules.tp)
        T.set_path(out, path, pgl.assemble(g, *args, lead=int(pd.periods))
                   if to_global else pgl.layout(
                       g, *args, lead=int(pd.periods),
                       expand=False).contiguous())
    return out


def make_train_step(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, optimizer: AdamW,
                    grad_transform: Callable | None = None):
    """Returns train_step(state, batch) -> (state, metrics).

    Microbatching: the batch's leading dim is split into
    ``run.microbatches`` contiguous chunks; each chunk's gradient is
    accumulated in f32 (divided by the count), the loss likewise, and one
    optimizer update follows. With one microbatch the gradients keep the
    parameters' dtype, as in JAX. The loss differentiated and reported is
    ``forward_train``'s total (cross-entropy + 0.01·aux), as in JAX.
    metrics: loss, aux_loss (the MoE load-balance loss, averaged over
    microbatches like the loss), grad_norm (f32 tensors) and step (int).

    ``grad_transform(grads, grad_state) -> (grads, grad_state)`` runs on
    the accumulated gradient before the update (JAX's hook, e.g.
    ``optim.compress.ErrorFeedbackInt8.transform``). It sees every gradient
    laid out as its global weight, as JAX's sees its arrays, so a transform
    that blocks the flattened gradient blocks it as JAX does. Its state
    rides in ``TrainState.grad_state`` and is threaded from step to step:
    JAX's hook is ``grads -> grads``, and its launcher's closure over a
    dict, traced once by ``jax.jit``, keeps the state at its initial value
    (ROADMAP C14)."""
    tmpl = T.param_template(cfg, run, rules) if grad_transform else None

    def grads_of(params, paths, mb):
        for _, p in paths:
            p.requires_grad_(True)
        loss, metrics = T.forward_train(params, mb, cfg, run, rules)
        gs = torch.autograd.grad(loss, [p for _, p in paths])
        return loss.detach(), metrics["aux_loss"].detach(), gs

    def train_step(state: TrainState, batch):
        params = state.params
        paths = list(T.leaves(params))
        nm = run.microbatches
        if nm > 1:
            mbs = [{k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(nm)]
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for _, p in paths]
            loss = aux = 0.0
            for mb in mbs:
                l_mb, a_mb, gs = grads_of(params, paths, mb)
                for a, g in zip(acc, gs):
                    a.add_(g.float() / nm)
                loss = loss + l_mb / nm
                aux = aux + a_mb / nm
            gs = acc
        else:
            loss, aux, gs = grads_of(params, paths, batch)
        grads: dict = {}
        for (path, _), g in zip(paths, gs):
            T.set_path(grads, path, g)
        grad_state = state.grad_state
        if grad_transform is not None:
            grads, grad_state = grad_transform(
                _relayout(grads, tmpl, rules, True), grad_state)
            grads = _relayout(grads, tmpl, rules, False)
        params, opt, gnorm = optimizer.update(grads, state.opt, params)
        return TrainState(params, opt, grad_state), {
            "loss": loss, "aux_loss": aux, "grad_norm": gnorm,
            "step": opt.step}

    return train_step


def make_serve_step(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, *, page_size: int = 0,
                    long_ctx: bool = False):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    against a pre-filled KV cache (for an encoder-decoder also the
    encoder's K/V in ``cache["cross"]``: ``decode_step_encdec``).
    ``page_size`` > 0: the cache is a page pool of ``page_size``-token
    pages (``runtime/paging.py``). ``long_ctx``: the cache is
    sequence-sharded over the dp and tp axes at once (the long_500k
    cell)."""
    if cfg.encoder_decoder:
        def serve_step(params, cache, tokens):
            return T.decode_step_encdec(params, cache, tokens, cfg, run,
                                        rules)
        return serve_step

    def serve_step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg, run, rules,
                             page_size=page_size, long_ctx=long_ctx)
    return serve_step


def make_prefill_step(cfg: ArchConfig, run: RunConfig,
                      rules: ShardingRules | None):
    """prefill(params, batch) -> logits (B, 1, V): the last position's
    logits of a full-sequence forward (``forward_prefill``)."""
    def prefill_step(params, batch):
        return T.forward_prefill(params, batch, cfg, run, rules)
    return prefill_step


def make_prefill_cache_step(cfg: ArchConfig, run: RunConfig,
                            rules: ShardingRules | None):
    """prefill(params, cache, tokens, prompt_lens) -> (logits, cache): the
    batched cache-building prefill one serving bucket runs."""
    def prefill_step(params, cache, tokens, prompt_lens):
        return T.prefill_step(params, cache, tokens, prompt_lens, cfg, run,
                              rules)
    return prefill_step


def make_paged_prefill_step(cfg: ArchConfig, run: RunConfig,
                            rules: ShardingRules | None, page_size: int):
    """prefill(params, cache, tokens, block_tables, prompt_lens,
    chunk_start, write_from) -> (logits, cache): one chunk of paged
    cache-building prefill against a pool of ``page_size``-token pages
    (``runtime/paging.py``).
    With ``prefill_chunk`` set every bucket shares one (G, cl) step and
    only the chunk count varies."""
    def prefill_step(params, cache, tokens, block_tables, prompt_lens,
                     chunk_start, write_from):
        return T.prefill_paged_step(params, cache, tokens, block_tables,
                                    prompt_lens, chunk_start, write_from,
                                    cfg, run, rules, page_size=page_size)
    return prefill_step
