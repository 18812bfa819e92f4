"""Step-function factories — the twins of ``make_train_step``,
``make_serve_step``, ``make_prefill_step`` and ``make_prefill_cache_step`` in
``repro/train/step.py``. PyTorch runs eagerly, so where JAX jits these
closures the port calls them directly (the serving engine under
``torch.no_grad``)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def make_train_step(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, optimizer: AdamW):
    """Returns train_step(state, batch) -> (state, metrics).

    Microbatching: the batch's leading dim is split into
    ``run.microbatches`` contiguous chunks; each chunk's gradient is
    accumulated in f32 (divided by the count), the loss likewise, and one
    optimizer update follows. With one microbatch the gradients keep the
    parameters' dtype, as in JAX. The loss differentiated and reported is
    ``forward_train``'s total (cross-entropy + 0.01·aux), as in JAX. (JAX's
    ``grad_transform`` hook serves the int8 gradient compression, ROADMAP
    item 11.) metrics: loss, aux_loss (the MoE load-balance loss, averaged
    over microbatches like the loss), grad_norm (f32 tensors) and step
    (int)."""

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
        params, opt, gnorm = optimizer.update(grads, state.opt, params)
        return TrainState(params, opt), {"loss": loss, "aux_loss": aux,
                                         "grad_norm": gnorm,
                                         "step": opt.step}

    return train_step


def make_serve_step(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    against a pre-filled KV cache (for an encoder-decoder also the
    encoder's K/V in ``cache["cross"]``: ``decode_step_encdec``)."""
    step = T.decode_step_encdec if cfg.encoder_decoder else T.decode_step

    def serve_step(params, cache, tokens):
        return step(params, cache, tokens, cfg, run, rules)
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
