"""Step-function factories of the serving path — the twins of
``make_serve_step`` and ``make_prefill_cache_step`` in
``repro/train/step.py``. PyTorch runs eagerly, so where the JAX engine jits
these closures the port calls them directly (under ``torch.no_grad``
in the engine). The train step is ROADMAP item A6."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingRules


def make_serve_step(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    against a pre-filled KV cache."""
    def serve_step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg, run, rules)
    return serve_step


def make_prefill_cache_step(cfg: ArchConfig, run: RunConfig,
                            rules: ShardingRules | None):
    """prefill(params, cache, tokens, prompt_lens) -> (logits, cache): the
    batched cache-building prefill one serving bucket runs."""
    def prefill_step(params, cache, tokens, prompt_lens):
        return T.prefill_step(params, cache, tokens, prompt_lens, cfg, run,
                              rules)
    return prefill_step
