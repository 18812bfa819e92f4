"""Deterministic synthetic token pipeline — the twin of
``repro/data/pipeline.py``.

``batch(step)`` is a pure function of (seed, step), so the checkpointable
cursor is the step integer and a resumed run sees the same batches. The
sequences follow the JAX package's rule — a per-sequence stride r, x_{t+1}
= (x_t + r) mod V, with a share ``noise`` of tokens replaced at random — so
training shows real loss descent. The draws come from a ``torch.Generator``
seeded with (seed, step); its numbers are not ``jax.random``'s, so the two
packages produce different tokens from the same seed (the cross-framework
tests feed both one numpy batch instead).

The batch is global: the dp ranks' shards are contiguous row blocks of it
(``core/pgl.py``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_rules: int = 8
    noise: float = 0.02


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    def batch(self, step: int) -> dict:
        """tokens, targets (B, S) int64 and weights (B, S) f32 of ``step``."""
        c = self.cfg
        g = torch.Generator().manual_seed((c.seed << 32) + int(step))
        b, s, v = c.global_batch, c.seq_len, c.vocab_size
        start = torch.randint(0, v, (b, 1), generator=g)
        rule = torch.randint(1, c.n_rules + 1, (b, 1), generator=g)
        t = torch.arange(s + 1)[None, :]
        toks = (start + rule * t) % v
        noise = torch.rand((b, s + 1), generator=g) < c.noise
        noise_tok = torch.randint(0, v, (b, s + 1), generator=g)
        toks = torch.where(noise, noise_tok, toks)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
               "weights": torch.ones((b, s), dtype=torch.float32)}
        return {k: x.contiguous().to(self.device) for k, x in out.items()}
