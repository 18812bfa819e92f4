"""AdamW with global-norm clipping — the twin of ``repro/optim/adamw.py``.

The moments have the shape and layout of the parameters' stored form
(``models/transformer.py``): a tp-stacked leaf is one tensor holding every
rank's shard once, a replicated leaf is stored global once, and an FSDP
shard is a slice of the tp-stacked leaf. So the global gradient norm sums
every stored gradient once, and each element of the model counts once —
not once per rank that holds a copy. Moments default to float32
(``moment_dtype``). Unlike the JAX optimizer, which returns new arrays,
``update`` writes the parameters and moments in place (under
``torch.no_grad``): on the card that saves a second copy of 1.1 B
parameters and their moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.transformer import leaves


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], float] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: torch.dtype = torch.float32

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        return AdamWState(step=0, m=_map(zeros, params),
                          v=_map(zeros, params))

    def _lr(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """sqrt of the sum of squares of every stored gradient, in f32."""
        sq = [g.float().square().sum() for _, g in leaves(grads)]
        return torch.stack(sq).sum().sqrt()

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: returns (params, state, grad_norm); params and moments
        are updated in place."""
        step = state.step + 1
        gnorm = self.global_norm(grads)
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / gnorm.clamp_min(1e-9),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        lr = self._lr(step)
        m_tree, v_tree = dict(leaves(state.m)), dict(leaves(state.v))
        g_tree = dict(leaves(grads))
        for path, p in leaves(params):
            g = g_tree[path].float() * scale
            m, v = m_tree[path], v_tree[path]
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g.square()
            u = (m_new / c1) / ((v_new / c2).sqrt() + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, AdamWState(step, state.m, state.v), gnorm


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor`` of it."""
    def lr(step: int) -> float:
        s = float(step)
        if s < warmup:
            return peak_lr * s / max(warmup, 1)
        prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5
                          * (1 + math.cos(math.pi * prog)))
    return lr
