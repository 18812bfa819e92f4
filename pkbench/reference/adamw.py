"""Plain float32 AdamW with clipping of the global gradient norm: the
update rule the benchmark's training cells state (``run`` in the cell's
file), applied to a dict of leaves in place."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        self.step_no = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """One step; returns the norm of each leaf's gradient as the update
        used it (after clipping)."""
        self.step_no += 1
        gn = torch.stack([g.square().sum() for g in grads.values()]).sum() \
            .sqrt()
        scale = torch.clamp(self.clip / gn.clamp_min(1e-9), max=1.0)
        c1 = 1 - self.b1 ** self.step_no
        c2 = 1 - self.b2 ** self.step_no
        used = {}
        for k, p in params.items():
            g = grads[k] * scale
            used[k] = float(g.norm())
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g.square())
            u = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * u)
        return used
