"""Training batches: uniform token ids from the seed.

``batch(i)`` is step ``i``'s (batch, seq) tokens and their next-token
targets, drawn on the device by a generator seeded from (seed, i), so
every step's rows are its own and the same seed gives the same batches.
The mix file gives ``batch`` and ``seq``; the ids cover the configuration's
vocabulary. The idea of the port's ``data/pipeline.py::SyntheticLM``,
without its per-sequence stride rule (the benchmark's own copy).
"""

from __future__ import annotations

import torch

from pkbench.harness.weights import derive


class Batches:
    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.b, self.s, self.v = mix["batch"], mix["seq"], vocab
        self.seed, self.device = seed, torch.device(device)

    def batch(self, i: int) -> dict:
        g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, f"batch{i}"))
        t = torch.randint(0, self.v, (self.b, self.s + 1), generator=g,
                          device=self.device)
        return {"tokens": t[:, :-1].contiguous(),
                "targets": t[:, 1:].contiguous(),
                "weights": torch.ones((self.b, self.s), device=self.device)}
