"""Closed-loop serving traffic: ``clients`` clients, each sending its
next request when its last one completes.

Each client has its own sequence of ``per_client`` (prompt length, output
length) pairs, drawn once from the mix's own ``size_seed``: prompt lengths
log-uniform over [lo, hi], output lengths uniform over [lo, hi]. Every run
serves the same sequences; ``--seed`` only deals them to the clients in
another order (which client starts first, and so the order in which the
engine sees them) and draws the prompts' token ids (uniform over the
vocabulary), so two seeds ask for the same work in another order. A
client that reaches the end of its sequence starts it again.
"""

from __future__ import annotations

import math

import numpy as np

from pkbench.harness.weights import derive


def _lengths(rng, spec: dict, n: int) -> np.ndarray:
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "log_uniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), n))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


class ClosedLoop:
    def __init__(self, mix: dict, vocab: int, seed: int):
        base = np.random.default_rng(mix["size_seed"])
        self.clients, k = mix["clients"], mix["per_client"]
        self.prompt_lens = _lengths(base, mix["prompt"], self.clients * k) \
            .reshape(self.clients, k)
        self.output_lens = _lengths(base, mix["output"], self.clients * k) \
            .reshape(self.clients, k)
        self.vocab = vocab
        self.rng = np.random.default_rng(derive(seed, "traffic"))
        self.deal = self.rng.permutation(self.clients)
        self.sent = [0] * self.clients

    def next(self, client: int) -> tuple[list[int], int]:
        """(prompt token ids, output length) of ``client``'s next request."""
        j = self.deal[client]
        i = self.sent[client] % self.prompt_lens.shape[1]
        self.sent[client] += 1
        toks = self.rng.integers(0, self.vocab, int(self.prompt_lens[j, i]))
        return toks.tolist(), int(self.output_lens[j, i])
