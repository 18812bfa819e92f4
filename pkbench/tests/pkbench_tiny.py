"""Tiny versions of the benchmark's cells, for the CPU tests: the cell,
configuration and mix files as committed, with their sizes cut so that
the port's plain CPU path runs them in seconds."""

from __future__ import annotations

import contextlib
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pkbench.harness import spec  # noqa: E402

SEED = 3_000_000_019      # above 2**31: a run's --seed may exceed 32 bits


def config(name: str) -> dict:
    c = copy.deepcopy(spec.load("configs", name))
    if c["family"] == "moe_transformer":
        c.update(hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=4, moe_intermediate_size=32,
                 n_routed_experts=8, num_experts_per_tok=2, vocab_size=256,
                 num_hidden_layers=2)
        c["run_as"]["head_dim"] = 16
    else:
        c.update(hidden_size=64, intermediate_size=128, state_size=8,
                 time_step_rank=8, vocab_size=256, num_hidden_layers=2)
    return c


def cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, mix) of a committed cell, cut to tiny."""
    w = copy.deepcopy(spec.load("workloads", name))
    cfg = config(w["config"])
    mix = copy.deepcopy(spec.load("traffic", w["traffic"]))
    if w["mode"] == "train":
        mix.update(batch=8, seq=16)
    else:
        w["serve"].update(max_batch=8, prefill_batch=min(
            2, w["serve"]["prefill_batch"]), max_new_tokens=8,
            bucket_edges=[16, 32] if not w["serve"].get("exact_buckets")
            else [32])
        mix.update(clients=8, per_client=4,
                   prompt={"dist": "log_uniform", "lo": 4, "hi": 32},
                   output={"dist": "uniform", "lo": 2, "hi": 8})
        # some hundreds of tokens, as at the cell's size: one routing flip
        # between bfloat16 and float32 moves a sample's mean by under 0.01
        w["check"].update(served_tokens=300, max_requests=60)
    return w, cfg, mix


@contextlib.contextmanager
def one_thread():
    """Run on one CPU thread, as ``run.py`` does, so that a window's
    steps do not slow down by the dozen when other tests load the CPU."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
