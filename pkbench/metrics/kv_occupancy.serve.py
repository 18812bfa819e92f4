"""Mean over the window's decode steps of the share of the reserved K/V
cache that holds live tokens, in % (the port's counters
``engine.kv_live_tokens`` over ``engine.kv_slot_tokens``: prompt and
generated tokens over the live slots against ``max_batch x s_max``)."""

import statistics

from pkbench.harness import spans


def read(record):
    shares = [100.0 * s["counters"]["engine.kv_live_tokens"]
              / s["counters"]["engine.kv_slot_tokens"]
              for s in spans.steps(record) or ()
              if s["counters"].get("engine.kv_slot_tokens")]
    return statistics.fmean(shares) if shares else None
