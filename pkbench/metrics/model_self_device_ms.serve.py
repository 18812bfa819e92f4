"""Median over the window's decode steps of the model's own stream ms:
the decode forward's (span ``engine.forward``) less every island's
(``island.*``), which leaves what runs between the islands (norms, the
residual adds, the K/V re-stack of ``_serve_blocks``, the LM head)."""

from pkbench.harness import spans


def read(record):
    return spans.median(
        s["stream_ms"]["engine.forward"] - spans.stream_sum(s, "island.")
        for s in spans.timed(spans.steps(record)))
