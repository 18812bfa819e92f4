"""Median over the window's decode steps of the stream ms of the MoE
island (the port's span ``island.moe``, summed over the layers)."""

from pkbench.harness import spans


def read(record):
    return spans.stream_median(record, "island.moe")
