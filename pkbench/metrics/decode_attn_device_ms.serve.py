"""Median over the window's decode steps of the stream ms of the decode
attention island (the port's span ``island.decode_attn``, summed over the
layers): its slab write, cast and mix."""

from pkbench.harness import spans


def read(record):
    return spans.stream_median(record, "island.decode_attn")
