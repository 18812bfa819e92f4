"""Median over the window's decode steps of the bytes a rank's
collectives put out, in MB (the port's counters ``comm.<op>.bytes``, by
the formulas of its comm trace)."""

from pkbench.harness import spans


def read(record):
    return spans.median(
        1e-6 * sum(v for n, v in s["counters"].items()
                   if n.startswith("comm.") and n.endswith(".bytes"))
        for s in spans.steps(record) or ())
