"""Median over the window's decode steps of the summed stream ms of every
``CommContext`` op (the port's spans ``comm.<op>.<backend>``). A fused
GEMM+collective's span holds its GEMM; on one card the virtual ranks'
collectives are HBM traffic."""

from pkbench.harness import spans


def read(record):
    return spans.median(spans.stream_sum(s, "comm.")
                        for s in spans.timed(spans.steps(record)))
