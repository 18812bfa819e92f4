"""Percent: the routed experts' grouped GEMM's roofline bound over its
device time in a serving window."""

from pkbench.harness.readers import roofline_share


def read(record):
    if record["mode"] != "serve":
        return None
    return roofline_share(record, only=("grouped_gemm",))
