"""Percent: the kernel families' summed roofline bounds over their summed
device time in a serving window (``pkbench/work/``)."""

from pkbench.harness.readers import roofline_share


def read(record):
    return roofline_share(record) if record["mode"] == "serve" else None
