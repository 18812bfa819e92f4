"""Percent: the kernel families' summed roofline bounds over their summed
device time in a training window (``pkbench/work/``)."""

from pkbench.harness.readers import roofline_share


def read(record):
    return roofline_share(record) if record["mode"] == "train" else None
