"""Percent: the selective scan's forward and backward roofline bounds over
their device time in a training window."""

from pkbench.harness.readers import roofline_share


def read(record):
    if record["mode"] != "train":
        return None
    return roofline_share(record, only=("scan", "scan_bwd"))
