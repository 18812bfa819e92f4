"""Percent: the selective scan's roofline bound over its device time in a
serving window (decode steps and prefills)."""

from pkbench.harness.readers import roofline_share


def read(record):
    if record["mode"] != "serve":
        return None
    return roofline_share(record, only=("scan",))
