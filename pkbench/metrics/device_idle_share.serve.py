"""Percent of the traced window in which no device work ran (1 - the
union of device activity over the window's wall time)."""

from pkbench.harness.readers import idle_share


def read(record):
    return idle_share(record) if record["mode"] == "serve" else None
