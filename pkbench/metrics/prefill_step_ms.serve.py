"""Median of the engine's ``step_times`` over the window's prefill steps,
in ms."""

import statistics


def read(record):
    if record["mode"] != "serve":
        return None
    t = record["serve"]["prefill_step_s"]
    return 1e3 * statistics.median(t) if t else None
