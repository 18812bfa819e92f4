"""Median of the engine's ``step_times`` over the window's decode steps,
in ms (host time of a step that ends in a device->host read)."""

import statistics


def read(record):
    if record["mode"] != "serve":
        return None
    t = record["serve"]["decode_step_s"]
    return 1e3 * statistics.median(t) if t else None
