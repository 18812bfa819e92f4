"""Seconds from the process's start to the window's opening: imports,
weights, layout, the kernels' build or load, warm-up."""


def read(record):
    return record["setup_s"]
