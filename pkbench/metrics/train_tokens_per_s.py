"""Tokens of every training step the window completed, over the window's
host time (the window ends in a synchronize)."""


def read(record):
    if record["mode"] != "train":
        return None
    return record["tokens"] / record["window_s"]
