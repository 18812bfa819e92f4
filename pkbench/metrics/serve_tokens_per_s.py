"""Tokens the engine generated in the window (its ``tokens_generated`` at
the window's close minus at its opening) over the window's host time."""


def read(record):
    if record["mode"] != "serve":
        return None
    return record["serve"]["tokens_in_window"] / record["window_s"]
