"""Median over the window's decode steps of the host ms of the decode
forward (the port's span ``engine.forward``): the time the host takes to
queue a step's device work."""

from pkbench.harness import spans


def read(record):
    return spans.median(s["host_ms"].get("engine.forward")
                        for s in spans.steps(record) or ())
