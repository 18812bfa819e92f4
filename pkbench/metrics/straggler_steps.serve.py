"""Steps of the window that the engine's straggler watchdog flagged (the
port's counter ``engine.straggler_steps``): steps over three times the
moving average of the step time."""

from pkbench.harness import spans


def read(record):
    recs = spans.steps(record, None)
    if recs is None:
        return None
    return sum(s["counters"].get("engine.straggler_steps", 0) for s in recs)
