"""Helpers of the metric readers (``pkbench/metrics/<name>.py``)."""

from __future__ import annotations

from pkbench.harness import spec, trace
from pkbench.work import _common


def roofline_share(record: dict, only=None):
    """Percent: the summed roofline bounds of the kernel families of
    ``pkbench/work/`` (or those named in ``only``) that ran in the traced
    window, over the summed device time of their kernels; None when none
    ran or the run was not traced."""
    t = record.get("trace")
    if not t:
        return None
    bound = busy = 0.0
    for name, mod in spec.families():
        if only is not None and name not in only:
            continue
        w = mod.work(record)
        ft = trace.family_time(t["kernels"], mod.NAMES)
        if w is None or ft <= 0:
            continue
        bound += _common.bound_s(*w)
        busy += ft
    return 100.0 * bound / busy if busy > 0 else None


def idle_share(record: dict):
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
