"""The numbers that decide ``correct``, each compared with its limit.

Training (``train_numbers``): the widest relative gap of the three first
steps' losses; and, by the worst weight, the gap between the program's and
the reference's norm of step 0's gradient as the update used it, and of
each weight's change after three steps, each measured against the
reference's norm of that weight or of the median weight, whichever is
larger. A weight whose reference gradient is under a thousandth of the
median weight's moves by round-off alone and is left out of the change.

Serving: the amount by which a served token's logit lies below the
reference's largest logit at its position, its widest over the sampled
tokens (``served_logit_gap``), its mean (``served_logit_gap_mean``) and
the share of positions where it is over 0.1
(``served_logit_gap_share_over_0.1``).
A cell's ``limits`` name the numbers that decide its ``correct``.
"""

from __future__ import annotations

import math
import statistics


def _worst(prog: dict, ref: dict, keep) -> float:
    keys = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(program: dict, reference: dict) -> dict:
    lp, lr = program["losses"], reference["losses"]
    g_ref = reference["grad_norms"]
    g_med = statistics.median(g_ref.values())
    if set(program["grad_norms"]) != set(g_ref):
        raise ValueError("the program's weights are not the reference's: "
                         f"{sorted(set(program['grad_norms']) ^ set(g_ref))}")
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
        "grad_gap": _worst(program["grad_norms"], g_ref, lambda k: True),
        "change_gap": _worst(program["change_norms"],
                             reference["change_norms"],
                             lambda k: g_ref[k] >= 1e-3 * g_med),
    }


def judge(compared: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    ``limits`` name: each finite and at most its limit. A cell without
    limits, or a limit on a number the run did not produce, is not
    correct."""
    out, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = compared.get(name, math.nan)
        out[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, out
