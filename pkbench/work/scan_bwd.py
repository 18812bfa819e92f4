"""The selective scan's backward (the port's ``mamba_scan_bwd``, B10-bwd,
``pk_scan_bwd_kernel`` and the ``pk_sum_mid_kernel`` that sums its
partials). Per token and inner channel: dt (f32), x (bf16) and dy (f32)
read, ddt and dx (f32) written; per token B and C (bf16) read and their
gradients (f32) written; A read and its gradient written once a call (f32,
di x N). FLOPs: 14 a state element and token (the forward's recurrence
again and its adjoint), against the float32 peak. Training only: one a
layer and step on the step's B x S tokens.
"""

from __future__ import annotations

from pkbench.work._common import F32, dims

NAMES = ("pk_scan_bwd_kernel", "pk_sum_mid_kernel")


def work(record: dict):
    if record["config"]["family"] != "mamba" or record["mode"] != "train":
        return None
    dm = dims(record)
    di, n = dm["di"], dm["n"]
    tok = record["mix"]["batch"] * record["mix"]["seq"] * record["steps"]
    fl = 14 * tok * di * n
    nb = tok * (18 * di + 12 * n) + record["steps"] * 2 * di * n * 4
    return fl * dm["layers"], nb * dm["layers"], F32
