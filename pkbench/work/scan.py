"""The selective scan's forward (the port's ``mamba_scan``, B10,
``pk_scan_direct_kernel`` / ``pk_scan_staged_kernel``). Per token and
inner channel: dt (f32), x (bf16) read, y (f32) written; per token B and
C (bf16, N each) read; A (f32, di x N) read once a call; the state (f32,
di x N a sequence) read and written once a call. FLOPs: 7 a state element
and token (the exponential counted as one), against the float32 peak.
Training counts one forward a layer and step (not remat's recompute) on
the step's B x S tokens; serving counts each decode step's live tokens
(one position, the state read and written) and each prefilled prompt.
"""

from __future__ import annotations

from pkbench.work._common import F32, dims

NAMES = ("pk_scan_direct_kernel", "pk_scan_staged_kernel")


def _seqs(seqs, dm) -> tuple[float, float]:
    di, n = dm["di"], dm["n"]
    tok = sum(seqs)
    fl = 7 * tok * di * n
    nb = tok * (10 * di + 4 * n) + di * n * 4 + len(seqs) * 2 * di * n * 4
    return fl, nb


def work(record: dict):
    if record["config"]["family"] != "mamba":
        return None
    dm = dims(record)
    if record["mode"] == "train":
        mix = record["mix"]
        seqs = [mix["seq"]] * mix["batch"]
        calls = [seqs] * record["steps"]
    else:
        sv = record["serve"]
        calls = [[1] * t for t in sv["decode_tokens"]] + \
            [list(p) for p in sv["prefill_prompts"]]
    fl = nb = 0.0
    for seqs in calls:
        f, b = _seqs(seqs, dm)
        fl, nb = fl + f, nb + b
    return fl * dm["layers"], nb * dm["layers"], F32
