"""The head's GEMM (the port's ``matmul`` / ``matmul_stacked``, B1,
``hopper_gemm.cuh``'s ``StoreBf16`` epilogue): x (T, d) @ head (d, V),
bf16 out. Work: 2 T d V FLOPs; bytes: x, the head and the logits (bf16)
once a call. Training: the loss's forward, a call for each
data-parallel group of each microbatch (its backward runs outside this
kernel). Serving: a call a step, on the live tokens of a decode step and
on each prefilled prompt's last position.
"""

from __future__ import annotations

from pkbench.work._common import BF16, dims, train_calls

NAMES = ("StoreBf16",)


def _call(t: int, dm: dict) -> tuple[float, float]:
    d, v = dm["d"], dm["vocab"]
    return 2 * t * d * v, 2 * (t * d + d * v + t * v)


def work(record: dict):
    dm = dims(record)
    if record["mode"] == "train":
        n, t = train_calls(record)
        calls = [t] * (n * record["steps"])
    else:
        sv = record["serve"]
        calls = sv["decode_tokens"] + [len(p) for p in sv["prefill_prompts"]]
    fl = sum(_call(t, dm)[0] for t in calls)
    nb = sum(_call(t, dm)[1] for t in calls)
    return fl, nb, BF16
