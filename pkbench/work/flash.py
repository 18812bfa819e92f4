"""Causal flash attention's forward (the port's ``flash_attention``, B7,
``flash_kernel``). Work: the two products over the causal pairs, 4 x hd
x S (S + 1) / 2 FLOPs a head and sequence; bytes: q, k, v and o (bf16)
once. Training counts one forward a step (not remat's recompute; the
backward runs outside this kernel); serving counts each prefill step's
prompts at their own lengths (decode attention is not this kernel).
"""

from __future__ import annotations

from pkbench.work._common import BF16, dims

NAMES = ("flash_kernel",)


def _seq(s: int, dm: dict) -> tuple[float, float]:
    h, kv, hd = dm["heads"], dm["kv_heads"], dm["hd"]
    return 4 * hd * h * s * (s + 1) / 2, 2 * s * hd * (2 * h + 2 * kv)


def work(record: dict):
    if record["config"]["family"] != "moe_transformer":
        return None
    dm = dims(record)
    if record["mode"] == "train":
        seqs = [record["mix"]["seq"]] * (record["mix"]["batch"]
                                         * record["steps"])
    else:
        seqs = [s for step in record["serve"]["prefill_prompts"]
                for s in step]
    fl = sum(_seq(s, dm)[0] for s in seqs) * dm["layers"]
    nb = sum(_seq(s, dm)[1] for s in seqs) * dm["layers"]
    return fl, nb, BF16
