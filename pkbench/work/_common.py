"""What the work formulas share: the H100's published peaks and the
configuration's sizes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit), as the port's ``PERF.md`` §6 bounds use them: 989 TFLOP/s bf16
on the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM.
A kernel's bound is the larger of its operations over the peak and its
bytes over the bandwidth (each input byte counted once, each output byte
once, the work these inputs need, not padding or capacity slots).
"""

from __future__ import annotations

import importlib

BF16 = 989e12
F32 = 67e12
HBM = 3.35e12


def dims(record: dict) -> dict:
    cfg = record["config"]
    return importlib.import_module(
        f"pkbench.reference.{cfg['family']}").dims(cfg)


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM)


def train_calls(record: dict) -> tuple[int, int]:
    """(calls a step of a per-group, per-microbatch kernel, tokens a
    call): a training step runs such a kernel once for each data-parallel
    group of each microbatch."""
    cell, mix = record["cell"], record["mix"]
    g = cell["mesh"][0] if cell.get("mesh") else 1
    nm = cell["run"].get("microbatches", 1)
    return g * nm, mix["batch"] * mix["seq"] // (g * nm)


def model_flops_per_token(record: dict) -> float:
    """Model FLOPs a trained token: 6 x the matrix-multiply weights a token
    uses (active experts and the head included, the embedding lookup not),
    plus the sequence mixing: causal attention's 2 x 2 x hd x heads x the
    mean context (S + 1) / 2 a layer, or the scan's 7 x di x N and the
    conv's 2 x di x ck a layer, times 3 for forward and backward. No
    recompute is counted."""
    dm = dims(record)
    s = record["mix"]["seq"]
    return 3 * forward_flops_per_token(record["config"]["family"], dm,
                                       (s + 1) / 2)


def forward_flops_per_token(family: str, dm: dict, ctx: float) -> float:
    """Forward model FLOPs of one token at mean attended context ``ctx``
    (the head included)."""
    d, v, L = dm["d"], dm["vocab"], dm["layers"]
    if family == "moe_transformer":
        h, kv, hd = dm["heads"], dm["kv_heads"], dm["hd"]
        per_layer = (2 * d * (2 * h * hd + 2 * kv * hd)
                     + 2 * d * dm["experts"]
                     + 2 * dm["top_k"] * 3 * d * dm["ff"]
                     + 4 * h * hd * ctx)
    elif family == "mamba":
        di, n, r, ck = dm["di"], dm["n"], dm["dtr"], dm["ck"]
        per_layer = (2 * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
                     + 7 * di * n + 2 * di * ck)
    else:
        raise ValueError(family)
    return L * per_layer + 2 * d * v
