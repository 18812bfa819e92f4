"""The routed experts' grouped GEMM (the port's ``grouped_matmul``, B9,
``hopper_gemm.cuh``'s ``StoreGrouped`` epilogue): the forward of every
expert layer, x @ w1, x @ w3 (f32 out) and SiLU(.)*(.) @ w2 (f32 out).

Routing decides the work. It is counted as every token's top-k
assignments, T x k rows of the three products, whether or not an expert's
capacity drops them and however many capacity slots the kernel computes.
Bytes: the assigned rows of x (bf16) once, every expert's three weights
(bf16) once a call, the two f32 outputs of w1 and w3, the bf16 input and
f32 output of w2. Training counts one forward a step (not remat's
recompute; the backward runs outside this kernel). Serving counts each
decode step's live tokens and each prefill step's prompt tokens.
"""

from __future__ import annotations

from pkbench.work._common import BF16, dims, train_calls

NAMES = ("StoreGrouped",)


def _call(a: int, dm: dict) -> tuple[float, float]:
    d, f, e = dm["d"], dm["ff"], dm["experts"]
    flops = 2 * a * d * f * 3
    nbytes = a * d * 2 + 3 * e * d * f * 2 + 2 * a * f * 4 + a * f * 2 \
        + a * d * 4
    return flops, nbytes


def work(record: dict):
    if record["config"]["family"] != "moe_transformer":
        return None
    dm = dims(record)
    k, L = dm["top_k"], dm["layers"]
    calls = []
    if record["mode"] == "train":
        n, t = train_calls(record)
        calls = [t * k] * (n * L * record["steps"])
    else:
        sv = record["serve"]
        calls = [x * k for x in sv["decode_tokens"] + sv["prefill_tokens"]
                 for _ in range(L)]
    flops = sum(_call(a, dm)[0] for a in calls)
    nbytes = sum(_call(a, dm)[1] for a in calls)
    return flops, nbytes, BF16
