"""The attention out-projection fused with its all-reduce over the model
axis (the port's ``matmul_ar_fused``, B4, the ``StoreAndCount``
epilogue): o (T, heads x hd) @ wo (heads x hd, d), summed over the ranks'
slices of heads x hd. Work: the whole product's 2 T (heads x hd) d FLOPs;
bytes: o and wo (bf16) once, the output (bf16) once, a call. Counted
where the cell runs the out-projection on this island
(``pk_attn_out_island`` in training, the pinned serving sites): training
one forward a call, a call for each data-parallel group of each
microbatch; serving a call a layer of each step, on its live tokens.
"""

from __future__ import annotations

from pkbench.work._common import BF16, dims, train_calls

NAMES = ("StoreAndCount",)


def _call(t: int, dm: dict) -> tuple[float, float]:
    hh, d = dm["heads"] * dm["hd"], dm["d"]
    return 2 * t * hh * d, 2 * (t * hh + hh * d + t * d)


def work(record: dict):
    cell = record["cell"]
    if record["config"]["family"] != "moe_transformer" or \
            not cell["run"].get("pk_attn_out_island", False):
        return None
    dm = dims(record)
    if record["mode"] == "train":
        n, t = train_calls(record)
        calls = [t] * (n * record["steps"])
    else:
        sv = record["serve"]
        calls = sv["decode_tokens"] + sv["prefill_tokens"]
    fl = sum(_call(t, dm)[0] for t in calls) * dm["layers"]
    nb = sum(_call(t, dm)[1] for t in calls) * dm["layers"]
    return fl, nb, BF16
