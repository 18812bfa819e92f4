"""Percent of the H100's bf16 peak: the forward model FLOPs of the prompt
tokens prefilled in the window (their real lengths, each at its causal
mean context, the head once a prompt) and of the tokens decoded (each at
its context), over the window."""

from pkbench.work._common import BF16, dims, forward_flops_per_token


def read(record):
    if record["mode"] != "serve":
        return None
    fam, dm = record["config"]["family"], dims(record)
    head = 2 * dm["d"] * dm["vocab"]
    sv = record["serve"]
    fl = 0.0
    for step in sv["prefill_prompts"]:
        for s in step:
            fl += s * (forward_flops_per_token(fam, dm, (s + 1) / 2) - head)
            fl += head
    for ctx in sv["decode_contexts"]:
        fl += forward_flops_per_token(fam, dm, ctx)
    return 100.0 * fl / record["window_s"] / BF16
