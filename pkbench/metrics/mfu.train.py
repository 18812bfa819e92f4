"""Percent of the H100's bf16 peak: model FLOPs a token
(``work/_common.model_flops_per_token``) times the window's tokens a
second."""

from pkbench.work._common import BF16, model_flops_per_token


def read(record):
    if record["mode"] != "train":
        return None
    rate = record["tokens"] / record["window_s"]
    return 100.0 * model_flops_per_token(record) * rate / BF16
