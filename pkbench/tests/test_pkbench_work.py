"""The kernel families' work formulas against a hand count at one shape."""

import pkbench_tiny  # noqa: F401  (puts the repository on the path)
import pytest

from pkbench.harness import spec

MOON = spec.load("configs", "moonshot-v1-16b-a3b-4l")
FALCON = spec.load("configs", "falcon-mamba-7b-16l")


def _work(name, record):
    return spec.module("work", name).work(record)


def _serve(config, decode, prompts):
    return {"mode": "serve", "config": config, "cell": {"run": {
        "pk_attn_out_island": True}}, "mix": {},
        "serve": {"decode_tokens": decode, "prefill_prompts": prompts,
                  "prefill_tokens": [sum(p) for p in prompts]}}


def _train(config, steps, run):
    return {"mode": "train", "config": config, "steps": steps,
            "mix": {"batch": 8, "seq": 512},
            "cell": {"mesh": [2, 4], "run": run}}


def test_lm_head():
    d, v = 2048, 163840
    fl, nb, peak = _work("lm_head", _serve(MOON, [64], [[100, 200]]))
    # a decode step of 64 tokens, a prefill step's 2 last positions
    assert fl == 2 * 64 * d * v + 2 * 2 * d * v
    assert nb == 2 * (64 * d + d * v + 64 * v) + 2 * (2 * d + d * v + 2 * v)
    assert peak == 989e12
    fl, nb, _ = _work("lm_head", _train(MOON, 3, {"microbatches": 2}))
    t = 8 * 512 // 4                     # a call: one group, one microbatch
    assert fl == 12 * 2 * t * d * v
    assert nb == 12 * 2 * (t * d + d * v + t * v)


def test_grouped_gemm_counts_routed_tokens_not_capacity():
    d, f, e, k = 2048, 1408, 64, 6
    fl, nb, _ = _work("grouped_gemm", _train(MOON, 1, {"microbatches": 2}))
    a = 1024 * k
    per_call_b = a * d * 2 + 3 * e * d * f * 2 + 2 * a * f * 4 + a * f * 2 \
        + a * d * 4
    assert fl == 4 * 4 * 2 * a * d * f * 3    # 4 layers x 4 calls
    assert nb == 4 * 4 * per_call_b
    assert _work("grouped_gemm", _train(FALCON, 1, {})) is None


def test_flash_causal_pairs():
    h, hd = 16, 128
    fl, nb, _ = _work("flash", _serve(MOON, [64], [[4]]))
    assert fl == 4 * 4 * hd * h * 4 * 5 / 2   # 4 layers, S = 4: 10 pairs
    assert nb == 4 * 2 * 4 * hd * 4 * h


def test_gemm_ar():
    d = 2048
    fl, nb, _ = _work("gemm_ar", _serve(MOON, [10], []))
    assert fl == 4 * 2 * 10 * d * d
    assert nb == 4 * 2 * (10 * d + d * d + 10 * d)
    assert _work("gemm_ar", _train(MOON, 1, {})) is None


def test_scan_forward_and_backward():
    di, n, L = 8192, 16, 16
    fl, nb, peak = _work("scan", _serve(FALCON, [3], [[100]]))
    tok = 3 + 100
    assert fl == L * 7 * tok * di * n
    assert nb == L * ((3 * (10 * di + 4 * n) + di * n * 4 + 3 * 2 * di * n * 4)
                      + (100 * (10 * di + 4 * n) + di * n * 4
                         + 2 * di * n * 4))
    assert peak == 67e12
    fl, nb, _ = _work("scan_bwd", _train(FALCON, 2, {}))
    tok = 2 * 8 * 512
    assert fl == L * 14 * tok * di * n
    assert nb == L * (tok * (18 * di + 12 * n) + 2 * 2 * di * n * 4)


def test_families_are_found_by_their_files():
    names = [n for n, _ in spec.families()]
    assert names == sorted(names)
    assert {"flash", "gemm_ar", "grouped_gemm", "lm_head", "scan",
            "scan_bwd"} <= set(names)
    assert all(hasattr(m, "NAMES") for _, m in spec.families())


@pytest.mark.parametrize("name", ["lm_head", "grouped_gemm", "flash",
                                  "gemm_ar", "scan", "scan_bwd"])
def test_no_work_when_nothing_ran(name):
    r = _serve(MOON if name != "scan" else FALCON, [], [])
    w = _work(name, r)
    assert w is None or (w[0] == 0 and w[1] == 0)
