#!/usr/bin/env python3
"""Where the Hopper GEMM's time goes: its rate against K, on one GPU.

    python3 scripts/gemm_rate_probe.py [--out gemm_rate.jsonl]

Times ``kernels/matmul.py::matmul`` and ``torch.matmul`` (a yardstick the
port never calls) at a fixed output shape while K grows, and at a few
squares, with the CUDA-event method of ``chip_smoke.py`` (``time_ms``: 20
calls queued behind a spin kernel, median of 5), operands warm. A line fit
of time against K splits the kernel's time into a part that grows with K —
its mainloop, whose slope gives the rate the tensor cores are fed at — and
a part that does not: launch, pipeline fill, the last partial wave and
each tile's epilogue. The same sweep of GEMM×RS (``matmul_rs_fused``, R =
4, at the TP pair's m = 4096, n = 2048; beside ``torch.matmul(x,
w).sum(0)``) splits its time into the mainloop and what its
store-and-count epilogue adds (the f32 partials written, counted and read
back), which does not grow with K. Prints the card's name and power
limit, one JSON line per shape, then the fits. Needs a CUDA device; exits
1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: (m, n, k): the K sweep at the AG×GEMM's gathered shape (4096 rows of
#: tinyllama's MLP gate/up, one rank's 2816 columns), then squares
SHAPES = [(4096, 2816, k) for k in (512, 1024, 2048, 4096, 8192)] + [
    (4096, 4096, 4096), (8192, 8192, 8192)]
#: GEMM×RS over R ranks at the TP pair's (m, n), k_loc from 64 to 2048
RS_RANKS, RS_M, RS_N = 4, 4096, 2048
RS_KS = (64, 256, 512, 1024, 1408, 2048)


def fit(rows, key, flops):
    """Least squares of rows' ``key`` against k: the fixed ms, the ms per
    1024 of K and the rate the slope implies for ``flops`` per unit of K."""
    ks = [r["k"] for r in rows]
    ts = [r[key] for r in rows]
    kbar, tbar = sum(ks) / len(ks), sum(ts) / len(ts)
    slope = (sum((a - kbar) * (b - tbar) for a, b in zip(ks, ts))
             / sum((a - kbar) ** 2 for a in ks))
    return {"ms_fixed": tbar - slope * kbar, "ms_per_1024_k": slope * 1024,
            "marginal_tflops": flops / slope / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_rate_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import matmul as MM

    dev = torch.device("cuda", 0)
    print(C.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for m, n, k in SHAPES:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev) * k ** -0.5
             ).to(torch.bfloat16)
        ms = C.time_ms(lambda: MM.matmul(x, w))
        lib = C.time_ms(lambda: torch.matmul(x, w))
        p = MM.plan(m, n, k, sms=MM.sm_count(dev))
        row = {"m": m, "n": n, "k": k, "block_n": p.block_n,
               "tiles": p.tiles, "grid": p.grid, "ms": ms, "library_ms": lib,
               "tflops": 2 * m * n * k / ms / 1e9,
               "library_tflops": 2 * m * n * k / lib / 1e9}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, w
    sweep = [r for r in rows if (r["m"], r["n"]) == (4096, 2816)]
    fits = [{"fit": key, **fit(sweep, key, 2 * 4096 * 2816)}
            for key in ("ms", "library_ms")]
    rs = []
    for k in RS_KS:
        x = torch.randn((RS_RANKS, RS_M, k), generator=g, device=dev
                        ).to(torch.bfloat16)
        w = (torch.randn((RS_RANKS, k, RS_N), generator=g, device=dev)
             * (RS_RANKS * k) ** -0.5).to(torch.bfloat16)
        row = {"kernel": "matmul_rs_fused", "r": RS_RANKS, "m": RS_M,
               "n": RS_N, "k": k,
               "ms": C.time_ms(lambda: CM.matmul_rs_fused(x, w)),
               "library_ms": C.time_ms(
                   lambda: torch.matmul(x, w).sum(0))}
        rs.append(row)
        print(json.dumps(row), flush=True)
        del x, w
    fits += [{"fit": f"matmul_rs_fused {key}",
              **fit(rs, key, 2 * RS_RANKS * RS_M * RS_N)}
             for key in ("ms", "library_ms")]
    rows += rs + fits
    for f in fits:
        print(json.dumps(f), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
