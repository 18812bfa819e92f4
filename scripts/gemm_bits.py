#!/usr/bin/env python3
"""Digests of the Hopper GEMM kernels' outputs on seeded inputs, on one GPU.

    python3 scripts/gemm_bits.py [--src DIR] [--out FILE]
    python3 scripts/gemm_bits.py --compare A.json B.json

Runs B1 (``matmul``, single and stacked), B5 (``ag_matmul_fused``), B6
(``matmul_rs_fused``), B4 (``matmul_ar_fused``) and B9 (``grouped_matmul``,
f32 and bf16 out) of the port found under
``DIR`` (default: this checkout's ``src/``) at the shapes ``chip_smoke.py``
times and two ragged ones, on inputs made on the card from seed 0, and
prints the card's name and power limit, then one JSON object: a SHA-256
digest of each output's bytes. Two checkouts print the same digests
exactly when their kernels give the same bits, so running it on a parent
tree and on a change shows whether a change to the shared mainloop moved
any of these kernels' bits. Needs a CUDA device; exits 1 without one.
``--compare`` reads two files written by ``--out`` and prints whether
their digests (only those: each file also names its own tree) are equal;
it exits 1 when they differ and needs no device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (m, k, n) of B1 single, then (m, k, n, R) of B1 stacked
MATMUL = [(8, 2048, 8000), (1024, 2048, 8000), (2048, 2048, 1408),
          (200, 264, 136), (65, 40, 72)]
STACKED = [(8, 2048, 8000, 4), (1024, 2048, 8000, 4)]
#: (R, m, k, n) of B5; of B6 and B4
AG = [(4, 1024, 2048, 2816), (4, 100, 264, 200)]
REDUCE = [(4, 4096, 1408, 2048), (4, 2048, 1408, 2048), (4, 8, 1408, 2048),
          (4, 200, 136, 120)]
#: (G, C, K, N) of B9: the MoE path's decode and 512-bucket w1, a ragged one
GROUPED = [(64, 1, 2048, 1408), (64, 240, 2048, 1408), (5, 70, 136, 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory whose repro_torch runs")
    ap.add_argument("--out", default=None, help="also write the JSON line")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare the digests of two --out files")
    args = ap.parse_args()
    if args.compare:
        a, b = ([json.loads(line) for line in open(f) if line.strip()][-1]
                ["digests"] for f in args.compare)
        same = sum(a[k] == b.get(k) for k in a)
        print(f"digests equal {a == b}: {same} of {len(a)} the same "
              f"({len(b)} in B)", flush=True)
        return 0 if a == b else 1
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("gemm_bits: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import matmul as MM

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    out = {}
    for m, k, n in MATMUL:
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        out[f"matmul x({m},{k})@w({k},{n})"] = digest(MM.matmul(x, w))
    for m, k, n, r in STACKED:
        x, w = randn(m, k), randn(r, k, n, scale=k ** -0.5)
        out[f"matmul_stacked x({m},{k})@w({r},{k},{n})"] = digest(
            MM.matmul_stacked(x, w))
    for r, m, k, n in AG:
        x, w = randn(r, m, k), randn(r, k, n, scale=k ** -0.5)
        out[f"ag_matmul_fused x({r},{m},{k})@w({r},{k},{n})"] = digest(
            CM.ag_matmul_fused(x, w))
    for r, m, k, n in REDUCE:
        x, w = randn(r, m, k), randn(r, k, n, scale=(r * k) ** -0.5)
        shape = f"x({r},{m},{k})@w({r},{k},{n})"
        out[f"matmul_rs_fused {shape}"] = digest(CM.matmul_rs_fused(x, w))
        out[f"matmul_ar_fused {shape}"] = digest(CM.matmul_ar_fused(x, w))
    for gs, c, k, n in GROUPED:
        x, w = randn(gs, c, k), randn(gs, k, n, scale=k ** -0.5)
        for dt in (torch.float32, torch.bfloat16):
            out[f"grouped_matmul x({gs},{c},{k})@w({gs},{k},{n}) {dt}"] = \
                digest(GM.grouped_matmul(x, w, out_dtype=dt))
    line = json.dumps({"src": os.path.abspath(args.src), "digests": out})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
