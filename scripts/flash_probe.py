#!/usr/bin/env python3
"""The flash attention kernel's time at the paths' shapes, on one GPU.

    python3 scripts/flash_probe.py [--out flash_probe.jsonl]

Times ``kernels/flash_attention.py::flash_attention`` and
``flash_attention_hop`` (B7, ``csrc/flash_attention.cu``) with the
CUDA-event method of ``chip_smoke.py`` (``time_ms``: 20 calls queued
behind a spin kernel, median of 5), operands warm, beside the mma.sync
kernel it replaced (``csrc/flash_mma_yardstick.cu``, which the port never
calls) and ``scaled_dot_product_attention`` over the same visible work (a
yardstick only). Rows: the tinyllama prefill group q(4,32,512,64)
kv(4,4,512,64) and the moonshot one q(4,16,512,128), causal, on the
head-transposed views prefill passes; the four hops of the
sequence-parallel path, q(4·1,32,2048,64) kv(4·1,4,2048,64) at the ranks'
global offsets; and two long rows where launch and the last wave matter
less (causal q(1,32,8192,64), non-causal q(4,16,2048,128)). Each row is
first held against its plain version (relative error <= 1e-2) and gives
its operations over its time (TFLOP/s of visible work) and its bound.
Prints the card's name and power limit, then one JSON line a row. Needs a
CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda", 0)
    print(CS.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []

    def row(name, run, plain, before, library, nbytes, flops, check=True):
        err = None
        if check:
            got, want = run(), plain()
            torch.cuda.synchronize()
            if isinstance(got, tuple):      # the hop: o, then l
                err = max(CS.rel_err(got[0], want[0]),
                          CS.rel_err(got[2], want[2]))
            else:
                err = CS.rel_err(got, want)
            if not err <= 1e-2:
                raise AssertionError(f"{name}: rel_err {err:.3e} > 1e-2")
        ms = CS.time_ms(run)
        b_ms, by = CS.bound_ms(nbytes, flops)
        r = {"row": name, "ms": ms, "ms_mm_tile": CS.time_ms(before),
             "library_ms": CS.time_ms(library), "bound_ms": b_ms,
             "bound_by": by, "tflops": flops / ms / 1e9, "rel_err": err}
        print(json.dumps(r), flush=True)
        rows.append(r)

    for b, hq, hkv, s, hd in ((4, 32, 4, 512, 64), (4, 16, 16, 512, 128)):
        q, k, v = (randn(b, s, h, hd).transpose(1, 2) for h in (hq, hkv, hkv))
        kr = k.repeat_interleave(hq // hkv, 1)
        vr = v.repeat_interleave(hq // hkv, 1)
        row(f"flash q({b},{hq},{s},{hd}) kv({b},{hkv},{s},{hd}) causal "
            "strided", partial(FA.flash_attention, q, k, v),
            partial(FA.flash_attention_plain, q, k, v),
            partial(CS.mm_tile_flash, q, k, v),
            partial(F.scaled_dot_product_attention, q, kr, vr,
                    is_causal=True),
            (2 * q.numel() + k.numel() + v.numel()) * 2,
            4.0 * b * hq * hd * s * (s + 1) // 2)

    r, b, hq, hkv, s, hd = 4, 1, 32, 4, 2048, 64
    q = randn(r * b, hq, s, hd)
    k, v = randn(r * b, hkv, s, hd), randn(r * b, hkv, s, hd)
    kr = k.repeat_interleave(hq // hkv, 1)
    vr = v.repeat_interleave(hq // hkv, 1)
    for hop in range(r):
        live = r if hop == 0 else r - hop
        pairs = live * s * (s + 1) // 2 if hop == 0 else live * s * s
        lo = 0 if hop == 0 else hop
        row(f"hop {hop} q({r}*{b},{hq},{s},{hd}) kv({r}*{b},{hkv},{s},{hd})",
            partial(FA.flash_attention_hop, q, k, v, ranks=r, hop=hop),
            partial(FA.flash_attention_hop_plain, q, k, v, ranks=r, hop=hop),
            partial(CS.mm_tile_flash_hop, q, k, v, r, hop),
            partial(F.scaled_dot_product_attention, q[lo:], kr[lo:], vr[lo:],
                    is_causal=hop == 0),
            live * b * (hq + 2 * hkv) * s * hd * 2
            + r * b * hq * s * (hd + 2) * 4,
            4.0 * b * hq * hd * pairs, check=hop == 1)
    del q, k, v, kr, vr

    for b, hq, s, hd, causal in ((1, 32, 8192, 64, True),
                                 (4, 16, 2048, 128, False)):
        q, k, v = (randn(b, hq, s, hd) for _ in range(3))
        pairs = s * (s + 1) // 2 if causal else s * s
        row(f"flash q({b},{hq},{s},{hd}) {'causal' if causal else 'full'}",
            partial(FA.flash_attention, q, k, v, causal=causal),
            partial(FA.flash_attention_plain, q, k, v, causal=causal),
            partial(CS.mm_tile_flash, q, k, v, causal),
            partial(F.scaled_dot_product_attention, q, k, v,
                    is_causal=causal),
            4 * q.numel() * 2, 4.0 * b * hq * hd * pairs, check=False)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
