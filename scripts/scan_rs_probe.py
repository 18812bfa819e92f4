#!/usr/bin/env python3
"""The reduce-scatter (B3's RS) and selective-scan (B10) kernels at the
paths' shapes, on one GPU.

    python3 scripts/scan_rs_probe.py [--out probe.jsonl] [--quick]
                                     [--variants]

Each kernel is first held against its plain version: the reduce-scatter
bit for bit (``reduce_scatter_plain`` and the store-and-count kernel it
replaced, ``csrc/pk_comm_yardstick.cu``) at R = 2, 4, 8 for n_chunks 1-4;
the scan's y and last state within relative 1e-3 of ``mamba_scan_plain``,
and bit-identical over chunk 1, 64, 256 and over S + 4 steps against S
steps then 4 single (decode-path) steps chained through h0. Then, unless
``--quick``, each row is timed with the CUDA-event method of
``chip_smoke.py`` (``time_ms``: 20 calls queued behind a spin kernel,
median of 5), operands warm, beside the kernel it replaced
(``ms_mm_tile``), one PyTorch call where one computes the same function
(``sum(0)`` for the RS), its bound (bytes over 3.35 TB/s or f32 operations
over 67 TFLOP/s) and, for the scan, its exponential floor (B·S·D·N
exponentials at 16 an SM a clock, at the card's highest SM clock as
``nvidia-smi`` reports it). ``--variants`` also times the launch's design
choices at the timed rows (RS: blocks an SM, bytes a stage, stages; scan:
channels a block, steps a stage, stages), each by setting the plan's
constants in its module for the timing (``constants``) and calling the
wrapper. Prints the card's name and power limit, then one JSON line a row.
Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def constants(module, **values):
    """Set ``module``'s constants to ``values`` inside the block; restore
    them after."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines")
    ap.add_argument("--quick", action="store_true",
                    help="check the kernels, time nothing")
    ap.add_argument("--variants", action="store_true",
                    help="also time the launch's design choices")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_rs_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import pk_comm as PK

    dev = torch.device("cuda", 0)
    print(CS.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = CS.max_sm_clock_mhz()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def emit(r):
        print(json.dumps(r), flush=True)
        rows.append(r)

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    # -- reduce-scatter --
    rs_shapes = [(2, 1024, 64), (2, 1024, 512), (2, 1024, 1408),
                 (2, 1024, 8000), (4, 512, 1408), (8, 256, 1408),
                 (2, 5, 7), (3, 3, 24)]
    for r, rows_, n in rs_shapes:
        for dtype in ((torch.bfloat16, torch.float32) if n == 1408 and r == 2
                      else (torch.bfloat16,)):
            x = torch.randn((r, r, rows_, 4, n), generator=g, device=dev
                            ).to(dtype)
            want = PK.reduce_scatter_plain(x)
            before = CS.mm_tile_reduce_scatter(x)
            for nc in (1, 2, 3, 4):
                got = PK.ring_reduce_scatter(x, n_chunks=nc)
                torch.cuda.synchronize()
                if not (same_bits(got, want) and same_bits(got, before)):
                    raise AssertionError(f"RS x{tuple(x.shape)} {dtype} "
                                         f"n_chunks={nc}: bits differ")
            blk = rows_ * 4 * n
            p = PK.rs_plan(r, blk, blk, x.element_size(),
                           aligned=blk * x.element_size() % 16 == 0, sms=sms)
            row = {"kernel": "ring_reduce_scatter",
                   "shape": f"x{tuple(x.shape)} {str(dtype)[6:]}",
                   "plan": dataclasses.asdict(p), "bit_identical": True}
            timed = (n in (1408, 8000) and r * rows_ * 4 * n > 1 << 20)
            if timed and not args.quick:
                nbytes = (r * r + r) * blk * x.element_size()
                row.update(
                    ms=CS.time_ms(partial(PK.ring_reduce_scatter, x)),
                    ms_mm_tile=CS.time_ms(
                        partial(CS.mm_tile_reduce_scatter, x)),
                    library_ms=CS.time_ms(lambda: x.sum(0)),
                    bound_ms=CS.bound_ms(nbytes, 0.0)[0])
            emit(row)
            if (args.variants and not args.quick and (r, n) == (2, 1408)
                    and dtype == torch.bfloat16):
                run = partial(PK.ring_reduce_scatter, x)
                for per_sm in (1, 2):
                    for stage_bytes in (16384, 32768, 65536):
                        for stages in (2, 3, 4):
                            with constants(PK, RS_PER_SM=per_sm,
                                           RS_STAGE_BYTES=stage_bytes,
                                           RS_STAGES=stages):
                                v = PK.rs_plan(r, blk, blk, 2, aligned=True,
                                               sms=sms)
                                if v.smem_bytes > PK.SMEM_LIMIT:
                                    continue
                                if not same_bits(run(), want):
                                    raise AssertionError(f"RS variant {v}")
                                ms = CS.time_ms(run)
                            emit({"kernel": "ring_reduce_scatter variant",
                                  "shape": row["shape"], "per_sm": per_sm,
                                  "stage_bytes": stage_bytes,
                                  "stages": stages, "plan":
                                  dataclasses.asdict(v), "ms": ms})
            del x

    # -- selective scan --
    d, n, rk = 8192, 16, 4

    def inputs(b, s, d=d, n=n):
        def f(*sh):
            return torch.randn(sh, generator=g, device=dev)
        h0 = f(b, d, n).unflatten(1, (rk, d // rk)).movedim(1, 0).contiguous()
        return (torch.nn.functional.softplus(f(b, s, d) - 2.0),
                f(b, s, n).to(torch.bfloat16), f(b, s, n).to(torch.bfloat16),
                f(b, s, d).to(torch.bfloat16), -torch.exp(f(d, n)), h0)

    for b, s in ((4, 60), (4, 174), (4, 405), (1, 405), (8, 1)):
        a_ = inputs(b, s)
        y, h = MS.mamba_scan(*a_)
        wy, wh = MS.mamba_scan_plain(*a_)
        errs = (CS.rel_err(y, wy), CS.rel_err(h, wh))
        if not max(errs) <= 1e-3:
            raise AssertionError(f"scan ({b}, {s}): rel_err {errs}")
        p = MS.scan_plan(b, s, d, n, 2, tma_ok=MS._tma_ok(*a_[:4]), sms=sms)
        row = {"kernel": "mamba_scan",
               "shape": f"dt({b},{s},{d}) f32, x/b/c bf16, N={n}",
               "plan": dataclasses.asdict(p), "rel_err_y": errs[0],
               "rel_err_h": errs[1]}
        if not args.quick:
            nbytes = b * s * d * (4 + 2 + 4) + 2 * b * s * n * 2 \
                + d * n * 4 + 2 * b * d * n * 4
            row.update(
                ms=CS.time_ms(lambda: MS.mamba_scan(*a_)),
                ms_mm_tile=CS.time_ms(lambda: CS.mm_tile_mamba_scan(*a_)),
                bound_ms=CS.bound_ms(nbytes, 7.0 * b * s * d * n,
                                     CS.PEAK_F32_FLOPS)[0],
                exp_floor_ms=CS.exp_floor_ms(b, s, d, n, sms, clock),
                max_sm_clock_mhz=clock)
        emit(row)
        if args.variants and not args.quick and (b, s) == (4, 405):
            fn = partial(MS.mamba_scan, *a_, chunk=256)
            for ch in (64, 128):
                for run in (16, 32, 64):
                    for stages in (2, 3, 4):
                        with constants(MS, CHANNELS=(ch, ch), RUN_MAX=run,
                                       STAGES=stages):
                            v = MS.scan_plan(b, s, d, n, 2, chunk=256,
                                             sms=sms)
                            if v.smem_bytes > MS.SMEM_LIMIT:
                                continue
                            if not torch.equal(fn()[0], y):
                                raise AssertionError(f"scan variant {v}")
                            ms = CS.time_ms(fn)
                        emit({"kernel": "mamba_scan variant",
                              "shape": row["shape"], "channels": ch,
                              "run": run, "stages": stages,
                              "smem_bytes": v.smem_bytes, "ms": ms})
        del a_

    # bit identity: every chunk, and S + 4 steps against S then 4 chained
    # single steps (the direct kernel), at D = 512 and at full width
    for b, s, dd, k in ((2, 61, 512, 4), (4, 170, 8192, 4)):
        dt, bm, cm, x, a, h0 = inputs(b, s + k, dd)
        full = MS.mamba_scan(dt, bm, cm, x, a, h0)
        for chunk in (1, 64, 256):
            yc, hc = MS.mamba_scan(dt, bm, cm, x, a, h0, chunk=chunk)
            if not (same_bits(yc, full[0]) and same_bits(hc, full[1])):
                raise AssertionError(f"scan: chunk={chunk} changed the bits")
        yc, hc = MS.mamba_scan(dt[:, :s], bm[:, :s], cm[:, :s], x[:, :s], a,
                               h0)
        ys = [yc]
        for i in range(s, s + k):
            yc, hc = MS.mamba_scan(dt[:, i:i + 1], bm[:, i:i + 1],
                                   cm[:, i:i + 1], x[:, i:i + 1], a, hc)
            ys.append(yc)
        if not (same_bits(torch.cat(ys, 1), full[0])
                and same_bits(hc, full[1])):
            raise AssertionError("scan: S + k steps differ from S then k "
                                 "chained single steps")
        emit({"kernel": "mamba_scan", "check": f"bit-identical for chunk 1, "
              f"64, 256 and {s} + {k} chained, B={b} D={dd}"})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
