#!/usr/bin/env python3
"""The ring all-gather (B3's AG), the p2p ring shift (B8) and the LCSC
ring all-gather (B11) kernels at the paths' shapes, on one GPU.

    python3 scripts/ag_p2p_probe.py [--out probe.jsonl] [--quick]
                                    [--variants]

Each kernel is first held against its plain version, bit for bit, and
against the kernel it ran on before (``csrc/pk_comm_yardstick.cu``, the
wrappers ``mm_tile_all_gather`` and ``mm_tile_p2p_ring_shift`` of
``chip_smoke.py``): the all-gather at every FSDP weight of the (2, 4)
tinyllama-1.1b training run, through the path's strided ``dp_view`` into
``all_gather_stacked(..., "fused")`` (rows and columns, R = 2 and 4, into
a contiguous output and into the memory order ``fsdp_gather`` gives it),
and
at the contiguous (R, blk, ...) layout at R = 2, 4, 8 for n_chunks 1-4; the
p2p shift at the SP path's k (4, 1, 4, 2048, 64) bf16 and ragged shapes
over three launches, the flags reaching the wrapper's count each time.
Then, unless ``--quick``, each row is timed with the CUDA-event method of
``chip_smoke.py`` (``time_ms``), operands warm, beside the kernel it
replaced (``ms_mm_tile``), one PyTorch call of the same function
(``repeat``, ``torch.roll``), its bound (bytes over 3.35 TB/s) and, for
the path form and the p2p row, the host time of a call's enqueue beside
the earlier kernel's (``host_us``, ``host_us_mm_tile``). The
path form times what an FSDP gather of the MLP weight w (4, 2048, 1408)
costs, copies included: the kernel's ``all_gather_stacked`` and one dp
group's ``.contiguous()`` (a no-op now), beside the same call on the
kernel it ran on before behind its wrapper (a copy before, a strided view
after, which the group's ``.contiguous()`` copies) and beside the ``bulk``
backend. ``--variants`` also times the launch's design choices (AG: bytes
a tile, stages, blocks an SM; p2p: bytes a tile, blocks an SM), each by
setting the plan's constants in ``kernels/pk_comm.py`` for the timing
(``constants``) and calling the wrapper. The LCSC all-gather is held, over
three launches a shape, against its plain version and the step-synchronous
kernel it ran on before (``csrc/lcsc_yardstick.cu``, the wrapper
``mm_tile_lcsc_all_gather`` of ``chip_smoke.py``), its flags holding each
launch's epoch; the MLP shard over R = 2, 4 and 8 is timed beside the
yardstick, ``repeat``, the gather's bound and the ring's own floor (R (R -
1) blk read, R² blk written), with both wrappers' host enqueue times;
``--variants`` sweeps bytes a tile, stages and blocks an SM at R = 2 and 8
(``kernels/lcsc.py``'s constants). Prints the card's name and power
limit, then one JSON line a row. Needs a CUDA device; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

#: full-width tinyllama-1.1b's FSDP-sharded weights, tp-stacked over 4
#: ranks as stored, and the stored dim their gather runs along: rows (wq,
#: wk/wv, w1/w3, head) and columns (wo, w2, emb)
FSDP_WEIGHTS = [((4, 2048, 512), 1), ((4, 2048, 64), 1),
                ((4, 2048, 1408), 1), ((4, 2048, 8000), 1),
                ((4, 512, 2048), 2), ((4, 1408, 2048), 2),
                ((4, 8000, 2048), 2)]


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
        print("ag_p2p_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from repro_torch.core import pgl
    from repro_torch.core.comms import all_gather_stacked
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    from scan_rs_probe import constants

    dev = torch.device("cuda", 0)
    print(CS.card_line(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    timing = not args.quick

    def emit(r):
        print(json.dumps(r), flush=True)
        rows.append(r)

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    def host_us(fn, n=200):
        """Host time of one call's enqueue, the device kept busy by a spin
        kernel so that no call waits on it."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return dt

    def randn(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * 50).to(dtype)

    def ag_variants():
        for stage_bytes in (16384, 32768, 65536):
            for stages in (2, 3, 4):
                for per_sm in (1, 2):
                    yield dict(AG_STAGE_BYTES=stage_bytes, AG_STAGES=stages,
                               AG_PER_SM=per_sm)

    # -- all-gather: the FSDP path's strided views --
    for stored, sdim in FSDP_WEIGHTS:
        for r in (2, 4):
            w = randn(*stored)
            x = pgl.dp_view(w, sdim, r)
            old = CS.mm_tile_path_gather(x, sdim)
            for order in (None, CS.FSDP_ORDER[sdim]):
                out = PK.gathered_empty(x, sdim, order)
                p = PK.ag_plan(r, x.shape[1:], x.stride()[1:], x.stride(0),
                               sdim, 2, addr=x.data_ptr(),
                               out_strides=out.stride(), sms=sms)
                got = all_gather_stacked(x, sdim, "fused", order)
                if not (p.route == "tma" and got.stride() == out.stride()
                        and same_bits(got, all_gather_stacked(
                            x, sdim, "bulk", order))
                        and same_bits(got, old) and same_bits(got[0], w)):
                    raise AssertionError(f"AG path form w{stored} dim {sdim} "
                                         f"R={r} order {order}: bits, "
                                         f"layout or route differ ({p})")
            fused = partial(all_gather_stacked, x, sdim, "fused")
            row = {"kernel": "ring_all_gather path form",
                   "shape": f"w{stored} bf16 gathered along dim {sdim}, "
                            f"R={r}", "plan": dataclasses.asdict(p),
                   "bit_identical": True, "contiguous": True}
            if timing and stored == (4, 2048, 1408) and sdim == 1 and r == 2:
                nbytes = (r + r * r) * x[0].numel() * 2
                row.update(
                    ms=CS.time_ms(lambda: fused()[0].contiguous()),
                    ms_mm_tile=CS.time_ms(
                        lambda: CS.mm_tile_path_gather(x, sdim)[0]
                        .contiguous()),
                    library_ms=CS.time_ms(
                        lambda: all_gather_stacked(x, sdim, "bulk")[0]
                        .contiguous()),
                    ms_fsdp_order=CS.time_ms(partial(
                        all_gather_stacked, x, sdim, "fused", order)),
                    bound_ms=CS.bound_ms(nbytes, 0.0)[0],
                    host_us=host_us(partial(all_gather_stacked, x, sdim,
                                            "fused", order)),
                    host_us_mm_tile=host_us(
                        lambda: CS.mm_tile_path_gather(x, sdim)[0]
                        .contiguous()))
            emit(row)
            del w, x, got, old

    # -- all-gather: the contiguous (R, blk, ...) layout --
    for r, rows_, n in ((2, 1024, 1408), (4, 512, 1408), (8, 256, 1408),
                        (2, 1024, 64), (2, 1024, 8000), (2, 5, 3),
                        (3, 3, 24)):
        x = randn(r, rows_, 4, n)
        want = PK.all_gather_plain(x)
        if not same_bits(CS.mm_tile_all_gather(x), want):
            raise AssertionError(f"AG yardstick x{tuple(x.shape)}")
        for nc in (1, 2, 3, 4):
            got = PK.ring_all_gather(x, n_chunks=nc)
            if not (got.is_contiguous() and same_bits(got, want)):
                raise AssertionError(f"AG x{tuple(x.shape)} n_chunks={nc}")
        p = PK.ag_plan(r, x.shape[1:], x.stride()[1:], x.stride(0), 0, 2,
                       addr=x.data_ptr(), sms=sms)
        row = {"kernel": "ring_all_gather",
               "shape": f"x{tuple(x.shape)} bf16",
               "plan": dataclasses.asdict(p), "bit_identical": True}
        run = partial(PK.ring_all_gather, x)
        if timing and n == 1408:
            row.update(ms=CS.time_ms(run),
                       ms_mm_tile=CS.time_ms(
                           partial(CS.mm_tile_all_gather, x)),
                       library_ms=CS.time_ms(
                           lambda: x.unsqueeze(0).repeat(r, 1, 1, 1, 1)),
                       bound_ms=CS.bound_ms((r + r * r) * x[0].numel() * 2,
                                            0.0)[0])
        emit(row)
        if args.variants and timing and (r, n) == (2, 1408):
            for v in ag_variants():
                with constants(PK, **v):
                    q = PK.ag_plan(r, x.shape[1:], x.stride()[1:],
                                   x.stride(0), 0, 2, sms=sms)
                    if q.smem_bytes * v["AG_PER_SM"] > 227 * 1024:
                        continue
                    if not same_bits(run(), want):
                        raise AssertionError(f"AG variant {v}")
                    ms = CS.time_ms(run)
                emit({"kernel": "ring_all_gather variant",
                      "shape": row["shape"], **v, "box": q.box,
                      "grid": q.grid, "ms": ms})
        del x, want

    # -- p2p ring shift --
    stream = torch.cuda.current_stream().cuda_stream
    flags = PK.p2p_flags(dev, stream)
    for shape, dtype in (((4, 1, 4, 2048, 64), torch.bfloat16),
                         ((4, 1, 4, 256, 64), torch.bfloat16),
                         ((4, 3, 5, 7), torch.float32),
                         ((3, 5), torch.uint8), ((8, 6, 130), torch.float32)):
        r = shape[0]
        for i in range(3):
            x = randn(*shape, dtype=dtype)
            start = flags.counts(r)
            got = PK.p2p_ring_shift(x)
            p = PK.p2p_plan(r, x[0].numel() * x.element_size(), sms=sms)
            counts = flags.counts(r)
            if not (same_bits(got, PK.ring_shift_plain(x))
                    and same_bits(got, CS.mm_tile_p2p_ring_shift(x))
                    and counts == flags.expected[:r]
                    == [(c + p.tiles) % 2 ** 32 for c in start]):
                raise AssertionError(f"p2p {shape} {dtype} launch {i}: "
                                     f"bits or flags {counts} differ")
        row = {"kernel": "p2p_ring_shift",
               "shape": f"x{shape} {str(dtype)[6:]}",
               "plan": dataclasses.asdict(p), "bit_identical": True,
               "flag_counts": counts}
        run = partial(PK.p2p_ring_shift, x)
        if timing and shape[3:4] in ((2048,), (256,)):
            row.update(ms=CS.time_ms(run),
                       ms_mm_tile=CS.time_ms(
                           partial(CS.mm_tile_p2p_ring_shift, x)),
                       library_ms=CS.time_ms(partial(torch.roll, x, 1, 0)),
                       bound_ms=CS.bound_ms(2 * x.numel() * 2, 0.0)[0],
                       host_us=host_us(run), host_us_mm_tile=host_us(
                           partial(CS.mm_tile_p2p_ring_shift, x)))
        emit(row)
        if args.variants and timing and shape[3:4] == (2048,):
            want = PK.ring_shift_plain(x)
            for tile in (8192, 16384, 32768, 65536):
                for per_sm in (1, 2, 4):
                    v = dict(P2P_TILE_BYTES=tile, P2P_PER_SM=per_sm)
                    with constants(PK, **v):
                        if not same_bits(run(), want):
                            raise AssertionError(f"p2p variant {v}")
                        ms = CS.time_ms(run)
                    emit({"kernel": "p2p_ring_shift variant",
                          "shape": row["shape"], **v, "ms": ms})
    # -- the LCSC ring all-gather (B11) --
    def lcsc_variants():
        for tile in (16384, 32768, 65536):
            for stages in (2, 3, 4):
                for per_sm in (1, 2, 3, 4):
                    yield dict(LCSC_TILE_BYTES=tile, LCSC_STAGES=stages,
                               LCSC_PER_SM=per_sm)

    for shape, dtype in (((2, 1024, 4, 1408), torch.bfloat16),
                         ((4, 512, 4, 1408), torch.bfloat16),
                         ((8, 256, 4, 1408), torch.bfloat16),
                         ((2, 1024, 4, 64), torch.bfloat16),
                         ((8, 3, 5, 7), torch.float32),
                         ((4, 1001), torch.uint8)):
        r = shape[0]
        x = randn(*shape, dtype=dtype)
        want = PK.all_gather_plain(x)
        if not same_bits(CS.mm_tile_lcsc_all_gather(x), want):
            raise AssertionError(f"LCSC yardstick x{shape}")
        run = partial(LC.lcsc_ring_all_gather, x)
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(3):
            got = run()
            flags = LC.lcsc_flags(dev, stream)
            p = LC.lcsc_plan(r, x[0].numel() * x.element_size(),
                             x.element_size(), x.data_ptr() % 16, sms=sms)
            if not (same_bits(got, want)
                    and bool((flags.flags[:p.items] == flags.epoch).all())):
                raise AssertionError(f"LCSC x{shape} launch {i}: bits or "
                                     "flags differ")
        row = {"kernel": "lcsc_ring_all_gather",
               "shape": f"x{shape} {str(dtype)[6:]}",
               "plan": dataclasses.asdict(p), "bit_identical": True,
               "epoch": flags.epoch}
        if timing and shape[-1] == 1408:
            blk = x[0].numel() * 2
            row.update(ms=CS.time_ms(run),
                       ms_mm_tile=CS.time_ms(
                           partial(CS.mm_tile_lcsc_all_gather, x)),
                       library_ms=CS.time_ms(
                           lambda: x.unsqueeze(0).repeat(r, 1, 1, 1, 1)),
                       bound_ms=CS.bound_ms((r + r * r) * blk, 0.0)[0],
                       ring_floor_ms=CS.bound_ms(
                           (r * (r - 1) + r * r) * blk, 0.0)[0],
                       host_us=host_us(run), host_us_mm_tile=host_us(
                           partial(CS.mm_tile_lcsc_all_gather, x)))
        emit(row)
        if args.variants and timing and shape[-1] == 1408 and r in (2, 8):
            for v in lcsc_variants():
                with constants(LC, **v):
                    q = LC.lcsc_plan(r, x[0].numel() * 2, 2, 0, sms=sms)
                    if (q.smem_bytes + 1024) * v["LCSC_PER_SM"] > 233472:
                        continue
                    if not same_bits(run(), want):
                        raise AssertionError(f"LCSC variant {v}")
                    ms = CS.time_ms(run)
                emit({"kernel": "lcsc_ring_all_gather variant",
                      "shape": row["shape"], **v, "tiles": q.tiles,
                      "grid": q.grid, "ms": ms})
        del x, want
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
