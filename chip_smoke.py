#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card: name and power limit as ``nvidia-smi`` reports them, torch and
   CUDA versions;
2. build: the hand-written kernels of ``src/repro_torch/kernels/csrc`` are
   compiled by nvcc for sm_90a (seconds printed);
3. kernels: each kernel of the serving and training paths runs at the
   shapes those paths give it (the GEMM at M 1-200 x ragged K, N, at the
   dense decode logits as one stacked launch over the 4 ranks' shards —
   bit-identical to one launch a shard and to a second call —, over 11
   and 16 stacked shards (two launches of at most 8, bit-identical too),
   one shard,
   the training loss (stacked bit-identical too), an MLP shape and the
   moonshot and falcon logits; every GEMM+AR site and prefill bucket, flash
   on the strided views prefill passes — also at moonshot's 16 heads of
   128 —, the grouped GEMM at every MoE shape (64 groups; C = 1, 60, 240;
   w1/w3 and w2; f32 and bf16 out; each group's bits the same launched
   among 64 groups, alone, among 16 and on a second call), the selective
   scan at falcon-mamba's
   prefill groups (S = 60, 174, 405) and decode (B = 8, S = 1) with the
   stacked state — bit-identical for chunk 1, 64 and 256 and over S + 4
   steps chained —, the scan's backward (B10-bwd, no Pallas counterpart)
   at falcon's training shapes (4, 512) and (2, 512) and the prefill
   shape (4, 405) x 8192 against its plain reverse recurrence, every
   output within 1e-3, bit-identical for segments of 1, 3 and 8 steps
   and a second call (details in ``check_mamba_scan_bwd``), the ring all-gather and reduce-scatter at every FSDP
   shard shape of the (2, 4) training run and
   at 4 and 8 ranks, each for 1-4 chunks, whose results must be
   bit-identical, to their plain versions and to the kernels they ran on
   before; the all-gather also in its path form, every FSDP weight (rows
   and columns) gathered from its strided ``dp_view`` by
   ``all_gather_stacked``: contiguous and bit-identical to the ``bulk``
   backend and to the old kernel behind its old wrapper; the p2p ring
   shift on k of the sequence-parallel path,
   (4, 1, 4, 2048, 64) bf16, and at ragged shapes, three launches each,
   bit-identical to the roll and to the kernel it ran on before, every
   rank's never-reset flag counting the plan's tiles more each launch;
   the flash hop at each of the 4 hops of that path at the ranks'
   global offsets; flash at head_dim 120, padded to 128; the AG×GEMM and
   GEMM×RS kernels at tinyllama's MLP, a Fig. 7/8 shape and a ragged
   shape, bit-identical for 1-4 chunks; the LCSC ring all-gather at every
   ring all-gather shape and at 4 and 8 ranks, over repeated and
   alternating launches, bit-identical to the plain gather and to the ring
   all-gather kernel; the all-to-all at Ulysses' q, kv and output
   shapes at 1 and 2 chunks and the a2a MoE dispatch, bit-identical to
   ``all_to_all_plain``, timed beside the bulk backend; flash non-causal
   at whisper-medium's encoder, q, kv (8, 16, 1500, 64), and
   cross-attention, q (4, 16, 448, 64) over kv (4, 16, 1500, 64), timed,
   and its 4-token prompt over the 1500 frames; the GEMM at whisper's
   decode logits and training loss (2 x 448 rows), whose 12967 columns a
   rank the head stores in rows padded to 16 bytes, stacked bit-identical
   too; GEMM+AR at whisper's encoder (8 x 1500 and 2 x 1500 rows) and
   decoder sites; the ring all-gather and reduce-scatter at whisper's FSDP
   shards, and whisper's padded head through ``fsdp_gather``) and is held
   against its plain PyTorch version on the same
   inputs — relative Frobenius error <= 1e-2 for bf16 outputs,
   <= 1e-3 for f32 outputs of bf16 inputs; one shape of each is then
   timed with CUDA events (20 calls queued back to back behind a spin
   kernel, median of 5; ``ms_single`` times each call alone) beside its
   plain version, one PyTorch library call of the same function where one
   exists (a yardstick only, never called by the port) and its bound
   (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16 — 67 TFLOP/s
   f32 for the scan —, the larger). The grouped GEMM's weights (369 MB)
   exceed the L2 whatever the method. The decode-shaped GEMM and GEMM+AR
   rows and the loss row are timed cold: each call takes the next of a set
   of weights larger than the 50 MB L2 (``rotate``), kernel, plain,
   library call and before-column alike, as a serving step reads each
   weight once; the others warm, with the same operands every call
   (``timing`` in each entry). The GEMM, AG×GEMM, GEMM×RS, GEMM+AR and
   grouped-GEMM rows also time the mma.sync kernels they ran on before the
   Hopper mainloop
   (``ms_mm_tile``, from ``csrc/mm_tile_yardstick.cu``); the flash and hop
   rows the mma.sync kernel flash ran on before its TMA + wgmma design
   (``ms_mm_tile``, from ``csrc/flash_mma_yardstick.cu``), after the
   flash kernel's own launch configuration is held against its plan
   (``flash_plan``) at both widths; the reduce-scatter rows (R = 2, 4, 8)
   the store-and-count kernel it ran on before its pull-and-sum design
   (``csrc/pk_comm_yardstick.cu``), the all-gather rows (the contiguous
   one, and the path form: the old wrapper's copy in, the old kernel and
   one dp group's copy of its strided result out, beside the ``bulk``
   backend as its library call) and the p2p row the kernels they ran on
   before (same file), the LCSC rows (R = 2, 4, 8) the step-synchronous
   kernel they ran on before (``csrc/lcsc_yardstick.cu``), the scan rows
   the kernel it ran on
   before its staged design (``csrc/mamba_scan_yardstick.cu``), its
   exponential floor printed beside them; the scan is also held at B = 1
   at every prompt length of the SSM serving run (4e), whose exact-bucket
   prefills run that launch. GEMM+AR is held
   at every site and bucket, bit-identical for 1-4 chunks and a second
   call, and GEMM×RS equal to GEMM+AR's owner rows bit for bit;
4. serving: the continuous-batching engine serves 8 requests of a seeded
   synthetic trace with tinyllama-1.1b at full width and depth on 4 virtual
   tensor-parallel ranks, every GEMM+AR site pinned to the fused kernel;
   every request must complete with finite logits, and every kernel's
   launch count over that run must be > 0 — the GEMM's exactly one a step
   (one stacked launch for the 4 ranks' logits). The same trace then runs
   with the ``bulk`` backend (no GEMM+AR kernel) for the share of agreeing
   greedy tokens and the first prefill logits' largest difference (beside
   the ring backend's, a third summation order);
3b. backward: the autograd wrappers of the GEMM (and its stacked form),
   flash attention and GEMM+AR at the training path's shapes, and the
   grouped GEMM at moonshot's MoE training shapes (64 groups, capacity
   240 and 120, K 2048 and 1408) — outputs and gradients against
   plain-torch autograd of their plain versions, relative error <= 2e-2;
4b. reference: tinyllama-1.1b at full width cut to 2 layers, card path
   (bf16, kernels) against the port's plain float32 path on the CPU with
   the same weights, on one small prefill group — relative Frobenius error
   of the logits <= 3e-2;
4c. MoE serving: the engine serves the same trace (8 requests, 32 new
   tokens, buckets 128/512) with moonshot-v1-16b-a3b at full width and
   depth (48 layers, 64 experts top-6, 56 GB of bf16 parameters, built
   once) on 4 virtual ranks, expert parallel (16 experts per rank), every
   GEMM+AR site on the fused kernel; every request must complete with
   finite logits and the grouped-GEMM, flash, GEMM+AR and GEMM kernels
   must each launch, the GEMM exactly once a step. The same parameters then
   serve the trace with the ring MoE combine for the share of agreeing
   greedy tokens;
4c'. MoE block: ``pk_moe_replicated`` at full width on a 512-bucket
   prefill group, the grouped-GEMM kernel against the plain grouped GEMM
   on the same inputs — relative Frobenius error <= 1e-2;
4d. MoE reference: the same model cut to 2 layers, one prefill group on
   the card against the port's plain f32 path on the CPU on the same
   (1, 4) mesh, the f32 path replaying the card's routing — logits within
   3e-2 and >= 0.8 of the tokens routed alike by the f32 path's own
   decisions (details in ``check_moe_reference``); the engine is freed;
4e. SSM serving: the engine serves the same trace with falcon-mamba-7b at
   full width and depth (64 mamba layers, d 4096, d_inner 8192, 14.56 GB of
   bf16 parameters) on 4 virtual ranks with exact buckets (one bucket per
   prompt length); every request must complete with finite logits, the
   selective-scan kernel must launch exactly 64 x (prefill + decode steps)
   times and the GEMM exactly once a step;
4f. SSM reference: the same model cut to 2 layers, one prefill group on
   the card against the port's plain f32 path on the CPU on the same
   (1, 4) mesh — logits within 3e-2 — and, on the card, a prefill of 60
   tokens then 4 decode steps against a prefill of 64 — last-token logits
   within 2e-2 (details in ``check_ssm_reference``); the engine is freed;
5. training: ``build_and_train`` trains tinyllama-1.1b at full width and
   depth on a (2, 4) virtual mesh (data 2 x model 4) with FSDP, every
   collective pinned to the kernels (``comm_backend="fused"``), batch 8 x
   seq 512 in 2 microbatches, 4 steps, and writes a checkpoint; every loss
   must be finite and every kernel of the path (the ring all-gather of each
   FSDP weight gather, the ring reduce-scatter of each FSDP gradient, the
   GEMM+AR, flash and GEMM kernels inside autograd) must launch, the GEMM
   exactly once a dp group, microbatch and step (the loss, stacked);
5b. train reference: the same model cut to 2 layers, one forward and
   backward on the card (bf16, kernels) against the port's plain float32
   path on the CPU with the same weights and batch — loss within relative
   1e-2 and global gradient norm within relative 3e-2;
5c. sequence-parallel training: ``forward_train(seq_sharded=True)`` and
   its backward, 3 calls, tinyllama-1.1b at full width and depth on (1, 4)
   with ring attention over 4 virtual ranks, batch 1 x seq 8192,
   ``comm_backend="fused"``, remat; every loss finite, the p2p, flash hop
   and GEMM launches exactly what the code implies, the dense mix's loss
   within 1e-2, one layer's island under fused equal to bulk bit for bit
   (details in ``train_sp``);
5d. SP reference: the same model cut to 2 layers, seq 2048 on (1, 4), the
   card against the port's plain f32 path on the CPU — loss within
   relative 1e-2, gradient norm within 3e-2;
5f. Ulysses training: the model, parameters and batch of 5c with
   ``sp_attention="ulysses"``, ``ulysses_chunks=2``, 3 calls; the
   all-to-all and flash launches exactly what the code implies, no p2p or
   hop, the loss within 1e-2 of 5c's ring loss, one layer's island at 2
   chunks equal to 1 chunk bit for bit (details in ``train_ulysses``);
5g. a2a MoE: ``pk_moe_a2a`` at moonshot-v1-16b-a3b's layer width on 4
   virtual ranks x 512 tokens, within 1e-2 of the dense oracle, 2 chunks
   within 1e-3 of 1, the grouped GEMM 3 launches a chunk (details in
   ``moe_a2a``);
5h. encoder-decoder serving: whisper-medium at full width and depth
   (24 encoder and 24 decoder layers, 0.81 B parameters) on (1, 4), the
   encoder over (8, 1500, 1024) frames and the cross K/V into the cache
   (``encode_cross``), a 4-token prompt and 32 greedy tokens through
   ``decode_step_encdec``; launches exact (flash, the GEMM, GEMM+AR), the
   logits after the prompt within a derived tolerance of
   ``forward_prefill``'s (details in ``serve_encdec``);
5i. encoder-decoder training: the same model on (2, 4) with FSDP, batch
   8 x 448 decoder tokens + their frames, 2 microbatches, remat, AdamW, 3
   steps through ``make_train_step``; losses finite, every kernel of the
   path launched, the GEMM exactly once a dp group, microbatch and step
   (details in ``train_encdec``);
5j. encoder-decoder reference: whisper-medium at full width cut to 2
   encoder and 2 decoder layers, the card against the port's plain f32
   path on the CPU: decode logits within 3e-2, the loss within 1e-3, the
   gradient norm within 3e-2 and the encoder's, the cross-attention's and
   the rest's gradients each within 3e-2 (details in
   ``check_encdec_reference``);
5k. MoE training: moonshot-v1-16b-a3b at full width cut to 4 of its 48
   layers on (2, 4) with FSDP, batch 8 x 512 in 2 microbatches, remat,
   AdamW, 3 steps; losses and aux losses finite, flash, GEMM+AR, the GEMM
   and B3's AG and RS launched, the grouped GEMM exactly 3 launches a
   layer, dp group, microbatch and forward (details in ``train_moe``);
5l. SSM training: falcon-mamba-7b at full width cut to 16 of its 64
   layers, the same run; the scan's forward kernel exactly 2 launches
   and its backward kernel 1 a layer and microbatch (``train_ssm``);
5m. hybrid training: jamba-1.5-large-398b ``.reduced()`` through the
   launcher on (2, 4) with FSDP, 3 steps; every kernel of the path
   launched (``train_hybrid``);
5n. MoE and SSM reference: 2-layer moonshot and falcon at full width,
   one step on (2, 4) with FSDP against the port's plain f32 CPU path on
   the card's routing — the loss within 1e-3, each gradient group within
   3e-2 (``check_family_reference``);
5e. TP GEMM pair: tinyllama-1.1b's MLP at full width on (1, 4), 4096
   tokens, through declared ``Island``s: AG+GEMM (gate/up) and GEMM+RS
   (down) under every backend, fused within 1e-2 of bulk, the AG×GEMM and
   GEMM×RS kernels launched exactly once per fused call and never
   otherwise, the sequence-sharded output gathered to every rank by the
   LCSC all-gather; then the paper's Fig. 7/8 sweep, fused and bulk
   device times (details in ``tp_gemm``);
5o. paged serving: the engine serves phase 4's trace plus 4 requests that
   share a prefix with it (``paged_trace``) with tinyllama-1.1b at full
   width and depth on (1, 4), phase 4's settings with
   ``cache_layout="paged"``, pages of 16 tokens and prefill chunks of 128;
   every request completes with finite logits, a prefix hit and a copied
   boundary page, a decode step between two chunks of one job, B1 once a
   step and B4 launched; then the same trace with a pool of a quarter of
   the slab's bytes: admission blocked, every request done; the greedy
   tokens' agreement with phase 4's slab run printed, not gated (details
   in ``serve_paged``);
5p. the same model cut to 4 layers: paged serving on (2, 4), slab serving
   with head-sharded caches on (1, 4) (B7 launched at prefill), and a
   2-layer paged prefill group and 4 decode ticks against the port's plain
   f32 path on the CPU — each step's logits within 3e-2 relative (details
   in ``serve_paged_cut``);
5q. int8 KV cache: phase 4's model, settings and trace with
   ``kv_dtype="int8"``, slab and then paged with 5o's settings; every
   request done, the cache at (64 + 4) / 128 of phase 4's and 5o's bytes,
   B1 once a step, B4 launched, B7 once a layer a slab prefill step; a
   2-layer int8 slab prefill group and 4 decode ticks against the port's
   plain f32 path on the CPU with the same cache format, within 3e-2
   (details in ``serve_int8``);
5r. int8 wire: phase 5e's GEMM pair with ``wire="int8"`` and
   ``"int8_sr"`` under the rings, 1/2/4 chunks bit-identical, within 2e-2
   of bulk, ``auto`` a ring, B5/B6 never launched; then 4 layers served
   with ``comm_wire="int8"`` and B4 never launched (``tp_gemm_int8``);
5s. compressed training: phase 5's run with ``compress_grads=True``, 3
   steps: losses finite, the error-feedback residual nonzero after step 1,
   B3's AG and RS a step as in phase 5 (``train_compressed``);
5t. 2D-TP MoE serving: moonshot at full width cut to 4 layers on (2, 4)
   with ``serve_moe_tp_data``: every request done, the grouped GEMM 3
   launches a chunk, layer, dp group and step, no weight gather; phase
   4d's 2-layer reference on that engine (``serve_moe_tp_data``);
5u. the empirical autotuner: ``calibrate`` on a (4,) mesh of virtual
   ranks (grid ``small``, bf16 and int8 wires, per-island sweeps at phase
   4's buckets and decode pool, the Ulysses island at 1 x 8192, moonshot's
   MoE dispatch): every GEMM op with bulk, ring and fused rows, no fused b1
   row, every island sweep with each row of its case grid, B4/B5/B6 and
   the all-to-all kernel launched, the table round-trips JSON, the CLI's
   ``show``/``diff``/``check --no-probe`` exit 0; then phase 4's engine and
   trace with ``comm_policy="measured"`` from that table: every active
   GEMM-collective bucket plan measured and equal to the table's argmin,
   every request done with finite logits, B4 launched iff a plan says
   fused; the shipped seed ``h100_sxm.json`` names this card; phase 5's
   training unpinned under the analytic and the measured policy, step
   times and plans printed, losses finite (``autotune_serve``,
   ``train_policies``);
5v. runtime health: phase 4's engine settings (tinyllama-1.1b at full
   width and depth on (1, 4), 8 requests, one set of parameters): a ring
   run; the same with island guards and a corrupt mlp hop at the step of
   its last prefill group, that group quarantined, ``mlp`` tripped, every
   other token the ring run's; the same with a retry, every token the ring
   run's; fused with the health monitor and a 50 s stall on mlp's link:
   one demotion (mlp -> bulk, drift), one promotion after probation, no B4
   launch at mlp while demoted, the two steps after it under 5 s; fused
   with guards and the monitor and no fault: no trip, no demotion; decode
   step times with and without guards printed (``serve_health``);
5w. the serving fleet: 2 replicas of phase 4's engine, ``least-loaded``,
   12 requests — no fault, ``kill:1@4 rejoin:1@8`` (the rejoin seed in a
   checkpoint under ``build/``) and a 4-tick delay of replica 1 that must
   steal: every request done exactly once, the kill and delay runs' tokens
   the no-fault run's, the rejoined parameters the snapshot's bit for bit,
   B1, B7 and B4 launched on both replicas; then replica 0's drain
   snapshot rejoins on a (2, 2) mesh through ``elastic_restore``, its
   logical parameters bit-identical, and serves (``serve_fleet``);
5x. GPipe: one tinyllama-1.1b decoder layer on no mesh as the stage, 22
   stages on ``pipe = 2``, 4 microbatches of (2, 512): the bulk and
   ``fused`` (B8) handoffs bit-identical, within 1e-2 of the sequential
   layers; B8 5 launches a forward; ``gpipe_loss``'s gradients within
   2e-2 of sequential autograd (``train_pipeline``);
5y. long-context decode (A8): h2o-danube-3-4b at full width cut to 8
   of 24 layers on (2, 4), batch 1, s_max 524,288, the cache sharded
   over (data, model) and seeded up to s_max - 16; 8 greedy steps
   through ``make_serve_step(long_ctx=True)``, timed, B1 once a step;
   with the window off, (2, 4) against no mesh: logits within 3e-2, the
   tokens equal (``serve_long_ctx``; C17 for why the window is off);
5z. FSDP over ("pod", "data"): tinyllama-1.1b full, 2 steps of 8 x 512
   on (2, 2, 2) against (4, 2), fused: losses, grad norms and parameters
   bit for bit, B3 as often in both (``train_multi_pod``);
5aa. the bf16 scan (A10e): falcon-mamba-7b cut to 4 of 64 layers,
   ``forward_prefill`` (2, 512) with the bf16 scan against the f32
   kernel, within 5e-2, both timed (``prefill_bf16_scan``);
5ab. the dry-run (A14): tinyllama (2 layers: a train step and a decode
   step) and moonshot (2 layers, a train step) on (2, 4) counted on the
   card, the card's step beside its roofline bound (``dryrun_check``);
   then, after every timed phase, 11 cells counted on ``meta`` by worker
   processes on the host, every one required, the report's tables
   printed, and the same reduced steps counted on meta: FLOPs, bytes,
   collectives and launches equal to the card's (the meta branches'
   recorded launches against the wrappers' ``.launches``), the meta peak
   within 10% of ``max_memory_allocated`` (``dryrun_finish``);
6. a line ``{"kernels": [...]}`` with each kernel's numbers (``launches``:
   the tinyllama serving run's count for the serving kernels, the MoE
   serving run's for the grouped GEMM, the SSM serving run's for the
   selective scan, the training run's for the ring AG/RS kernels, the
   sequence-parallel run's for the p2p shift and the flash hop, the
   Ulysses run's for the all-to-all, the TP GEMM pair's for AG×GEMM,
   GEMM×RS and the LCSC all-gather, the SSM training run's for the scan's
   backward; ``launches_by_path`` has all thirty paths, 5g's a2a
   MoE, the whisper runs 5h and 5i, the training runs 5k-5m, the paged and
   head-sharded serving runs 5o and 5p, the runs of 5q-5t, 5u's
   calibration and measured serving, and 5v-5x's ``serve_health``,
   ``serve_fleet`` and ``train_pipeline`` among them, and 5y-5ab's
   ``serve_long_ctx``, ``train_multi_pod``, ``prefill_bf16_scan`` and
   ``dryrun_check``),
   then
   GEMM+AR's cold decode row, whose counts are GEMM+AR's whole-path
   counts (prefill and decode together, the counter named by
   ``launches_counter``), not its own, the all-gather's path-form row,
   whose counts are the all-gather's, and flash's whisper rows, whose
   ``launches`` are flash's in 5h (encoder) and 5i (cross);
7. the last line, ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
TOL_BF16_OUT = 1e-2
TOL_F32_OUT = 1e-3


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_HBM_BYTES, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call: the median over ``reps`` of the time between
    two CUDA events around ``iters`` calls, divided by ``iters``. The calls
    are queued behind a spin kernel (``torch.cuda._sleep``) twice as long
    as their host-side enqueue, so the device runs them back to back and
    the wrappers' host time does not show."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    cycles = int(2 * (time.perf_counter() - t0) * 2e9) + 10 ** 6
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def time_ms_single(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA events around each call alone (the script's earlier
    method): on an idle device this adds the wrapper's host time to the
    kernel's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rotate(fn, arg_sets):
    """A call of ``fn`` on the next of ``arg_sets`` each time: the cold
    method. Rotating over a set of distinct operands larger than the L2 makes
    every call read its operands from device memory, as the serving path
    does when it reads each rank's head shard once a step."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def mm_tile_matmul(x, w):
    """B1's earlier kernel (``csrc/mm_tile_yardstick.cu``: the mma.sync
    tile it ran on before the Hopper mainloop), timed as the before-column
    ``ms_mm_tile``; the port never calls it."""
    import torch

    from repro_torch.kernels import _build
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    _build.check(_build.library().pk_mm_tile_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], w.shape[1],
        x.shape[1], x.stride(0), w.stride(0), out.stride(0),
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_matmul_bf16")
    return out


def mm_tile_ag_matmul(x, w):
    """B5's earlier kernel on the mma.sync tile, the before-column of
    ``ag_matmul_fused``; the port never calls it."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    r, m_loc, k = x.shape
    out = torch.empty((r, r * m_loc, w.shape[2]), dtype=x.dtype,
                      device=x.device)
    _build.check(_build.library().pk_mm_tile_ag_matmul_bf16(
        *[_build.host_table(pgl.pointer_table(t)) for t in (x, w, out)], r,
        m_loc, w.shape[2], k, torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_ag_matmul_bf16")
    return out


def mm_tile_reduce(x, w, gather):
    """B4's (``gather``) and B6's earlier kernel on the mma.sync tile, the
    before-column of ``matmul_ar_fused`` / ``matmul_rs_fused``: its own
    landing slots and flags (one int a 64 x 64 tile) each call; the port
    never calls it."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    r, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((r, m if gather else m // r, n), dtype=torch.float32,
                      device=x.device)
    landing = torch.empty((r, r, m // r, n), dtype=torch.float32,
                          device=x.device)
    flags = torch.empty((-(-m // 64) * -(-n // 64),), dtype=torch.int32,
                        device=x.device)
    fn = ("pk_mm_tile_matmul_ar_bf16" if gather
          else "pk_mm_tile_matmul_rs_bf16")
    _build.check(getattr(_build.library(), fn)(
        *[_build.host_table(pgl.pointer_table(t))
          for t in (x, w, landing, out)], flags.data_ptr(), r, m, n, k,
        torch.cuda.current_stream(x.device).cuda_stream), fn)
    return out


def mm_tile_grouped_matmul(x, w, out_dtype):
    """B9's earlier kernel on the mma.sync tile, the before-column of
    ``grouped_matmul``; the port never calls it."""
    import torch

    from repro_torch.kernels import _build
    g, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((g, c, n), dtype=out_dtype, device=x.device)
    _build.check(_build.library().pk_mm_tile_grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), g, c, n, k, x.stride(0),
        x.stride(1), w.stride(0), w.stride(1), out.stride(0), out.stride(1),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_grouped_matmul_bf16")
    return out


def mm_tile_flash(q, k, v, causal=True):
    """B7's earlier kernel (``csrc/flash_mma_yardstick.cu``: the mma.sync
    flash it ran on before the TMA + wgmma design), the before-column
    ``ms_mm_tile`` of the flash rows, at head_dim 64 or 128; the port never
    calls it."""
    import torch

    from repro_torch.kernels import _build
    b, hq, sq, hd = q.shape
    out = torch.empty((b, hq, sq, hd), dtype=q.dtype, device=q.device)
    _build.check(_build.library().pk_mm_tile_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], hd,
        *[t.stride(i) for t in (q, k, v) for i in range(3)], int(causal), 0,
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream),
        "pk_mm_tile_flash_attention_bf16")
    return out


def mm_tile_flash_hop(q, k, v, ranks, hop):
    """The hop's earlier kernel (causal, the yardstick of
    ``mm_tile_flash``): o, m, l in f32; the port never calls it."""
    import torch

    from repro_torch.kernels import _build
    b, hq, sq, hd = q.shape
    o = torch.empty((b, hq, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    l_ = torch.empty_like(m)
    _build.check(_build.library().pk_mm_tile_flash_attention_hop_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l_.data_ptr(), b, hq, k.shape[1], sq, k.shape[2], hd,
        *[t.stride(i) for t in (q, k, v) for i in range(3)], ranks, hop, 1,
        0, hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream),
        "pk_mm_tile_flash_attention_hop_bf16")
    return o, m, l_


_MM_TILE_RS_SCRATCH: dict = {}


def mm_tile_reduce_scatter(x, n_chunks=1):
    """B3's reduce-scatter kernel before its pull-and-sum design
    (``csrc/pk_comm_yardstick.cu``: store-and-count through landing slots
    and flags), the before-column ``ms_mm_tile`` of the RS rows; the port
    never calls it. Landing slots and flags are cached by shape."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    from repro_torch.kernels import pk_comm as PK
    r, blk = x.shape[0], x[0, 0].numel()
    rows = x.shape[2] if x.dim() > 2 else 1
    chunk = blk // PK._chunks(rows, n_chunks)
    n_flags = r * (blk // chunk) * -(-chunk // 1024)   # (owner, tile) at most
    key = (x.device, r, blk, x.dtype)
    if key not in _MM_TILE_RS_SCRATCH or \
            _MM_TILE_RS_SCRATCH[key][1].numel() < n_flags:
        _MM_TILE_RS_SCRATCH[key] = (
            torch.empty((r, r, blk), dtype=x.dtype, device=x.device),
            torch.empty((n_flags,), dtype=torch.int32, device=x.device))
    landing, flags = _MM_TILE_RS_SCRATCH[key]
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    _build.check(_build.library().pk_mm_tile_reduce_scatter(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)),
        _build.host_table(pgl.pointer_table(landing)), flags.data_ptr(), r,
        blk, chunk, PK._DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_reduce_scatter")
    return out


def mm_tile_all_gather(x, n_chunks=1):
    """B3's all-gather kernel before its TMA-staged design
    (``csrc/pk_comm_yardstick.cu``: one 16-byte load a thread, R stores),
    on a contiguous (R, blk, ...) -> (R, R, blk, ...); the before-column
    ``ms_mm_tile`` of the all-gather rows. The port never calls it."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    from repro_torch.kernels import pk_comm as PK
    r, rows = x.shape[0], x.shape[1] if x.dim() > 1 else 1
    out = torch.empty((r, *x.shape), dtype=x.dtype, device=x.device)
    blk = x[0].numel() * x.element_size()
    _build.check(_build.library().pk_mm_tile_all_gather(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)), r, blk,
        blk // PK._chunks(rows, n_chunks),
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_all_gather")
    return out


def mm_tile_path_gather(x, axis):
    """What an FSDP gather of the strided view x (R, *local) along local dim
    ``axis`` cost before the TMA design: the old wrapper's moves and copy
    around the old kernel (``mm_tile_all_gather``), returning the
    non-contiguous (R, *gathered) view it returned."""
    front = x.movedim(1 + axis, 1).contiguous()
    return mm_tile_all_gather(front).flatten(1, 2).movedim(1, 1 + axis)


_MM_TILE_P2P_FLAGS: dict = {}


def mm_tile_p2p_ring_shift(x):
    """B8's kernel before its persistent design
    (``csrc/pk_comm_yardstick.cu``: grid (tile, source), a memset of the
    flags before every launch); the before-column of the p2p row."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.device not in _MM_TILE_P2P_FLAGS:
        _MM_TILE_P2P_FLAGS[x.device] = torch.zeros(
            (8,), dtype=torch.int32, device=x.device)
    _build.check(_build.library().pk_mm_tile_p2p_ring_shift(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)),
        _MM_TILE_P2P_FLAGS[x.device].data_ptr(), x.shape[0],
        x[0].numel() * x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_p2p_ring_shift")
    return out


_MM_TILE_LCSC_FLAGS: dict = {}


def mm_tile_lcsc_all_gather(x):
    """B11's kernel before its item walk (``csrc/lcsc_yardstick.cu``: the
    step-synchronous template, a memset of its flags before every launch,
    word copies through registers), the before-column of the LCSC rows."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.kernels import _build
    x = x.contiguous()
    out = torch.empty((x.shape[0], *x.shape), dtype=x.dtype, device=x.device)
    if x.device not in _MM_TILE_LCSC_FLAGS:
        _MM_TILE_LCSC_FLAGS[x.device] = torch.empty(
            (1 << 16,), dtype=torch.int32, device=x.device)
    flags = _MM_TILE_LCSC_FLAGS[x.device]
    _build.check(_build.library().pk_mm_tile_lcsc_all_gather(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)), flags.data_ptr(),
        flags.numel(), x.shape[0], x[0].numel() * x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream),
        "pk_mm_tile_lcsc_all_gather")
    return out


def mm_tile_mamba_scan(dt, b_ssm, c_ssm, x, a, h0, chunk=128):
    """B10's kernel before its staged, pipelined design
    (``csrc/mamba_scan_yardstick.cu``: one lane a state, staging no load
    overlapped), the before-column ``ms_mm_tile`` of the scan rows: y and
    h_last in h0's layout; the port never calls it."""
    import torch

    from repro_torch.kernels import _build
    bsz, s, d = dt.shape
    n = a.shape[-1]
    h_out = torch.empty_like(h0)
    if h0.dim() == 3:
        dl, h0r, h0b, hor, hob = d, 0, h0.stride(0), 0, h_out.stride(0)
    else:
        dl, h0r, h0b = h0.shape[2], h0.stride(0), h0.stride(1)
        hor, hob = h_out.stride(0), h_out.stride(1)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    _build.check(_build.library().pk_mm_tile_mamba_scan(
        dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), bsz, s,
        d, n, chunk, int(x.dtype == torch.bfloat16), dt.stride(0),
        dt.stride(1), x.stride(0), x.stride(1), b_ssm.stride(0),
        b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1), dl, h0r, h0b,
        hor, hob, torch.cuda.current_stream(dt.device).cuda_stream),
        "pk_mm_tile_mamba_scan")
    return y, h_out


def exp_floor_ms(b, s, d, n, sms, clock_mhz) -> float:
    """The selective scan's exponential floor: B·S·D·N exponentials at 16
    an SM a clock (the SFU's ex2 rate) on ``sms`` SMs at ``clock_mhz``."""
    return b * s * d * n / (16.0 * sms * clock_mhz * 1e6) * 1e3


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock as ``nvidia-smi`` reports it (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_kernels(dev) -> dict:
    """Phase 3: every kernel at its serving-path shapes against its plain
    version, then timed. Returns name -> JSON entry (launches filled in
    by the serving phase)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import pk_comm as PK

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    entries = {}

    def compare(name, shape, run, plain, tol):
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        print(f"[kernel] {name} {shape}: rel_err={err:.3e} (tol {tol:g}) "
              f"max_abs_err={max_abs:.3e}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {shape} disagrees with its plain "
                                 f"version: rel_err {err:.3e} > {tol:g}")
        return err, max_abs

    def record(name, shape, source, replaces, run, plain, library, tol,
               nbytes, flops, peak=PEAK_BF16_FLOPS, plain_iters=20,
               checked=None, before=None, timing="warm"):
        """Compare (unless ``checked`` gives the (rel, max abs) errors of a
        check already made), then time; the kernel's JSON entry. ``before``
        times the kernel this one replaced (``ms_mm_tile``); ``timing``
        names the method: "warm" (the same operands every call) or "cold
        ..." (``rotate``), for kernel, plain, library and before alike."""
        err, max_abs = checked or compare(name, shape, run, plain, tol)
        ms = time_ms(run)
        plain_ms = time_ms(plain, iters=plain_iters, reps=min(5, plain_iters))
        lib_ms = time_ms(library) if library is not None else None
        single = time_ms_single(run)
        b_ms, by = bound_ms(nbytes, flops, peak)
        lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "shape": shape, "launches": 0,
                 "max_abs_err": max_abs, "rel_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                 "library_ms": lib_ms, "ms_single": single, "timing": timing}
        extra = ""
        if before is not None:
            entry["ms_mm_tile"] = time_ms(before)
            extra = f" ms_mm_tile={entry['ms_mm_tile']:.4f}"
        print(f"[kernel] {name} {shape}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_txt} bound_ms={b_ms:.4f} ({by}); "
              f"ms_single={single:.4f}{extra}; timing {timing}", flush=True)
        return entry

    entries.update(check_matmul(dev, record, compare, randn))

    for hd in FA.KERNEL_HEAD_DIMS:      # the built kernel is the plan's
        st = (512 * hd, 256 * hd, hd, 1)
        p = FA.flash_plan((1, 2, 256, hd), st, (1, 2, 256, hd), st, st)
        want = (p.block_q, p.block_k, p.stages, p.threads, p.smem_bytes)
        if FA.kernel_config(hd) != want:
            raise AssertionError(f"flash at head_dim {hd}: the kernel's "
                                 f"{FA.kernel_config(hd)} is not the plan's "
                                 f"{want}")
    # flash attention: the prefill bucket groups (B=4, S=512 and S=128),
    # tinyllama heads. Prefill hands the kernel head-transposed views of
    # (B, S, H, hd) projections, so q/k/v are strided as there; the
    # contiguous layout is checked as well.
    b, hq, hkv, hd = 4, 32, 4, 64
    for s, strided in ((512, True), (128, True), (512, False)):
        if strided:
            q, k_, v = (randn(b, s, h, hd).transpose(1, 2)
                        for h in (hq, hkv, hkv))
        else:
            q, k_, v = (randn(b, h, s, hd) for h in (hq, hkv, hkv))
        shape = (f"q({b},{hq},{s},{hd}) kv({b},{hkv},{s},{hd}) causal"
                 + (" strided" if strided else ""))
        run = partial(FA.flash_attention, q, k_, v, causal=True)
        plain = partial(FA.flash_attention_plain, q, k_, v, causal=True)
        if (s, strided) != (512, True):
            compare("flash_attention", shape, run, plain, TOL_BF16_OUT)
            continue
        kr = k_.repeat_interleave(hq // hkv, 1)
        vr = v.repeat_interleave(hq // hkv, 1)
        visible = s * (s + 1) // 2             # causal (q, k) pairs per head
        entries["flash_attention"] = record(
            "flash_attention", shape,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:73", run, plain,
            lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                   is_causal=True),
            TOL_BF16_OUT, (2 * q.numel() + k_.numel() + v.numel()) * 2,
            4.0 * b * hq * hd * visible,
            before=partial(mm_tile_flash, q, k_, v))

    # GEMM+AR, R = 4 ranks: the MLP down-projection island (k_loc = ff/R =
    # 1408) at prefill (m = 4 x 512 and 4 x 128) and decode (m = 8), and
    # the attention out-projection island (k_loc = d/R = 512) at prefill
    # and decode. Every shape must give the same bits for n_chunks 1-4 and
    # a second call. The 512-bucket MLP is timed warm; the decode MLP cold,
    # rotated over 3 copies of w (69 MB > the 50 MB L2: 23 MB would stay in
    # L2 and beat its HBM bound), as a decode step reads each weight once;
    # the rest are checked. Both timed rows also time the kernel B4 ran on
    # before (``mm_tile_reduce``) by the same method. Then whisper-medium's
    # sites (n = d = 1024; attention out-projection k_loc = 1024/4 = 256,
    # MLP 4096/4 = 1024), checked alike: the encoder at the serving batch's
    # 8 x 1500 frames (5h) and at a training dp group's microbatch, 2 x
    # 1500 (5i), the decoder's MLP at a decode step (m = 8), and the
    # decoder's out-projections (self and cross) and MLP at the training
    # microbatch's 2 x 448 tokens.
    r = 4
    for m, kl, n, key in ((2048, 1408, 2048, "pk_matmul_ar"),
                          (8, 1408, 2048, "pk_matmul_ar@decode"),
                          (512, 1408, 2048, None), (2048, 512, 2048, None),
                          (512, 512, 2048, None), (8, 512, 2048, None),
                          (12000, 256, 1024, None), (12000, 1024, 1024, None),
                          (8, 1024, 1024, None), (3000, 256, 1024, None),
                          (3000, 1024, 1024, None), (896, 256, 1024, None),
                          (896, 1024, 1024, None)):
        copies = 3 if key == "pk_matmul_ar@decode" else 1
        sets = [(randn(r, m, kl), randn(r, kl, n, scale=(r * kl) ** -0.5))
                for _ in range(copies)]
        x, w = sets[0]
        shape = f"x({r},{m},{kl})@w({r},{kl},{n})"
        first = CM.matmul_ar_fused(x, w)
        for nc in (1, 2, 3, 4):
            if not torch.equal(CM.matmul_ar_fused(x, w, n_chunks=nc), first):
                raise AssertionError(f"pk_matmul_ar {shape}: n_chunks={nc} "
                                     "or a second call changed the result")
        run = partial(CM.matmul_ar_fused, x, w)
        plain = partial(CM.matmul_ar_plain, x, w)
        checked = compare("pk_matmul_ar", shape, run, plain, TOL_F32_OUT)
        if key is None:
            continue
        nbytes = (x.numel() + w.numel()) * 2 + r * m * n * 4
        if copies > 1:
            timing = (f"cold (w rotated over {copies} copies, "
                      f"{copies * w.numel() * 2 / 1e6:.0f} MB)")
            run, plain = (rotate(CM.matmul_ar_fused, sets),
                          rotate(CM.matmul_ar_plain, sets))
            library = rotate(lambda x, w: torch.matmul(x, w).sum(0), sets)
            before = rotate(lambda x, w: mm_tile_reduce(x, w, True), sets)
        else:
            timing = "warm"
            library = lambda x=x, w=w: torch.matmul(x, w).sum(0)  # noqa
            before = partial(mm_tile_reduce, x, w, True)
        entries[key] = record(
            "pk_matmul_ar", shape,
            "src/repro_torch/kernels/csrc/collective_matmul.cu",
            "src/repro/kernels/collective_matmul.py:306", run, plain,
            library, TOL_F32_OUT, nbytes, 2.0 * r * m * kl * n,
            checked=checked, before=before, timing=timing)
        del sets
    print("[kernel] pk_matmul_ar: bit-identical for n_chunks 1-4 and a "
          "second call at every shape", flush=True)

    # ring all-gather / reduce-scatter at the FSDP shard shapes of the
    # (2, 4) training run: a dp rank's shard of a tp-stacked weight with the
    # gathered dim moved to the front, (R_dp, d/2, R_tp, n) for n = 64 (wk,
    # wv), 512 (wq, wo), 1408 (w1, w3, w2) and 8000 (embed, lm_head); then
    # the MLP shard over 4 and 8 ranks; then whisper-medium's on (2, 4)
    # (5i), d/2 = 512 rows: n = 256 (the self- and cross-attention's
    # projections), 1024 (w1, w2) and 12968 (the head, its 12967 columns a
    # rank in rows padded to 16 bytes). Every chunk count must give the
    # same bits, the plain version's and those of the kernel each ran on
    # before (``mm_tile_all_gather``, ``mm_tile_reduce_scatter``). The MLP
    # shape is timed: the all-gather at R = 2, the reduce-scatter at R = 2,
    # 4 and 8, beside its yardstick.
    for r, rows, n in ((2, 1024, 64), (2, 1024, 512), (2, 1024, 1408),
                       (2, 1024, 8000), (4, 512, 1408), (8, 256, 1408),
                       (2, 512, 256), (2, 512, 1024), (2, 512, 12968)):
        x = randn(r, rows, 4, n)
        parts = randn(r, r, rows, 4, n)
        blk = rows * 4 * n
        for name, fn, plain, arg, lib, nbytes, yard in (
                ("pk_all_gather", PK.ring_all_gather, PK.all_gather_plain,
                 x, lambda: x.unsqueeze(0).repeat(r, 1, 1, 1, 1),
                 (r + r * r) * blk * 2, mm_tile_all_gather),
                ("pk_reduce_scatter", PK.ring_reduce_scatter,
                 PK.reduce_scatter_plain, parts, lambda: parts.sum(0),
                 (r * r + r) * blk * 2, mm_tile_reduce_scatter)):
            shape = f"x{tuple(arg.shape)} bf16"
            first = fn(arg)
            for nc in (2, 3, 4):
                if not torch.equal(fn(arg, n_chunks=nc), first):
                    raise AssertionError(f"{name} {shape}: n_chunks={nc} "
                                         "changed the result")
            run = partial(fn, arg)
            before = partial(yard, arg)
            bits = first.view(torch.int16)
            if not (torch.equal(bits, plain(arg).view(torch.int16))
                    and torch.equal(bits, before().view(torch.int16))):
                raise AssertionError(f"{name} {shape}: not the plain "
                                     "version's or the earlier kernel's "
                                     "bits")
            key = name + ("" if r == 2 else f"@r{r}")
            if n != 1408 or (name == "pk_all_gather" and r != 2):
                compare(name, shape, run, partial(plain, arg), TOL_BF16_OUT)
                continue
            entries[key] = record(
                name, shape, "src/repro_torch/kernels/csrc/pk_comm.cu",
                "src/repro/kernels/pk_comm.py:"
                + ("151" if name == "pk_all_gather" else "242"),
                run, partial(plain, arg), lib, TOL_BF16_OUT, nbytes, 0.0,
                before=before)
    print("[kernel] ring all-gather / reduce-scatter: bit-identical for "
          "n_chunks 1-4 at every shape, to their plain versions and to the "
          "kernels they ran on before", flush=True)
    entries.update(check_fsdp_gathers(dev, record, compare, randn))

    # moonshot-v1-16b-a3b on (1, 4): the grouped expert GEMM over all
    # G = 4 ranks x 16 experts at every shape the MoE path gives it — w1/w3
    # (K, N) = (2048, 1408) and w2 (1408, 2048), capacity C = 1 (decode),
    # 60 (128 bucket) and 240 (512 bucket), f32 out (the path's) and bf16;
    # each group's f32 bits must not depend on the groups beside it in the
    # launch or on the call; decode w1 and prefill-512 w1 (f32 out) are
    # timed, beside the kernel B9 ran on before (``mm_tile_grouped_matmul``)
    g_all = 64
    for c in (1, 60, 240):
        for k, n in ((2048, 1408), (1408, 2048)):
            x, w = randn(g_all, c, k), randn(g_all, k, n, scale=k ** -0.5)
            full = GM.grouped_matmul(x, w, out_dtype=torch.float32)
            parts = [GM.grouped_matmul(x, w, out_dtype=torch.float32)] + [
                GM.grouped_matmul(x[z:z + 1], w[z:z + 1],
                                  out_dtype=torch.float32)
                for z in (0, 37, 63)] + [
                GM.grouped_matmul(x[16:32], w[16:32],
                                  out_dtype=torch.float32)]
            for got, want in zip(parts, (full, full[0:1], full[37:38],
                                         full[63:64], full[16:32])):
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"grouped_matmul x({g_all},{c},{k})@w({g_all},{k},"
                        f"{n}): a group's bits changed with the groups "
                        "launched beside it or on a second call")
            del full, parts
            for out_dt, tol in ((torch.float32, TOL_F32_OUT),
                                (torch.bfloat16, TOL_BF16_OUT)):
                shape = (f"x({g_all},{c},{k})@w({g_all},{k},{n}) "
                         f"{str(out_dt).split('.')[-1]} out")
                run = partial(GM.grouped_matmul, x, w, out_dtype=out_dt)
                plain = partial(GM.grouped_matmul_plain, x, w,
                                out_dtype=out_dt)
                key = {1: "grouped_matmul", 240: "grouped_matmul@prefill"
                       }.get(c)
                if (k, out_dt) != (2048, torch.float32) or key is None:
                    compare("grouped_matmul", shape, run, plain, tol)
                    continue
                entries[key] = record(
                    "grouped_matmul", shape,
                    "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                    "src/repro/kernels/grouped_matmul.py:33", run, plain,
                    partial(torch.bmm, x, w), tol,
                    (x.numel() + w.numel()) * 2 + g_all * c * n * 4,
                    2.0 * g_all * c * k * n,
                    before=partial(mm_tile_grouped_matmul, x, w, out_dt))
    print("[kernel] grouped_matmul: each group's bits the same among 64 "
          "groups, alone, among 16 and on a second call, at every shape",
          flush=True)

    # flash at the moonshot prefill shape: 16 heads of 128, MHA, the
    # head-transposed views prefill passes (512 bucket timed, 128 checked)
    b, h, hd = 4, 16, 128
    for s in (512, 128):
        q, k_, v = (randn(b, s, h, hd).transpose(1, 2) for _ in range(3))
        shape = f"q({b},{h},{s},{hd}) kv({b},{h},{s},{hd}) causal strided"
        run = partial(FA.flash_attention, q, k_, v, causal=True)
        plain = partial(FA.flash_attention_plain, q, k_, v, causal=True)
        if s != 512:
            compare("flash_attention", shape, run, plain, TOL_BF16_OUT)
            continue
        entries["flash_attention@moonshot"] = record(
            "flash_attention", shape,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:73", run, plain,
            partial(F.scaled_dot_product_attention, q, k_, v,
                    is_causal=True),
            TOL_BF16_OUT, 4 * q.numel() * 2,
            4.0 * b * h * hd * (s * (s + 1) // 2),
            before=partial(mm_tile_flash, q, k_, v))

    # whisper-medium (16 heads of 64, MHA), non-causal: the encoder's
    # self-attention over 1500 frames at the serving batch (8), the
    # cross-attention of the training microbatch's 448 decoder tokens over
    # them (4 rows), both timed, and the serving check's 4-token prompt
    # over them, checked; all on the projections' head-transposed views
    h, hd, se = 16, 64, 1500
    for key, b, sq in (("flash_attention@encoder", 8, se),
                       ("flash_attention@cross", 4, 448), (None, 8, 4)):
        q = randn(b, sq, h, hd).transpose(1, 2)
        k_, v = (randn(b, se, h, hd).transpose(1, 2) for _ in range(2))
        shape = (f"q({b},{h},{sq},{hd}) kv({b},{h},{se},{hd}) non-causal "
                 "strided")
        run = partial(FA.flash_attention, q, k_, v, causal=False)
        plain = partial(FA.flash_attention_plain, q, k_, v, causal=False)
        if key is None:
            compare("flash_attention", shape, run, plain, TOL_BF16_OUT)
            continue
        entries[key] = record(
            "flash_attention", shape,
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:73", run, plain,
            partial(F.scaled_dot_product_attention, q, k_, v),
            TOL_BF16_OUT, (2 * q.numel() + k_.numel() + v.numel()) * 2,
            4.0 * b * h * hd * sq * se,
            before=partial(mm_tile_flash, q, k_, v, causal=False))

    entries.update(check_mamba_scan(dev, record, compare))
    entries.update(check_mamba_scan_bwd(dev, record, compare))
    entries.update(check_ring_kernels(dev, record, compare, randn))
    entries.update(check_tp_kernels(dev, record, compare, randn))
    entries.update(check_a2a_kernel(dev, record, randn))
    return entries


def check_a2a_kernel(dev, record, randn) -> dict:
    """Phase 3, the all-to-all kernel (``pk_comm.all_to_all``, the chunked
    backend of ``CommContext.all_to_all``; it replaces no Pallas kernel) at
    the shapes its paths give it, R = 4 ranks: Ulysses' q (4, 1, 32, 2048,
    64) split 1 concat 2 at 1 and 2 chunks, its output's inverse (4, 1, 8,
    8192, 64) split 2 concat 1 and kv (4, 1, 4, 2048, 64) at 2 chunks (the
    path's, 64-byte rows) and 1, the a2a MoE dispatch (4, 4, 16, 512, 2048)
    split = concat = 0 (phase 5g's capacity), q in f32 once; each
    bit-identical to ``all_to_all_plain`` and on a second call. Timed: q
    and the output at 2 chunks, the MoE dispatch, beside the bulk backend
    (one strided torch copy, the library call) and the bytes bound (read
    once, written once)."""
    import torch

    from repro_torch.core.comms import CommContext
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.kernels import pk_comm as PK

    ctx = CommContext("x", mesh=VirtualMesh((4,), ("x",), dev))
    entries = {}
    for shape, a, c, key in (((4, 1, 32, 2048, 64), 1, 2, "pk_all_to_all"),
                             ((4, 1, 8, 8192, 64), 2, 1, "pk_all_to_all@out"),
                             ((4, 1, 4, 2048, 64), 1, 2, None),
                             ((4, 4, 16, 512, 2048), 0, 0,
                              "pk_all_to_all@moe"),
                             ((4, 1, 32, 2048, 64), 1, 2, "f32")):
        x = randn(*shape)
        if key == "f32":
            x, key = x.float(), None
        want = PK.all_to_all_plain(x, a, c)
        chunks = (1,) if a == c else (1, 2)
        for n in chunks:
            got = [PK.all_to_all(x, a, c, n_chunks=n) for _ in range(2)]
            bits = [t.view(torch.uint8) for t in got + [want]]
            if not (torch.equal(bits[0], bits[2])
                    and torch.equal(bits[1], bits[2])):
                raise AssertionError(f"pk_all_to_all {shape} split {a} "
                                     f"concat {c} n_chunks {n}: not "
                                     f"all_to_all_plain's bits")
        print(f"[kernel] pk_all_to_all x{shape} {str(x.dtype)[6:]} split "
              f"{a} concat {c}: bit-identical to all_to_all_plain at "
              f"n_chunks {chunks}, twice each", flush=True)
        if key is None:
            continue
        n = chunks[-1]
        entries[key] = record(
            "pk_all_to_all", f"x{shape} bf16 split {a} concat {c}, "
            f"{n} chunk{'s' * (n > 1)}",
            "src/repro_torch/kernels/csrc/pk_comm.cu",
            "none: JAX's chunked all_to_all is lax.all_to_all "
            "(src/repro/core/comms.py:1258)",
            partial(PK.all_to_all, x, a, c, n_chunks=n),
            partial(PK.all_to_all_plain, x, a, c),
            partial(ctx.all_to_all, x, split_axis=a, concat_axis=c,
                    backend="bulk"), 0.0, 2 * x.numel() * x.element_size(),
            0.0, checked=(0.0, 0.0))
        del x, want, got, bits
    return entries


def check_matmul(dev, record, compare, randn) -> dict:
    """Phase 3, B1 (``kernels/matmul.py``) at the shapes its paths give it,
    against ``matmul_plain`` within ``TOL_BF16_OUT``:

    * M in (1, 8, 16, 63, 64, 65, 200) x ragged (K, N) (40, 72), (264,
      136), checked;
    * the dense decode logits as serving runs them, x (8, 2048) against the
      4 ranks' stacked head shards (4, 2048, 8000) in one launch
      (``matmul_stacked``): bit-identical to one launch a shard and to a
      second call; timed cold (rotated over 2 stacks, 262 MB);
    * one rank's shard x (8, 2048) @ w (2048, 8000), timed cold (rotated over
      the 4 shards, 131 MB);
    * the MLP-shaped compute-bound row x (2048, 2048) @ w (2048, 1408),
      timed warm as before;
    * the training loss, x (1024, 2048) @ w (2048, 8000) a rank, timed cold
      (the 4 shards), and its stacked form bit-identical to one launch a
      shard;
    * the moonshot and falcon-mamba logits, x (8, 2048) @ w (2048, 40960)
      and x (8, 4096) @ w (4096, 16256) (and the falcon prefill group's 4
      rows, checked), timed cold (2 copies each, 336 / 266 MB).

    Every timed row also times ``mm_tile_matmul``, the kernel B1 ran on
    before, by the same method (``ms_mm_tile``); the stacked row's is its
    four launches, as serving made them."""
    import torch

    from repro_torch.kernels import matmul as MM
    src, rep = ("src/repro_torch/kernels/csrc/matmul.cu",
                "src/repro/kernels/matmul.py:31")
    entries = {}

    def cost(m, k, n, r=1):
        return (m * k + r * k * n + r * m * n) * 2, 2.0 * r * m * n * k

    for m in (1, 8, 16, 63, 64, 65, 200):
        for k, n in ((40, 72), (264, 136)):
            x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
            compare("matmul", f"x({m},{k})@w({k},{n})",
                    partial(MM.matmul, x, w), partial(MM.matmul_plain, x, w),
                    TOL_BF16_OUT)

    def same_bits(x, w, shape):
        got = MM.matmul_stacked(x, w)
        ranks = torch.stack([MM.matmul(x, w[j]) for j in range(w.shape[0])])
        torch.cuda.synchronize()
        if not (torch.equal(got, ranks)
                and torch.equal(got, MM.matmul_stacked(x, w))):
            raise AssertionError(f"matmul_stacked {shape}: not bit-identical "
                                 "to one launch a shard, or to itself")
        print(f"[kernel] matmul_stacked {shape}: bit-identical to "
              f"{w.shape[0]} single launches and to a second call",
              flush=True)

    # the dense decode logits: x against the 4 ranks' stacked shards
    m, k, n, r = 8, 2048, 8000, 4
    x = randn(m, k)
    stacks = [randn(r, k, n, scale=k ** -0.5) for _ in range(2)]
    shape = f"x({m},{k})@w({r},{k},{n}) stacked"
    same_bits(x, stacks[0], shape)
    checked = compare("matmul", shape, partial(MM.matmul_stacked, x,
                                               stacks[0]),
                      partial(MM.matmul_stacked_plain, x, stacks[0]),
                      TOL_BF16_OUT)
    sets = [(x, w) for w in stacks]
    entries["matmul"] = record(
        "matmul", shape, src, rep, rotate(MM.matmul_stacked, sets),
        rotate(MM.matmul_stacked_plain, sets), rotate(torch.matmul, sets),
        TOL_BF16_OUT, *cost(m, k, n, r), checked=checked,
        before=rotate(lambda x, w: [mm_tile_matmul(x, w[j])
                                    for j in range(r)], sets),
        timing="cold (w rotated over 2 stacks, 262 MB)")
    # more slabs than a launch takes (MM.MAX_SLABS = 8), as 16 tp ranks
    # stack them on a production mesh, and an uneven count: one launch a
    # MAX_SLABS, bit-identical to one launch a slab, within the bf16 bound
    # of the plain version
    for many in (11, 16):
        ws = randn(many, k, n, scale=k ** -0.5)
        n0 = MM.matmul.launches
        got = MM.matmul_stacked(x, ws)
        torch.cuda.synchronize()
        launched = MM.matmul.launches - n0
        err = rel_err(got, MM.matmul_stacked_plain(x, ws))
        shape_many = f"x({m},{k})@w({many},{k},{n}) stacked"
        same_bits(x, ws, shape_many)
        want = MM.launches(m, n, k, many)
        print(f"[kernel] matmul_stacked {shape_many}: {launched} launches "
              f"(expected {want}), rel_err vs plain {err:.3e} (tol "
              f"{TOL_BF16_OUT})", flush=True)
        if launched != want or want != 2:
            raise AssertionError(f"matmul_stacked {shape_many}: {launched} "
                                 f"launches, not 2")
        if not err <= TOL_BF16_OUT:
            raise AssertionError(f"matmul_stacked {shape_many}: rel_err "
                                 f"{err} against the plain version")
        del ws, got
    # one rank's shard, rotated over the 4 shards of a stack
    shards = [(x, stacks[0][j]) for j in range(r)]
    shape = f"x({m},{k})@w({k},{n})"
    checked = compare("matmul", shape, partial(MM.matmul, *shards[0]),
                      partial(MM.matmul_plain, *shards[0]), TOL_BF16_OUT)
    entries["matmul@rank"] = record(
        "matmul", shape, src, rep, rotate(MM.matmul, shards),
        rotate(MM.matmul_plain, shards), rotate(torch.matmul, shards),
        TOL_BF16_OUT, *cost(m, k, n), checked=checked,
        before=rotate(mm_tile_matmul, shards),
        timing="cold (w rotated over 4 shards, 131 MB)")
    # the training loss a rank, rotated over the 4 shards; stacked bits
    xl = randn(1024, k)
    same_bits(xl, stacks[0], f"x(1024,{k})@w({r},{k},{n}) stacked")
    shards = [(xl, stacks[0][j]) for j in range(r)]
    shape = f"x(1024,{k})@w({k},{n})"
    checked = compare("matmul", shape, partial(MM.matmul, *shards[0]),
                      partial(MM.matmul_plain, *shards[0]), TOL_BF16_OUT)
    entries["matmul@loss"] = record(
        "matmul", shape, src, rep, rotate(MM.matmul, shards),
        rotate(MM.matmul_plain, shards), rotate(torch.matmul, shards),
        TOL_BF16_OUT, *cost(1024, k, n), checked=checked,
        before=rotate(mm_tile_matmul, shards),
        timing="cold (w rotated over 4 shards, 131 MB)")
    del stacks, shards, sets

    # the compute-bound MLP-shaped row, warm as it was
    m, k, n = 2048, 2048, 1408
    x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
    entries["matmul@mlp"] = record(
        "matmul", f"x({m},{k})@w({k},{n})", src, rep,
        partial(MM.matmul, x, w), partial(MM.matmul_plain, x, w),
        partial(torch.matmul, x, w), TOL_BF16_OUT, *cost(m, k, n),
        before=partial(mm_tile_matmul, x, w))

    # the moonshot logits (163840 / 4 a rank) and the falcon-mamba logits
    # (65024 / 4; a prefill group's 4 rows checked), 2 copies of w each
    for key, k, n, ms in (("matmul@moonshot", 2048, 40960, (8,)),
                          ("matmul@falcon", 4096, 16256, (4, 8))):
        ws = [randn(k, n, scale=k ** -0.5) for _ in range(2)]
        for m in ms:
            x = randn(m, k)
            shape = f"x({m},{k})@w({k},{n})"
            checked = compare("matmul", shape, partial(MM.matmul, x, ws[0]),
                              partial(MM.matmul_plain, x, ws[0]),
                              TOL_BF16_OUT)
            if m != 8:
                continue
            sets = [(x, w) for w in ws]
            entries[key] = record(
                "matmul", shape, src, rep, rotate(MM.matmul, sets),
                rotate(MM.matmul_plain, sets), rotate(torch.matmul, sets),
                TOL_BF16_OUT, *cost(m, k, n), checked=checked,
                before=rotate(mm_tile_matmul, sets),
                timing=f"cold (w rotated over 2 copies, "
                       f"{2 * k * n * 2 / 1e6:.0f} MB)")
        del ws

    # the whisper-medium decode logits on (1, 4): 51868 / 4 = 12967
    # columns a rank, no multiple of 8, so the head is stored in rows
    # padded to 12968 (``pgl.aligned_rows``) and the kernel reads them as
    # they are; stacked as serving runs it, timed cold (2 stacks, 212 MB)
    from repro_torch.core import pgl
    m, k, n, r = 8, 1024, 12967, 4
    x = randn(m, k)
    stacks = [pgl.aligned_rows(randn(r, k, n, scale=k ** -0.5))
              for _ in range(2)]
    shape = f"x({m},{k})@w({r},{k},{n}) stacked, ragged N"
    same_bits(x, stacks[0], shape)
    checked = compare("matmul", shape, partial(MM.matmul_stacked, x,
                                               stacks[0]),
                      partial(MM.matmul_stacked_plain, x, stacks[0]),
                      TOL_BF16_OUT)
    sets = [(x, w) for w in stacks]
    entries["matmul@whisper"] = record(
        "matmul", shape, src, rep, rotate(MM.matmul_stacked, sets),
        rotate(MM.matmul_stacked_plain, sets), rotate(torch.matmul, sets),
        TOL_BF16_OUT, *cost(m, k, n, r), checked=checked,
        timing="cold (w rotated over 2 stacks, 212 MB)")
    del stacks, sets
    # whisper's training loss on (2, 4) with FSDP (phase 5i): a dp group's
    # microbatch, 2 x 448 rows (compute-bound), against a gathered copy of
    # the head, laid out as the global (1024, 4 x 12968) weight seen
    # stacked (``fsdp_gather``'s order, the rows' padding kept)
    m = 2 * 448
    x = randn(m, k)
    w = randn(k, r, 12968, scale=k ** -0.5).permute(1, 0, 2)[..., :n]
    shape = f"x({m},{k})@w({r},{k},{n}) stacked, ragged N, gathered copy"
    same_bits(x, w, shape)
    compare("matmul", shape, partial(MM.matmul_stacked, x, w),
            partial(MM.matmul_stacked_plain, x, w), TOL_BF16_OUT)
    return entries


#: full-width tinyllama-1.1b's FSDP-sharded weights, tp-stacked over 4
#: ranks as stored, and the stored dim their gather runs along: rows (wq,
#: wk/wv, w1/w3, head) and columns (wo, w2, emb)
FSDP_WEIGHTS = ((4, 2048, 512, 1), (4, 2048, 64, 1), (4, 2048, 1408, 1),
                (4, 2048, 8000, 1), (4, 512, 2048, 2), (4, 1408, 2048, 2),
                (4, 8000, 2048, 2),
                # whisper-medium's: wq/wk/wv and the cross-attention's, w1,
                # wo, w2
                (4, 1024, 256, 1), (4, 1024, 1024, 1), (4, 256, 1024, 2),
                (4, 1024, 1024, 2))
#: the memory order ``fsdp_gather`` gives a copy, by gathered dim: the
#: global weight's (rows: tp-sharded over the columns, so the tp rank dim
#: sits between d and n; columns: tp over the rows, contiguous)
FSDP_ORDER = {1: (1, 0, 2), 2: None}


def check_fsdp_gathers(dev, record, compare, randn) -> dict:
    """Phase 3, B3's all-gather in its path form: every FSDP weight of the
    (2, 4) training run, rows and columns, gathered from the strided view,
    ``all_gather_stacked(dp_view(w), dim, "fused")`` over 2 dp ranks, into
    a contiguous output and into the memory order ``fsdp_gather`` gives it
    (``FSDP_ORDER``): bit-identical to the ``bulk`` backend, to the plain
    gather and to the kernel it ran on before behind its old wrapper
    (``mm_tile_path_gather``). The MLP weight w (4, 2048, 1408) is timed
    with one dp group's ``.contiguous()`` (what a consumer did to the old
    wrapper's strided result; a no-op now) beside the old wrapper and
    kernel (``ms_mm_tile``) and the ``bulk`` backend (``library_ms``); the
    call in ``fsdp_gather``'s order is timed too (``ms_fsdp_order``)."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.core.comms import all_gather_stacked
    from repro_torch.kernels import pk_comm as PK

    entries = {}
    r = 2
    for *stored, sdim in FSDP_WEIGHTS:
        w = randn(*stored)
        x = pgl.dp_view(w, sdim, r)
        shape = (f"w{tuple(stored)} bf16 along dim {sdim}, dp_view "
                 f"x{tuple(x.shape)} strided, R={r}")
        want = PK.gather_along_plain(x, sdim).view(torch.int16)
        old = mm_tile_path_gather(x, sdim).view(torch.int16)
        for order in (None, FSDP_ORDER[sdim]):
            got = all_gather_stacked(x, sdim, "fused", order)
            bits = got.view(torch.int16)
            if not (got.stride() == PK.gathered_empty(x, sdim, order)
                    .stride() and torch.equal(bits, all_gather_stacked(
                        x, sdim, "bulk", order).view(torch.int16))
                    and torch.equal(bits, want) and torch.equal(bits, old)):
                raise AssertionError(f"FSDP gather {shape} order {order}: "
                                     "not the layout asked for, or not the "
                                     "bits of bulk, the plain gather and "
                                     "the earlier kernel")
        if tuple(stored) != (4, 2048, 1408):
            continue
        entries["pk_all_gather@path"] = record(
            "pk_all_gather", "path form: all_gather_stacked + one group's "
            ".contiguous(), " + shape,
            "src/repro_torch/kernels/csrc/pk_comm.cu",
            "src/repro/kernels/pk_comm.py:151",
            lambda: all_gather_stacked(x, sdim, "fused")[0].contiguous(),
            lambda: PK.gather_along_plain(x, sdim)[0].contiguous(),
            lambda: all_gather_stacked(x, sdim, "bulk")[0].contiguous(),
            TOL_BF16_OUT, (r + r * r) * x[0].numel() * 2, 0.0,
            before=lambda: mm_tile_path_gather(x, sdim)[0].contiguous())
        entries["pk_all_gather@path"]["ms_fsdp_order"] = time_ms(
            lambda: all_gather_stacked(x, sdim, "fused", FSDP_ORDER[sdim]))
    print(f"[kernel] FSDP gathers: all {len(FSDP_WEIGHTS)} weights, rows and "
          "columns, from the strided dp_view, contiguous and in "
          "fsdp_gather's order: bit-identical to bulk, the plain gather and "
          "the earlier kernel; in fsdp_gather's order "
          f"{entries['pk_all_gather@path']['ms_fsdp_order']:.4f} ms",
          flush=True)
    check_padded_head_gather(dev, randn)
    return entries


def check_padded_head_gather(dev, randn) -> None:
    """Phase 3, whisper-medium's head on (2, 4) with FSDP: stored in rows
    padded to 16 bytes (12967 columns a rank in rows of 12968), gathered
    by ``fsdp_gather`` with its rows' padding on the all-gather kernel. The
    copies must keep rows the GEMM's tensor maps read (a multiple of 8
    elements apart) and hold the bits of the ``bulk`` backend's gather and
    of the plain gather of the unpadded leaf."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import pgl
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.core.template import fsdp_gather
    from repro_torch.kernels import pk_comm as PK
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    head = pgl.aligned_rows(randn(4, 1024, 12967))
    got = {}
    for backend in ("fused", "bulk"):
        run = RunConfig(fsdp=True, comm_backend=backend)
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev),
                              run)
        spec = T.param_template(get_config(ENCDEC_ARCH), run,
                                rules)["lm_head"].spec
        got[backend] = fsdp_gather(head, spec, rules, run, dim=0)
    want = PK.gather_along_plain(pgl.dp_view(head.contiguous(), 1, 2), 1,
                                 FSDP_ORDER[1])
    fused = got["fused"]
    if not (fused.stride(-2) % 8 == 0 and fused.shape == want.shape
            and torch.equal(fused.contiguous().view(torch.int16),
                            want.contiguous().view(torch.int16))
            and torch.equal(fused, got["bulk"])):
        raise AssertionError("whisper's padded head: the FSDP gather lost "
                             "its rows' padding or its bits")
    print(f"[kernel] FSDP gather of whisper's padded head "
          f"{tuple(head.shape)} (rows {head.stride(-2)} apart): copies "
          f"{tuple(fused.shape)}, rows {fused.stride(-2)} apart, "
          f"bit-identical to bulk and to the plain gather", flush=True)


def check_ring_kernels(dev, record, compare, randn) -> dict:
    """Phase 3, the sequence-parallel path's kernels at the shapes of the
    sp-train phase (tinyllama-1.1b, 4 ranks x 2048 tokens, batch 1):

    * the p2p ring shift on k (or v) stacked over the ranks, (4, 1, 4,
      2048, 64) bf16, and at ragged f32 and byte shapes: bit-identical to
      ``ring_shift_plain`` (a copy), every rank's arrival flag counting the
      same number of tiles; timed beside ``torch.roll``, its bound 2 x
      bytes over 3.35 TB/s;
    * the flash hop for each of the 4 hops, q (4, 32, 2048, 64) and kv (4,
      4, 2048, 64) (rank folded into the batch), causal at the ranks'
      global offsets: o and l within relative 1e-2 of the plain hop (bf16
      products, P rounded to bf16), m within 1e-3 on the rows with a
      visible key and exactly NEG_INF on the others. Each hop is timed
      (hop 1 goes into the kernels line), its bound from the work the
      hop's mask leaves (the ranks whose block comes from a later rank
      are skipped: no q/k/v read, zeros written), beside SDPA over the
      same visible work — causal over all ranks at hop 0 (every block is
      its rank's own), non-causal over the ranks whose block is full
      (src < d) at hops 1-3;
    * flash at Ulysses' local mix (phase 5f), q (4·1, 8, 8192, 64) and kv
      (4·1, 1, 8192, 64) causal, and at head_dim 120 (h2o-danube-3-4b;
      padded to 128), against its plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pk_comm as PK

    entries = {}
    r, b, hq, hkv, s, hd = 4, 1, 32, 4, 2048, 64
    flags = PK.p2p_flags(dev, torch.cuda.current_stream().cuda_stream)
    for shape, dtype in (((r, b, hkv, s, hd), torch.bfloat16),
                         ((r, 3, 5, 7), torch.float32),
                         ((r, 1001), torch.uint8)):
        for _ in range(3):              # the flags are never reset
            x = (torch.randn(shape, device=dev) * 50).to(dtype)
            start = flags.counts(r)
            got = PK.p2p_ring_shift(x)
            counts = flags.counts(r)
            tiles = PK.p2p_plan(r, x[0].numel() * x.element_size()).tiles
            if not (torch.equal(got, PK.ring_shift_plain(x))
                    and torch.equal(got, mm_tile_p2p_ring_shift(x))
                    and counts == flags.expected[:r]
                    == [(c + tiles) % 2 ** 32 for c in start]):
                raise AssertionError(
                    f"p2p_ring_shift {shape} {dtype}: not the plain roll or "
                    f"the earlier kernel's bits, or flags {start} -> "
                    f"{counts}, not {tiles} tiles more")
        print(f"[kernel] p2p_ring_shift {shape} {dtype}: 3 launches "
              f"bit-identical to ring_shift_plain and the earlier kernel, "
              f"every rank's flag {tiles} tiles more each launch (now "
              f"{counts[0]})", flush=True)
    kv = randn(r, b, hkv, s, hd)
    nbytes = 2 * kv.numel() * kv.element_size()
    entries["p2p_ring_shift"] = record(
        "p2p_ring_shift", f"x{tuple(kv.shape)} bf16",
        "src/repro_torch/kernels/csrc/pk_comm.cu",
        "src/repro/kernels/pk_comm.py:284", partial(PK.p2p_ring_shift, kv),
        partial(PK.ring_shift_plain, kv), partial(torch.roll, kv, 1, 0),
        0.0, nbytes, 0.0, before=partial(mm_tile_p2p_ring_shift, kv))

    q = randn(r * b, hq, s, hd)
    k_, v = randn(r * b, hkv, s, hd), randn(r * b, hkv, s, hd)
    kr = k_.repeat_interleave(hq // hkv, 1)
    vr = v.repeat_interleave(hq // hkv, 1)
    shape = (f"q({r}*{b},{hq},{s},{hd}) kv({r}*{b},{hkv},{s},{hd}) causal "
             "global offsets")
    for hop in range(r):
        run = partial(FA.flash_attention_hop, q, k_, v, ranks=r, hop=hop)
        got, want = run(), FA.flash_attention_hop_plain(q, k_, v, ranks=r,
                                                        hop=hop)
        torch.cuda.synchronize()
        dead = want[2] == 0
        errs = (rel_err(got[0], want[0]), rel_err(got[2], want[2]),
                rel_err(got[1][~dead], want[1][~dead]))
        print(f"[kernel] flash_attention_hop hop {hop} {shape}: rel_err o "
              f"{errs[0]:.3e} l {errs[1]:.3e} (tol 1e-2), m {errs[2]:.3e} "
              f"(tol 1e-3); {int(dead.sum())} rows see no key", flush=True)
        if not (errs[0] <= TOL_BF16_OUT and errs[1] <= TOL_BF16_OUT
                and errs[2] <= TOL_F32_OUT
                and torch.equal(got[1][dead], want[1][dead])
                and not bool(got[2][dead].any() or got[0][dead].any())):
            raise AssertionError(f"flash_attention_hop hop {hop} disagrees "
                                 f"with its plain version: {errs}")
        live = r if hop == 0 else r - hop      # ranks with a visible block
        pairs = live * s * (s + 1) // 2 if hop == 0 else live * s * s
        lo = 0 if hop == 0 else hop
        library = partial(F.scaled_dot_product_attention, q[lo:], kr[lo:],
                          vr[lo:], is_causal=hop == 0)
        entries[f"flash_attention_hop@{hop}"] = record(
            "flash_attention_hop", f"hop {hop}, {shape}",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:73", run,
            partial(FA.flash_attention_hop_plain, q, k_, v, ranks=r,
                    hop=hop), library, TOL_BF16_OUT,
            live * b * (hq + 2 * hkv) * s * hd * 2
            + r * b * hq * s * (hd + 2) * 4,
            4.0 * b * hq * hd * pairs, plain_iters=2,
            checked=(errs[0], float((got[0] - want[0]).abs().max())),
            before=partial(mm_tile_flash_hop, q, k_, v, r, hop))
        del got, want
    entries["flash_attention_hop"] = entries.pop("flash_attention_hop@1")

    # Ulysses' local mix (phase 5f): the 4 ranks folded into the batch, each
    # with 8 of the 32 q heads and 1 of the 4 KV heads over all 8192 tokens
    q, k_, v = (randn(r * b, h, r * s, hd) for h in (hq // r, hkv // r,
                                                     hkv // r))
    compare("flash_attention", f"q({r}*{b},{hq // r},{r * s},{hd}) "
            f"kv({r}*{b},{hkv // r},{r * s},{hd}) causal (Ulysses' local "
            "mix)", partial(FA.flash_attention, q, k_, v),
            partial(FA.flash_attention_plain, q, k_, v), TOL_BF16_OUT)
    del q, k_, v

    # C6: h2o-danube-3-4b's head_dim 120 (32 q heads, 8 KV heads), padded
    q, k_, v = (randn(2, 512, h, 120).transpose(1, 2) for h in (32, 8, 8))
    compare("flash_attention", "q(2,32,512,120) kv(2,8,512,120) causal "
            "window 4096 strided (head_dim padded to 128)",
            partial(FA.flash_attention, q, k_, v, window=4096),
            partial(FA.flash_attention_plain, q, k_, v, window=4096),
            TOL_BF16_OUT)
    return entries


def check_tp_kernels(dev, record, compare, randn) -> dict:
    """Phase 3, the kernels of the TP GEMM pair (phase 5e), R = 4 ranks:

    * AG×GEMM at tinyllama's MLP gate/up projection, x (4, 1024, 2048) @
      w (4, 2048, 2816) (timed), a Fig. 7 shape, x (4, 1024, 1024) @ w
      (4, 1024, 1024), and a ragged one (m_loc 100, n 200): bf16 out within
      ``TOL_BF16_OUT`` of ``ag_matmul_plain``;
    * GEMM×RS at the MLP down projection, x (4, 4096, 1408) @ w (4, 1408,
      2048) (timed), a Fig. 8 shape, x (4, 4096, 512) @ w (4, 512, 1024),
      and a ragged one (m/R 50, n 120): f32 out within ``TOL_F32_OUT`` of
      ``matmul_rs_plain``;
    * each bit-identical for n_chunks 1-4 at every shape, and GEMM×RS
      bit-identical to GEMM×AR's owner rows (on every rank) at every shape;
    * each timed row also times the mma.sync kernel it ran on before
      (``ms_mm_tile``);
    * the LCSC ring all-gather at every shape phase 3 runs the ring
      all-gather at, and at ragged f32 and byte shapes (the word route),
      each launched twice in a row, then again in reverse order (the
      never-reset flags holding other shapes' epochs): bit-identical to
      ``all_gather_plain`` and to ``pk_comm.ring_all_gather``; timed at the
      training run's MLP shard over 2, 4 and 8 ranks, (R, 2048 / R, 4,
      1408), beside ``repeat`` and the step-synchronous kernel it ran on
      before (``mm_tile_lcsc_all_gather``), whose bits it also equals.

    Bounds: AG×GEMM and GEMM×RS by their operations (2·R·m·k·n over 989
    TFLOP/s) against their bytes (x, w read once; the output written
    once); the all-gather by bytes (R·blk read, R²·blk written); the LCSC
    rows' print lines also give the ring's own floor (R (R - 1) blk read
    and R² blk written, what a ring of dependent hops must move), which is
    no key of their entries."""
    import torch

    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK

    entries = {}
    r = 4
    cases = (
        ("ag_matmul_fused", CM.ag_matmul_fused, CM.ag_matmul_plain,
         "src/repro/kernels/collective_matmul.py:116", TOL_BF16_OUT,
         ((1024, 2048, 2816, True), (1024, 1024, 1024, False),
          (100, 264, 200, False))),
        ("matmul_rs_fused", CM.matmul_rs_fused, CM.matmul_rs_plain,
         "src/repro/kernels/collective_matmul.py:231", TOL_F32_OUT,
         ((4096, 1408, 2048, True), (4096, 512, 1024, False),
          (200, 136, 120, False))))
    for name, fn, plain_fn, replaces, tol, shapes in cases:
        ag = name == "ag_matmul_fused"
        for m, k, n, timed in shapes:
            x = randn(r, m, k)
            w = randn(r, k, n, scale=(k if ag else r * k) ** -0.5)
            shape = f"x({r},{m},{k})@w({r},{k},{n})"
            run, plain = partial(fn, x, w), partial(plain_fn, x, w)
            first = run()
            for nc in (2, 3, 4):
                if not torch.equal(fn(x, w, n_chunks=nc), first):
                    raise AssertionError(f"{name} {shape}: n_chunks={nc} "
                                         "changed the result")
            if not ag:      # RS and AR share the plan and the sums
                ar = CM.matmul_ar_fused(x, w)
                torch.cuda.synchronize()
                if not all(torch.equal(first[o], ar[d, o * (m // r):
                                                     (o + 1) * (m // r)])
                           for o in range(r) for d in range(r)):
                    raise AssertionError(f"{name} {shape}: not matmul_ar_"
                                         "fused's owner rows bit for bit")
                print(f"[kernel] {name} {shape}: bit-identical to "
                      "matmul_ar_fused's owner rows on every rank",
                      flush=True)
            if not timed:
                compare(name, shape, run, plain, tol)
                continue
            if ag:      # the gathered x against every rank's w
                library = partial(torch.matmul, x.reshape(-1, k), w)
                out_bytes = r * r * m * n * 2
                flops = 2.0 * r * (r * m) * k * n
            else:
                library = lambda x=x, w=w: torch.matmul(x, w).sum(0)  # noqa
                out_bytes = m * n * 4
                flops = 2.0 * r * m * k * n
            entries[name] = record(
                name, shape,
                "src/repro_torch/kernels/csrc/collective_matmul.cu",
                replaces, run, plain, library, tol,
                (x.numel() + w.numel()) * 2 + out_bytes, flops,
                before=(partial(mm_tile_ag_matmul, x, w) if ag
                        else partial(mm_tile_reduce, x, w, False)))
    print("[kernel] ag_matmul_fused / matmul_rs_fused: bit-identical for "
          "n_chunks 1-4 at every shape", flush=True)

    lcsc_cases = ((2, (1024, 4, 64), torch.bfloat16),
                  (2, (1024, 4, 512), torch.bfloat16),
                  (2, (1024, 4, 1408), torch.bfloat16),
                  (2, (1024, 4, 8000), torch.bfloat16),
                  (4, (512, 4, 1408), torch.bfloat16),
                  (8, (256, 4, 1408), torch.bfloat16),
                  (8, (3, 5, 7), torch.float32),
                  (4, (1001,), torch.uint8))
    xs = [(torch.randn((rr, *shape), device=dev) * 50).to(dtype)
          for rr, shape, dtype in lcsc_cases]
    # every shape twice in a row, then the shapes again in reverse: the
    # never-reset flags hold other shapes' old epochs at each launch
    for x in xs + xs[::-1]:
        for _ in range(2):
            got = LC.lcsc_ring_all_gather(x)
            torch.cuda.synchronize()
            if not (torch.equal(got, PK.all_gather_plain(x))
                    and torch.equal(got, PK.ring_all_gather(x))):
                raise AssertionError(f"lcsc_ring_all_gather "
                                     f"{tuple(x.shape)} {x.dtype}: not the "
                                     "plain gather or B3's")
    for x in xs:
        print(f"[kernel] lcsc_ring_all_gather {tuple(x.shape)} {x.dtype}: "
              "bit-identical to all_gather_plain and ring_all_gather over "
              "repeated and alternating launches", flush=True)
    for x in xs:
        rr = x.shape[0]
        if tuple(x.shape[1:]) != (2048 // rr, 4, 1408):
            continue
        blk = x[0].numel()
        if not torch.equal(mm_tile_lcsc_all_gather(x),
                           LC.lcsc_ring_all_gather(x)):
            raise AssertionError(f"lcsc_ring_all_gather {tuple(x.shape)}: "
                                 "not the earlier kernel's bits")
        key = "lcsc_ring_all_gather" + ("" if rr == 2 else f"@r{rr}")
        entries[key] = record(
            "lcsc_ring_all_gather", f"x{tuple(x.shape)} bf16",
            "src/repro_torch/kernels/csrc/lcsc.cu",
            "src/repro/kernels/lcsc.py:110",
            partial(LC.lcsc_ring_all_gather, x),
            partial(PK.all_gather_plain, x),
            lambda x=x, rr=rr: x.unsqueeze(0).repeat(rr, 1, 1, 1, 1),
            0.0, (rr + rr * rr) * blk * 2, 0.0, checked=(0.0, 0.0),
            before=partial(mm_tile_lcsc_all_gather, x))
        # the ring's own floor: R (R - 1) blk read and R^2 blk written
        floor = bound_ms((rr * (rr - 1) + rr * rr) * blk * 2, 0.0)[0]
        e = entries[key]
        print(f"[kernel] lcsc_ring_all_gather x{tuple(x.shape)}: "
              f"{e['ms']:.4f} ms = {e['bound_ms'] / e['ms']:.0%} of the "
              f"gather's bound, {floor / e['ms']:.0%} of the "
              f"ring's floor {floor:.4f}; "
              f"{e['ms'] / e['ms_mm_tile']:.2f} x the earlier kernel",
              flush=True)
    return entries


def check_mamba_scan(dev, record, compare) -> dict:
    """Phase 3, the selective scan at falcon-mamba-7b's serving shapes
    (D = 8192, N = 16; the model's types: dt f32, x, b, c bf16, a and the
    state f32, the state stacked over the 4 virtual ranks as the cache
    holds it): the prefill groups of the SSM serving run (4 rows, S = 60,
    174, 405) and decode (B = 8, S = 1, nonzero h0), against the plain
    sequential f32 recurrence — relative Frobenius error of y and h_last
    <= 1e-3 (f32 outputs). The SSM serving run's own prefills follow: exact
    buckets make each prompt length a group of one, so every length of its
    trace (``ssm_prompt_lengths``) is checked at B = 1, the launch
    ``scan_plan`` gives them (64-channel tiles). Then bit-identity at B = 4
    and B = 1: chunk 1, 64 and 256 give the same bits, and S + 4 steps in
    one launch equal S steps then 4 single steps chained through h0. S =
    405 at B = 4 and B = 1, and decode are timed; no single PyTorch call
    computes a selective scan, so there is no library time. Bound: bytes
    (dt, x, y over (B, S, D); b, c over (B, S, N); a; the state read once
    and written once) over 3.35 TB/s, or 7 f32 operations per (b, t, d, n)
    (the exponential counted as one) over 67 TFLOP/s. Each timed row also
    times the kernel the scan ran on before (``mm_tile_mamba_scan``,
    ``ms_mm_tile``), and its exponential floor (``exp_floor_ms``: B·S·D·N
    exponentials at 16 an SM a clock at the card's highest SM clock) is
    printed beside it."""
    import torch

    from repro_torch.kernels import mamba_scan as MS

    g = torch.Generator(device=dev).manual_seed(5)
    d, n, r = 8192, 16, 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_mhz()

    def inputs(b, s):
        def f(*sh):
            return torch.randn(sh, generator=g, device=dev)
        h0 = f(b, d, n).unflatten(1, (r, d // r)).movedim(1, 0).contiguous()
        return (torch.nn.functional.softplus(f(b, s, d) - 2.0),
                f(b, s, n).to(torch.bfloat16), f(b, s, n).to(torch.bfloat16),
                f(b, s, d).to(torch.bfloat16), -torch.exp(f(d, n)), h0)

    def cost(b, s):
        nbytes = b * s * d * (4 + 2 + 4) + 2 * b * s * n * 2 + d * n * 4 \
            + 2 * b * d * n * 4
        return nbytes, 7.0 * b * s * d * n

    entries = {}
    lengths = sorted(ssm_prompt_lengths())
    rows = [(4, 60, None), (4, 174, None), (4, 405, "mamba_scan@prefill"),
            (8, 1, "mamba_scan")]
    rows += [(1, s, "mamba_scan@prefill-b1" if s == lengths[-1] else None)
             for s in lengths]
    for b, s, key in rows:
        args = inputs(b, s)
        shape = (f"dt({b},{s},{d}) f32, x/b/c bf16, N={n}, h0 stacked "
                 f"({r},{b},{d // r},{n})")
        for part in (0, 1):
            compare(f"mamba_scan {'y' if part == 0 else 'h_last'}", shape,
                    lambda: MS.mamba_scan(*args)[part],
                    lambda: MS.mamba_scan_plain(*args)[part], TOL_F32_OUT)
        if key is None:
            continue
        entries[key] = record(
            "mamba_scan", shape,
            "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "src/repro/kernels/mamba_scan.py:53",
            lambda: MS.mamba_scan(*args)[0],
            lambda: MS.mamba_scan_plain(*args)[0], None,
            TOL_F32_OUT, *cost(b, s), peak=PEAK_F32_FLOPS,
            plain_iters=20 if s == 1 else 2,
            before=lambda: mm_tile_mamba_scan(*args)[0])
        print(f"[kernel] mamba_scan {shape}: exp_floor_ms="
              f"{exp_floor_ms(b, s, d, n, sms, clock):.4f} (B·S·D·N "
              f"exponentials at 16 an SM a clock, {sms} SMs at {clock:.0f} "
              f"MHz)", flush=True)

    # bit-identity at the 174 prefill group, as a group of 4 and as the
    # serving run's group of one: every chunk, and S + 4 steps against S
    # steps then 4 decode steps chained through h0
    s, k = 170, 4
    for b in (4, 1):
        dt, bm, cm, x, a, h0 = inputs(b, s + k)
        full = MS.mamba_scan(dt, bm, cm, x, a, h0)
        for chunk in (1, 64, 256):
            y, h = MS.mamba_scan(dt, bm, cm, x, a, h0, chunk=chunk)
            if not (torch.equal(y, full[0]) and torch.equal(h, full[1])):
                raise AssertionError(f"mamba_scan: B={b} chunk={chunk} "
                                     "changed the result")
        y, h = MS.mamba_scan(dt[:, :s], bm[:, :s], cm[:, :s], x[:, :s], a,
                             h0)
        ys = [y]
        for i in range(s, s + k):
            y, h = MS.mamba_scan(dt[:, i:i + 1], bm[:, i:i + 1],
                                 cm[:, i:i + 1], x[:, i:i + 1], a, h)
            ys.append(y)
        torch.cuda.synchronize()
        if not (torch.equal(torch.cat(ys, 1), full[0])
                and torch.equal(h, full[1])):
            raise AssertionError(f"mamba_scan: B={b}: S + k steps in one "
                                 "launch differ from S steps then k chained "
                                 "single steps")
        print(f"[kernel] mamba_scan: B={b} bit-identical for chunk 1, 64, "
              f"256 and for {s} + {k} steps chained through h0", flush=True)
    return entries


def check_mamba_scan_bwd(dev, record, compare) -> dict:
    """Phase 3, the selective scan's backward (B10-bwd, no Pallas
    counterpart: JAX differentiates its XLA scan) at falcon-mamba-7b's
    training shapes — the 5l run's microbatch dt (4, 512, 8192), the dp
    group's half (2, 512, 8192) — and its serving prefill shape (4, 405,
    8192); dt and dy f32, x, b, c bf16, N 16, h0 = 0 as in training,
    against ``mamba_scan_bwd_plain`` (the sequential f32 reverse
    recurrence) on the card: every output's relative Frobenius error <=
    1e-3 (ddt and da f32; dx, db, dc rounded once to bf16 on both sides).
    Then the same bits for segments of 1, 3 and 8 steps (8 is the path's;
    3 divides neither 512 nor 405, 8 not 405: ragged last segments) and on
    a second call.
    Bound: bytes (dt, x, dy read, ddt, dx written over (B, S, D); b, c
    read and db, dc written over (B, S, N); a read, da written) over 3.35
    TB/s, or 18 f32 operations per (b, t, d, n) — the forward step that
    rebuilds h_{t-1} and the reverse step, the exponential counted as one
    — over 67 TFLOP/s; the exponential floor (two exponentials a state a
    step: abar for the reverse step and for the rebuilt forward) printed
    beside it. No PyTorch call computes the scan's backward: no library
    time."""
    import torch

    from repro_torch.kernels import mamba_scan as MS

    g = torch.Generator(device=dev).manual_seed(6)
    d, n = 8192, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_mhz()

    def inputs(b, s):
        def f(*sh):
            return torch.randn(sh, generator=g, device=dev)
        return (torch.nn.functional.softplus(f(b, s, d) - 2.0),
                f(b, s, n).to(torch.bfloat16), f(b, s, n).to(torch.bfloat16),
                f(b, s, d).to(torch.bfloat16), -torch.exp(f(d, n)),
                torch.zeros(b, d, n, device=dev), f(b, s, d))

    def cost(b, s):
        nbytes = b * s * d * (4 + 2 + 4 + 4 + 2) + 4 * b * s * n * 2 \
            + 2 * d * n * 4
        return nbytes, 18.0 * b * s * d * n

    entries = {}
    for b, s, key in ((4, 512, "mamba_scan_bwd"),
                      (2, 512, "mamba_scan_bwd@dp-half"),
                      (4, 405, "mamba_scan_bwd@prefill")):
        args = inputs(b, s)
        shape = (f"dt({b},{s},{d}) f32, x/b/c bf16, N={n}, dy f32, h0 0")
        got = MS.mamba_scan_bwd(*args)
        want = MS.mamba_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for name, gv, wv in zip(("ddt", "db", "dc", "dx", "da"), got, want):
            if gv.dtype != wv.dtype or gv.shape != wv.shape:
                raise AssertionError(f"mamba_scan_bwd {name}: {gv.dtype} "
                                     f"{tuple(gv.shape)} against the plain "
                                     f"{wv.dtype} {tuple(wv.shape)}")
            errs[name] = (rel_err(gv, wv),
                          float((gv.float() - wv.float()).abs().max()))
        print(f"[kernel] mamba_scan_bwd {shape}: rel_err "
              f"{ {k: f'{v[0]:.3e}' for k, v in errs.items()} } (tol "
              f"{TOL_F32_OUT:g})", flush=True)
        if not all(v[0] <= TOL_F32_OUT for v in errs.values()):
            raise AssertionError(f"mamba_scan_bwd {shape} disagrees with "
                                 f"its plain version: {errs}")
        for seg in (1, 3, MS.BWD_SEG_MAX, None):
            again = (MS.mamba_scan_bwd(*args) if seg is None
                     else MS._launch_bwd(*args, seg=seg))
            if not all(torch.equal(p, q) for p, q in zip(again, got)):
                raise AssertionError(f"mamba_scan_bwd {shape}: segments of "
                                     f"{seg or 'the plan'} steps changed the "
                                     "bits")
        print(f"[kernel] mamba_scan_bwd {shape}: bit-identical for segments "
              f"of 1, 3 and {MS.BWD_SEG_MAX} steps and a second call",
              flush=True)
        worst = (max(v[0] for v in errs.values()),
                 max(v[1] for v in errs.values()))
        entries[key] = record(
            "mamba_scan_bwd", shape,
            "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
            "none: JAX differentiates its XLA associative scan "
            "(src/repro/models/ssm.py:33); the forward's Pallas kernel is "
            "src/repro/kernels/mamba_scan.py:53",
            lambda: MS.mamba_scan_bwd(*args),
            lambda: MS.mamba_scan_bwd_plain(*args), None, TOL_F32_OUT,
            *cost(b, s), peak=PEAK_F32_FLOPS, plain_iters=2,
            checked=worst)
        entries[key]["rel_err_by_output"] = {k: v[0]
                                             for k, v in errs.items()}
        floor = 2 * exp_floor_ms(b, s, d, n, sms, clock)
        entries[key]["exp_floor_ms"] = floor
        print(f"[kernel] mamba_scan_bwd {shape}: exp_floor_ms={floor:.4f} "
              f"(2 B·S·D·N exponentials at 16 an SM a clock, {sms} SMs at "
              f"{clock:.0f} MHz)", flush=True)
    return entries


def check_backward(dev) -> None:
    """Phase 3b: the autograd wrappers' outputs and gradients against
    plain-torch autograd of the plain versions, at the training path's
    shapes (per dp group and microbatch: 2 x 512 tokens; attention over the
    microbatch's 4 sequences). Tolerance: relative error <= 2e-2 — bf16
    products (and bf16 cotangents) on both sides, summed in other orders."""
    import torch

    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import matmul as MM

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    def grads(fn, args):
        args = [a.detach().requires_grad_(True) for a in args]
        y = fn(*args)
        gy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
        return [y, *torch.autograd.grad(y, args, gy)]

    b, s, hq, hkv, hd = 4, 512, 32, 4, 64
    cases = (
        ("matmul", "x(1024,2048)@w(2048,8000)", MM.matmul, MM.matmul_plain,
         (randn(1024, 2048), randn(2048, 8000, scale=2048 ** -0.5))),
        ("flash_attention", f"q({b},{hq},{s},{hd}) kv({b},{hkv},{s},{hd}) "
         "causal strided",
         partial(FA.flash_attention, causal=True),
         partial(FA.flash_attention_plain, causal=True),
         tuple(randn(b, s, h, hd).transpose(1, 2) for h in (hq, hkv, hkv))),
        ("matmul_stacked", "x(1024,2048)@w(4,2048,8000)", MM.matmul_stacked,
         MM.matmul_stacked_plain,
         (randn(1024, 2048), randn(4, 2048, 8000, scale=2048 ** -0.5))),
        ("pk_matmul_ar", "x(4,1024,1408)@w(4,1408,2048)", CM.matmul_ar_fused,
         CM.matmul_ar_plain,
         (randn(4, 1024, 1408), randn(4, 1408, 2048, scale=5632 ** -0.5))))
    # the grouped GEMM (B9) at moonshot's MoE training shapes: 64 groups (4
    # ranks x 16 experts), capacity 240 (2,048 tokens a group) and 120
    # (5k's 1,024), w1/w3 (K 2048) and w2 (K 1408), f32 out; its backward
    # is torch.matmul
    for c in (240, 120):
        for k, n in ((2048, 1408), (1408, 2048)):
            cases += (("grouped_matmul", f"x(64,{c},{k})@w(64,{k},{n}) "
                       "f32 out",
                       partial(GM.grouped_matmul, out_dtype=torch.float32),
                       partial(GM.grouped_matmul_plain,
                               out_dtype=torch.float32),
                       (randn(64, c, k), randn(64, k, n, scale=k ** -0.5))),)
    for name, shape, fn, plain, args in cases:
        gen_state = g.get_state()
        got = grads(fn, args)
        g.set_state(gen_state)                  # the same cotangent
        want = grads(plain, args)
        torch.cuda.synchronize()
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        print(f"[backward] {name} {shape}: rel_err output {errs[0]:.3e}, "
              f"grads {', '.join(f'{e:.3e}' for e in errs[1:])} (tol 2e-2)",
              flush=True)
        if not max(errs) <= 2e-2:
            raise AssertionError(f"{name} autograd disagrees with plain "
                                 f"autograd: {errs}")


KERNEL_COUNTERS = ("matmul", "flash_attention", "pk_matmul_ar",
                   "pk_all_gather", "pk_reduce_scatter", "grouped_matmul",
                   "mamba_scan", "p2p_ring_shift", "flash_attention_hop",
                   "ag_matmul_fused", "matmul_rs_fused",
                   "lcsc_ring_all_gather", "pk_all_to_all",
                   "mamba_scan_bwd")
MOE_ARCH = "moonshot-v1-16b-a3b"
SSM_ARCH = "falcon-mamba-7b"


def ssm_serve_config():
    """The SSM serving run's settings: exact buckets, one per prompt
    length, so every prefill group is one request."""
    from repro_torch.configs.base import ServeConfig
    return ServeConfig(max_batch=8, prefill_batch=4, bucket_edges=(128, 512),
                       max_new_tokens=32, exact_buckets=True)


def ssm_prompt_lengths() -> list[int]:
    """The prompt lengths of the SSM serving run's trace (8 requests, seed
    0), each a prefill of one row."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_trace
    return [len(p) for p in synthetic_trace(
        8, ssm_serve_config(), get_config(SSM_ARCH).vocab_size, seed=0)]


def _counters():
    """Each kernel's launch counter: (module, wrapper attribute)."""
    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import pk_comm as PK
    return {"matmul": MM.matmul, "flash_attention": FA.flash_attention,
            "pk_matmul_ar": CM.matmul_ar_fused,
            "pk_all_gather": PK.ring_all_gather,
            "pk_reduce_scatter": PK.ring_reduce_scatter,
            "grouped_matmul": GM.grouped_matmul,
            "mamba_scan": MS.mamba_scan,
            "mamba_scan_bwd": MS.mamba_scan_bwd,
            "p2p_ring_shift": PK.p2p_ring_shift,
            "flash_attention_hop": FA.flash_attention_hop,
            "ag_matmul_fused": CM.ag_matmul_fused,
            "matmul_rs_fused": CM.matmul_rs_fused,
            "lcsc_ring_all_gather": LC.lcsc_ring_all_gather,
            "pk_all_to_all": PK.all_to_all}


def check_logits_launches(tag: str, launches: dict, st: dict) -> None:
    """A serving run computes its logits once a step, all ranks' vocab
    shards in one stacked launch: B1 launches exactly prefill + decode
    steps times."""
    want = st["prefill_steps"] + st["decode_steps"]
    print(f"[{tag}] matmul launches {launches['matmul']}, expected one a "
          f"step: {want}", flush=True)
    if launches["matmul"] != want:
        raise AssertionError(f"{tag} launched matmul {launches['matmul']} "
                             f"times, not {want}")


def serve(dev) -> dict:
    """Phase 4: the port's main path, with launch counts around it.
    Returns (launches, each request's greedy tokens)."""
    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import build_engine, synthetic_trace

    cfg_serve = ServeConfig(max_batch=8, prefill_batch=4,
                            bucket_edges=(128, 512), max_new_tokens=32)

    def engine(backend):
        return build_engine(
            "tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
            serve=cfg_serve, seed=0, device=dev,
            run_overrides={"comm_backend": backend,
                           "pk_attn_out_island": True})

    t0 = time.perf_counter()
    eng = engine("fused")
    trace = synthetic_trace(8, cfg_serve, eng.cfg.vocab_size, seed=0)
    print(f"[serve] engine built in {time.perf_counter() - t0:.1f}s: "
          f"{eng.cfg.name} n_layers={eng.cfg.n_layers} "
          f"d_model={eng.cfg.d_model} mesh=(1, 4) on {dev}; prompt lengths "
          f"{[len(p) for p in trace]}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar")}
    for fn in counters.values():
        fn.launches = 0
    done = eng.run(trace)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    step_ms = {kind: 1e3 * statistics.median(
        t for k, t in zip(eng.step_kinds, eng.step_times) if k == kind)
        for kind in ("prefill", "decode")}
    print(f"[serve] median step wall time (host clock, each step ends in a "
          f"device->host copy): prefill {step_ms['prefill']:.2f} ms, decode "
          f"{step_ms['decode']:.2f} ms", flush=True)
    print(f"[serve] {len(done)}/{len(trace)} requests, "
          f"{st['tokens_generated']} tokens in {st['wall_s']:.3f}s "
          f"({st['tokens_per_s']:.1f} tok/s); {st['prefill_steps']} prefill "
          f"+ {st['decode_steps']} decode steps; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated(dev)} B; launches {launches}",
          flush=True)
    if len(done) != len(trace) or any(
            len(c.tokens) != cfg_serve.max_new_tokens for c in done):
        raise AssertionError("not every request completed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the serving run launched no {name} kernel")
    check_logits_launches("serve", launches, st)

    # the same trace through the bulk backend: no GEMM+AR kernel
    ref = engine("bulk")
    ref_done = {c.rid: c.tokens for c in ref.run(trace)}
    same = sum(a == b for c in done for a, b in zip(c.tokens,
                                                    ref_done[c.rid]))
    total = sum(len(c.tokens) for c in done)
    group = [p for p in trace if cfg_serve.bucket_for(len(p))
             == cfg_serve.bucket_for(len(trace[0]))][:cfg_serve.prefill_batch]
    lf, lb = eng.prefill_logits(group), ref.prefill_logits(group)
    del eng
    lr = engine("ring").prefill_logits(group)   # a third summation order
    for lg in (lf, lb, lr):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite prefill logits")
    print(f"[serve] fused vs bulk: {same}/{total} greedy tokens agree "
          f"({same / total:.3f}); first prefill group logits max |diff| "
          f"fused-bulk {float((lf - lb).abs().max()):.4e}, ring-bulk "
          f"{float((lr - lb).abs().max()):.4e} (scale "
          f"{float(lb.abs().max()):.3e})", flush=True)
    return launches, {c.rid: c.tokens for c in done}


def check_reference(dev) -> None:
    """Phase 4b: the card's path against the port's plain f32 path on the
    CPU, on a small input — tinyllama-1.1b at full width cut to 2 layers,
    the same weights (bf16 values widened to f32), one prefill group of 4
    short prompts, then their greedy tokens. Tolerance: relative Frobenius
    error of the logits <= 3e-2 — two layers round some twenty bf16
    intermediates per element (rms 2^-9/sqrt(3) each), about 1e-2 in all,
    and the tolerance allows three times that."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.transformer import leaves, set_path
    from repro_torch.runtime.serving import ServingEngine

    serve_cfg = ServeConfig(max_batch=4, prefill_batch=4, bucket_edges=(64,),
                            max_new_tokens=3)
    gpu = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                       serve=serve_cfg, seed=1, device=dev,
                       run_overrides={"comm_backend": "fused",
                                      "pk_attn_out_island": True})
    cfg = dataclasses.replace(gpu.cfg, n_layers=2)
    gpu = ServingEngine(cfg, gpu.base_run, gpu.rules, {
        **gpu.params, "blocks": {"pos0": {
            g: {k: t[:2] for k, t in sub.items()}
            for g, sub in gpu.params["blocks"]["pos0"].items()}}},
        serve_cfg, device=dev)
    params = {}
    for path, t in leaves(gpu.params):
        set_path(params, path, t.float().cpu())
    cpu_rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), "cpu"),
                              gpu.base_run)
    cpu = ServingEngine(dataclasses.replace(cfg, dtype="float32"),
                        gpu.base_run, cpu_rules, params, serve_cfg,
                        device="cpu")
    trace = synthetic_trace(4, serve_cfg, cfg.vocab_size, seed=1)
    want = cpu.prefill_logits(trace)
    got = gpu.prefill_logits(trace).cpu()
    err = rel_err(got, want)
    print(f"[reference] 2-layer full-width prefill logits, card (bf16 "
          f"kernels) vs cpu (f32 plain): rel_err={err:.3e} (tol 3e-2), "
          f"max |diff| {float((got - want).abs().max()):.3e}", flush=True)
    if not err <= 3e-2:
        raise AssertionError(f"card logits disagree with the f32 plain "
                             f"path: rel_err {err:.3e}")
    got_t = {c.rid: c.tokens for c in gpu.run(trace)}
    want_t = {c.rid: c.tokens for c in cpu.run(trace)}
    same = sum(a == b for r in got_t for a, b in zip(got_t[r], want_t[r]))
    print(f"[reference] greedy tokens card vs cpu: {same}/"
          f"{sum(map(len, got_t.values()))} agree", flush=True)


def serve_moe(dev) -> dict:
    """Phase 4c: the MoE serving path — moonshot-v1-16b-a3b at full width
    and depth on 4 virtual ranks (expert parallel: 16 experts per rank),
    with launch counts around it; then, on the same parameters (built
    once), the ring-combine engine, the MoE block check (4c') and the
    2-layer reference (4d). Frees everything before returning."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.transformer import leaves
    from repro_torch.runtime.serving import ServingEngine

    cfg_serve = ServeConfig(max_batch=8, prefill_batch=4,
                            bucket_edges=(128, 512), max_new_tokens=32)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = build_engine(MOE_ARCH, reduced=False, mesh_shape=(1, 4),
                       serve=cfg_serve, seed=0, device=dev,
                       run_overrides={"comm_backend": "fused",
                                      "pk_attn_out_island": True})
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(eng.params))
    trace = synthetic_trace(8, cfg_serve, eng.cfg.vocab_size, seed=0)
    print(f"[serve-moe] engine built in {time.perf_counter() - t0:.1f}s: "
          f"{eng.cfg.name} n_layers={eng.cfg.n_layers} d_model="
          f"{eng.cfg.d_model} experts={eng.cfg.n_experts} top_k="
          f"{eng.cfg.top_k} mesh=(1, 4) on {dev}; parameters {n_bytes} B; "
          f"prompt lengths {[len(p) for p in trace]}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "grouped_matmul")}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    done = eng.run(trace)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    step_ms = {kind: 1e3 * statistics.median(
        t for k, t in zip(eng.step_kinds, eng.step_times) if k == kind)
        for kind in ("prefill", "decode")}
    print(f"[serve-moe] median step wall time (host clock, each step ends "
          f"in a device->host copy): prefill {step_ms['prefill']:.2f} ms, "
          f"decode {step_ms['decode']:.2f} ms", flush=True)
    print(f"[serve-moe] {len(done)}/{len(trace)} requests, "
          f"{st['tokens_generated']} tokens in {st['wall_s']:.3f}s "
          f"({st['tokens_per_s']:.1f} tok/s); {st['prefill_steps']} prefill "
          f"+ {st['decode_steps']} decode steps; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated(dev)} B ({at_start} B allocated "
          f"at the run's start); launches {launches}", flush=True)
    if len(done) != len(trace) or any(
            len(c.tokens) != cfg_serve.max_new_tokens for c in done):
        raise AssertionError("not every MoE request completed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the MoE serving run launched no {name} "
                                 "kernel")
    check_logits_launches("serve-moe", launches, st)

    # the same trace with the MoE combine as a ring (bf16 hops) on the same
    # parameter tree: a second summation order
    ring = ServingEngine(eng.cfg, dataclasses.replace(eng.base_run,
                                                      pk_ring_psum=True),
                         eng.rules, eng.params, cfg_serve, device=dev)
    ring_done = {c.rid: c.tokens for c in ring.run(trace)}
    del ring
    same = sum(a == b for c in done for a, b in zip(c.tokens,
                                                    ring_done[c.rid]))
    total = sum(len(c.tokens) for c in done)
    print(f"[serve-moe] bulk vs ring combine: {same}/{total} greedy tokens "
          f"agree ({same / total:.3f})", flush=True)
    check_moe_block(dev, eng)
    check_moe_reference(dev, eng)
    del eng, done
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_moe_block(dev, eng) -> None:
    """Phase 4c': ``pk_moe_replicated`` at full width on the card with the
    engine's layer-0 experts and bf16 inputs of a 512-bucket prefill group
    (4 x 512 tokens, capacity 240): the grouped-GEMM kernel against the
    same function with the plain grouped GEMM, on the same inputs — the
    routing is the same, only the GEMM differs. Tolerance: relative
    Frobenius error <= 1e-2 (bf16 outputs of bf16 products)."""
    from unittest import mock

    import torch

    from repro_torch.core import moe
    from repro_torch.core.template import comm_context
    from repro_torch.kernels import grouped_matmul as GM

    cfg, rules = eng.cfg, eng.rules
    r = rules.mesh.shape[rules.tp]
    layer = {k: t[0] for k, t in eng.params["blocks"]["pos0"]["moe"].items()}
    n_tok = 4 * 512
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n_tok, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    plan = moe.dispatch_plan(n_tok, n_experts=cfg.n_experts, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
    args = (x.expand(r, -1, -1), layer["router"].expand(r, -1, -1),
            layer["w1"][:, 0], layer["w3"][:, 0], layer["w2"][:, 0])
    kw = dict(ctx=comm_context(eng.base_run, rules.tp, mesh=rules.mesh),
              n_experts=cfg.n_experts, top_k=cfg.top_k, plan=plan)
    got, _ = moe.pk_moe_replicated(*args, **kw)
    with mock.patch.object(moe, "grouped_matmul", GM.grouped_matmul_plain):
        want, _ = moe.pk_moe_replicated(*args, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    print(f"[moe-block] pk_moe_replicated x({n_tok},{cfg.d_model}) bf16, "
          f"{cfg.n_experts} experts on {r} ranks, capacity {plan.cap}: "
          f"kernel vs plain grouped GEMM rel_err={err:.3e} (tol 1e-2), "
          f"max |diff| {float((got.float() - want.float()).abs().max()):.3e}",
          flush=True)
    if not err <= 1e-2:
        raise AssertionError(f"the MoE block with the kernel disagrees with "
                             f"the plain GEMM: rel_err {err:.3e}")


def _routes(calls, n_tok: int) -> list:
    """Per layer, each token's routing from the recorded top-k calls (the
    router's (T, K) top-k, then the capacity selection's (R, E_loc, C)):
    (its expert set, the (rank, local expert) slots that selected it)."""
    out = []
    for (_, top_idx), (sel_gate, sel_idx) in zip(calls[0::2], calls[1::2]):
        sel = [set() for _ in range(n_tok)]
        for r, e, c in (sel_gate > 0).nonzero().tolist():
            sel[int(sel_idx[r, e, c])].add((r, e))
        out.append([(frozenset(row), frozenset(s))
                    for row, s in zip(top_idx.tolist(), sel)])
    return out


def check_moe_reference(dev, eng, tag: str = "moe-reference") -> None:
    """Phase 4d: moonshot at full width cut to 2 layers (the engine's first
    two layers), one prefill group of 4 prompts (bucket 64, 256 routed
    tokens, capacity 30) on the card (bf16, kernels, (1, 4)) against the
    port's plain f32 path on the CPU on the same (1, 4) mesh (with no mesh
    the CPU would run the dense oracle, other semantics), with the same
    weights (bf16 values widened). Phase 5t runs it on its (2, 4) engine
    with ``serve_moe_tp_data``, where every dp group routes all 256 tokens
    (its top-k calls are checked alike, group by group).

    Routing is discontinuous: a token whose router probabilities nearly
    tie may take another expert under bf16 rounding, and then take a
    capacity slot from another token, whose hidden state changes in turn.
    So the f32 path replays the card's routing — each top-k (the router's,
    then the capacity selection) returns the card's indices, with the f32
    path's own values at them — and computes the same function; it also
    makes its own decisions beside them. Gates: the logits of all 4
    prompts within relative Frobenius error 3e-2 (two layers round some
    twenty bf16 intermediates per element, about 1e-2 in all, as in phase
    4b), and the share of tokens whose own f32 routing (experts and
    capacity slots) equals the card's in both layers >= 0.8 (bf16 against
    f32 alone moves 4-15% of the decisions per layer at this width). A
    free-running f32 prefill (its own routing throughout) is printed
    beside them."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core import moe
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import synthetic_trace
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.transformer import leaves, set_path
    from repro_torch.runtime.serving import ServingEngine

    serve_cfg = ServeConfig(max_batch=4, prefill_batch=4, bucket_edges=(64,),
                            max_new_tokens=3)
    cfg = dataclasses.replace(eng.cfg, n_layers=2)
    params = {**eng.params, "blocks": {"pos0": {
        g: {k: t[:2] for k, t in sub.items()}
        for g, sub in eng.params["blocks"]["pos0"].items()}}}
    gpu = ServingEngine(cfg, eng.base_run, eng.rules, params, serve_cfg,
                        device=dev)
    cpu_params: dict = {}
    for path, t in leaves(params):
        set_path(cpu_params, path, t.cpu().float())
    mesh_shape = tuple(eng.rules.mesh.shape[a] for a in ("data", "model"))
    groups = mesh_shape[0] if eng.base_run.serve_moe_tp_data else 1
    cpu_rules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model"),
                                          "cpu"), eng.base_run)
    cpu = ServingEngine(dataclasses.replace(cfg, dtype="float32"),
                        eng.base_run, cpu_rules, cpu_params, serve_cfg,
                        device="cpu")
    trace = synthetic_trace(4, serve_cfg, cfg.vocab_size, seed=1)
    n_tok = len(trace) * serve_cfg.bucket_edges[0]
    real_topk = moe.topk_stable

    def prefill(engine, topk):
        with mock.patch.object(moe, "topk_stable", topk):
            return engine.prefill_logits(trace).float().cpu()

    def recorder(calls):
        def topk(x, k):
            out = real_topk(x, k)
            calls.append(tuple(t.cpu() for t in out))
            return out
        return topk

    card, own, free = [], [], []
    got = prefill(gpu, recorder(card))
    replayed = iter(card)

    def replay(x, k):
        own.append(tuple(t.cpu() for t in real_topk(x, k)))
        idx = next(replayed)[1].to(x.device)
        return x.gather(-1, idx), idx

    t0 = time.perf_counter()
    want = prefill(cpu, replay)
    cpu_s = time.perf_counter() - t0
    want_free = prefill(cpu, recorder(free))
    if not len(card) == len(own) == len(free) == 4 * groups:
        raise AssertionError("expected 2 top-k calls per MoE layer and "
                             f"routing group, got {len(card)} / {len(own)} "
                             f"/ {len(free)}")
    r_card = _routes(card, n_tok)

    def alike(routes):
        per_layer = [sum(a == b for a, b in zip(x, y)) / n_tok
                     for x, y in zip(r_card, routes)]
        both = sum(all(x[t] == y[t] for x, y in zip(r_card, routes))
                   for t in range(n_tok)) / n_tok
        return both, per_layer

    share, per_layer = alike(_routes(own, n_tok))
    free_share, free_layer = alike(_routes(free, n_tok))
    err = rel_err(got, want)
    print(f"[{tag}] 2-layer full-width prefill (4 prompts, {n_tok} "
          f"routed tokens, mesh {mesh_shape}), card (bf16 kernels) vs cpu "
          f"(f32 "
          f"plain, {cpu_s:.1f} s) on the card's routing: logits rel_err="
          f"{err:.3e} (tol 3e-2), max |diff| "
          f"{float((got - want).abs().max()):.3e}; tokens whose f32 routing "
          f"is the card's in both layers {share:.4f} (gate 0.8), per layer "
          f"{[round(v, 4) for v in per_layer]}", flush=True)
    print(f"[{tag}] free-running f32 (its own routing): tokens "
          f"routed as on the card in both layers {free_share:.4f}, per "
          f"layer {[round(v, 4) for v in free_layer]}; logits rel_err "
          f"{rel_err(got, want_free):.3e}", flush=True)
    if not (share >= 0.8 and err <= 3e-2):
        raise AssertionError(f"card MoE disagrees with the f32 plain path: "
                             f"routing share {share:.4f}, rel_err "
                             f"{err:.3e}")


def serve_ssm(dev) -> dict:
    """Phase 4e: the SSM serving path — falcon-mamba-7b at full width and
    depth (64 mamba layers, d 4096, d_inner 8192, N 16, dt_rank 256, conv
    4, vocab 65,024) on 4 virtual tensor-parallel ranks, exact buckets,
    with launch counts around it; every selective scan of the run goes
    through the kernel, one launch a layer a step. Then the 2-layer
    reference (4f) on the same parameters. Frees everything before
    returning."""
    import gc

    import torch

    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.transformer import leaves

    cfg_serve = ssm_serve_config()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = build_engine(SSM_ARCH, reduced=False, mesh_shape=(1, 4),
                       serve=cfg_serve, seed=0, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(eng.params))
    trace = synthetic_trace(8, cfg_serve, eng.cfg.vocab_size, seed=0)
    cfg = eng.cfg
    print(f"[serve-ssm] engine built in {time.perf_counter() - t0:.1f}s: "
          f"{cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"d_inner={cfg.d_inner} ssm_state={cfg.ssm_state} dt_rank="
          f"{cfg.dtr} mesh=(1, 4) on {dev}; parameters {n_bytes} B; exact "
          f"buckets; prompt lengths {[len(p) for p in trace]}", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "mamba_scan")}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    done = eng.run(trace)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    step_ms = {kind: 1e3 * statistics.median(
        t for k, t in zip(eng.step_kinds, eng.step_times) if k == kind)
        for kind in ("prefill", "decode")}
    print(f"[serve-ssm] median step wall time (host clock, each step ends "
          f"in a device->host copy): prefill {step_ms['prefill']:.2f} ms, "
          f"decode {step_ms['decode']:.2f} ms", flush=True)
    print(f"[serve-ssm] {len(done)}/{len(trace)} requests, "
          f"{st['tokens_generated']} tokens in {st['wall_s']:.3f}s "
          f"({st['tokens_per_s']:.1f} tok/s); {st['prefill_steps']} prefill "
          f"+ {st['decode_steps']} decode steps; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated(dev)} B ({at_start} B allocated "
          f"at the run's start); state cache "
          f"{sum(t.nbytes for _, t in leaves(eng.cache))} B; "
          f"launches {launches}", flush=True)
    # every request completes (the engine raises on non-finite logits)
    if len(done) != len(trace) or any(
            len(c.tokens) != cfg_serve.max_new_tokens for c in done):
        raise AssertionError("not every SSM request completed")
    want = cfg.n_layers * (st["prefill_steps"] + st["decode_steps"])
    if launches["mamba_scan"] != want:
        raise AssertionError(f"the SSM serving run launched the scan kernel "
                             f"{launches['mamba_scan']} times, not "
                             f"{cfg.n_layers} layers x {st['steps']} steps "
                             f"= {want}")
    check_logits_launches("serve-ssm", launches, st)
    check_ssm_reference(dev, eng)
    del eng, done
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_ssm_reference(dev, eng) -> None:
    """Phase 4f: falcon-mamba-7b at full width cut to 2 layers (the
    engine's first two), one prefill group of 4 prompts of 64 tokens (exact
    bucket 64) on the card (bf16, kernels, (1, 4)) against the port's plain
    f32 path on the CPU on the same mesh with the same weights (bf16 values
    widened): relative Frobenius error of the logits <= 3e-2 (two layers
    round some twenty bf16 intermediates per element, about 1e-2 in all,
    as in phase 4b).

    Continuation, on the card: a prefill of the first 60 tokens followed
    by 4 decode steps fed the next 4 must give the last-token logits of the
    prefill of all 64. Both sides round in bf16 at the same places, and the
    scan kernel gives the same bits over 64 steps as over 60 + 4 chained;
    only the products' f32 accumulation order differs with the row count
    (4 x 64 rows against 4 x 1), flipping some bf16 roundings by one unit
    (2^-8 relative). Two layers of that stay near 5e-3; the gate is 2e-2.
    The same check on the CPU f32 path is printed beside it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.transformer import leaves, set_path
    from repro_torch.runtime.serving import ServingEngine

    s, k = 60, 4
    serve_cfg = ServeConfig(max_batch=4, prefill_batch=4,
                            bucket_edges=(s + k,), max_new_tokens=3,
                            exact_buckets=True)
    cfg = dataclasses.replace(eng.cfg, n_layers=2)
    params = {**eng.params, "blocks": {"pos0": {
        g: {n: t[:2] for n, t in sub.items()}
        for g, sub in eng.params["blocks"]["pos0"].items()}}}
    gpu = ServingEngine(cfg, eng.base_run, eng.rules, params, serve_cfg,
                        device=dev)
    cpu_params: dict = {}
    for path, t in leaves(params):
        set_path(cpu_params, path, t.cpu().float())
    cpu_rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), "cpu"),
                              eng.base_run)
    cpu = ServingEngine(dataclasses.replace(cfg, dtype="float32"),
                        eng.base_run, cpu_rules, cpu_params, serve_cfg,
                        device="cpu")
    rng = np.random.RandomState(2)
    prompts = [tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                                 size=s + k))
               for _ in range(4)]
    t0 = time.perf_counter()
    want = cpu.prefill_logits(prompts)
    cpu_s = time.perf_counter() - t0
    got = gpu.prefill_logits(prompts).float().cpu()
    err = rel_err(got, want)
    print(f"[ssm-reference] 2-layer full-width prefill (4 x {s + k} tokens, "
          f"mesh (1, 4)), card (bf16 kernels) vs cpu (f32 plain, "
          f"{cpu_s:.1f} s): logits rel_err={err:.3e} (tol 3e-2), max |diff| "
          f"{float((got - want).abs().max()):.3e}", flush=True)
    if not err <= 3e-2:
        raise AssertionError(f"card SSM logits disagree with the f32 plain "
                             f"path: rel_err {err:.3e}")

    def continued(engine):
        """Last-token logits of a prefill of s tokens then k decode steps
        fed the prompts' next k tokens."""
        _, cache = engine._run_prefill(s, [p[:s] for p in prompts])
        with torch.no_grad():
            for i in range(s, s + k):
                tok = torch.tensor([[p[i]] for p in prompts],
                                   device=engine.device)
                logits, cache = engine._decode_fn(engine.params, cache, tok)
        return logits.float().cpu()

    cont = continued(gpu)
    c_err = rel_err(cont, got)
    cpu_err = rel_err(continued(cpu), want)
    print(f"[ssm-reference] continuation: prefill {s} + {k} decode steps vs "
          f"prefill {s + k}, last-token logits rel_err on the card "
          f"{c_err:.3e} (tol 2e-2), on the cpu f32 path {cpu_err:.3e}",
          flush=True)
    if not c_err <= 2e-2:
        raise AssertionError(f"SSM continuation disagrees with the longer "
                             f"prefill: rel_err {c_err:.3e}")


def train(dev, steps: int = 4) -> dict:
    """Phase 5: the port's training path, with launch counts around it."""
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch.train import build_and_train

    batch, seq, mb = 8, 512, 2
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "pk_all_gather", "pk_reduce_scatter")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        state, log = build_and_train(
            "tinyllama-1.1b", steps=steps, reduced=False, mesh_shape=(2, 4),
            mesh_axes=("data", "model"), batch=batch, seq=seq,
            ckpt_dir=ckpt, microbatches=mb, log_every=1, ckpt_every=100,
            comm_backend="fused", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        latest = CheckpointManager(ckpt).latest_step()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state
    losses = [m["loss"] for m in log]
    step_s = [m["step_time_s"] for m in log]
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    print(f"[train] tinyllama-1.1b full width and depth, mesh (2, 4) "
          f"(data x model) virtual, FSDP, comm_backend=fused, batch {batch} "
          f"x seq {seq}, microbatches {mb}: losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(m['grad_norm'], 4) for m in log]}", flush=True)
    print(f"[train] step wall times (host clock, each ends in a device->host "
          f"read) {[round(t, 4) for t in step_s]} s; median of steps 2-"
          f"{steps} {steady:.4f} s = {batch * seq / steady:.1f} tokens/s; "
          f"build + {steps} steps + checkpoint {wall:.1f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B; "
          f"checkpoint latest_step {latest}", flush=True)
    print(f"[train] launches over {steps} steps {launches}; per step "
          f"{ {k: v / steps for k, v in launches.items()} }", flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"training losses not all finite: {losses}")
    if latest != steps:
        raise AssertionError(f"checkpoint latest_step {latest} != {steps}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the training run launched no {name} "
                                 "kernel")
    # the loss island runs once a dp group and microbatch, one stacked B1
    # launch a 512-token chunk of its sequences
    want = steps * 2 * mb * max(1, seq // 512)
    if launches["matmul"] != want:
        raise AssertionError(f"training launched matmul {launches['matmul']} "
                             f"times, not steps x dp x microbatches x loss "
                             f"chunks = {want}")
    return launches


def check_train_reference(dev) -> None:
    """Phase 5b: tinyllama-1.1b at full width cut to 2 layers on the (2, 4)
    mesh with FSDP, one forward and backward of 4 x 128 tokens: the card
    (bf16, kernels, fused collectives) against the port's plain float32
    path on the CPU with the same weights (bf16 values widened) and batch.
    Tolerance: loss within relative 1e-2 and the global gradient norm within
    relative 3e-2 — two layers round some twenty bf16 intermediates per
    element (about 1e-2 relative in all, as in phase 4b); the loss averages
    that over tokens, the gradient norm over 2.2e8 entries, and the bf16
    cotangents add as much again, hence three times the budget there."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    run = RunConfig(fsdp=True, comm_backend="fused")

    def loss_and_norm(cfg, params, batch, device):
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), device),
                              run)
        paths = list(T.leaves(params))
        for _, p in paths:
            p.requires_grad_(True)
        loss, _ = T.forward_train(params, batch, cfg, run, rules)
        gs = torch.autograd.grad(loss, [p for _, p in paths])
        tree: dict = {}
        for (path, _), g in zip(paths, gs):
            T.set_path(tree, path, g)
        return float(loss.detach()), float(AdamW.global_norm(tree))

    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev), run)
    gen = torch.Generator(device=dev).manual_seed(2)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 128, 4, seed=2),
                        device=dev).batch(0)
    cpu_params: dict = {}
    for path, t in T.leaves(params):
        T.set_path(cpu_params, path, t.detach().float().cpu())
    got = loss_and_norm(cfg, params, batch, dev)
    t0 = time.perf_counter()
    want = loss_and_norm(dataclasses.replace(cfg, dtype="float32"),
                         cpu_params, {k: v.cpu() for k, v in batch.items()},
                         "cpu")
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[train-reference] 2-layer full-width (2, 4) FSDP step, card "
          f"(bf16 kernels) vs cpu (f32 plain, {time.perf_counter() - t0:.1f}"
          f" s): loss {got[0]:.5f} vs {want[0]:.5f} (rel {errs[0]:.3e}, tol "
          f"1e-2), grad norm {got[1]:.5f} vs {want[1]:.5f} (rel "
          f"{errs[1]:.3e}, tol 3e-2)", flush=True)
    if not (errs[0] <= 1e-2 and errs[1] <= 3e-2):
        raise AssertionError(f"card training step disagrees with the f32 "
                             f"plain path: {errs}")


def sp_setup(dev, seq: int = 8192) -> dict:
    """The sequence-parallel phases' model, shared by 5c and 5f:
    tinyllama-1.1b at full width and depth (22 layers, d 2048, 32 q heads
    and 4 KV heads of 64, ff 5632, vocab 32000) on (1, 4), batch 1 x seq
    8192 (2048 tokens a virtual rank), FSDP off, random weights from seed
    0, tokens from a numpy seed."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("tinyllama-1.1b")
    run = RunConfig(fsdp=False, comm_backend="fused")
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), dev), run)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (1, seq))).to(dev),
             "targets": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (1, seq))).to(dev),
             "weights": torch.ones((1, seq), device=dev)}
    return {"cfg": cfg, "run": run, "rules": rules, "params": params,
            "batch": batch, "seq": seq}


def sp_calls(dev, sp: dict, run, counters: dict, calls: int) -> dict:
    """``calls`` times ``forward_train(seq_sharded=True)`` and its backward
    on ``sp``'s model under ``run``, with the launch counts around them:
    losses, wall times, launches, peak memory, gradients finite."""
    import torch

    from repro_torch.models import transformer as T

    leaves = [p for _, p in T.leaves(sp["params"])]
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    at_start = torch.cuda.memory_allocated(dev)
    for fn in counters.values():
        fn.launches = 0
    losses, walls = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        loss, _ = T.forward_train(sp["params"], sp["batch"], sp["cfg"], run,
                                  sp["rules"], seq_sharded=True)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))  # the device->host read
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {"losses": losses, "walls": walls, "at_start": at_start,
           "launches": {k: fn.launches for k, fn in counters.items()},
           "peak": torch.cuda.max_memory_allocated(dev),
           "finite": all(bool(torch.isfinite(g).all()) for g in grads)}
    del grads
    for p in leaves:
        p.requires_grad_(False)
    return out


def train_sp(dev, sp: dict, calls: int = 3) -> tuple[dict, float]:
    """Phase 5c: the sequence-parallel training path on ``sp_setup``'s
    model with ring attention, ``comm_backend="fused"``, remat on (the
    RunConfig default: a layer's forward runs again in the backward).
    ``calls`` times ``forward_train(seq_sharded=True)`` and its backward,
    with launch counts around them: per call and layer the p2p kernel
    shifts k and v R - 1 times and the flash hop runs R times in each of
    the 2 forward passes. Then, on the same parameters and batch, the dense
    mix's loss (a forward only) within 1e-2 of the ring's, and one layer's
    SP island under fused equal to it under bulk, bit for bit (the shift
    is a copy). Returns the launches and the first ring loss."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, run, rules, seq = sp["cfg"], sp["run"], sp["rules"], sp["seq"]
    params, batch = sp["params"], sp["batch"]
    r = rules.mesh.shape["model"]
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "p2p_ring_shift", "flash_attention_hop")}
    res = sp_calls(dev, sp, run, counters, calls)
    losses, walls, launches = res["losses"], res["walls"], res["launches"]
    peak, at_start, finite = res["peak"], res["at_start"], res["finite"]
    med = statistics.median(walls)
    passes = 2 if run.remat else 1
    want = {"p2p_ring_shift": 2 * (r - 1) * cfg.n_layers * passes * calls,
            "flash_attention_hop": r * cfg.n_layers * passes * calls,
            "matmul": (seq // 512) * calls}
    print(f"[train-sp] tinyllama-1.1b full width and depth, mesh (1, 4), "
          f"seq_sharded ring attention, comm_backend=fused, batch 1 x seq "
          f"{seq} ({seq // r} tokens a rank), remat: losses "
          f"{[round(x, 5) for x in losses]}; wall times (host clock, each "
          f"call ends in the loss's device->host read) "
          f"{[round(t, 4) for t in walls]} s, median {med:.4f} s = "
          f"{seq / med:.1f} tokens/s; max_memory_allocated {peak} B "
          f"({at_start} B allocated at the start)", flush=True)
    print(f"[train-sp] launches over {calls} calls {launches}; per call "
          f"{ {k: v / calls for k, v in launches.items()} }; expected p2p "
          f"2·(R-1)·layers·passes = {want['p2p_ring_shift'] // calls}, hop "
          f"R·layers·passes = {want['flash_attention_hop'] // calls}, matmul "
          f"one stacked launch a 512-token loss chunk = "
          f"{want['matmul'] // calls} a call (passes = {passes}: remat reruns "
          "each layer's forward in the backward)", flush=True)
    if not (all(map(math.isfinite, losses)) and finite):
        raise AssertionError(f"sp-train losses or gradients not finite: "
                             f"{losses}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"sp-train launched {name} "
                                 f"{launches[name]} times, not {n}")
    if launches["pk_matmul_ar"] <= 0:
        raise AssertionError("sp-train launched no pk_matmul_ar kernel")
    with torch.no_grad():
        dense = float(T.forward_train(params, batch, cfg, run, rules)[0])
    print(f"[train-sp] dense mix (seq_sharded=False, forward only) loss "
          f"{dense:.5f} vs ring {losses[0]:.5f}: |diff| "
          f"{abs(dense - losses[0]):.3e} (tol 1e-2)", flush=True)
    if not abs(dense - losses[0]) <= 1e-2:
        raise AssertionError("the ring attention loss disagrees with the "
                             "dense mix's")

    # one layer's island at the path's shape, fused against bulk
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = ((torch.randn((1, h, seq, cfg.hd), generator=g, device=dev)
                ).to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads,
                                               cfg.n_kv_heads))
    outs = {}
    with torch.no_grad():
        for be in ("fused", "bulk"):
            isl = L.sp_attention_island(
                cfg, dataclasses.replace(run, comm_backend=be), rules, 1, seq)
            outs[be] = isl(q=q, k=k, v=v)
    torch.cuda.synchronize()
    same = torch.equal(outs["fused"], outs["bulk"])
    print(f"[train-sp] one layer's SP island q(1,{cfg.n_heads},{seq},"
          f"{cfg.hd}): fused equals bulk bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError("the fused ring shift changed the island's "
                             "output")
    return launches, losses[0]


def train_ulysses(dev, sp: dict, ring_loss: float, calls: int = 3,
                  chunks: int = 2) -> dict:
    """Phase 5f: Ulysses sequence-parallel training on ``sp_setup``'s model
    (the parameters and batch of phase 5c), ``RunConfig(fsdp=False,
    comm_backend="fused", sp_attention="ulysses", ulysses_chunks=2)``:
    ``calls`` times ``forward_train(seq_sharded=True)`` and its backward.
    Per call and layer the all-to-all kernel runs ``chunks`` launches for
    each of q, k, v and the output in each of the 2 forward passes (remat)
    and for each of their 4 gradients, 4·c·layers·(passes + 1); the flash
    kernel once a forward pass (its backward is the plain f32 recompute);
    no p2p shift, no hop. The first loss within 1e-2 of phase 5c's ring
    loss on the same batch; one layer's Ulysses island at the path's shape
    under 2 chunks (the kernel) equal to it under 1 (bulk, a torch copy)
    bit for bit: the all-to-all is a copy."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L

    cfg, rules, seq = sp["cfg"], sp["rules"], sp["seq"]
    run = dataclasses.replace(sp["run"], sp_attention="ulysses",
                              ulysses_chunks=chunks)
    r = rules.mesh.shape["model"]
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "p2p_ring_shift", "flash_attention_hop",
                         "pk_all_to_all")}
    res = sp_calls(dev, sp, run, counters, calls)
    losses, walls, launches = res["losses"], res["walls"], res["launches"]
    med = statistics.median(walls)
    passes = 2 if run.remat else 1
    want = {"pk_all_to_all": 4 * chunks * cfg.n_layers * (passes + 1)
            * calls,
            "flash_attention": cfg.n_layers * passes * calls,
            "p2p_ring_shift": 0, "flash_attention_hop": 0,
            "matmul": (seq // 512) * calls}
    print(f"[train-ulysses] tinyllama-1.1b full width and depth, mesh (1, "
          f"{r}), seq_sharded Ulysses attention, ulysses_chunks={chunks}, "
          f"comm_backend=fused, batch 1 x seq {seq} ({seq // r} tokens a "
          f"rank), remat: losses {[round(x, 5) for x in losses]}; wall "
          f"times (host clock, each call ends in the loss's device->host "
          f"read) {[round(t, 4) for t in walls]} s, median {med:.4f} s = "
          f"{seq / med:.1f} tokens/s; max_memory_allocated {res['peak']} B "
          f"({res['at_start']} B allocated at the start)", flush=True)
    print(f"[train-ulysses] launches over {calls} calls {launches}; per "
          f"call { {k: v / calls for k, v in launches.items()} }; expected "
          f"all-to-all 4·c·layers·(passes + 1) = "
          f"{want['pk_all_to_all'] // calls} (c = {chunks}: q, k, v and "
          f"the output, each forward pass and their gradients), flash "
          f"layers·passes = {want['flash_attention'] // calls}, matmul "
          f"{want['matmul'] // calls}, p2p and hop 0 (passes = {passes})",
          flush=True)
    if not (all(map(math.isfinite, losses)) and res["finite"]):
        raise AssertionError(f"ulysses losses or gradients not finite: "
                             f"{losses}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"ulysses training launched {name} "
                                 f"{launches[name]} times, not {n}")
    if launches["pk_matmul_ar"] <= 0:
        raise AssertionError("ulysses training launched no pk_matmul_ar "
                             "kernel")
    print(f"[train-ulysses] loss {losses[0]:.5f} vs ring (phase 5c) "
          f"{ring_loss:.5f}: |diff| {abs(losses[0] - ring_loss):.3e} (tol "
          f"1e-2)", flush=True)
    if not abs(losses[0] - ring_loss) <= 1e-2:
        raise AssertionError("the Ulysses loss disagrees with the ring's")

    # one layer's island at the path's shape, chunked (the kernel) against
    # bulk (a torch copy)
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = ((torch.randn((1, h, seq, cfg.hd), generator=g, device=dev)
                ).to(torch.bfloat16) for h in (cfg.n_heads, cfg.n_kv_heads,
                                               cfg.n_kv_heads))
    outs, kern = {}, _counters()["pk_all_to_all"]
    with torch.no_grad():
        for c in (chunks, 1):
            kern.launches = 0
            isl = L.sp_attention_island(
                cfg, dataclasses.replace(run, ulysses_chunks=c), rules, 1,
                seq)
            outs[c] = isl(q=q, k=k, v=v)
            print(f"[train-ulysses] island ulysses_chunks={c}: plan "
                  f"{isl.plan()}; all-to-all kernel launches "
                  f"{kern.launches}", flush=True)
            if kern.launches != (4 * c if c > 1 else 0):
                raise AssertionError(f"the Ulysses island at {c} chunks "
                                     f"launched the all-to-all kernel "
                                     f"{kern.launches} times")
    torch.cuda.synchronize()
    same = torch.equal(outs[chunks], outs[1])
    print(f"[train-ulysses] one layer's Ulysses island q(1,{cfg.n_heads},"
          f"{seq},{cfg.hd}): {chunks} chunks equal 1 chunk (bulk) bit for "
          f"bit: {same}", flush=True)
    if not same:
        raise AssertionError("the chunked all-to-all changed the Ulysses "
                             "island's output")
    return launches


def moe_a2a(dev, tokens: int = 512, seed: int = 11) -> dict:
    """Phase 5g: ``pk_moe_a2a`` at moonshot-v1-16b-a3b's layer width (64
    experts top-6, d 2048, expert ff 1408, bf16) on 4 virtual ranks, 16
    experts a rank, one layer's random weights (1.1 GB of experts) and
    ``tokens`` tokens a rank from seed ``seed``, capacity factor E / k so
    nothing drops (capacity = tokens): the output within relative 1e-2 of
    ``moe_reference_dense`` on all 4 x ``tokens`` tokens (the same bf16
    kernels, routing decided alike: only roundings differ), 2 capacity
    chunks within relative 1e-3 of 1 (the f32 combine; the scatter order
    and the expert GEMMs' row counts differ), the grouped GEMM launched 3
    times a chunk (first held against its plain version at the path's
    shape); device ms of one call at 1 and 2 chunks."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.core.comms import CommContext
    from repro_torch.core.pgl import VirtualMesh

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    e, k, d, ff, r = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff, 4
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    x = randn(r, tokens, d)
    wr = randn(d, e, scale=d ** -0.5)
    w1, w3 = randn(e, d, ff, scale=d ** -0.5), randn(e, d, ff,
                                                      scale=d ** -0.5)
    w2 = randn(e, ff, d, scale=ff ** -0.5)
    ctx = CommContext("x", mesh=VirtualMesh((r,), ("x",), dev))
    kw = dict(ctx=ctx, n_experts=e, top_k=k, capacity_factor=e / k)
    cap = moe.dispatch_plan(tokens, n_experts=e, top_k=k,
                            capacity_factor=e / k).cap
    gm, a2a = _counters()["grouped_matmul"], _counters()["pk_all_to_all"]
    from repro_torch.kernels import grouped_matmul as GM
    xg = randn(e, r * cap, d)              # the expert GEMM's w1 at 1 chunk
    err_g = rel_err(GM.grouped_matmul(xg, w1, out_dtype=torch.float32),
                    GM.grouped_matmul_plain(xg, w1, out_dtype=torch.float32))
    print(f"[moe-a2a] grouped_matmul x({e},{r * cap},{d})@w({e},{d},{ff}) "
          f"f32 out: rel_err {err_g:.3e} (tol {TOL_F32_OUT:g})", flush=True)
    if not err_g <= TOL_F32_OUT:
        raise AssertionError("grouped_matmul disagrees with its plain "
                             "version at the a2a MoE's shape")
    del xg

    def call(n_chunks):
        return moe.pk_moe_a2a(
            x, wr.expand(r, d, e), *(w.view(r, e // r, *w.shape[1:])
                                     for w in (w1, w3, w2)),
            n_chunks=n_chunks, **kw)

    outs, launches = {}, {}
    for n_chunks in (1, 2):
        gm.launches = a2a.launches = 0
        outs[n_chunks] = call(n_chunks)
        torch.cuda.synchronize()
        launches[n_chunks] = {"grouped_matmul": gm.launches,
                              "pk_all_to_all": a2a.launches}
        if gm.launches != 3 * n_chunks:
            raise AssertionError(f"pk_moe_a2a at {n_chunks} chunks launched "
                                 f"grouped_matmul {gm.launches} times, not "
                                 f"{3 * n_chunks}")
    want, _ = moe.moe_reference_dense(x.view(r * tokens, d), wr, w1, w3, w2,
                                      n_experts=e, top_k=k)
    got = outs[1][0].view(r * tokens, d)
    err = rel_err(got, want)
    err2 = rel_err(outs[2][0], outs[1][0])
    aux_ok = torch.allclose(outs[2][1], outs[1][1])
    ms = {c: time_ms(partial(call, c), iters=5, reps=3, warmup=1)
          for c in (1, 2)}
    print(f"[moe-a2a] pk_moe_a2a {MOE_ARCH} layer width (E {e}, top-{k}, d "
          f"{d}, ff {ff}) on {r} virtual ranks x {tokens} tokens, capacity "
          f"{cap} (factor E/k): vs moe_reference_dense rel_err {err:.3e} "
          f"(tol 1e-2); 2 chunks vs 1 rel_err {err2:.3e} (tol 1e-3), aux "
          f"equal: {aux_ok}; launches {launches}; device ms a call: 1 "
          f"chunk {ms[1]:.4f}, 2 chunks {ms[2]:.4f}", flush=True)
    if not (err <= 1e-2 and err2 <= 1e-3 and aux_ok
            and all(map(math.isfinite, (err, err2)))):
        raise AssertionError(f"pk_moe_a2a disagrees: dense {err:.3e}, "
                             f"chunks {err2:.3e}, aux {aux_ok}")
    del outs, want, got, x, w1, w3, w2
    gc.collect()
    torch.cuda.empty_cache()
    return launches[1]


def check_sp_reference(dev, seq: int = 2048) -> None:
    """Phase 5d: tinyllama-1.1b at full width cut to 2 layers on (1, 4),
    ``forward_train(seq_sharded=True)`` and its backward on 1 x 2048 tokens:
    the card (bf16, the p2p kernel and flash hops) against the port's plain
    float32 path on the CPU (the hops' and the shift's plain versions) with
    the same weights (bf16 values widened) and batch — loss within relative
    1e-2 and global gradient norm within relative 3e-2, as phase 5b."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    run = RunConfig(fsdp=False, comm_backend="fused")

    def loss_and_norm(cfg, params, batch, device):
        rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), device),
                              run)
        paths = list(T.leaves(params))
        for _, p in paths:
            p.requires_grad_(True)
        loss, _ = T.forward_train(params, batch, cfg, run, rules,
                                  seq_sharded=True)
        gs = torch.autograd.grad(loss, [p for _, p in paths])
        tree: dict = {}
        for (path, _), g in zip(paths, gs):
            T.set_path(tree, path, g)
        return float(loss.detach()), float(AdamW.global_norm(tree))

    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), dev), run)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq)))
             for k in ("tokens", "targets")}
    batch["weights"] = torch.ones((1, seq))
    cpu_params: dict = {}
    for path, t in T.leaves(params):
        T.set_path(cpu_params, path, t.detach().float().cpu())
    got = loss_and_norm(cfg, params, {k: v.to(dev) for k, v in
                                      batch.items()}, dev)
    t0 = time.perf_counter()
    want = loss_and_norm(dataclasses.replace(cfg, dtype="float32"),
                         cpu_params, batch, "cpu")
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    print(f"[sp-reference] 2-layer full-width (1, 4) seq_sharded step on "
          f"1 x {seq} tokens, card (bf16 kernels) vs cpu (f32 plain, "
          f"{time.perf_counter() - t0:.1f} s): loss {got[0]:.5f} vs "
          f"{want[0]:.5f} (rel {errs[0]:.3e}, tol 1e-2), grad norm "
          f"{got[1]:.5f} vs {want[1]:.5f} (rel {errs[1]:.3e}, tol 3e-2)",
          flush=True)
    if not (errs[0] <= 1e-2 and errs[1] <= 3e-2):
        raise AssertionError(f"card SP training step disagrees with the "
                             f"f32 plain path: {errs}")


ENCDEC_ARCH = "whisper-medium"
#: phase 5j's limits beside 5b's gradient norm (3e-2): the loss, and each
#: part's gradient (encoder, cross-attention, the rest) as one vector,
#: relative to the f32 path's. Set from the readings on an H100 80GB HBM3
#: at 700 W (loss 2.2e-5; the parts' gradients 7.4e-3-8.0e-3), some times
#: above them: at random init the loss sits near ln V, so a wrong encoder
#: or cross path could move it by less than 5b's 1e-2; it moves its part's
#: gradient by O(1).
ENCDEC_TOL_LOSS = 1e-3
ENCDEC_TOL_GRAD = 3e-2


def encdec_model(dev, run, mesh_shape, seed, **cut):
    """whisper-medium (``cut`` replaces its depth) on a virtual mesh:
    (cfg, rules, random parameters from ``seed``, the generator)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    cfg = dataclasses.replace(get_config(ENCDEC_ARCH), **cut)
    rules = ShardingRules(VirtualMesh(mesh_shape, ("data", "model"), dev),
                          run)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    return cfg, rules, params, gen


def encdec_decode(params, enc, tokens, cfg, run, rules, s_max, dev):
    """The encoder and the cross K/V into a fresh cache (``encode_cross``),
    then ``tokens`` (B, n) fed one at a time through the serve step
    (``decode_step_encdec``): (last logits, cache)."""
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_serve_step

    tmpl = T.cache_template(cfg, run, rules, batch=tokens.shape[0],
                            s_max=s_max, enc_len=enc.shape[1])
    cache = T.encode_cross(params, T.zeros(tmpl, rules, dev), enc, cfg, run,
                           rules)
    step = make_serve_step(cfg, run, rules)
    for i in range(tokens.shape[1]):
        logits, cache = step(params, cache, tokens[:, i:i + 1])
    return logits, cache


def serve_encdec(dev, batch: int = 8, enc_len: int = 1500, s_max: int = 448,
                 prompt: int = 4, new: int = 32) -> dict:
    """Phase 5h: whisper-medium at full width and depth (24 encoder and 24
    decoder layers, d 1024, 16 heads of 64, ff 4096, vocab 51865) on (1, 4)
    virtual ranks, ``comm_backend="fused"`` with the attention out-projection
    island: ``enc_embeds`` (8, 1500, 1024) bf16 (the stub frontend's 30-s
    window) through the encoder and every decoder layer's cross K/V into
    ``cache["cross"]`` (``encode_cross``, the helpers ``forward_train``
    runs), then a 4-token prompt fed one token at a time through the serve
    step (``decode_step_encdec``) and 32 greedy tokens, a self cache of
    448 (Whisper's max_target_positions). Launch counts around that run:
    flash once an encoder layer, B1 once a step, B4 twice an encoder layer
    (attention out-projection and MLP) and once a decoder layer a step
    (the MLP; decode's out-projections and mixes are plain, as in JAX).
    Then ``forward_prefill`` over the same prompt and frames (flash causal
    over 4 tokens, non-causal over 4 x 1500): its logits must match the
    decode path's after the 4th prompt token within a tolerance derived
    here — the two paths share the encoder and the cross K/V (the same
    kernels at the same shapes, the same bits) and differ in the decoder's
    24 layers, each rounding about 16 bf16 intermediates an element
    (relative rms 2^-8/sqrt(3)) in another order: if every one reached the
    logits whole, the relative difference would be sqrt(2 x 24 x 16) x
    2^-8/sqrt(3) = 6.2e-2, the tolerance."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_prefill_step, make_serve_step

    run = RunConfig(fsdp=False, comm_backend="fused", pk_attn_out_island=True)
    t0 = time.perf_counter()
    cfg, rules, params, gen = encdec_model(dev, run, (1, 4), seed=0)
    enc = torch.randn((batch, enc_len, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                           device=dev)
    print(f"[serve-encdec] {cfg.name} ({cfg.param_count() / 1e9:.3f} B "
          f"parameters, {cfg.n_encoder_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d {cfg.d_model}) built in "
          f"{time.perf_counter() - t0:.1f}s on (1, 4); batch {batch}, frames "
          f"{enc_len}, prompt {prompt}, {new} new tokens, s_max {s_max}",
          flush=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    tmpl = T.cache_template(cfg, run, rules, batch=batch, s_max=s_max,
                            enc_len=enc_len)
    step = make_serve_step(cfg, run, rules)
    with torch.no_grad():
        t0 = time.perf_counter()
        cache = T.encode_cross(params, T.zeros(tmpl, rules, dev), enc, cfg,
                               run, rules)
        torch.cuda.synchronize()
        enc_ms = 1e3 * (time.perf_counter() - t0)
        for i in range(prompt):
            logits, cache = step(params, cache, tokens[:, i:i + 1])
        prompt_logits = logits
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(new):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            logits, cache = step(params, cache, nxt)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    steps = prompt + new
    print(f"[serve-encdec] encoder + cross K/V {enc_ms:.1f} ms (host clock, "
          f"first call, ends in a synchronize); {new} greedy steps in "
          f"{dec_s:.3f} s = {batch * new / dec_s:.1f} tokens/s "
          f"({1e3 * dec_s / new:.2f} ms a step, host clock); "
          f"max_memory_allocated {peak} B; launches {launches}", flush=True)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite whisper decode logits")
    again = []
    with torch.no_grad():
        for _ in range(2):      # steady: the first call imports and plans
            t0 = time.perf_counter()
            T.encode_cross(params, T.zeros(tmpl, rules, dev), enc, cfg, run,
                           rules)
            torch.cuda.synchronize()
            again.append(1e3 * (time.perf_counter() - t0))
    print(f"[serve-encdec] encoder + cross K/V again (not counted): "
          f"{[round(t, 1) for t in again]} ms", flush=True)
    want = {"matmul": steps, "flash_attention": cfg.n_encoder_layers,
            "pk_matmul_ar": 2 * cfg.n_encoder_layers + cfg.n_layers * steps}
    if launches != want:
        raise AssertionError(f"whisper serving launches {launches}, "
                             f"expected {want}")
    with torch.no_grad():
        pre = make_prefill_step(cfg, run, rules)(
            params, {"tokens": tokens, "enc_embeds": enc})
    tol = math.sqrt(2 * cfg.n_layers * 16) * 2 ** -8 / math.sqrt(3)
    err = rel_err(prompt_logits, pre)
    agree = int((prompt_logits[:, -1].argmax(-1) == pre[:, -1].argmax(-1))
                .sum())
    print(f"[serve-encdec] logits after the 4th prompt token, decode path "
          f"vs forward_prefill: rel_err={err:.3e} (tol {tol:.3e}), max "
          f"|diff| {float((prompt_logits - pre).abs().max()):.3e}, argmax "
          f"agrees in {agree}/{batch} rows", flush=True)
    if not err <= tol:
        raise AssertionError(f"whisper decode logits disagree with "
                             f"forward_prefill: rel_err {err:.3e}")
    del params, cache
    return launches


def train_encdec(dev, batch: int = 8, seq: int = 448,
                 enc_len: int = 1500) -> dict:
    """Phase 5i: whisper-medium at full width and depth on a (2, 4)
    virtual mesh (data 2 x model 4) with FSDP, every collective on the
    kernels (``comm_backend="fused"``), remat, AdamW through
    ``make_train_step`` (``train_family``): batch 8 x 448 decoder tokens
    with their ``enc_embeds`` (8, 1500, 1024), 2 microbatches, 3 steps.
    Every loss finite; the ring all-gather (each FSDP weight gather, the
    encoder's and the cross-attention's among them), the ring
    reduce-scatter (each FSDP gradient), GEMM+AR, flash (encoder, decoder,
    cross) and the GEMM must each launch, the GEMM exactly once a dp group,
    microbatch and step (the loss, stacked, one 448-token chunk)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig

    cfg = get_config(ENCDEC_ARCH)

    def frames(gen):
        return {"enc_embeds": torch.randn(
            (batch, enc_len, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)}

    launches, _ = train_family(
        dev, "train-encdec", cfg,
        RunConfig(fsdp=True, comm_backend="fused", microbatches=2),
        names=("matmul", "flash_attention", "pk_matmul_ar", "pk_all_gather",
               "pk_reduce_scatter"), batch=batch, seq=seq, extra=frames)
    return launches


def check_encdec_reference(dev, enc_len: int = 1500) -> None:
    """Phase 5j: whisper-medium at full width cut to 2 encoder and 2
    decoder layers, the card (bf16, kernels, fused collectives) against the
    port's plain float32 path on the CPU with the same weights (bf16 values
    widened) and inputs: the decode logits after 3 tokens over 1500 frames
    on (1, 4) (encode_cross, then decode_step_encdec) within relative 3e-2,
    as phase 4b; one forward and backward of 2 x 64 decoder tokens with
    their frames on (2, 4) with FSDP, the global gradient norm within 3e-2,
    as phase 5b, the loss within ``ENCDEC_TOL_LOSS`` and the gradients of
    the encoder, of the cross-attention and of the rest, each as one
    vector, within ``ENCDEC_TOL_GRAD`` relative Frobenius error."""
    import dataclasses

    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW

    def on_cpu(tree):
        out: dict = {}
        for path, t in T.leaves(tree):
            T.set_path(out, path, t.detach().float().cpu())
        return out

    cut = dict(n_layers=2, n_encoder_layers=2)
    srun = RunConfig(fsdp=False, comm_backend="fused",
                     pk_attn_out_island=True)
    cfg, rules, params, gen = encdec_model(dev, srun, (1, 4), seed=3, **cut)
    enc = torch.randn((2, enc_len, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 3), generator=gen,
                           device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu_rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), "cpu"),
                              srun)
    t0 = time.perf_counter()
    with torch.no_grad():
        got = encdec_decode(params, enc, tokens, cfg, srun, rules, 16,
                            dev)[0].cpu()
        want = encdec_decode(on_cpu(params), enc.float().cpu(), tokens.cpu(),
                             cfg32, srun, cpu_rules, 16, "cpu")[0]
    err = rel_err(got, want)
    print(f"[encdec-reference] 2+2-layer full-width decode logits, card "
          f"(bf16 kernels) vs cpu (f32 plain, {time.perf_counter() - t0:.1f}"
          f" s): rel_err={err:.3e} (tol 3e-2), max |diff| "
          f"{float((got - want).abs().max()):.3e}", flush=True)
    if not err <= 3e-2:
        raise AssertionError(f"whisper decode logits disagree with the f32 "
                             f"plain path: rel_err {err:.3e}")
    del params

    trun = RunConfig(fsdp=True, comm_backend="fused")
    cfg, rules, params, gen = encdec_model(dev, trun, (2, 4), seed=4, **cut)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     generator=gen, device=dev),
             "targets": torch.randint(0, cfg.vocab_size, (2, 64),
                                      generator=gen, device=dev),
             "weights": torch.ones((2, 64), device=dev),
             "enc_embeds": torch.randn((2, enc_len, cfg.d_model),
                                       generator=gen, device=dev).to(
                                           torch.bfloat16)}

    def loss_and_grads(cfg, params, batch, device):
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), device),
                              trun)
        paths = list(T.leaves(params))
        for _, p in paths:
            p.requires_grad_(True)
        loss, _ = T.forward_train(params, batch, cfg, trun, rules)
        gs = torch.autograd.grad(loss, [p for _, p in paths])
        tree: dict = {}
        for (path, _), g in zip(paths, gs):
            T.set_path(tree, path, g)
        return float(loss.detach()), float(AdamW.global_norm(tree)), tree

    cpu_params = on_cpu(params)
    got = loss_and_grads(cfg, params, batch, dev)
    t0 = time.perf_counter()
    want = loss_and_grads(dataclasses.replace(cfg, dtype="float32"),
                          cpu_params, {k: (v.float() if v.is_floating_point()
                                           else v).cpu()
                                       for k, v in batch.items()}, "cpu")
    errs = [abs(a - b) / abs(b) for a, b in zip(got[:2], want[:2])]
    # each part's gradient against the f32 path's, as one vector: a
    # dropped or wrong encoder or cross-attention moves its part by O(1)
    diff: dict = {}
    ref: dict = {}
    for path, g in T.leaves(got[2]):
        part = ("encoder" if path[0] in ("enc_blocks", "enc_final_norm")
                else "cross" if "cross" in path else "decoder")
        w = _leaf(want[2], path)
        diff[part] = diff.get(part, 0.0) + float(
            (g.detach().float().cpu() - w).pow(2).sum())
        ref[part] = ref.get(part, 0.0) + float(w.pow(2).sum())
    part_errs = {k: math.sqrt(diff[k] / ref[k]) for k in sorted(diff)}
    print(f"[encdec-reference] 2+2-layer full-width (2, 4) FSDP step, card "
          f"(bf16 kernels) vs cpu (f32 plain, {time.perf_counter() - t0:.1f}"
          f" s): loss {got[0]:.5f} vs {want[0]:.5f} (rel {errs[0]:.3e}, tol "
          f"{ENCDEC_TOL_LOSS:g}), grad norm {got[1]:.5f} vs {want[1]:.5f} "
          f"(rel {errs[1]:.3e}, tol 3e-2); each part's gradient, relative "
          f"error {', '.join(f'{k} {v:.3e}' for k, v in part_errs.items())}"
          f" (tol {ENCDEC_TOL_GRAD:g})", flush=True)
    if not (errs[0] <= ENCDEC_TOL_LOSS and errs[1] <= 3e-2
            and set(part_errs) == {"encoder", "cross", "decoder"}
            and all(e <= ENCDEC_TOL_GRAD for e in part_errs.values())):
        raise AssertionError(f"whisper training step disagrees with the f32 "
                             f"plain path: {errs}, {part_errs}")


MOE_TRAIN_LAYERS = 4       # of moonshot-v1-16b-a3b's 48
SSM_TRAIN_LAYERS = 16      # of falcon-mamba-7b's 64
HYBRID_ARCH = "jamba-1.5-large-398b"
FAMILY_TOL_LOSS = 1e-3
FAMILY_TOL_GRAD = 3e-2


def train_family(dev, tag: str, cfg, run, *, names, steps: int = 3,
                 batch: int = 8, seq: int = 512, seed: int = 1,
                 extra=None) -> dict:
    """A full-width training run of ``cfg`` on a (2, 4) virtual mesh (data
    2 x model 4) with FSDP, through ``make_train_step`` with AdamW: random
    parameters from ``seed``, ``steps`` steps of ``batch`` x ``seq``
    synthetic tokens in ``run.microbatches`` microbatches, each batch
    joined by ``extra(generator)``'s inputs where one is given. Prints the
    losses (the total, which is differentiated, and the MoE aux loss), the
    step wall times (host clock, each ending in the loss's device->host
    read), the peak ``max_memory_allocated`` and the launches a step of the
    kernels ``names``; fails unless every loss is finite, every kernel
    launched and the GEMM exactly once a dp group, microbatch and step (the
    loss, stacked, one chunk of at most ``run.loss_chunk`` tokens). Returns
    the launches over the run
    and the run's numbers."""
    import torch

    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import TrainState, make_train_step

    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev), run)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=dev)
    n_params = sum(p.numel() for _, p in T.leaves(params))
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed),
                       device=dev)
    opt = AdamW(lr=1e-4, weight_decay=0.01)
    step = make_train_step(cfg, run, rules, opt)
    state = TrainState(params, opt.init(params))
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    counters = {k: fn for k, fn in _counters().items() if k in names}
    for fn in counters.values():
        fn.launches = 0
    losses, auxes, times = [], [], []
    for i in range(steps):
        b = data.batch(i)
        if extra is not None:
            b.update(extra(gen))
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux_loss"]))
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[{tag}] {cfg.name} full width, {cfg.n_layers} layers "
          f"({n_params} parameters, built in {build_s:.1f} s), mesh (2, 4) "
          f"FSDP, comm_backend={run.comm_backend}, remat={run.remat}, batch "
          f"{batch} x seq {seq}, microbatches {run.microbatches}: losses "
          f"(loss + 0.01 aux) {[round(x, 4) for x in losses]}, aux_loss "
          f"{[round(x, 4) for x in auxes]}; step wall times (host clock, "
          f"each ends in a device->host read) {[round(t, 4) for t in times]}"
          f" s; max_memory_allocated {peak} B", flush=True)
    print(f"[{tag}] launches a step {per_step}", flush=True)
    if not all(map(math.isfinite, losses + auxes)):
        raise AssertionError(f"{tag}: losses not all finite: {losses}, "
                             f"{auxes}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{tag} launched no {name} kernel")
    want = steps * 2 * run.microbatches * max(1, seq // run.loss_chunk)
    if launches["matmul"] != want:
        raise AssertionError(f"{tag} launched matmul {launches['matmul']} "
                             f"times, not {want}")
    del state
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "aux": auxes, "times": times,
                      "peak": peak, "params": n_params}


def train_moe(dev) -> dict:
    """Phase 5k: MoE training — moonshot-v1-16b-a3b at full width (d 2048,
    16 heads of 128, 64 experts top-6, expert ff 1408, vocab 163840) cut to
    4 of its 48 layers: 4 x 570 M + 2 x 335 M (embedding, head) = 2.95 B
    parameters, about 41 GB of training state at 14 bytes a parameter
    (bf16 weight, f32 AdamW moments, f32 gradient sums); all 48 layers
    would need about 390 GB. On (2, 4) with FSDP, every collective on the
    kernels, the attention out-projection on the GEMM+AR island
    (``pk_attn_out_island``: no layer has a dense MLP), remat, batch 8 x
    512 in 2 microbatches, 3 steps. The MoE island runs once a dp group on
    its 2 x 512 = 1,024 tokens (capacity 120); the grouped GEMM must launch
    exactly 3 x its chunks a layer, dp group and microbatch, twice (remat
    reruns the forward), and flash, GEMM+AR, the GEMM and B3's AG and RS
    must launch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import ShardingRules

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    run = RunConfig(fsdp=True, comm_backend="fused", microbatches=2,
                    pk_attn_out_island=True)
    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model")), run)
    island = L.moe_island(cfg, run, rules, 4, 512)
    chunks = island.comm.n_chunks
    launches, st = train_family(
        dev, "train-moe", cfg, run,
        names=("matmul", "flash_attention", "pk_matmul_ar", "pk_all_gather",
               "pk_reduce_scatter", "grouped_matmul"))
    want = 3 * cfg.n_layers * 2 * run.microbatches * 3 * chunks * 2
    print(f"[train-moe] grouped_matmul launches {launches['grouped_matmul']}"
          f", expected {want} (3 steps x {cfg.n_layers} layers x 2 dp groups"
          f" x 2 microbatches x 3 GEMMs x {chunks} chunk(s) x 2 forwards)",
          flush=True)
    if launches["grouped_matmul"] != want:
        raise AssertionError(f"MoE training launched the grouped GEMM "
                             f"{launches['grouped_matmul']} times, not "
                             f"{want}")
    if not all(a > 0 for a in st["aux"]):
        raise AssertionError(f"MoE training's aux loss is not positive: "
                             f"{st['aux']}")
    return launches


def train_ssm(dev) -> dict:
    """Phase 5l: SSM training — falcon-mamba-7b at full width (d 4096,
    d_inner 8192, N 16, dt_rank 256, vocab 65024) cut to 16 of its 64
    layers: 16 x 105 M + 2 x 266 M = 2.21 B parameters, about 31 GB of
    training state at 14 bytes a parameter; all 64 layers would need about
    102 GB. On (2, 4) with FSDP (``in_proj`` and ``out_proj`` gathered),
    every collective on the kernels, remat, batch 8 x 512 in 2
    microbatches, 3 steps. The scan runs on the microbatch's global (4,
    512, 8192) activations: its forward kernel exactly twice a layer and
    microbatch (remat reruns the forward), its backward kernel once; the
    GEMM and B3's AG and RS must launch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig

    cfg = dataclasses.replace(get_config(SSM_ARCH),
                              n_layers=SSM_TRAIN_LAYERS)
    run = RunConfig(fsdp=True, comm_backend="fused", microbatches=2)
    launches, st = train_family(
        dev, "train-ssm", cfg, run,
        names=("matmul", "pk_all_gather", "pk_reduce_scatter", "mamba_scan",
               "mamba_scan_bwd"))
    per = 3 * cfg.n_layers * run.microbatches
    want = {"mamba_scan": 2 * per, "mamba_scan_bwd": per}
    print(f"[train-ssm] scan launches forward {launches['mamba_scan']}, "
          f"backward {launches['mamba_scan_bwd']}; expected {want}",
          flush=True)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"SSM training's scan launches {launches} are "
                             f"not {want}")
    if any(st["aux"]):
        raise AssertionError(f"SSM training has an aux loss: {st['aux']}")
    return launches


def train_hybrid(dev, steps: int = 3) -> dict:
    """Phase 5m: the hybrid — jamba-1.5-large-398b ``.reduced()`` (8
    layers: attention, mamba, dense and MoE FFNs in one period; d 64)
    trained by the launcher (``build_and_train``) on (2, 4) with FSDP,
    every collective on the kernels, batch 8 x 128 in 2 microbatches, 3
    steps. Only width is cut: one full-width MoE layer of jamba alone
    holds 16 x 3 x 8192 x 24576 = 9.7 B parameters. Every mixer and FFN
    kind in one model: losses finite, the aux loss positive, and every
    kernel of the path launched — flash, the GEMM, GEMM+AR (the dense MLP
    island), B3's AG and RS, the grouped GEMM, the scan and its
    backward."""
    import torch

    from repro_torch.launch.train import build_and_train

    names = ("matmul", "flash_attention", "pk_matmul_ar", "pk_all_gather",
             "pk_reduce_scatter", "grouped_matmul", "mamba_scan",
             "mamba_scan_bwd")
    counters = {k: fn for k, fn in _counters().items() if k in names}
    for fn in counters.values():
        fn.launches = 0
    ckpt = os.path.join(ROOT, "build", "chip_smoke_hybrid_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    _, log = build_and_train(HYBRID_ARCH, steps=steps, reduced=True,
                             mesh_shape=(2, 4), batch=8, seq=128,
                             microbatches=2, ckpt_dir=ckpt, log_every=1,
                             comm_backend="fused", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [m["loss"] for m in log]
    auxes = [m["aux_loss"] for m in log]
    print(f"[train-hybrid] {HYBRID_ARCH} reduced, mesh (2, 4) FSDP fused, "
          f"batch 8 x 128, 2 microbatches: losses {losses}, aux_loss "
          f"{auxes}; build + {steps} steps + checkpoint {wall:.1f} s; "
          f"launches a step { {k: v / steps for k, v in launches.items()} }",
          flush=True)
    if not (len(log) == steps and all(map(math.isfinite, losses + auxes))
            and all(a > 0 for a in auxes)):
        raise AssertionError(f"hybrid training: losses {losses}, aux "
                             f"{auxes}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"hybrid training launched no {name} "
                                 "kernel")
    return launches


def check_family_reference(dev, seq: int = 64) -> None:
    """Phase 5n: moonshot-v1-16b-a3b and falcon-mamba-7b at full width cut
    to 2 layers, one forward and backward of 2 x 64 tokens on (2, 4) with
    FSDP, the card (bf16, kernels, fused collectives) against the port's
    plain float32 path on the CPU with the same weights (bf16 values
    widened) and batch: the loss (the total, loss + 0.01 aux) within
    relative ``FAMILY_TOL_LOSS`` and each group's gradient, as one vector,
    within ``FAMILY_TOL_GRAD`` relative Frobenius error — moonshot's
    router, experts and the rest; falcon's scan leaves (``A_log``, ``D``,
    ``dt_bias``: small beside the projections, so a wrong da or ddt from
    the backward kernel would hardly move the mamba group), the other mamba
    leaves and the rest. No
    remat (the forward runs once). Routing is discontinuous (bf16 against
    f32 moves 4-15% of the decisions a layer, phase 4d), so the f32 path
    replays the card's routing — each top-k returns the card's indices,
    with the f32 path's own values at them — and computes the same
    function."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import moe
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    real_topk = moe.topk_stable

    def loss_and_grads(cfg, run, params, batch, device, topk):
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), device),
                              run)
        paths = list(T.leaves(params))
        for _, p in paths:
            p.requires_grad_(True)
        with mock.patch.object(moe, "topk_stable", topk):
            total, m = T.forward_train(params, batch, cfg, run, rules)
            gs = torch.autograd.grad(total, [p for _, p in paths])
        tree: dict = {}
        for (path, _), g in zip(paths, gs):
            T.set_path(tree, path, g.detach().float().cpu())
        return float(total.detach()), float(m["aux_loss"].detach()), tree

    for arch, group in ((MOE_ARCH, lambda p: (
            "router" if p[-1] == "router" else "experts"
            if "moe" in p and p[-1] in ("w1", "w2", "w3") else "rest")),
            (SSM_ARCH, lambda p: (
                "scan" if p[-1] in ("A_log", "D", "dt_bias") else "mamba"
                if "mamba" in p else "rest"))):
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        run = RunConfig(fsdp=True, comm_backend="fused", remat=False,
                        pk_attn_out_island=True)
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev),
                              run)
        gen = torch.Generator(device=dev).manual_seed(7)
        params = T.init_params(T.param_template(cfg, run, rules), gen,
                               cfg.d_model, rules=rules, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                         generator=gen, device=dev),
                 "targets": torch.randint(0, cfg.vocab_size, (2, seq),
                                          generator=gen, device=dev),
                 "weights": torch.ones((2, seq), device=dev)}
        cpu_params: dict = {}
        for path, t in T.leaves(params):
            T.set_path(cpu_params, path, t.detach().float().cpu())
        calls: list = []

        def record(x, k):
            out = real_topk(x, k)
            calls.append(out[1])
            return out

        got = loss_and_grads(cfg, run, params, batch, dev, record)
        del params
        replayed = iter(calls)

        def replay(x, k):
            idx = next(replayed).to(x.device)
            return x.gather(-1, idx), idx

        t0 = time.perf_counter()
        want = loss_and_grads(dataclasses.replace(cfg, dtype="float32"),
                              run, cpu_params,
                              {k: v.cpu() for k, v in batch.items()},
                              "cpu", replay)
        cpu_s = time.perf_counter() - t0
        if next(replayed, None) is not None:
            raise AssertionError(f"{arch}: the f32 path made fewer top-k "
                                 "calls than the card")
        loss_err = abs(got[0] - want[0]) / abs(want[0])
        diff: dict = {}
        ref: dict = {}
        for path, g in T.leaves(got[2]):
            part = group(path)
            w = _leaf(want[2], path)
            diff[part] = diff.get(part, 0.0) + float((g - w).pow(2).sum())
            ref[part] = ref.get(part, 0.0) + float(w.pow(2).sum())
        part_errs = {k: math.sqrt(diff[k] / ref[k]) for k in sorted(diff)}
        print(f"[family-reference] {arch} 2-layer full-width (2, 4) FSDP "
              f"step, card (bf16 kernels, {len(calls)} top-k calls "
              f"replayed) vs cpu (f32 plain, {cpu_s:.1f} s): loss "
              f"{got[0]:.5f} vs {want[0]:.5f} (rel {loss_err:.3e}, tol "
              f"{FAMILY_TOL_LOSS:g}), aux {got[1]:.5f} vs {want[1]:.5f}; "
              f"each group's gradient, relative error "
              f"{', '.join(f'{k} {v:.3e}' for k, v in part_errs.items())} "
              f"(tol {FAMILY_TOL_GRAD:g})", flush=True)
        groups = ({"router", "experts", "rest"} if arch == MOE_ARCH
                  else {"scan", "mamba", "rest"})
        if not (loss_err <= FAMILY_TOL_LOSS and set(part_errs) == groups
                and all(e <= FAMILY_TOL_GRAD for e in part_errs.values())):
            raise AssertionError(f"{arch} training step disagrees with the "
                                 f"f32 plain path: loss {loss_err:.3e}, "
                                 f"{part_errs}")
        del got, want, cpu_params
        torch.cuda.empty_cache()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tp_gemm(dev, sweep=(4096, 8192, 16384)) -> dict:
    """Phase 5e: the tensor-parallel GEMM pair (paper Fig. 7/8) through
    ``CommContext`` and declared ``Island``s with ``Comm(op, m, n, k,
    backend=...)``, as ``benchmarks/paper_figures._gemm_island`` declares
    them, at tinyllama-1.1b's MLP at full width on (1, 4), batch 8 x seq
    512 = 4096 tokens, bf16, weights and activations from seed 17:

    * AG+GEMM: the row-sharded activations x (4096, 2048) -> (4, 1024,
      2048) against the gate and up shards side by side, w (4, 2048, 2816)
      -> (4, 4096, 2816);
    * GEMM+RS: the K-sharded activations x (4096, 5632) -> (4, 4096, 1408)
      against w (4, 1408, 2048) -> (4, 1024, 2048), sequence-sharded; every
      rank then gathers it (the hand-off to the next layer's input) with
      the LCSC ring all-gather, bit-identical to the plain gather.

    Each side runs under ``bulk``, ``ring``, ``ring_bidir`` (AG only) and
    ``fused``: every output finite, the others within ``TOL_BF16_OUT``
    (relative) of ``bulk``; the AG×GEMM and GEMM×RS kernels launch exactly
    once per fused call and never under the other backends, the LCSC
    all-gather once per GEMM+RS call. Each island's plan is printed. Then
    the paper's Fig. 7/8 sweep (``paper_figures.fig7_ag_gemm`` /
    ``fig8_gemm_rs`` with R = 4 in place of N) at ``sweep``: fused and bulk
    device times of each side."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import template as TT
    from repro_torch.core.pgl import P, VirtualMesh
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK

    cfg = get_config("tinyllama-1.1b")
    mesh = VirtualMesh((1, 4), ("data", "model"), dev)
    r = mesh.shape["model"]
    tokens, d, ff = 8 * 512, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    def island(op, backend, specs, m, n, k):
        xs, ws, out = specs
        return TT.Island(
            f"{op}/{backend}", mesh=mesh, axis="model",
            inputs={"x": xs, "w": ws}, out_specs=out,
            body=lambda ctx, x, w: getattr(ctx, op)(x, w, backend=backend),
            comm=TT.Comm(op, m=m, n=n, k=k, backend=backend))

    ag_specs = (P("model", None), P(None, "model"), TT.Stacked(P(None,
                                                                 "model")))
    rs_specs = (P(None, "model"), P("model", None), TT.Stacked(P("model",
                                                                 None)))
    sides = (
        ("all_gather_matmul", ag_specs, randn(tokens, d),
         randn(r, d, 2 * ff // r, scale=d ** -0.5), (tokens, 2 * ff // r, d),
         ("bulk", "ring", "ring_bidir", "fused")),
        ("matmul_reduce_scatter", rs_specs, randn(tokens, ff),
         randn(r, ff // r, d, scale=ff ** -0.5), (tokens, d, ff // r),
         ("bulk", "ring", "fused")))
    kernel = {"all_gather_matmul": "ag_matmul_fused",
              "matmul_reduce_scatter": "matmul_rs_fused"}
    counters = {k: fn for k, fn in _counters().items()
                if k in ("ag_matmul_fused", "matmul_rs_fused",
                         "lcsc_ring_all_gather")}
    runs, outs = [], {}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        for op, specs, x, w, (m, n, k), backends in sides:
            for be in backends:
                isl = island(op, be, specs, m, n, k)
                before = {kk: fn.launches for kk, fn in counters.items()}
                out = isl(x=x, w=w)
                if op == "matmul_reduce_scatter":   # the hand-off gather
                    full = LC.lcsc_ring_all_gather(out)
                    torch.cuda.synchronize()
                    if not torch.equal(full, PK.all_gather_plain(out)):
                        raise AssertionError(f"{op}/{be}: the LCSC gather "
                                             "of the output is not a copy")
                    del full
                torch.cuda.synchronize()
                got = {kk: fn.launches - before[kk]
                       for kk, fn in counters.items()}
                want = {kernel[op]: int(be == "fused"),
                        "lcsc_ring_all_gather":
                            int(op == "matmul_reduce_scatter")}
                if any(got[kk] != want.get(kk, 0) for kk in got):
                    raise AssertionError(f"{op}/{be} launched {got}, not "
                                         f"{want}")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{op}/{be}: non-finite output")
                print(f"[tp-gemm] {op} backend={be}: out {tuple(out.shape)} "
                      f"{out.dtype}, kernel launches {got}; plan "
                      f"{isl.plan()}", flush=True)
                runs.append((op, be, isl, x, w))
                outs[op, be] = out
    launches = {kk: fn.launches for kk, fn in counters.items()}
    print(f"[tp-gemm] launches on the MLP pair: {launches}", flush=True)
    for op, be, isl, x, w in runs:
        err = rel_err(outs[op, be], outs[op, "bulk"])
        diff = (outs[op, be].float() - outs[op, "bulk"].float()).abs().max()
        with torch.no_grad():
            ms = time_ms(lambda isl=isl, x=x, w=w: isl(x=x, w=w), iters=5,
                         reps=3, warmup=1)
        print(f"[tp-gemm] {op} {be}: device {ms:.4f} ms a call; vs bulk "
              f"rel_err {err:.3e} (tol {TOL_BF16_OUT:g}), max |diff| "
              f"{float(diff):.3e}", flush=True)
        if not err <= TOL_BF16_OUT:
            raise AssertionError(f"{op} {be} disagrees with bulk")
    del runs, outs, sides

    for nsz in sweep:
        x7 = randn(nsz, nsz // 4)
        w7 = randn(nsz // 4, nsz // 4, scale=(nsz // 4) ** -0.5)
        x8 = randn(nsz, r * (nsz // 8))
        w8 = randn(r * (nsz // 8), nsz // 4, scale=(r * nsz // 8) ** -0.5)
        for tag, op, specs, x, w, mnk in (
                ("fig7_ag_gemm", "all_gather_matmul",
                 (P("model", None), P(None, None), P(None, None)), x7, w7,
                 (nsz, nsz // 4, nsz // 4)),
                ("fig8_gemm_rs", "matmul_reduce_scatter",
                 (P(None, "model"), P("model", None), P("model", None)), x8,
                 w8, (nsz, nsz // 4, nsz // 8))):
            times = {}
            with torch.no_grad():
                for be in ("fused", "bulk"):
                    isl = island(op, be, specs, *mnk)
                    times[be] = time_ms(lambda isl=isl: isl(x=x, w=w),
                                        iters=3, reps=3, warmup=1)
            print(f"[tp-gemm] {tag} N={nsz} (m, n, k) = {mnk}: fused "
                  f"{times['fused']:.4f} ms, bulk {times['bulk']:.4f} ms, "
                  f"bulk/fused {times['bulk'] / times['fused']:.3f}",
                  flush=True)
        del x7, w7, x8, w8
        torch.cuda.empty_cache()
    return launches


#: phase 5o's serving settings: phase 4's, with the paged cache
PAGED_SERVE = dict(max_batch=8, prefill_batch=4, bucket_edges=(128, 512),
                   max_new_tokens=32, cache_layout="paged", page_size=16,
                   prefill_chunk=128)
PAGED_CUT_LAYERS = 4        # phase 5p: of tinyllama-1.1b's 22


def paged_trace(vocab: int) -> list:
    """Phase 4's 8 requests, then 4 that share a prefix with the first 4
    of them that have 40 tokens or more: each fork keeps 3/4 of its donor
    (one less where that is a whole number of 16-token pages, so that the
    boundary page is copied on write), changes the next token and adds 8
    seeded ones."""
    import random

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import synthetic_trace

    slab = {k: v for k, v in PAGED_SERVE.items()
            if k not in ("cache_layout", "page_size", "prefill_chunk")}
    trace = synthetic_trace(8, ServeConfig(**slab), vocab, seed=0)
    rng = random.Random(5)
    forks = []
    for donor in [p for p in trace if len(p) >= 40][:4]:
        k = len(donor) * 3 // 4
        if k % 16 == 0:
            k -= 1
        forks.append(donor[:k] + ((donor[k] + 1) % vocab,)
                     + tuple(rng.randrange(vocab) for _ in range(8)))
    return trace + forks


def _chunk_gaps(eng) -> list:
    """Per prefill job, the step kinds between its consecutive chunks."""
    jobs: dict = {}
    for e in eng.events:
        if e[0] == "prefill_chunk":
            jobs.setdefault(e[2], []).append(e[1])
    return [[eng.step_kinds[s] for s in range(a + 1, b)]
            for steps in jobs.values() for a, b in zip(steps, steps[1:])]


def _serve_run(tag: str, eng, trace, dev, counters) -> dict:
    """Run ``trace`` through ``eng`` with launch counts around it; print
    the step times, tokens/s and peak memory; gate completion. Returns the
    launches."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    done = eng.run(trace)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    step_ms = {kind: 1e3 * statistics.median(
        t for k, t in zip(eng.step_kinds, eng.step_times) if k == kind)
        for kind in ("prefill", "decode")}
    print(f"[{tag}] median step wall time (host clock, each step ends in a "
          f"device->host copy): prefill {step_ms['prefill']:.2f} ms, decode "
          f"{step_ms['decode']:.2f} ms; {len(done)}/{len(trace)} requests, "
          f"{st['tokens_generated']} tokens in {st['wall_s']:.3f}s "
          f"({st['tokens_per_s']:.1f} tok/s); {st['prefill_steps']} prefill "
          f"+ {st['decode_steps']} decode steps; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated(dev)} B; launches {launches}",
          flush=True)
    if len(done) != len(trace) or any(
            len(c.tokens) != eng.serve.max_new_tokens for c in done):
        raise AssertionError(f"{tag}: not every request completed")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{tag} launched no {name} kernel")
    if "matmul" in launches:
        check_logits_launches(tag, launches, st)
    return launches


def serve_paged(dev, slab_tokens: dict) -> dict:
    """Phase 5o: the paged KV cache — tinyllama-1.1b at full width and depth
    on (1, 4), phase 4's settings with ``cache_layout="paged"``, pages of
    16 tokens, prefill in chunks of 128, over phase 4's trace plus 4
    requests sharing a prefix with it. Gates: every request completes with
    finite logits (the engine raises on others), a prefix hit and a
    copied boundary page, a decode step between two chunks of one prefill
    job, B1 once a step and B4 launched; then the same trace with a pool of
    a quarter of the slab's bytes: admission blocked at least once, every
    request done. Prints the greedy tokens' agreement with phase 4's slab
    run (not gated: bf16 rounds the paged and slab mixes differently)."""
    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.runtime.serving import ServingEngine

    serve_cfg = ServeConfig(**PAGED_SERVE)
    t0 = time.perf_counter()
    eng = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                       serve=serve_cfg, seed=0, device=dev,
                       run_overrides={"comm_backend": "fused",
                                      "pk_attn_out_island": True})
    trace = paged_trace(eng.cfg.vocab_size)
    g = eng.geom
    print(f"[serve-paged] engine built in {time.perf_counter() - t0:.1f}s: "
          f"pages of {g.page_size} tokens, {g.n_pages} pages, "
          f"{g.pages_per_slot} a slot, chunks of "
          f"{serve_cfg.prefill_chunk}; prompt lengths "
          f"{[len(p) for p in trace]}", flush=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "pk_matmul_ar")}
    launches = _serve_run("serve-paged", eng, trace, dev, counters)
    cs = eng.cache_stats()
    gaps = _chunk_gaps(eng)
    print(f"[serve-paged] pool {cs['hbm_bytes']} B vs slab "
          f"{cs['slab_bytes']} B; peak pages {cs['peak_resident_pages']}/"
          f"{cs['n_pages']}, prefix hits {cs['prefix_hits']}, shared pages "
          f"{cs['shared_pages_reused']}, copied pages {cs['cow_copies']}, "
          f"admission blocked {cs['admission_blocked']}; steps between "
          f"chunks of one job {gaps}", flush=True)
    if not (cs["prefix_hits"] > 0 and cs["cow_copies"] > 0):
        raise AssertionError(f"no prefix shared or page copied: {cs}")
    if not any("decode" in gap for gap in gaps):
        raise AssertionError("no decode step between two chunks of a job")
    got = {c.rid: c.tokens for c in eng.completions.values()}
    same = sum(a == b for r, toks in slab_tokens.items()
               for a, b in zip(got[r], toks))
    total = sum(map(len, slab_tokens.values()))
    print(f"[serve-paged] greedy tokens paged vs phase 4's slab run: "
          f"{same}/{total} agree ({same / total:.3f})", flush=True)

    small = ServeConfig(**dict(PAGED_SERVE, n_pages=g.n_pages // 4))
    tight = ServingEngine(eng.cfg, eng.base_run, eng.rules, eng.params,
                          small, device=dev)
    _serve_run("serve-paged-quarter", tight, trace, dev, counters)
    cs = tight.cache_stats()
    print(f"[serve-paged-quarter] pool {cs['hbm_bytes']} B "
          f"({cs['hbm_bytes'] / cs['slab_bytes']:.3f} of the slab's), peak "
          f"pages {cs['peak_resident_pages']}/{cs['n_pages']}, peak slots "
          f"{cs['peak_resident_slots']}, admission blocked "
          f"{cs['admission_blocked']}", flush=True)
    if cs["admission_blocked"] <= 0:
        raise AssertionError("the quarter pool never blocked admission")
    del eng, tight
    torch.cuda.empty_cache()
    return launches


def _cut_params(params, n_layers: int) -> dict:
    """The first ``n_layers`` layers of a one-position pattern's blocks."""
    return {**params, "blocks": {"pos0": {
        g: {k: t[:n_layers] for k, t in sub.items()}
        for g, sub in params["blocks"]["pos0"].items()}}}


def paged_logits(cfg, run, rules, params, geom, prompts, dev, feed=None,
                 ticks: int = 4, chunk: int = 128) -> tuple[list, list]:
    """One paged prefill group (``prefill_paged_step`` chunk by chunk, each
    row's logits from the chunk that holds its last token) and ``ticks``
    decode steps over a fresh pool, the block tables mapping row r to pages
    ``[r·P, (r+1)·P)``. Decode feeds ``feed``'s tokens, or the greedy ones.
    Returns (each step's logits on the CPU, the tokens fed)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.runtime import paging

    g = len(prompts)
    pps = geom.pages_per_slot
    n_chunks = -(-max(map(len, prompts)) // chunk)
    tmpl = paging.paged_cache_template(cfg, run, rules, batch=g, geom=geom)
    cache = T.zeros(tmpl, rules, dev)
    bt = torch.arange(g * pps, dtype=torch.int32, device=dev).view(g, pps)
    tokens = torch.zeros((g, n_chunks * chunk), dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    wf = torch.zeros(g, dtype=torch.int64, device=dev)
    first = None
    with torch.no_grad():
        for c in range(n_chunks):
            logits, cache = T.prefill_paged_step(
                params, cache, tokens[:, c * chunk:(c + 1) * chunk].to(dev),
                bt, lens, c * chunk, wf, cfg, run, rules,
                page_size=geom.page_size)
            here = ((lens - 1) // chunk == c).view(g, 1, 1)
            first = logits if first is None else torch.where(here, logits,
                                                             first)
        cache["block_tables"] = bt
        cache["pos"] = lens.to(torch.int32)
        outs, fed = [first.cpu()], []
        logits = first
        for t in range(ticks):
            nxt = (feed[t] if feed is not None else
                   logits[:, -1, :cfg.vocab_size].argmax(-1).cpu())
            fed.append(nxt)
            logits, cache = T.decode_step(params, cache,
                                          nxt.view(g, 1).to(dev), cfg, run,
                                          rules, page_size=geom.page_size)
            outs.append(logits.cpu())
    return outs, fed


def serve_paged_cut(dev) -> dict:
    """Phase 5p: tinyllama-1.1b at full width cut to 4 layers — (a) paged
    serving on (2, 4), dp 2 x tp 4, the pool partitioned over the dp
    groups; (b) slab serving with head-sharded caches
    (``decode_seq_shard=False``) on (1, 4), whose prefill mixes through
    flash over the global cache; (c) a 2-layer paged prefill group (2
    chunks) and 4 decode ticks on (1, 4) against the port's plain f32 path
    on the CPU with the same weights, fed the card's greedy tokens: each
    step's logits within phase 4b's 3e-2 relative. Returns (a)'s and (b)'s
    launches, by run."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.transformer import leaves, set_path
    from repro_torch.runtime.serving import ServingEngine, \
        resolve_page_geometry

    full = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                        serve=ServeConfig(**PAGED_SERVE), seed=2, device=dev,
                        run_overrides={"comm_backend": "fused",
                                       "pk_attn_out_island": True})
    cfg = dataclasses.replace(full.cfg, n_layers=PAGED_CUT_LAYERS)
    params = _cut_params(full.params, PAGED_CUT_LAYERS)
    base_run = full.base_run
    del full
    trace = paged_trace(cfg.vocab_size)[:8]
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "pk_matmul_ar", "flash_attention")}
    out = {}

    rules24 = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev),
                            base_run)
    eng = ServingEngine(cfg, base_run, rules24, params,
                        ServeConfig(**PAGED_SERVE), device=dev)
    print(f"[serve-paged-dp] {cfg.n_layers} layers on (2, 4): pool of "
          f"{eng.geom.n_pages} pages in {eng.geom.n_partitions} partitions",
          flush=True)
    out["dp"] = _serve_run("serve-paged-dp", eng, trace, dev,
                           {k: counters[k] for k in ("matmul",
                                                     "pk_matmul_ar")})
    del eng

    run_hs = dataclasses.replace(base_run, decode_seq_shard=False)
    rules_hs = ShardingRules(VirtualMesh((1, 4), ("data", "model"), dev),
                             run_hs)
    slab = {k: v for k, v in PAGED_SERVE.items()
            if k not in ("cache_layout", "page_size", "prefill_chunk")}
    eng = ServingEngine(cfg, run_hs, rules_hs, params, ServeConfig(**slab),
                        device=dev)
    print(f"[serve-head-sharded] {cfg.n_layers} layers on (1, 4), slab "
          f"cache stored global: {tuple(eng.cache['blocks']['pos0']['k'].shape)}",
          flush=True)
    out["head_sharded"] = _serve_run("serve-head-sharded", eng, trace, dev,
                                     counters)
    del eng

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = _cut_params(params, 2)
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), dev),
                          base_run)
    serve_ref = ServeConfig(max_batch=4, prefill_batch=4,
                            bucket_edges=(256,), max_new_tokens=8,
                            cache_layout="paged", page_size=16,
                            prefill_chunk=128)
    geom = resolve_page_geometry(serve_ref, rules)
    import random
    rng = random.Random(7)
    prompts = [tuple(rng.randrange(cfg.vocab_size) for _ in range(n))
               for n in (200, 77, 130, 15)]
    got, fed = paged_logits(cfg2, base_run, rules, params2, geom, prompts,
                            dev)
    cpu_params = {}
    for path, t in leaves(params2):
        set_path(cpu_params, path, t.float().cpu())
    cpu_rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), "cpu"),
                              base_run)
    want, _ = paged_logits(dataclasses.replace(cfg2, dtype="float32"),
                           base_run, cpu_rules, cpu_params, geom, prompts,
                           "cpu", feed=fed)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    print(f"[paged-reference] 2-layer paged prefill (2 chunks of 128) + 4 "
          f"decode ticks, card (bf16) vs cpu (f32 plain): rel_err "
          f"{[f'{e:.3e}' for e in errs]} (tol 3e-2)", flush=True)
    if not all(e <= 3e-2 for e in errs):
        raise AssertionError(f"paged logits disagree with the f32 path: "
                             f"{errs}")
    del params, params2
    torch.cuda.empty_cache()
    return out

#: phase 4's serving settings, which phase 5q runs with an int8 cache
SERVE4 = dict(max_batch=8, prefill_batch=4, bucket_edges=(128, 512),
              max_new_tokens=32)
INT8_KV_RATIO = (64 + 4) / 128     # tinyllama: (hd + 4 scale bytes) / 2·hd


def slab_logits(cfg, run, rules, params, prompts, dev, *, kv_dtype: str,
                feed=None, ticks: int = 4, bucket: int = 256
                ) -> tuple[list, list]:
    """One slab prefill group (``prefill_step`` over the prompts
    right-padded to ``bucket``) and ``ticks`` decode steps with a
    ``kv_dtype`` cache. Decode feeds ``feed``'s tokens, or the greedy ones.
    Returns (each step's logits on the CPU, the tokens fed)."""
    import torch

    from repro_torch.models import transformer as T

    g = len(prompts)
    tmpl = T.cache_template(cfg, run, rules, batch=g, s_max=bucket + ticks,
                            slot_pos=True, kv_dtype=kv_dtype)
    cache = T.zeros(tmpl, rules, dev)
    tokens = torch.zeros((g, bucket), dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    outs, fed = [], []
    with torch.no_grad():
        logits, cache = T.prefill_step(params, cache, tokens.to(dev), lens,
                                       cfg, run, rules)
        outs.append(logits.cpu())
        for t in range(ticks):
            nxt = (feed[t] if feed is not None else
                   logits[:, -1, :cfg.vocab_size].argmax(-1).cpu())
            fed.append(nxt)
            logits, cache = T.decode_step(params, cache,
                                          nxt.view(g, 1).to(dev), cfg, run,
                                          rules)
            outs.append(logits.cpu())
    return outs, fed


def serve_int8(dev, slab_tokens: dict) -> dict:
    """Phase 5q: the int8 KV cache — tinyllama-1.1b at full width and depth
    on (1, 4), phase 4's settings and trace with ``kv_dtype="int8"``: the
    slab cache, then the paged one with 5o's settings. Gates: every request
    completes with finite logits; the cache's bytes are (64 + 4) / 128 =
    0.531 of the bf16 slab's (phase 4) and pool's (5o); B1 once a step, B4
    launched, B7 once a layer a prefill step on the slab (the prompt
    attends over its dequantized K/V) and never on the paged cache (its mix
    is plain torch, as JAX's is XLA). The greedy tokens' agreement with
    phase 4's bf16 run is printed, not gated. Then the model cut to 2
    layers: one slab prefill group (4 prompts, bucket 256) and 4 decode
    ticks with an int8 cache on the card against the port's plain f32 path
    on the CPU with the same cache format, fed the card's tokens — each
    step's logits within 3e-2 relative. Returns the two runs' launches."""
    import dataclasses
    import random

    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.models.transformer import leaves, set_path
    from repro_torch.runtime import paging
    from repro_torch.runtime.serving import ServingEngine

    t0 = time.perf_counter()
    eng = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                       serve=ServeConfig(**SERVE4, kv_dtype="int8"), seed=0,
                       device=dev,
                       run_overrides={"comm_backend": "fused",
                                      "pk_attn_out_island": True})
    cfg = eng.cfg
    trace = synthetic_trace(8, eng.serve, cfg.vocab_size, seed=0)
    print(f"[serve-int8] engine built in {time.perf_counter() - t0:.1f}s: "
          f"int8 K/V {tuple(eng.cache['blocks']['pos0']['k'].shape)} "
          f"{eng.cache['blocks']['pos0']['k'].dtype}, scales "
          f"{tuple(eng.cache['blocks']['pos0']['k_scale'].shape)}",
          flush=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "pk_matmul_ar", "flash_attention")}
    out = {}
    runs = (("serve-int8", eng.serve,
             paging.slab_hbm_bytes(cfg, 8, eng.s_max)),
            ("serve-int8-paged", ServeConfig(**PAGED_SERVE, kv_dtype="int8"),
             None))
    for tag, serve_cfg, bf16_bytes in runs:
        e = eng if tag == "serve-int8" else ServingEngine(
            cfg, eng.base_run, eng.rules, eng.params, serve_cfg, device=dev)
        if bf16_bytes is None:
            bf16_bytes = paging.pool_hbm_bytes(cfg, e.geom)
        paged = e.paged
        for fn in counters.values():
            fn.launches = 0
        launches = _serve_run(tag, e, trace, dev,
                              {k: v for k, v in counters.items()
                               if not (paged and k == "flash_attention")})
        fl = counters["flash_attention"].launches
        want_fl = 0 if paged else cfg.n_layers * e.stats()["prefill_steps"]
        cs = e.cache_stats()
        ratio = cs["hbm_bytes"] / bf16_bytes
        got = {c.rid: c.tokens for c in e.completions.values()}
        same = sum(a == b for r, toks in slab_tokens.items()
                   for a, b in zip(got[r], toks))
        total = sum(map(len, slab_tokens.values()))
        print(f"[{tag}] cache {cs['hbm_bytes']} B = {ratio:.5f} of the "
              f"bf16 cache's {bf16_bytes} B (expected {INT8_KV_RATIO}); "
              f"flash launches {fl} (expected {want_fl}); greedy tokens vs "
              f"phase 4's bf16 slab run: {same}/{total} agree "
              f"({same / total:.3f}, not gated)", flush=True)
        if ratio != INT8_KV_RATIO:
            raise AssertionError(f"{tag}: int8 cache bytes {ratio} of bf16")
        if fl != want_fl:
            raise AssertionError(f"{tag} launched flash {fl} times, not "
                                 f"{want_fl}")
        out[tag] = dict(launches, flash_attention=fl)
        del e
    params = {**eng.params, "blocks": {"pos0": {
        g: {k: t[:2] for k, t in sub.items()}
        for g, sub in eng.params["blocks"]["pos0"].items()}}}
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    run, rules = eng.base_run, eng.rules
    del eng
    rng = random.Random(9)
    prompts = [tuple(rng.randrange(cfg.vocab_size) for _ in range(n))
               for n in (200, 77, 256, 15)]
    got, fed = slab_logits(cfg2, run, rules, params, prompts, dev,
                           kv_dtype="int8")
    cpu_params = {}
    for path, t in leaves(params):
        set_path(cpu_params, path, t.float().cpu())
    cpu_rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), "cpu"),
                              run)
    want, _ = slab_logits(dataclasses.replace(cfg2, dtype="float32"), run,
                          cpu_rules, cpu_params, prompts, "cpu",
                          kv_dtype="int8", feed=fed)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    print(f"[int8-reference] 2-layer slab prefill (bucket 256) + 4 decode "
          f"ticks with an int8 cache, card (bf16) vs cpu (f32 plain, int8 "
          f"cache): rel_err {[f'{e:.3e}' for e in errs]} (tol 3e-2)",
          flush=True)
    if not all(e <= 3e-2 for e in errs):
        raise AssertionError(f"int8-cache logits disagree with the f32 "
                             f"path: {errs}")
    del params
    torch.cuda.empty_cache()
    return out


def tp_gemm_int8(dev) -> dict:
    """Phase 5r: the int8 wire — phase 5e's TP GEMM pair at tinyllama-1.1b's
    MLP on (1, 4) (4096 tokens, seed 17), ``CommContext(wire=...)`` with
    ``"int8"`` and ``"int8_sr"`` under ``ring`` and ``ring_bidir`` (AG) and
    ``ring`` (RS). Gates: 1, 2 and 4 chunks bit-identical; every output
    within 2e-2 relative of ``bulk`` at full precision; ``auto`` never
    ``fused`` under a quantized wire (on the card the policy takes the
    fused kernels for a full-precision wire; they ship full precision) but
    a ring where the policy overlaps, bulk where it does not (GEMM+RS at
    this shape: its GEMM is below the sync cost, whatever the wire), and
    the AG×GEMM and GEMM×RS kernels (B5, B6) never launched under one. Each call's device time is
    printed beside bulk's and fused's. Then tinyllama cut to 4 layers
    serves phase 4's trace with ``comm_wire="int8"``: the GEMM+AR sites'
    plans under ``auto`` are printed (never ``fused``; at these shapes the
    analytic policy keeps bulk, as it does at full precision), then the
    run with the sites pinned to ``ring``, which ships the int8 wire:
    every plan (ring, int8), every request done, the GEMM+AR kernel (B4)
    never launched. Returns that run's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.core.comms import GEMM_OP_KIND, CommContext
    from repro_torch.core.pgl import P, VirtualMesh, layout
    from repro_torch.launch.serve import synthetic_trace
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import island_plans
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.runtime.serving import ServingEngine

    cfg = get_config("tinyllama-1.1b")
    mesh = VirtualMesh((1, 4), ("data", "model"), dev)
    r = mesh.shape["model"]
    tokens, d, ff = 8 * 512, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    ag = ("all_gather_matmul",
          layout(randn(tokens, d), P("model", None), mesh, "model"),
          randn(r, d, 2 * ff // r, scale=d ** -0.5), ("ring", "ring_bidir"),
          (tokens, 2 * ff // r, d))
    rs = ("matmul_reduce_scatter",
          layout(randn(tokens, ff), P(None, "model"), mesh, "model"),
          randn(r, ff // r, d, scale=ff ** -0.5), ("ring",),
          (tokens, d, ff // r))
    counters = {k: fn for k, fn in _counters().items()
                if k in ("ag_matmul_fused", "matmul_rs_fused")}
    full = CommContext("model", mesh=mesh)
    with torch.no_grad():
        for op, x, w, backends, mnk in (ag, rs):
            bulk = getattr(full, op)(x, w, backend="bulk")
            t_bulk = time_ms(lambda: getattr(full, op)(x, w, backend="bulk"),
                             iters=5, reps=3, warmup=1)
            t_fused = time_ms(lambda: getattr(full, op)(x, w,
                                                        backend="fused"),
                              iters=5, reps=3, warmup=1)
            auto16 = full.auto_gemm_backend(op, *mnk,
                                            fused_ok=full._prefer_fused())
            for wire in ("int8", "int8_sr"):
                ctx = CommContext("model", mesh=mesh, wire=wire)
                auto = ctx.auto_gemm_backend(op, *mnk,
                                             fused_ok=ctx._prefer_fused())
                overlap = ctx.gemm_policy(
                    *mnk, kind=GEMM_OP_KIND[op]).enabled
                for fn in counters.values():
                    fn.launches = 0
                auto_out = getattr(ctx, op)(x, w)
                for be in backends:
                    outs = [getattr(ctx, op)(x, w, backend=be, n_chunks=c)
                            for c in (1, 2, 4)]
                    torch.cuda.synchronize()
                    same = all(torch.equal(o, outs[0]) for o in outs[1:])
                    err = rel_err(outs[0], bulk)
                    ms = time_ms(lambda be=be: getattr(ctx, op)(
                        x, w, backend=be), iters=5, reps=3, warmup=1)
                    print(f"[wire-int8] {op} wire={wire} backend={be}: "
                          f"out {tuple(outs[0].shape)}, chunks 1/2/4 "
                          f"bit-identical {same}, rel_err vs bulk bf16 "
                          f"{err:.3e} (tol 2e-2); device {ms:.4f} ms a "
                          f"call (bulk {t_bulk:.4f}, fused {t_fused:.4f})",
                          flush=True)
                    if not (same and err <= 2e-2
                            and bool(torch.isfinite(outs[0]).all())):
                        raise AssertionError(f"{op} {wire} {be}: chunks "
                                             f"alike {same}, rel_err {err}")
                launched = {k: fn.launches for k, fn in counters.items()}
                print(f"[wire-int8] {op} wire={wire}: auto -> {auto} (the "
                      f"policy overlaps: {overlap}; at full precision auto "
                      f"-> {auto16}); B5/B6 launches under the quantized "
                      f"wire {launched}", flush=True)
                if (auto in ("ring", "ring_bidir")) != overlap or \
                        auto == "fused" or any(launched.values()):
                    raise AssertionError(f"{op} {wire}: auto {auto}, "
                                         f"launches {launched}")
                if rel_err(auto_out, bulk) > 2e-2:
                    raise AssertionError(f"{op} {wire}: auto's output off")
            del bulk
    del ag, rs

    cfg4 = dataclasses.replace(cfg, n_layers=PAGED_CUT_LAYERS)
    run = RunConfig(fsdp=False, decode_seq_shard=True, comm_wire="int8",
                    pk_attn_out_island=True)
    rules = ShardingRules(mesh, run)
    params = T.init_params(T.param_template(cfg4, run, rules),
                           torch.Generator(device=dev).manual_seed(3),
                           cfg4.d_model, rules=rules, device=dev)

    def gemm_ar_plans(eng):
        return {(name, p.island): (p.backend, p.wire)
                for name, bp in eng.bucket_plans.items() for p in bp.plans
                if p.op == "matmul_all_reduce"}

    auto = gemm_ar_plans(ServingEngine(cfg4, run, rules, params,
                                       ServeConfig(**SERVE4), device=dev))
    run = dataclasses.replace(run, comm_backend="ring")
    eng = ServingEngine(cfg4, run, rules, params, ServeConfig(**SERVE4),
                        device=dev)
    plans = gemm_ar_plans(eng)
    print(f"[serve-wire-int8] {cfg4.n_layers} layers on (1, 4), "
          f"comm_wire=int8, GEMM+AR plans (bucket, island) -> (backend, "
          f"wire) under auto {auto}; pinned to ring {plans}", flush=True)
    if any(be == "fused" for be, _ in auto.values()) or set(
            plans.values()) != {("ring", "int8")}:
        raise AssertionError(f"GEMM+AR plans under the int8 wire: {auto}, "
                             f"{plans}")
    trace = synthetic_trace(8, eng.serve, cfg4.vocab_size, seed=0)
    ar = _counters()["pk_matmul_ar"]
    ar.launches = 0
    launches = _serve_run("serve-wire-int8", eng, trace, dev,
                          {k: fn for k, fn in _counters().items()
                           if k in ("matmul", "flash_attention")})
    launches["pk_matmul_ar"] = ar.launches
    if ar.launches:
        raise AssertionError(f"GEMM+AR kernel launched {ar.launches} times "
                             "under comm_wire=int8")
    del eng, params
    torch.cuda.empty_cache()
    return launches


def train_compressed(dev, train_launches: dict, train_steps: int) -> dict:
    """Phase 5s: compressed FSDP training — phase 5's run (tinyllama-1.1b at
    full width and depth on (2, 4), FSDP, ``comm_backend="fused"``, batch
    8 x 512 in 2 microbatches) through ``build_and_train(compress_grads=
    True)`` for 3 steps: int8 error-feedback compression of every step's
    gradient, its residual (f32, every weight's global layout) carried in
    the train state. Gates: the losses finite, the residual nonzero after
    step 1 (the transform's output state, read at every call), B3's AG
    and RS launched a step as in phase 5. Returns the launches."""
    from unittest import mock

    import torch

    from repro_torch.launch.train import build_and_train
    from repro_torch.models.transformer import leaves
    from repro_torch.optim.compress import ErrorFeedbackInt8

    steps, batch, seq, mb = 3, 8, 512, 2
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "pk_all_gather", "pk_reduce_scatter")}
    residual_abs = []
    real = ErrorFeedbackInt8.transform

    def spy(self, grads, state):
        out, new = real(self, grads, state)
        residual_abs.append(float(sum(r.abs().sum()
                                      for _, r in leaves(new.residual))))
        return out, new

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    try:
        with mock.patch.object(ErrorFeedbackInt8, "transform", spy):
            state, log = build_and_train(
                "tinyllama-1.1b", steps=steps, reduced=False,
                mesh_shape=(2, 4), mesh_axes=("data", "model"), batch=batch,
                seq=seq, ckpt_dir=ckpt, microbatches=mb, log_every=1,
                ckpt_every=100, comm_backend="fused", compress_grads=True,
                device=dev)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state
    losses = [m["loss"] for m in log]
    times = [m["step_time_s"] for m in log]
    per_step = {k: v / steps for k, v in launches.items()}
    base = {k: train_launches[k] / train_steps
            for k in ("pk_all_gather", "pk_reduce_scatter")}
    print(f"[train-compressed] tinyllama-1.1b full width and depth, (2, 4) "
          f"FSDP, compress_grads: losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(m['grad_norm'], 4) for m in log]}; step wall "
          f"times (host clock) {[round(t, 4) for t in times]} s; residual "
          f"sum |r| after each step {residual_abs}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev)} B", flush=True)
    print(f"[train-compressed] launches a step {per_step}; phase 5's AG/RS "
          f"a step {base}", flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"compressed losses not all finite: {losses}")
    if len(residual_abs) != steps or not residual_abs[0] > 0:
        raise AssertionError(f"residual after step 1: {residual_abs}")
    if any(per_step[k] != base[k] for k in base):
        raise AssertionError(f"AG/RS a step {per_step} != phase 5's {base}")
    return launches


def serve_moe_tp_data(dev) -> dict:
    """Phase 5t: resident 2D-TP MoE serving (``serve_moe_tp_data``) —
    moonshot-v1-16b-a3b at full width cut to 4 of its 48 layers, as 5k
    cuts it, on (2, 4): expert weights stay put, their ff sliced over the
    2 dp groups; every dp group dispatches all the tokens with its slice
    and the f32 partials are summed over dp. The engine serves phase 4c's
    trace (8 requests, 32 new tokens, buckets 128/512). Gates: every
    request completes; the grouped GEMM launches exactly 3 x its chunks a
    layer, dp group and step; no FSDP gather of expert weights (no
    all-gather kernel at all, and the MoE island declares none); then the
    2-layer reference of phase 4d on this (2, 4) engine: logits within 3e-2
    of the port's plain f32 CPU path on the card's routing. Returns the
    serving run's launches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import synthetic_trace
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.runtime.serving import ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    run = RunConfig(fsdp=False, decode_seq_shard=True,
                    serve_moe_tp_data=True, comm_backend="fused",
                    pk_attn_out_island=True)
    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"), dev), run)
    t0 = time.perf_counter()
    params = T.init_params(T.param_template(cfg, run, rules),
                           torch.Generator(device=dev).manual_seed(0),
                           cfg.d_model, rules=rules, device=dev)
    eng = ServingEngine(cfg, run, rules, params, ServeConfig(**SERVE4),
                        device=dev)
    isl = L.moe_island(cfg, run, rules, 8, 1)
    chunks = isl.comm.n_chunks
    w1 = params["blocks"]["pos0"]["moe"]["w1"]
    print(f"[serve-moe-tp-data] {cfg.name} cut to {cfg.n_layers} layers on "
          f"(2, 4), built in {time.perf_counter() - t0:.1f}s: expert w1 "
          f"stored {tuple(w1.shape)} (ff sliced over dp in the island), "
          f"island gathers {isl.gathers}, chunks {chunks}", flush=True)
    trace = synthetic_trace(8, eng.serve, cfg.vocab_size, seed=0)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar",
                         "grouped_matmul")}
    gather = _counters()["pk_all_gather"]
    gather.launches = 0
    launches = _serve_run("serve-moe-tp-data", eng, trace, dev, counters)
    st = eng.stats()
    steps = st["prefill_steps"] + st["decode_steps"]
    want = 3 * cfg.n_layers * 2 * chunks * steps
    print(f"[serve-moe-tp-data] grouped_matmul launches "
          f"{launches['grouped_matmul']}, expected {want} (3 GEMMs x "
          f"{chunks} chunk(s) x {cfg.n_layers} layers x 2 dp groups x "
          f"{steps} steps); all-gather launches {gather.launches}",
          flush=True)
    if launches["grouped_matmul"] != want:
        raise AssertionError(f"2D-TP MoE launched the grouped GEMM "
                             f"{launches['grouped_matmul']} times, not "
                             f"{want}")
    if gather.launches or isl.gathers:
        raise AssertionError("2D-TP MoE serving gathered weights")
    launches["pk_all_gather"] = gather.launches
    check_moe_reference(dev, eng, tag="moe-tp-data-reference")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches

#: where phase 5u keeps its calibration table and the autotuner's cache
AUTOTUNE_DIR = os.path.join(ROOT, "build", "autotune")


def _serving_sweeps(cfg, run, rules, serve) -> list:
    """The per-island sweeps of a serving engine's buckets: each prefill
    bucket at (prefill_batch, edge) and the decode pool at (max_batch,
    s_max), as ``resolve_serving_plans`` resolves them."""
    from repro_torch.models.layers import island_comm_sweeps
    from repro_torch.runtime.serving import padded_s_max

    sweeps = []
    for edge in serve.bucket_edges:
        sweeps += island_comm_sweeps(cfg, run, rules,
                                     batch=serve.prefill_batch, seq=edge,
                                     phase="prefill")
    sweeps += island_comm_sweeps(cfg, run, rules, batch=serve.max_batch,
                                 seq=padded_s_max(serve, rules),
                                 phase="decode")
    return sweeps


def _print_plans(tag: str, eng, serve_cfg, calibration) -> None:
    """Print the GEMM-collective plans of ``eng``'s buckets resolved under
    the analytic policy (``calibration=None``) or from the shipped seed
    (``"seed"``), unpinned, for comparison with the measured ones."""
    import dataclasses

    from repro_torch.core import autotune as TA
    from repro_torch.core.comms import GEMM_OP_KIND
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.runtime.serving import resolve_serving_plans

    run = dataclasses.replace(eng.base_run, comm_policy="analytic",
                              calibration_path=None)
    if calibration == "seed":
        seed = os.path.join(os.path.dirname(TA.__file__), "calibrations",
                            "h100_sxm.json")
        run = dataclasses.replace(run, comm_policy="measured",
                                  calibration_path=seed)
    plans = resolve_serving_plans(eng.cfg, run,
                                  ShardingRules(eng.rules.mesh, run),
                                  serve_cfg)
    for name, bp in plans.items():
        print(f"[{tag}] {name}: " + ", ".join(
            f"{p.island} {p.backend} x{p.n_chunks} hidden "
            f"{p.hidden_fraction:.3f} ({p.source})" for p in bp.plans
            if not p.fallback and p.op in GEMM_OP_KIND), flush=True)


def autotune_serve(dev, slab_tokens: dict) -> dict:
    """Phase 5u: the empirical autotuner on the card, then serving from
    the table it wrote.

    (a) ``calibrate`` on a (4,) mesh of virtual ranks, grid ``small``, wire
    widths bf16 and int8, with per-island sweeps for tinyllama-1.1b at full
    width: phase 4's prefill buckets (4 x 128, 4 x 512) and decode pool
    (8), their int8-wire twins, the Ulysses island at 1 x 8192 and
    moonshot-v1-16b-a3b's MoE dispatch at 4 x 512 tokens. Gates: every GEMM
    op has bulk, ring and fused rows and no b1 row is fused; every island
    sweep has exactly the rows of its case grid (``island_sweep_cases``:
    bulk, ring and, at b2, fused at each chunk count; ``a2a_sweep_cases``:
    bulk and the chunked counts); B4, B5 and B6 launched during
    calibration, the all-to-all kernel for the chunked rows; the table
    round-trips JSON; ``show``, ``diff`` (one-sided) and ``check
    --no-probe`` exit 0. Prints the fitted corrections beside H100_SXM's,
    the GEMM probe's device time beside ``torch.matmul``'s, and the wall
    time.
    (b) phase 4's engine and trace with ``comm_policy="measured"`` and
    ``calibration_path`` that table. Gates: every active GEMM-collective
    island plan of every bucket is ``source="measured"`` with the backend
    ``table.best_backend`` gives at that bucket's coordinates; every
    request completes with finite prefill logits; B1 once a step, flash
    launched; B4 launched iff some bucket plan says fused. Prints the
    greedy tokens' agreement with phase 4 (not gated).
    (c) the shipped seed ``core/calibrations/h100_sxm.json``: its
    ``device_kind`` must be this card's name; prints whether
    ``find_table("h100_sxm")`` resolves it.
    (d) ``train_policies``: phase 5's training under both policies.
    Returns the launches of (a) and (b)."""
    import contextlib
    import gc
    import io

    import torch

    from repro_torch import autotune as cli
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.core import autotune as TA
    from repro_torch.core import costmodel as cm
    from repro_torch.core.comms import GEMM_OP_KIND, OP_BACKENDS
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models.layers import island_comm_sweeps
    from repro_torch.models.sharding import ShardingRules

    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(AUTOTUNE_DIR, exist_ok=True)
    # the autotuner's cache search stays inside the checkout
    os.environ["REPRO_CACHE_DIR"] = os.path.join(AUTOTUNE_DIR, "cache")
    TA.clear_caches()
    serve_cfg = ServeConfig(**SERVE4)
    cfg = get_config("tinyllama-1.1b")
    mesh = VirtualMesh((1, 4), ("data", "model"), dev)
    srun = RunConfig(dp_axes=("data",), fsdp=False, pk_attn_out_island=True,
                     sp_attention="ulysses")
    srules = ShardingRules(mesh, srun)
    sweeps = _serving_sweeps(cfg, srun, srules, serve_cfg)
    sweeps += [sw for sw in island_comm_sweeps(cfg, srun, srules, batch=1,
                                               seq=8192, phase="all")
               if sw.op == "all_to_all"]
    mcfg = get_config(MOE_ARCH)
    mrun = RunConfig(dp_axes=("data",), fsdp=False, sp_attention="none")
    sweeps += [sw for sw in island_comm_sweeps(
        mcfg, mrun, ShardingRules(mesh, mrun), batch=SERVE4["prefill_batch"],
        seq=SERVE4["bucket_edges"][-1], phase="prefill")
        if sw.island.startswith("moe_dispatch|")]
    sweeps += cli.int8_island_sweeps(sweeps)
    keys = sorted({sw.island for sw in sweeps})
    print(f"[autotune] {len(sweeps)} island sweeps: {keys}", flush=True)
    if not any(k.startswith("attn_ulysses|") for k in keys) or not any(
            k.startswith("moe_dispatch|") for k in keys):
        raise AssertionError("the Ulysses and MoE-dispatch sweeps are "
                             "missing")

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = TA.calibrate(VirtualMesh((4,), ("x",), dev), grid="small",
                         reps=3, dtypes=(2, 1), islands=sweeps,
                         notes="chip_smoke phase 5u")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cal_launches = {k: c.launches for k, c in counters.items()}
    path = table.save(os.path.join(AUTOTUNE_DIR, "table.json"))
    print(f"[autotune] calibrated in {wall:.2f}s: "
          f"{len(table.measurements)} rows {table.ops_covered()}; "
          f"fingerprint {table.fingerprint}; launches {cal_launches}",
          flush=True)
    a = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
    t_lib = TA._device_seconds(torch.matmul, a, a, reps=3, device=dev)
    t_wall = TA._timeit(torch.matmul, a, a, reps=3, device=dev)
    lib_eff = 2 * 512 ** 3 / t_lib / cm.H100_SXM.peak_flops_bf16
    print(f"[autotune] GEMM probe 512^3 bf16, device time: B1 "
          f"{table.corrections['gemm_efficiency']:.4e} of the 989 TFLOP/s "
          f"peak; torch.matmul (reference only) {lib_eff:.4e} "
          f"({t_lib * 1e6:.2f} us of device time a call, {t_wall * 1e6:.1f}"
          f" us synchronized wall)", flush=True)
    print("[autotune] fitted corrections beside H100_SXM's:\n"
          + "\n".join(cli._fmt_corrections(table.corrections, cm.H100_SXM)),
          flush=True)
    if table.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise AssertionError("the table does not name the card")
    grid = [r for r in table.measurements if not r.get("island")]
    for op in TA.GEMM_OPS:
        have = {r["backend"] for r in grid
                if r["op"] == op and r["dtype_bytes"] == 2}
        if not {"bulk", "ring", "fused"} <= have:
            raise AssertionError(f"{op}: grid rows {sorted(have)} lack one "
                                 "of bulk, ring, fused")
    if any(r["backend"] == "fused" for r in table.measurements
           if r.get("dtype_bytes") == 1):
        raise AssertionError("a b1 (int8-wire) row was timed fused")
    for name in ("pk_matmul_ar", "ag_matmul_fused", "matmul_rs_fused",
                 "pk_all_to_all"):
        if cal_launches[name] <= 0:
            raise AssertionError(f"calibration launched no {name} kernel")
    chunked = [r for r in table.measurements
               if r["op"] == "all_to_all" and r["backend"] == "chunked"]
    if not chunked:
        raise AssertionError("no chunked all-to-all row was measured")
    # every island sweep has each row its case grid calls for (on the card
    # calibrate raises where a row fails; this holds the table to it
    # apart): a GEMM sweep at b2 bulk, ring and fused at every count, an
    # all-to-all sweep bulk and its chunked counts
    for sw in sweeps:
        if sw.op == "all_to_all":
            want = set(TA.a2a_sweep_cases(sw, 4))
        else:
            want = set(TA.island_sweep_cases(sw, 4, OP_BACKENDS[sw.op], dev))
            if sw.dtype_bytes == 2 and not {"bulk", "ring", "fused"} <= {
                    be for be, _ in want}:
                raise AssertionError(f"{sw.island}: cases {sorted(want)} "
                                     "lack one of bulk, ring, fused")
        if sw.op == "all_to_all" and not any(be == "chunked"
                                             for be, _ in want):
            raise AssertionError(f"{sw.island}: no chunked a2a case")
        have = {(r["backend"], int(r.get("n_chunks", 1)))
                for r in table.measurements if r.get("island") == sw.island
                and (r["m"], r["n"], r["k"]) == (sw.m, sw.n, sw.k)}
        if not want or have != want:
            raise AssertionError(f"{sw.island} at ({sw.m}, {sw.n}, {sw.k}):"
                                 f" rows {sorted(have)}, cases "
                                 f"{sorted(want)}")
    print(f"[autotune] all {len(sweeps)} island sweeps have every row of "
          "their case grids", flush=True)
    for r in table.measurements:
        if r.get("island"):
            print(f"[autotune] row {r['island']} {r['backend']} "
                  f"c={r.get('n_chunks', 1)} m={r['m']} n={r['n']} "
                  f"k={r['k']}: {r['us']:.1f} us", flush=True)
    back = TA.CalibrationTable.load(path)
    if back.to_json() != table.to_json():
        raise AssertionError("the table does not round-trip JSON")
    for argv in (["show", str(path)], ["diff", str(path)],
                 ["check", str(path), "--no-probe"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines()
        print(f"[autotune] `{' '.join(argv[:1] + argv[2:])}` exit {rc}: "
              f"{len(lines)} lines; " + " | ".join(lines[:3]), flush=True)
        if rc != 0:
            raise AssertionError(f"autotune {argv[0]} exited {rc}")

    # (b) phase 4's engine and trace, dispatching from the table
    TA.clear_caches()
    t0 = time.perf_counter()
    eng = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                       serve=serve_cfg, seed=0, device=dev,
                       run_overrides={"pk_attn_out_island": True,
                                      "comm_policy": "measured",
                                      "calibration_path": str(path)})
    print(f"[serve-measured] engine built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    fused_planned = False
    for name, bp in eng.bucket_plans.items():
        coords = {sw.island: sw for sw in island_comm_sweeps(
            eng.cfg, eng.base_run, eng.rules, batch=bp.batch,
            seq=(bp.seq if bp.phase == "prefill"
                 else eng.s_max), phase=bp.phase)}
        for p in bp.plans:
            if p.fallback or p.op not in GEMM_OP_KIND:
                continue
            key = TA.island_key(p.island, p.op, 2)
            sw = coords[key]
            allowed = ["bulk", "ring", "fused"]
            if p.op == "all_gather_matmul" and sw.m // 4 >= 2:
                allowed.append("ring_bidir")
            want = table.best_backend(p.op, sw.m, sw.n, sw.k,
                                      allowed=allowed, axis_size=4,
                                      dtype_bytes=sw.dtype_bytes,
                                      island=key)
            print(f"[serve-measured] {name} {p.island}: {p.backend} "
                  f"x{p.n_chunks} hidden {p.hidden_fraction:.3f} "
                  f"({p.source}); table argmin {want} at ({sw.m}, {sw.n}, "
                  f"{sw.k})", flush=True)
            if p.source != "measured" or p.backend != want:
                raise AssertionError(f"{name} {p.island}: plan {p.backend} "
                                     f"({p.source}), table argmin {want}")
            fused_planned |= p.backend == "fused"
    for tag, cal in (("analytic", None), ("seed", "seed")):
        # the same buckets under the analytic policy, and from the seed
        _print_plans(f"plans-{tag}", eng, serve_cfg, cal)
    trace = synthetic_trace(8, serve_cfg, eng.cfg.vocab_size, seed=0)
    ar = counters["pk_matmul_ar"]
    ar.launches = 0
    launches = _serve_run("serve-measured", eng, trace, dev,
                          {k: counters[k] for k in ("matmul",
                                                    "flash_attention")})
    launches["pk_matmul_ar"] = ar.launches
    print(f"[serve-measured] pk_matmul_ar launches {ar.launches}; a bucket "
          f"plan says fused: {fused_planned}", flush=True)
    if (ar.launches > 0) != fused_planned:
        raise AssertionError("B4 launches disagree with the bucket plans")
    group = [p for p in trace if serve_cfg.bucket_for(len(p))
             == serve_cfg.bucket_for(len(trace[0]))][:serve_cfg.prefill_batch]
    if not bool(torch.isfinite(eng.prefill_logits(group)).all()):
        raise AssertionError("non-finite prefill logits")
    done = {c.rid: c.tokens for c in eng.completions.values()}
    same = sum(a == b for rid, toks in done.items()
               for a, b in zip(toks, slab_tokens[rid]))
    total = sum(len(t) for t in done.values())
    print(f"[serve-measured] greedy tokens vs phase 4 (fused pinned): "
          f"{same}/{total} agree ({same / total:.3f})", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the shipped seed
    seed_path = os.path.join(os.path.dirname(TA.__file__), "calibrations",
                             "h100_sxm.json")
    seed = TA.CalibrationTable.load(seed_path)
    TA.clear_caches()
    found = TA.find_table("h100_sxm")
    resolved = found is not None and found.to_json() == seed.to_json()
    print(f"[autotune] shipped seed: {seed.fingerprint}, "
          f"{len(seed.measurements)} rows, created {seed.created}; "
          f"find_table('h100_sxm') resolves it: {resolved}", flush=True)
    if seed.fingerprint.device_kind != torch.cuda.get_device_name(0):
        raise AssertionError(f"the seed names {seed.fingerprint.device_kind!r}"
                             f", not this card")
    train_policies(dev, table)
    return {"calibrate": cal_launches, "serve": launches}


def train_policies(dev, table, steps: int = 3) -> None:
    """Phase 5u (d): phase 5's training (tinyllama-1.1b, (2, 4) with FSDP,
    8 x 512 tokens, 2 microbatches) unpinned under ``comm_policy=
    "analytic"`` and then ``"measured"`` from 5u's table, put where the
    launcher's search finds it (the user cache). Prints both runs' island
    plans (the launcher's ``[plan]`` lines) and step times, and the host
    cost of one measured dispatch decision against an analytic one. Gates:
    the search resolves the table; both runs' losses are finite."""
    import gc

    import torch

    from repro_torch.core import autotune as TA
    from repro_torch.core.comms import CommContext
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.train import build_and_train

    table.save(TA.cache_path(table.fingerprint))
    TA.clear_caches()
    if TA.find_table(table.fingerprint.hw) is None:
        raise AssertionError("the launcher's search does not find 5u's table")
    mesh = VirtualMesh((4,), ("x",), dev)
    for policy in ("analytic", "measured"):
        ctx = CommContext("x", mesh=mesh, policy=policy, island="mlp|"
                          "matmul_all_reduce|b2")
        ctx.auto_gemm_backend("matmul_all_reduce", 1024, 2048, 1408,
                              fused_ok=True)
        t0 = time.perf_counter()
        for _ in range(1000):
            ctx.auto_gemm_backend("matmul_all_reduce", 1024, 2048, 1408,
                                  fused_ok=True)
            ctx.gemm_chunk_schedule("matmul_all_reduce", 1024, 2048, 1408,
                                    backend="fused")
        print(f"[train-policy] {policy}: one backend + chunk decision "
              f"{(time.perf_counter() - t0) * 1e3:.2f} us of host time",
              flush=True)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    for policy in ("analytic", "measured"):
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            state, log = build_and_train(
                "tinyllama-1.1b", steps=steps, reduced=False,
                mesh_shape=(2, 4), mesh_axes=("data", "model"), batch=8,
                seq=512, ckpt_dir=ckpt, microbatches=2, log_every=1,
                ckpt_every=100, comm_policy=policy, device=dev)
            torch.cuda.synchronize()
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        del state
        losses = [m["loss"] for m in log]
        step_s = [m["step_time_s"] for m in log]
        print(f"[train-policy] {policy}: losses "
              f"{[round(x, 4) for x in losses]}; step wall times (host "
              f"clock) {[round(t, 4) for t in step_s]} s; median of steps "
              f"2-{steps} {statistics.median(step_s[1:]):.4f} s", flush=True)
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{policy} training losses: {losses}")
        gc.collect()
        torch.cuda.empty_cache()


#: phase 5v's scripted stall (JAX tests/test_health.py's): 50 s a step on
#: mlp's link for 4 engine steps from step 3
HEALTH_STALL = dict(kind="stall", island="mlp", step=3, ticks=4,
                    stall_dt=50.0)
#: phase 5w: where the fleet keeps its rejoin snapshot (deleted after)
FLEET_DIR = os.path.join(ROOT, "build", "fleet_ckpt")
#: phase 5w's scripted straggler: replica 1 goes dark for 4 fleet ticks
#: from fleet step 1, while its queue still holds requests
FLEET_DELAY = "delay:1@1x4"
#: phase 5x: the pipeline's microbatches, (M, batch, seq), and pipe ranks
PIPE_MB, PIPE_RANKS = (4, 2, 512), 2


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _decode_ms(eng) -> float:
    """Median decode step wall time of an engine's run, ms."""
    return 1e3 * statistics.median(
        t for k, t in zip(eng.step_kinds, eng.step_times) if k == "decode")


def _health_kinds(eng) -> list:
    return [(e[0], e[1]) for e in eng.events
            if e[0] in ("comm_fault", "comm_fault_end", "guard_trip",
                        "retry", "quarantine", "health_demote",
                        "health_promote")]


class _MlpB4:
    """Counts, engine step by engine step, the GEMM+AR kernel's (B4)
    launches at the mlp island — made by the calls whose weight has the
    MLP down-projection's k (d_ff over the tp ranks; attn_out's is d_model
    over them) — by wrapping ``CommContext.matmul_all_reduce`` while it is
    open (the kernel's own counter is the one read)."""

    def __init__(self, k_mlp: int):
        from repro_torch.core.comms import CommContext
        from repro_torch.kernels import collective_matmul as CM
        self.ctx, self.cm, self.k = CommContext, CM, k_mlp
        self.orig = CommContext.matmul_all_reduce
        self.n = 0

    def __enter__(self):
        orig, cm = self.orig, self.cm

        def counted(ctx, x, w, **kw):
            before = cm.matmul_ar_fused.launches
            out = orig(ctx, x, w, **kw)
            if w.shape[1] == self.k:
                self.n += cm.matmul_ar_fused.launches - before
            return out

        self.ctx.matmul_all_reduce = counted
        return self

    def __exit__(self, *a):
        self.ctx.matmul_all_reduce = self.orig
        return False


def serve_health(dev) -> dict:
    """Phase 5v: runtime health on phase 4's engine settings —
    tinyllama-1.1b at full width and depth on (1, 4), 8 requests of
    ``synthetic_trace(seed=0)``, one set of parameters for every run:

    (a) every GEMM+AR site on ``ring``, no fault: the reference tokens;
    (b) the same with ``island_guards``, ``max_retries=0`` and a corrupt
        mlp hop at the step of (a)'s last prefill group: that group
        quarantined (``prefill_nonfinite``), ``mlp`` among the islands that
        tripped, every other request's tokens equal to (a)'s;
    (c) as (b) with ``max_retries=1``: no quarantine, every token (a)'s.

    (b) and (c) corrupt the last group, not the first: the ring's bf16
    accumulator adds the ranks' partials in an order set by the row's
    block of the GEMM, so a request's tokens depend on its slot and its row
    in a prefill group, in JAX as here (ROADMAP C15). Quarantining the last
    group moves no other request; quarantining the first would move every
    later group to other slots.
    (d) ``fused`` pinned, ``health_monitor``, a stall on mlp's link (50 s
        a step, 4 steps from step 3): exactly one demotion (mlp -> bulk,
        ``drift``) and one promotion at least ``health_probation`` steps
        later, no B4 launch at mlp while demoted (and some before), the
        first two steps after the demotion under 5 s;
    (e) ``fused``, guards and the monitor on, no fault, on the card's own
        step times: no guard trip, no demotion.

    Prints each run's steps and health events and its median decode step
    time, with and without guards. Returns the launches over the five
    runs."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.runtime.health import CommFaultEvent, CommFaultPlan
    from repro_torch.runtime.serving import ServingEngine

    t0 = time.perf_counter()
    base = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                        serve=ServeConfig(**SERVE4), seed=0, device=dev,
                        run_overrides={"comm_backend": "ring",
                                       "pk_attn_out_island": True})
    trace = synthetic_trace(8, base.serve, base.cfg.vocab_size, seed=0)
    print(f"[serve-health] engine built in {time.perf_counter() - t0:.1f}s;"
          f" prompt lengths {[len(p) for p in trace]}", flush=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar")}
    for fn in counters.values():
        fn.launches = 0
    k_mlp = base.cfg.d_ff // base.rules.mesh.shape[base.rules.tp]

    def run(tag, backend, *, guards=False, faults=None, per_step=None,
            **serve_kw):
        eng = ServingEngine(
            base.cfg, dataclasses.replace(base.base_run,
                                          comm_backend=backend,
                                          island_guards=guards),
            base.rules, base.params, ServeConfig(**SERVE4, **serve_kw),
            comm_faults=faults, device=dev)
        _sync(dev)
        for p in trace:
            eng.submit(p)
        while eng.pending:
            if per_step is None:
                eng.step()
                continue
            with _MlpB4(k_mlp) as mlp:
                eng.step()
            per_step[eng.step_no] = mlp.n
        _sync(dev)
        st = eng.stats()
        print(f"[serve-health] ({tag}) {backend}, guards {guards}: "
              f"{st['steps']} steps ({st['prefill_steps']} prefill, "
              f"{st['decode_steps']} decode, {st['idle_steps']} idle), "
              f"{len(eng.completions)} done, quarantined "
              f"{sorted(eng.quarantined)}, retries {st['retries']}, guard "
              f"trips {st['guard_trips']}, demotions "
              f"{st['health_demotions']}; median decode step "
              f"{_decode_ms(eng):.2f} ms; events {_health_kinds(eng)}",
              flush=True)
        for c in eng.completions.values():
            if len(c.tokens) != SERVE4["max_new_tokens"]:
                raise AssertionError(f"({tag}) request {c.rid} incomplete")
        return eng, {c.rid: c.tokens for c in eng.completions.values()}

    ref_eng, ref = run("a", "ring")
    if len(ref) != len(trace):
        raise AssertionError("(a) not every request completed")
    last = max(e[1] for e in ref_eng.events if e[0] == "admit")
    group = {e[2] for e in ref_eng.events if e[0] == "admit"
             and e[1] == last}
    fault = f"corrupt:mlp@{last + 1}"      # the step of that prefill
    print(f"[serve-health] (a)'s last prefill group {sorted(group)} runs "
          f"at step {last + 1}: {fault}", flush=True)

    eng, got = run("b", "ring", guards=True, faults=fault, max_retries=0)
    tripped = {e[2] for e in eng.events if e[0] == "guard_trip"}
    if set(eng.quarantined) != group or {
            r["reason"] for r in eng.quarantined.values()} != \
            {"prefill_nonfinite"}:
        raise AssertionError(f"(b) quarantined {eng.quarantined}, the "
                             f"group is {sorted(group)}")
    if "mlp" not in tripped:
        raise AssertionError(f"(b) mlp did not trip: {sorted(tripped)}")
    if set(got) != set(ref) - group or any(got[r] != ref[r] for r in got):
        raise AssertionError("(b) the other requests' tokens differ from "
                             "(a)'s")
    guarded_ring = _decode_ms(eng)

    eng, got = run("c", "ring", guards=True, faults=fault, max_retries=1)
    if eng.quarantined or got != ref:
        raise AssertionError("(c) the retried run differs from (a)")
    print(f"[serve-health] decode step with ring: {_decode_ms(ref_eng):.2f} "
          f"ms without guards, {guarded_ring:.2f} / {_decode_ms(eng):.2f} ms "
          f"with them ((b) / (c))", flush=True)

    per_step: dict = {}
    eng, got = run("d", "fused", health_monitor=True, per_step=per_step,
                   faults=CommFaultPlan(events=(
                       CommFaultEvent(**HEALTH_STALL),)))
    demotes = [e for e in eng.health.events if e[0] == "demote"]
    promotes = [e for e in eng.health.events if e[0] == "promote"]
    print(f"[serve-health] (d) health events {eng.health.events}; B4 "
          f"launches at mlp a step {per_step}; step times "
          f"{[round(t, 4) for t in eng.step_times]}", flush=True)
    if len(demotes) != 1 or len(promotes) != 1 or \
            demotes[0][2:] != ("mlp", "bulk", "drift"):
        raise AssertionError(f"(d) wanted one mlp drift demotion and one "
                             f"promotion: {eng.health.events}")
    dstep, pstep = demotes[0][1], promotes[0][1]
    if pstep - dstep < eng.serve.health_probation:
        raise AssertionError(f"(d) promoted {pstep - dstep} steps after "
                             "the demotion, under the probation")
    if any(per_step[s] for s in range(dstep + 1, pstep + 1)) or not any(
            per_step[s] for s in range(1, dstep + 1)):
        raise AssertionError(f"(d) B4 at mlp while demoted: {per_step}")
    after = eng.step_times[dstep:dstep + 2]
    if len(after) < 2 or max(after) >= 5.0:
        raise AssertionError(f"(d) steps after the demotion took {after}")
    unguarded_fused = _decode_ms(eng)

    eng, got = run("e", "fused", guards=True, health_monitor=True)
    if eng.stats()["guard_trips"] or eng.stats()["health_demotions"] or \
            len(got) != len(trace):
        raise AssertionError(f"(e) a fault-free run tripped or demoted: "
                             f"{eng.stats()}")
    print(f"[serve-health] decode step with fused: {unguarded_fused:.2f} ms "
          f"without guards ((d), the median over its stall), "
          f"{_decode_ms(eng):.2f} ms with guards and the monitor ((e))",
          flush=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[serve-health] launches over (a)-(e) {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve-health launched no {name} kernel")
    del base, ref_eng, eng
    _empty_cache(dev)
    return launches


def _empty_cache(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def serve_fleet(dev) -> dict:
    """Phase 5w: the serving fleet — 2 replicas of phase 4's engine
    (tinyllama-1.1b at full width and depth on (1, 4), fused GEMM+AR) behind
    ``least-loaded``, 12 requests of ``synthetic_trace(seed=0)``: a run with
    no fault; ``kill:1@4 rejoin:1@8`` with the rejoin seed (replica 1's
    parameters) saved to a checkpoint under ``build/``; ``FLEET_DELAY``,
    which must steal a queued request. Gates: every request completes
    exactly once with finite logits (none quarantined); the kill run's and
    the delay run's tokens equal the no-fault run's, token for token; the
    rejoined replica's parameters equal the snapshot's bit for bit; B1, B7
    and B4 launch on every replica. Then replica 0 drains (its snapshot
    cut) and rejoins on a (2, 2) mesh through ``elastic_restore``: its
    logical parameters, assembled, equal the snapshot's bit for bit, and 4
    more requests complete there. Prints the fleet's stats, each replica's
    tokens/s and, for comparison, one engine's over the same 12 requests.
    Returns the launches over the four fleet runs."""
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import FleetConfig, ServeConfig
    from repro_torch.core import pgl
    from repro_torch.launch.serve import build_engine, synthetic_trace
    from repro_torch.models import transformer as T
    from repro_torch.runtime.fleet import FaultPlan, ServingFleet
    from repro_torch.runtime.serving import ServingEngine

    serve_cfg = ServeConfig(**SERVE4)
    over = {"comm_backend": "fused", "pk_attn_out_island": True}
    t0 = time.perf_counter()
    base = build_engine("tinyllama-1.1b", reduced=False, mesh_shape=(1, 4),
                        serve=serve_cfg, seed=0, device=dev,
                        run_overrides=over)
    trace = synthetic_trace(12, serve_cfg, base.cfg.vocab_size, seed=0)
    print(f"[serve-fleet] parameters built in "
          f"{time.perf_counter() - t0:.1f}s; prompt lengths "
          f"{[len(p) for p in trace]}", flush=True)
    counters = {k: fn for k, fn in _counters().items()
                if k in ("matmul", "flash_attention", "pk_matmul_ar")}
    total = dict.fromkeys(counters, 0)

    def attributed(eng, idx, per_rep):
        """``eng`` whose steps add their kernel launches to replica
        ``idx``'s count."""
        step = eng.step

        def counted():
            before = {k: fn.launches for k, fn in counters.items()}
            kind = step()
            got = per_rep.setdefault(idx, dict.fromkeys(counters, 0))
            for k, fn in counters.items():
                got[k] += fn.launches - before[k]
            return kind

        eng.step = counted
        return eng

    def fleet_run(tag, plan, per_rep, ckpt=None, seed_snapshot=False):
        fleet = ServingFleet(
            lambda i: attributed(ServingEngine(
                base.cfg, base.base_run, base.rules, base.params,
                serve_cfg, device=dev), i, per_rep),
            FleetConfig(n_replicas=2, router="least-loaded"),
            fault_plan=FaultPlan.parse(plan) if plan else None,
            ckpt_dir=ckpt)
        if seed_snapshot:
            # the rejoin seed, as a drain cuts it
            fleet._snapshot(fleet.replicas[1].engine)
        _sync(dev)
        done = fleet.run(trace)
        _sync(dev)
        st = fleet.stats()
        quarantined = [r for rep in fleet.replicas if rep.alive
                       for r in rep.engine.quarantined]
        print(f"[serve-fleet] ({tag}) {len(done)}/{len(trace)} done in "
              f"{st['fleet_steps']} fleet steps, {st['wall_s']:.3f}s "
              f"({st['tokens_per_s']:.1f} tok/s), {st['steals']} steals, "
              f"{st['requeued']} requeued, {st['live']}/2 live; per "
              f"replica tok/s "
              f"{[round(f.get('tokens_per_s', 0.0), 1) for f in st['per_replica'].values()]}"
              f"; events {[e[:3] for e in fleet.events if e[0] != 'complete']}"
              f"; launches by replica {per_rep}", flush=True)
        rids = sorted(c.rid for c in done)
        if rids != list(range(len(trace))) or quarantined or any(
                len(c.tokens) != serve_cfg.max_new_tokens for c in done):
            raise AssertionError(f"({tag}) not every request completed "
                                 f"exactly once: {rids}, quarantined "
                                 f"{quarantined}")
        for idx in (0, 1):
            for k, n in per_rep.get(idx, {}).items():
                total[k] += n
            if not all(per_rep.get(idx, {}).get(k, 0) > 0
                       for k in counters):
                raise AssertionError(f"({tag}) replica {idx} launched "
                                     f"{per_rep.get(idx)}")
        return fleet, {c.rid: c.tokens for c in done}

    one = ServingEngine(base.cfg, base.base_run, base.rules, base.params,
                        serve_cfg, device=dev)
    _sync(dev)
    one_done = {c.rid: c.tokens for c in one.run(trace)}
    _sync(dev)
    one_tps = one.stats()["tokens_per_s"]
    _, ref = fleet_run("no fault", None, {})
    print(f"[serve-fleet] one engine over the same 12 requests: "
          f"{one_tps:.1f} tok/s; tokens equal to the fleet's "
          f"{one_done == ref}", flush=True)
    del one
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    fleet, got = fleet_run("kill", "kill:1@4 rejoin:1@8", {},
                           ckpt=FLEET_DIR, seed_snapshot=True)
    same = sum(a == b for r in ref for a, b in zip(ref[r], got[r]))
    print(f"[serve-fleet] kill run vs no fault: {same}/"
          f"{sum(map(len, ref.values()))} tokens agree", flush=True)
    if got != ref:
        raise AssertionError("the kill run's tokens differ from the no-fault "
                             "run's")
    flat, _ = CheckpointManager(FLEET_DIR, async_save=False).load_flat()
    rejoined = fleet.replicas[1].engine
    for path, pd in T.leaves(T.param_template(rejoined.cfg,
                                              rejoined.base_run,
                                              rejoined.rules)):
        leaf = rejoined.params
        for k in path:
            leaf = leaf[k]
        if not torch.equal(leaf.cpu(), flat["/".join(path)]):
            raise AssertionError(f"the rejoined {'/'.join(path)} differs "
                                 "from the snapshot's")
    fleet, got = fleet_run("delay", FLEET_DELAY, {})
    if fleet.steals < 1 or got != ref:
        raise AssertionError(f"the delay run stole {fleet.steals} times, "
                             f"tokens equal {got == ref}")

    # a drain snapshot of replica 0 rejoins on a (2, 2) mesh
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    per_rep: dict = {}
    fleet = ServingFleet(
        lambda i: attributed(ServingEngine(
            base.cfg, base.base_run, base.rules, base.params, serve_cfg,
            device=dev), i, per_rep),
        FleetConfig(n_replicas=2, router="least-loaded"),
        ckpt_dir=FLEET_DIR)
    for p in trace[:8]:
        fleet.submit(p)
    fleet.step()
    fleet.drain(0)
    fleet.run()
    fleet.rejoin(0, factory=lambda i: attributed(build_engine(
        "tinyllama-1.1b", reduced=False, mesh_shape=(2, 2),
        serve=serve_cfg, seed=1, device=dev, run_overrides=over), i,
        per_rep))
    eng = fleet.replicas[0].engine
    tmpl = T.param_template(eng.cfg, eng.base_run, eng.rules)
    snap = T.param_template(base.cfg, base.base_run, base.rules)
    for (path, pd), (_, spd) in zip(T.leaves(tmpl), T.leaves(snap)):
        new, old = eng.params, base.params
        for k in path:
            new, old = new[k], old[k]
        new = pgl.assemble(new, pd.spec, eng.rules.mesh, eng.rules.tp,
                           lead=int(pd.periods)) \
            if new.dim() == len(pd.shape) + 1 else new
        old = pgl.assemble(old, spd.spec, base.rules.mesh, base.rules.tp,
                           lead=int(spd.periods)) \
            if old.dim() == len(spd.shape) + 1 else old
        if not torch.equal(new, old):
            raise AssertionError(f"(2, 2) rejoin: {'/'.join(path)} differs "
                                 "from the snapshot's")
    done = fleet.run(trace[8:])
    st = fleet.stats()
    print(f"[serve-fleet] (2, 2) rejoin: logical parameters bit-identical "
          f"to replica 0's snapshot; {len(done)}/4 more requests done, "
          f"assignments after the rejoin "
          f"{[a for a in fleet.assignments if a[0] >= st['fleet_steps'] - 64][-4:]}"
          f"; per replica tok/s "
          f"{[round(f.get('tokens_per_s', 0.0), 1) for f in st['per_replica'].values()]}",
          flush=True)
    if len(done) != 4 or not any(a[2] == 0 for a in fleet.assignments[-4:]):
        raise AssertionError("the (2, 2) replica served nothing after its "
                             "rejoin")
    for k in counters:
        total[k] += sum(r.get(k, 0) for r in per_rep.values())
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    print(f"[serve-fleet] launches over the four runs {total}", flush=True)
    del base, fleet, eng
    _empty_cache(dev)
    return total


def train_pipeline(dev) -> dict:
    """Phase 5x: GPipe over ``pipe = 2`` virtual ranks, the stage one
    tinyllama-1.1b decoder layer on no mesh (full width, d 2048): its 22
    layers as 22 stages, 11 virtual stages a rank, random weights from the
    seed; 4 microbatches of (2, 512) tokens' hidden states. Gates:
    ``gpipe_forward`` under the declared bulk handoff and under a ``fused``
    override (the p2p kernel, B8) bit-identical to each other and within
    1e-2 (relative Frobenius) of the 22 layers run in sequence on the
    whole batch (whether that is bit-identical too is printed); B8
    launched exactly M + n - 1 = 5 times a forward; ``gpipe_loss``'s
    gradients through the fused handoff, for every stage parameter and the
    input, within relative 2e-2 of sequential autograd. Returns the
    launches of the fused forward and the loss's forward and backward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.core.template import comm_context
    from repro_torch.models import transformer as T
    from repro_torch.train.pipeline import gpipe_forward, gpipe_loss

    cfg = get_config("tinyllama-1.1b")
    run = RunConfig(fsdp=False)
    spec = cfg.layer_pattern()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = T.init_params(T.param_template(cfg, run, None), gen,
                           cfg.d_model, device=dev)["blocks"]["pos0"]
    m, b, s = PIPE_MB
    x = (torch.randn((m, b, s, cfg.d_model), generator=gen, device=dev)
         * 0.5).to(torch.bfloat16)
    mesh = VirtualMesh((PIPE_RANKS,), ("pipe",), dev)
    fused = RunConfig(fsdp=False,
                      island_overrides=(("gpipe", "fused", None),))
    n_stages = cfg.n_layers

    def stage(bp, h):
        return T._apply_block(bp, spec, h, cfg, run, None)[0]

    def sequential(bp, h):
        h = h.reshape(m * b, s, -1)
        for i in range(n_stages):
            h = stage({g: {k: v[i] for k, v in sub.items()}
                       for g, sub in bp.items()}, h)
        return h.reshape(m, b, s, -1)

    counters = {k: fn for k, fn in _counters().items()
                if k in ("flash_attention", "p2p_ring_shift")}
    with torch.no_grad():
        bulk_out = gpipe_forward(stage, blocks, x, mesh, run=run)
        for fn in counters.values():
            fn.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        fused_out = gpipe_forward(stage, blocks, x, mesh, run=fused)
        _sync(dev)
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        fwd_launches = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        want = sequential(blocks, x)
        _sync(dev)
        seq_ms = 1e3 * (time.perf_counter() - t0)
    err = rel_err(fused_out.float(), want.float())
    print(f"[train-pipeline] {n_stages} stages on pipe={PIPE_RANKS}, "
          f"microbatches {PIPE_MB}: fused forward {fwd_ms:.1f} ms (host "
          f"clock, ends in a synchronize), sequential {seq_ms:.1f} ms; "
          f"fused == bulk bit for bit {torch.equal(fused_out, bulk_out)}; "
          f"vs sequential rel err {err:.3e}, bit-identical "
          f"{torch.equal(fused_out, want)}; forward launches "
          f"{fwd_launches}", flush=True)
    if not torch.equal(fused_out, bulk_out):
        raise AssertionError("the fused handoff differs from bulk")
    if not err <= 1e-2:
        raise AssertionError(f"the pipeline is {err:.3e} from sequential")
    if fwd_launches["p2p_ring_shift"] != m + PIPE_RANKS - 1:
        raise AssertionError(f"B8 launched {fwd_launches['p2p_ring_shift']}"
                             f" times a forward, not {m + PIPE_RANKS - 1}")
    del bulk_out, fused_out, want

    def loss_fn(o, t):
        return (o.float() ** 2).mean()

    n_loc = n_stages // PIPE_RANKS

    def rank_stages(slab, h):
        # a rank's 11 virtual stages in order, as the island's body runs
        for i in range(n_loc):
            h = stage({g: {k: v[i] for k, v in sub.items()}
                       for g, sub in slab.items()}, h)
        return h

    leaves = {g: {k: v.detach().clone().requires_grad_()
                  for k, v in sub.items()} for g, sub in blocks.items()}
    xg = x.clone().requires_grad_()
    ctx = comm_context(None, "pipe", mesh=mesh, backend="fused")
    for fn in counters.values():
        fn.launches = 0
    slabs = {g: {k: v.unflatten(0, (PIPE_RANKS, n_loc))
                 for k, v in sub.items()} for g, sub in leaves.items()}
    loss = gpipe_loss(rank_stages, loss_fn, slabs, xg, None, ctx)
    loss.backward()
    _sync(dev)
    launches = {k: fn.launches + fwd_launches[k]
                for k, fn in counters.items()}
    ref_leaves = {g: {k: v.detach().clone().requires_grad_()
                      for k, v in sub.items()} for g, sub in blocks.items()}
    xr = x.clone().requires_grad_()
    ref_loss = loss_fn(sequential(ref_leaves, xr), None)
    ref_loss.backward()
    errs = {"x": rel_err(xg.grad.float(), xr.grad.float())}
    for g, sub in leaves.items():
        for k, v in sub.items():
            if v.grad is not None:
                errs[f"{g}/{k}"] = rel_err(v.grad.float(),
                                           ref_leaves[g][k].grad.float())
    worst = max(errs, key=errs.get)
    print(f"[train-pipeline] gpipe_loss {loss.item():.6f} vs sequential "
          f"{ref_loss.item():.6f}; gradient rel errs {errs} (worst "
          f"{worst}); launches {launches}", flush=True)
    if not errs[worst] <= 2e-2:
        raise AssertionError(f"pipeline gradient {worst} is {errs[worst]:.3e}"
                             " from sequential autograd")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"train-pipeline launched no {name}")
    del blocks, leaves, ref_leaves, x, xg, xr
    _empty_cache(dev)
    return launches


# ---------------------------------------------------------------------------
# 5y-5ab: long-context decode (A8), multi-pod FSDP, the bf16 scan and the
# dry-run (A14)
# ---------------------------------------------------------------------------

def _global_params(params, cfg, run, rules):
    """A mesh's stored parameters as the no-mesh tree (each leaf assembled
    to its global weight, stored as the no-mesh template stores it)."""
    from repro_torch.core import pgl
    from repro_torch.models import transformer as T

    out: dict = {}
    flat = T.param_template(cfg, run, None)
    for path, pd in T.leaves(T.param_template(cfg, run, rules)):
        x = pgl.assemble(_leaf(params, path), pd.spec, rules.mesh,
                         T.stack_axis(pd, rules), lead=int(pd.periods))
        T.set_path(out, path, T.to_stored(x.contiguous(),
                                          _leaf(flat, path), None))
    return out


def _long_ctx_cache(cfg, run, rules, s_max, fill, dev):
    """The decode cache of ``cache_template(long_ctx=True)`` (``rules``
    given) or the no-mesh one, K/V seeded a layer at a time on the card
    (seed 100 + 2·layer for K, + 1 for V), zero from ``fill`` on, the
    position ``fill``: the same values both ways."""
    import torch

    from repro_torch.core import pgl
    from repro_torch.core.pgl import P
    from repro_torch.models import transformer as T

    tmpl = T.cache_template(cfg, run, rules, batch=1, s_max=s_max,
                            long_ctx=True)
    cache = T.zeros(tmpl, rules, dev)
    cache["pos"] = torch.tensor(fill, dtype=torch.int32, device=dev)
    pd = tmpl["blocks"]["pos0"]["k"]
    shape = pd.shape[1:]
    for li in range(cfg.n_layers):
        for j, name in enumerate(("k", "v")):
            g = torch.Generator(device=dev).manual_seed(100 + 2 * li + j)
            x = torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
            x[:, :, fill:] = 0
            dst = cache["blocks"]["pos0"][name][li]
            if rules is None:
                dst.copy_(x)
            else:
                axis = T.stack_axis(pd, rules)
                dst.copy_(pgl.layout(x, P(*pd.spec[1:]), rules.mesh,
                                     axis))
            del x
    return cache


def serve_long_ctx(dev, n_layers: int = 8, steps: int = 8) -> dict:
    """Phase 5y: long-context decode over (dp x tp) (ROADMAP A8) —
    h2o-danube-3-4b at full width (d 3840, 32/8 heads of 120, window 4096)
    cut to ``n_layers`` of its 24 layers, on (2, 4), batch 1, ``s_max``
    524,288: the cache sequence-sharded over (data, model) (8 flat ranks of
    65,536 positions), seeded K/V up to position s_max - 16, then
    ``steps`` greedy decode steps through ``make_serve_step(long_ctx=
    True)`` with GEMM+AR pinned to the fused kernel (timed; B1 once a
    step). B4 does not launch: the MLP island's m is the one token, not
    divisible by the 4 tp ranks, and the fused kernel, like JAX's ring,
    needs m % R == 0, so the pinned backend degrades to bulk there.

    The reference: the no-mesh decode of JAX and the port measures the
    window from position 0 and so attends to every cached key past it
    (ROADMAP C17), where the sharded island windows at the decoded
    position. So the same weights and cache run with the window off, on
    (2, 4) and with no mesh. Gates: each step's logits within relative
    Frobenius 3e-2 — the bound of this script's other model-level bf16
    comparisons (4b, 4d, 4f, 5p, 5q); the two paths round 8 layers of bf16
    GEMMs and the f32 mix in other orders — and the greedy tokens equal.
    Returns the windowed mesh run's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.train.step import make_serve_step

    s_max = 524288
    fill = s_max - 16
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              n_layers=n_layers)
    flat = dataclasses.replace(cfg, sliding_window=None)
    run = RunConfig(fsdp=False, decode_seq_shard=True, comm_backend="fused")
    rules = ShardingRules(make_mesh((2, 4), ("data", "model"), device=dev),
                          run)
    _empty_cache(dev)
    params = T.init_params(T.param_template(cfg, run, rules),
                           torch.Generator(device=dev).manual_seed(5),
                           cfg.d_model, rules=rules, device=dev)
    counters = _counters()
    tok0 = int(torch.randint(0, cfg.vocab_size, (1,), generator=torch
                             .Generator().manual_seed(9)))

    def decode(cfg_, params_, rules_, run_):
        cache = _long_ctx_cache(cfg_, run_, rules_, s_max, fill, dev)
        step = make_serve_step(cfg_, run_, rules_,
                               long_ctx=rules_ is not None)
        tok = torch.tensor([[tok0]], device=dev)
        logits, tokens, times = [], [], []
        with torch.no_grad():
            for _ in range(steps):
                _sync(dev)
                t0 = time.perf_counter()
                out, cache = step(params_, cache, tok)
                _sync(dev)
                times.append(time.perf_counter() - t0)
                logits.append(out.float().clone())
                tok = out[:, -1].argmax(-1, keepdim=True)
                tokens.append(int(tok))
        pos = int(cache["pos"])
        shape = tuple(cache["blocks"]["pos0"]["k"].shape)
        del cache
        _empty_cache(dev)
        if pos != fill + steps:
            raise AssertionError(f"long-context decode left pos {pos}, not "
                                 f"{fill + steps}")
        return logits, tokens, times, shape

    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    win, win_tok, times, shape = decode(cfg, params, rules, run)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    kv_gb = 2 * math.prod(shape) * 2 / 1e9
    print(f"[long-ctx] h2o-danube-3-4b full width, {n_layers} of 24 layers, "
          f"(2, 4) data x model, batch 1, s_max {s_max}, window 4096: K "
          f"leaf {shape} (8 flat ranks x 65536 positions), {kv_gb:.2f} GB "
          f"of K/V, decode from position {fill}; step wall times "
          f"{[round(t * 1e3, 2) for t in times]} ms (median "
          f"{statistics.median(times) * 1e3:.2f}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; greedy tokens "
          f"{win_tok}; max_memory_allocated {peak} B", flush=True)
    if not all(torch.isfinite(x).all() for x in win):
        raise AssertionError("long-context logits not finite")
    if launches["matmul"] != steps:
        raise AssertionError(f"long-context decode launched B1 "
                             f"{launches['matmul']} times, not {steps}")
    if launches["pk_matmul_ar"]:
        raise AssertionError(f"long-context decode launched B4 "
                             f"{launches['pk_matmul_ar']} times at m = 1")
    got, got_tok, _, _ = decode(flat, params, rules, run)
    ref_params = _global_params(params, cfg, run, rules)
    del params
    _empty_cache(dev)
    want, want_tok, ref_times, _ = decode(flat, ref_params, None,
                                          RunConfig(fsdp=False))
    del ref_params
    _empty_cache(dev)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    print(f"[long-ctx] window off, (2, 4) against no mesh (same weights "
          f"and cache): logits rel err a step {[f'{e:.2e}' for e in errs]} "
          f"(<= 3e-2); greedy tokens {got_tok} vs {want_tok}; no-mesh step "
          f"{statistics.median(ref_times) * 1e3:.2f} ms; the window moves "
          f"the first step's logits by {rel_err(win[0], got[0]):.2e}",
          flush=True)
    if max(errs) > 3e-2:
        raise AssertionError(f"long-context logits differ: {errs}")
    if got_tok != want_tok:
        raise AssertionError(f"long-context greedy tokens {got_tok} != "
                             f"{want_tok}")
    return launches


def train_multi_pod(dev, steps: int = 2) -> dict:
    """Phase 5z: FSDP over several dp axes — tinyllama-1.1b at full width
    and depth, ``make_train_step`` (AdamW) with FSDP on (2, 2, 2) over
    ("pod", "data", "model"), ``dp_axes=("pod", "data")``, every collective
    on the kernels (``comm_backend="fused"``), batch 8 x 512, ``steps``
    steps; then the same steps on (4, 2) over ("data", "model"). The
    flattened (pod, data) group holds the same ranks in the same order, so
    the gates are bit for bit: each step's loss and grad norm, and every
    parameter after the last step; B3's all-gather and reduce-scatter
    launched, as often in both runs. Returns the (2, 2, 2) run's
    launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import TrainState, make_train_step

    cfg = get_config("tinyllama-1.1b")
    counters = _counters()
    g = torch.Generator(device=dev).manual_seed(23)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (8, 512),
                                        generator=g, device=dev),
                "targets": torch.randint(0, cfg.vocab_size, (8, 512),
                                         generator=g, device=dev),
                "weights": torch.ones(8, 512, device=dev)}
               for _ in range(steps)]
    out = {}
    for shape, axes, dp_axes in (((2, 2, 2), ("pod", "data", "model"),
                                  ("pod", "data")),
                                 ((4, 2), ("data", "model"), ("data",))):
        run = RunConfig(fsdp=True, dp_axes=dp_axes, comm_backend="fused")
        rules = ShardingRules(make_mesh(shape, axes, device=dev), run)
        _empty_cache(dev)
        params = T.init_params(T.param_template(cfg, run, rules),
                               torch.Generator(device=dev).manual_seed(0),
                               cfg.d_model, rules=rules, device=dev)
        opt = AdamW()
        state = TrainState(params, opt.init(params))
        step = make_train_step(cfg, run, rules, opt)
        for fn in counters.values():
            fn.launches = 0
        metrics, times = [], []
        for b in batches:
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            metrics.append((m["loss"].detach().clone(),
                            m["grad_norm"].detach().clone()))
        launches = {k: fn.launches for k, fn in counters.items()}
        out[shape] = (metrics, [p.detach().clone()
                                for _, p in T.leaves(state.params)],
                      launches)
        print(f"[multi-pod] tinyllama-1.1b full width and depth, FSDP on "
              f"{shape} {axes}, dp axes {dp_axes}, fused, batch 8 x 512: "
              f"losses {[round(float(l), 6) for l, _ in metrics]}, grad "
              f"norms {[round(float(n), 6) for _, n in metrics]}, step "
              f"wall {[round(t, 3) for t in times]} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        del state, params, step
    (ma, pa, la), (mb, pb, lb) = out[(2, 2, 2)], out[(4, 2)]
    same = all(torch.equal(x, y) for (x, _), (y, _) in zip(ma, mb)) and \
        all(torch.equal(x, y) for (_, x), (_, y) in zip(ma, mb))
    n_same = sum(torch.equal(x, y) for x, y in zip(pa, pb))
    print(f"[multi-pod] (2, 2, 2) against (4, 2): losses and grad norms "
          f"bit-identical {same}; parameters bit-identical {n_same}/"
          f"{len(pa)} leaves", flush=True)
    if not same or n_same != len(pa):
        raise AssertionError("FSDP over (pod, data) differs from FSDP over "
                             "one data axis of the same ranks")
    for k in ("pk_all_gather", "pk_reduce_scatter"):
        if la[k] <= 0 or la[k] != lb[k]:
            raise AssertionError(f"B3 {k}: {la[k]} launches on (2, 2, 2), "
                                 f"{lb[k]} on (4, 2)")
    del out
    _empty_cache(dev)
    return la


def prefill_bf16_scan(dev, n_layers: int = 4) -> dict:
    """Phase 5aa: the bf16 scan (ROADMAP A10e) — falcon-mamba-7b at full
    width cut to ``n_layers`` of its 64 layers on (1, 4),
    ``forward_prefill`` of (2, 512) tokens with ``ssm_scan_dtype=
    "bfloat16"`` (JAX's chunked scan in plain torch) against the f32
    default (the scan kernel) on the same weights, each timed (host clock
    around a synchronized call, the second of two). Gates: logits within
    relative Frobenius 5e-2 of the f32 scan's (bf16 terms, relative step
    2^-8, through a 256-step chunk's log-depth scan and the layers), the
    scan kernel launched by the f32 forward only. Returns the f32
    forward's launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=n_layers)
    run32 = RunConfig(fsdp=False)
    rules = ShardingRules(make_mesh((1, 4), ("data", "model"), device=dev),
                          run32)
    _empty_cache(dev)
    params = T.init_params(T.param_template(cfg, run32, rules),
                           torch.Generator(device=dev).manual_seed(31),
                           cfg.d_model, rules=rules, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 512), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    counters = _counters()
    res = {}
    for name, run in (("float32", run32),
                      ("bfloat16", dataclasses.replace(
                          run32, ssm_scan_dtype="bfloat16"))):
        rules_ = ShardingRules(rules.mesh, run)
        with torch.no_grad():
            T.forward_prefill(params, {"tokens": tok}, cfg, run, rules_)
            for fn in counters.values():
                fn.launches = 0
            _sync(dev)
            t0 = time.perf_counter()
            out = T.forward_prefill(params, {"tokens": tok}, cfg, run,
                                    rules_)
            _sync(dev)
        res[name] = (out.float(), time.perf_counter() - t0,
                     {k: fn.launches for k, fn in counters.items() if
                      fn.launches})
    (l32, t32, n32), (l16, t16, n16) = res["float32"], res["bfloat16"]
    err = rel_err(l16, l32)
    print(f"[bf16-scan] falcon-mamba-7b full width, {n_layers} of 64 "
          f"layers, (1, 4), forward_prefill (2, 512): bf16 scan against "
          f"the f32 kernel scan, logits rel err {err:.3e} (<= 5e-2), "
          f"greedy last tokens equal "
          f"{bool((l16[:, -1].argmax(-1) == l32[:, -1].argmax(-1)).all())}; "
          f"forward {t32 * 1e3:.1f} ms f32 (kernel) / {t16 * 1e3:.1f} ms "
          f"bf16 (plain torch); launches f32 {n32}, bf16 {n16}",
          flush=True)
    if not math.isfinite(err) or err > 5e-2:
        raise AssertionError(f"bf16 scan logits differ by {err}")
    if n32.get("mamba_scan", 0) != n_layers or n16.get("mamba_scan", 0):
        raise AssertionError(f"scan kernel launches f32 {n32}, bf16 {n16}")
    del params
    _empty_cache(dev)
    return n32


#: the dry-run cells: every cell of three archs on 16 x 16, one on
#: 2 x 16 x 16, spread over three worker processes (the train cells
#: first); the third also counts 5ab's reduced steps on meta
DRYRUN_WORKERS = [
    [("moonshot-v1-16b-a3b", "train_4k", "single")],
    [("tinyllama-1.1b", "train_4k", "single"),
     ("tinyllama-1.1b", "prefill_32k", "multi"),
     ("moonshot-v1-16b-a3b", "prefill_32k", "single"),
     ("moonshot-v1-16b-a3b", "decode_32k", "single")],
    [("h2o-danube-3-4b", "train_4k", "single"),
     ("tinyllama-1.1b", "prefill_32k", "single"),
     ("tinyllama-1.1b", "decode_32k", "single"),
     ("h2o-danube-3-4b", "prefill_32k", "single"),
     ("h2o-danube-3-4b", "decode_32k", "single"),
     ("h2o-danube-3-4b", "long_500k", "single")],
]

#: 5ab's reduced steps, counted on meta and on the card: tinyllama-1.1b
#: at full width cut to 2 layers, a train step of 8 x 512 on (2, 4) with
#: FSDP and the fused backends and a decode step (batch 8, s_max 4096),
#: and moonshot-v1-16b-a3b at 2 layers, the same train step
DRYRUN_CHECK_CASES = [("tinyllama-1.1b", "train"),
                      ("tinyllama-1.1b", "decode"),
                      ("moonshot-v1-16b-a3b", "train")]


def _check_step(arch: str, kind: str, device):
    """One of 5ab's reduced steps on ``device``: (step, args, grad)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeCell
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch import dryrun as D
    from repro_torch.models.sharding import ShardingRules

    cell = (ShapeCell("train_4k", 512, 8, "train") if kind == "train"
            else ShapeCell("decode_32k", 4096, 8, "decode"))
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    run = RunConfig(fsdp=kind == "train", comm_backend="fused",
                    microbatches=1)
    mesh = VirtualMesh((2, 4), ("data", "model"), device=device)
    step, args, _ = D.build_step(cfg, cell, run, ShardingRules(mesh, run),
                                 mesh.device)
    return step, args, cfg, kind == "train"


def _summary(sc) -> dict:
    """A counted step as JSON: FLOPs, bytes, collective bytes and calls by
    kind a device, launches a kernel, the peak of live storages."""
    from repro_torch.roofline import hlo as HLO
    return json.loads(json.dumps({
        "flops": sc.flops, "bytes": sc.bytes,
        "collectives": HLO.collective_bytes(sc.comms, 8).by_kind,
        "launches": sc.launches, "peak_bytes": sc.peak_bytes}))


def dryrun_meta_counts(path: str) -> None:
    """5ab's reduced steps counted on ``meta`` (in a dry-run worker, whose
    meta ops run on ATen's C++ kernels as the dry-run's command line runs
    them), written to ``path`` as JSON."""
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import counters as C
    C.use_native_meta_kernels()
    rows = {}
    for arch, kind in DRYRUN_CHECK_CASES:
        step, args, _, grad = _check_step(arch, kind, "meta")
        rows[f"{arch} {kind}"] = _summary(
            D.count_step(step, args, grad=grad, device="meta"))
    with open(path, "w") as f:
        json.dump(rows, f)


def dryrun_start() -> tuple:
    """Start the dry-run's cells and 5ab's meta counts (phase 5ab) in
    worker processes on the host's cores, no card
    (``CUDA_VISIBLE_DEVICES`` empty), once every timed card phase is done:
    nothing else runs on the host meanwhile. Returns (processes, out
    dir)."""
    out = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = []
    for i, cells in enumerate(DRYRUN_WORKERS):
        calls = "; ".join(
            f"rc |= D.cli(['--arch', {a!r}, '--cell', {c!r}, '--mesh', "
            f"{m!r}, '--out', {out!r}])" for a, c, m in cells)
        if i == len(DRYRUN_WORKERS) - 1:
            calls += ("; import chip_smoke; chip_smoke.dryrun_meta_counts("
                      f"{os.path.join(out, 'check_counts.meta')!r})")
        code = ("import sys, torch; torch.set_num_threads(1); "
                "from repro_torch.launch import dryrun as D; rc = 0; "
                f"{calls}; sys.exit(rc)")
        log = open(os.path.join(out, f"worker{i}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       env=env, cwd=ROOT, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs, out


def dryrun_finish(procs, out: str, card_counts: dict,
                  timeout: float = 600.0) -> None:
    """Phase 5ab (b): wait for the dry-run workers, require every cell
    counted (``0 failed``), print each worker's lines and the report's two
    tables (``python -m repro_torch.roofline.report``), and hold the meta
    counts of 5ab's reduced steps to the card's (``dryrun_check``): FLOPs,
    bytes, collective bytes and calls by kind and launches a kernel equal
    (on meta the launches the wrappers' meta branches recorded on the
    counter, on the card the wrappers' ``.launches``), the meta peak of
    live storages within 10% of the card's ``max_memory_allocated`` over
    the step (beyond the arguments)."""
    t0 = time.perf_counter()
    try:
        for p, log in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            log.close()
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = []
    for i, (p, _) in enumerate(procs):
        with open(os.path.join(out, f"worker{i}.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith(("===", "  count", "  FAILED", "dry-run")):
                print(f"[dryrun] {line.strip()}", flush=True)
        if p.returncode != 0:
            bad.append(i)
            print(text[-4000:], flush=True)
    n_files = len([f for f in os.listdir(out) if f.endswith(".json")])
    n_cells = sum(len(c) for c in DRYRUN_WORKERS)
    print(f"[dryrun] {n_files} of {n_cells} cells counted on meta in "
          f"{time.perf_counter() - t0:.1f} s after the timed card phases",
          flush=True)
    if bad or n_files != n_cells:
        raise AssertionError(f"dry-run workers {bad} failed")
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", "--dir", out],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    print(rep.stdout, flush=True)
    with open(os.path.join(out, "check_counts.meta")) as f:
        meta_counts = json.load(f)
    for tag, c in card_counts.items():
        m = meta_counts[tag]
        print(f"[dryrun-check] {tag} 2 layers on (2, 4): FLOPs meta "
              f"{m['flops']} card {c['flops']}; bytes meta {m['bytes']} card "
              f"{c['bytes']}; collective bytes/device and calls by kind meta "
              f"{m['collectives']} card {c['collectives']}; launches meta "
              f"(counter) {m['launches']} card (.launches) {c['launches']}; "
              f"peak of live storages meta {m['peak_bytes']} B, card "
              f"max_memory_allocated over the step {c['card_peak']} B "
              f"(meta/card {m['peak_bytes'] / max(c['card_peak'], 1):.3f})",
              flush=True)
        for key in ("flops", "bytes", "collectives", "launches"):
            if m[key] != c[key]:
                raise AssertionError(f"{tag}: meta and card {key} differ")
        if abs(m["peak_bytes"] - c["card_peak"]) > 0.1 * c["card_peak"]:
            raise AssertionError(f"{tag}: meta peak {m['peak_bytes']} not "
                                 f"within 10% of {c['card_peak']}")


def _fill(tree, vocab: int, gen) -> None:
    """Values for a tree the specs laid out on the card: float leaves
    ~ N(0, 0.02²), integer leaves (tokens) uniform over the vocabulary."""
    import torch
    if isinstance(tree, dict):
        for v in tree.values():
            _fill(v, vocab, gen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _fill(v, vocab, gen)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        if tree.is_floating_point():
            tree.normal_(0.0, 0.02, generator=gen)
        else:
            tree.random_(0, vocab, generator=gen)


def dryrun_check(dev) -> tuple:
    """Phase 5ab (a): 5ab's reduced steps (``DRYRUN_CHECK_CASES``) on the
    card, each after one warm-up call, with its kernels launched under a
    ``StepCounter``: their counts, held to the meta counts after the timed
    phases (``dryrun_finish``), and ``max_memory_allocated`` over the step
    beyond the arguments. Prints the card's step time (CUDA events) beside
    the H100_SXM roofline bound of the step's whole count (every rank runs
    on the one card): not a gate. Returns (the card runs' launches by
    chip_smoke's names, the card counts by case)."""
    import torch

    from repro_torch.core.costmodel import H100_SXM
    from repro_torch.launch import dryrun as D

    total, counts = {}, {}
    card = card_line()
    for arch, kind in DRYRUN_CHECK_CASES:
        step, args, cfg, grad = _check_step(arch, kind, dev)
        _fill(args, cfg.vocab_size,
              torch.Generator(device=dev).manual_seed(41))
        with torch.set_grad_enabled(grad):
            step(*args)                              # warm-up, not counted
        # the warm-up's garbage freed now, not inside the step
        gc.collect()
        _sync(dev)
        _empty_cache(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sc = D.count_step(step, args, grad=grad, device="cuda")
        ev[1].record()
        _sync(dev)
        seconds = ev[0].elapsed_time(ev[1]) / 1e3
        tag = f"{arch} {kind}"
        counts[tag] = dict(
            _summary(sc),
            card_peak=torch.cuda.max_memory_allocated(dev) - base)
        bound = max(sc.flops / H100_SXM.peak_flops_bf16,
                    sc.bytes / H100_SXM.hbm_bandwidth)
        print(f"[dryrun-check] {tag} 2 layers on (2, 4), card: step "
              f"{seconds * 1e3:.2f} ms (CUDA events) against the roofline "
              f"bound {bound * 1e3:.3f} ms (modelled: H100_SXM 989 TFLOP/s "
              f"bf16, 3.35 TB/s) on {card}; launches {sc.launches}",
              flush=True)
        for k, fn in _counters().items():       # chip_smoke's names
            total[k] = total.get(k, 0) + sc.launches.get(fn.__name__, 0)
        del step, args, sc
        _empty_cache(dev)
    return total, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s",
          flush=True)
    procs = []
    try:
        return _phases(dev, card, procs)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _phases(dev, card: str, procs: list) -> int:
    import torch
    entries = check_kernels(dev)
    check_backward(dev)
    serve_launches, slab_tokens = serve(dev)
    check_reference(dev)
    moe_launches = serve_moe(dev)
    ssm_launches = serve_ssm(dev)
    train_launches = train(dev)
    check_train_reference(dev)
    sp = sp_setup(dev)
    sp_launches, ring_loss = train_sp(dev, sp)
    ulysses_launches = train_ulysses(dev, sp, ring_loss)
    del sp
    check_sp_reference(dev)
    moe_a2a_launches = moe_a2a(dev)
    encdec_serve_launches = serve_encdec(dev)
    encdec_train_launches = train_encdec(dev)
    check_encdec_reference(dev)
    moe_train_launches = train_moe(dev)
    ssm_train_launches = train_ssm(dev)
    hybrid_train_launches = train_hybrid(dev)
    check_family_reference(dev)
    tp_launches = tp_gemm(dev)
    paged_launches = serve_paged(dev, slab_tokens)
    paged_cut_launches = serve_paged_cut(dev)
    int8_launches = serve_int8(dev, slab_tokens)
    wire_launches = tp_gemm_int8(dev)
    compressed_launches = train_compressed(dev, train_launches, 4)
    tp_data_launches = serve_moe_tp_data(dev)
    autotune_launches = autotune_serve(dev, slab_tokens)
    health_launches = serve_health(dev)
    fleet_launches = serve_fleet(dev)
    pipeline_launches = train_pipeline(dev)
    long_ctx_launches = serve_long_ctx(dev)
    multi_pod_launches = train_multi_pod(dev)
    bf16_scan_launches = prefill_bf16_scan(dev)
    check_launches, card_counts = dryrun_check(dev)
    # the last timed phase is done: the dry-run's workers have the host
    workers, dry_out = dryrun_start()
    procs.extend(workers)
    dryrun_finish(procs, dry_out, card_counts)
    main_entries = []
    for key in KERNEL_COUNTERS + ("pk_matmul_ar@decode",
                                  "pk_all_gather@path",
                                  "flash_attention@encoder",
                                  "flash_attention@cross"):
        counter = key.split("@")[0]
        by_path = {"serve": serve_launches.get(counter, 0),
                   "serve_moe": moe_launches.get(counter, 0),
                   "serve_ssm": ssm_launches.get(counter, 0),
                   "train": train_launches.get(counter, 0),
                   "train_sp": sp_launches.get(counter, 0),
                   "train_ulysses": ulysses_launches.get(counter, 0),
                   "moe_a2a": moe_a2a_launches.get(counter, 0),
                   "tp_gemm": tp_launches.get(counter, 0),
                   "serve_encdec": encdec_serve_launches.get(counter, 0),
                   "train_encdec": encdec_train_launches.get(counter, 0),
                   "train_moe": moe_train_launches.get(counter, 0),
                   "train_ssm": ssm_train_launches.get(counter, 0),
                   "train_hybrid": hybrid_train_launches.get(counter, 0),
                   "serve_paged": paged_launches.get(counter, 0),
                   "serve_paged_dp": paged_cut_launches["dp"].get(counter,
                                                                  0),
                   "serve_head_sharded": paged_cut_launches[
                       "head_sharded"].get(counter, 0),
                   "serve_int8": int8_launches["serve-int8"].get(counter, 0),
                   "serve_int8_paged": int8_launches[
                       "serve-int8-paged"].get(counter, 0),
                   "serve_wire_int8": wire_launches.get(counter, 0),
                   "train_compressed": compressed_launches.get(counter, 0),
                   "serve_moe_tp_data": tp_data_launches.get(counter, 0),
                   "autotune_calibrate": autotune_launches[
                       "calibrate"].get(counter, 0),
                   "serve_measured": autotune_launches["serve"].get(counter,
                                                                   0),
                   "serve_health": health_launches.get(counter, 0),
                   "serve_fleet": fleet_launches.get(counter, 0),
                   "train_pipeline": pipeline_launches.get(counter, 0),
                   "serve_long_ctx": long_ctx_launches.get(counter, 0),
                   "train_multi_pod": multi_pod_launches.get(counter, 0),
                   "prefill_bf16_scan": bf16_scan_launches.get(counter, 0),
                   "dryrun_check": check_launches.get(counter, 0)}
        main_path = {"grouped_matmul": "serve_moe",
                     "mamba_scan": "serve_ssm",
                     "p2p_ring_shift": "train_sp",
                     "flash_attention_hop": "train_sp",
                     "ag_matmul_fused": "tp_gemm",
                     "matmul_rs_fused": "tp_gemm",
                     "lcsc_ring_all_gather": "tp_gemm",
                     "pk_all_to_all": "train_ulysses",
                     "flash_attention@encoder": "serve_encdec",
                     "flash_attention@cross": "train_encdec",
                     "mamba_scan_bwd": "train_ssm"}.get(
            key, "serve" if counter in serve_launches else "train")
        entry = dict(entries[key], launches=by_path[main_path],
                     launches_by_path=by_path)
        if key != counter:              # a row sharing another's counter
            entry["launches_counter"] = counter
        main_entries.append(entry)
    for key in ("matmul@rank", "matmul@loss", "matmul@mlp",
                "matmul@moonshot", "matmul@whisper",
                "flash_attention@moonshot", "grouped_matmul@prefill",
                "matmul@falcon", "mamba_scan@prefill",
                "mamba_scan@prefill-b1",
                "pk_reduce_scatter@r4", "pk_reduce_scatter@r8",
                "lcsc_ring_all_gather@r4", "lcsc_ring_all_gather@r8",
                "flash_attention_hop@0", "flash_attention_hop@2",
                "flash_attention_hop@3", "pk_all_to_all@out",
                "pk_all_to_all@moe", "mamba_scan_bwd@dp-half",
                "mamba_scan_bwd@prefill"):
        print(f"[kernel-extra] {json.dumps(entries[key])}", flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"kernels": main_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
