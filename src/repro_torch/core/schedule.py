"""Overlap schedule selection (paper §3.1.3 "SM partitioning", TPU form).

On GPUs the knob is how many SMs to dedicate to communication; on TPU the ICI
DMA engines are free, so the knobs become (a) whether to decompose a bulk
collective into a ring pipeline at all, (b) the chunk count, and (c) whether
to use the bidirectional ring (2 link-pairs). This module picks them from the
paper's cost model — the analytic analogue of PK's runtime SM-split search.

Two levels of granularity:

* ``choose_gemm_collective`` — ring vs bulk vs bidirectional ring, the
  step-level decision (one GEMM + one shift per ring step);
* ``choose_gemm_chunks`` — the chunk-pipeline refinement: how many
  double-buffered sub-chunks each ring step is split into, so step *i*'s
  shift overlaps step *i−1*'s GEMM at sub-shard granularity (Syncopate's
  chunk-centric scheduling, arXiv 2601.20595). The count is the argmin of
  ``costmodel.chunk_pipeline_cost`` — priced on measured link/GEMM constants
  when the spec is calibrated.

Chunked schedules never *reject* shapes: ``fit_chunks`` degrades a requested
count to the largest divisor the chunked sub-shape supports, so divisibility
is validated against the sub-shape, not the full shard.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import costmodel as cm

#: cost-model kind -> the dimension the chunk pipeline slices. AG+GEMM moves
#: the (m, k) input around the ring, so its chunks cut the travelling shard's
#: rows; RS/AR move the (m, n) output block, whose rows are likewise the
#: payload dim. "n" (slicing the GEMM's output columns / w's columns) is the
#: explicit-override alternative for shapes whose m extent will not split.
GEMM_CHUNK_DIM = {"all_gather": "m", "reduce_scatter": "m", "all_reduce": "m"}

#: candidate sub-chunk counts the scheduler searches (per ring step).
CHUNK_CANDIDATES = (1, 2, 4, 8)


def fit_chunks(extent: int, n_chunks: int) -> int:
    """Largest divisor of ``extent`` that is <= ``n_chunks`` (always >= 1).

    The non-divisible fallback for every chunked schedule: a chunk count that
    does not divide the chunked sub-shape degrades to the nearest one that
    does instead of raising — chunking is an optimization, never a new shape
    constraint.
    """
    if extent <= 0:
        return 1
    c = max(1, min(n_chunks, extent))
    while extent % c:
        c -= 1
    return c


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """The chunk-pipeline decision for one GEMM×collective call."""

    n_chunks: int            # sub-chunks per ring step (1 = classic ring)
    chunk_dim: str           # "m" | "n" — which GEMM dim the chunks slice
    reason: str
    source: str = "analytic"   # "analytic" | "measured" | "explicit"


@dataclasses.dataclass(frozen=True)
class OverlapPolicy:
    strategy: str            # "none" | "ring" | "ring_bidir"
    n_chunks: int
    hidden_fraction: float   # predicted fraction of T_comm hidden
    reason: str

    @property
    def enabled(self) -> bool:
        return self.strategy != "none"


def choose_gemm_collective(m: int, n: int, k: int, *, axis_size: int,
                           kind: str, dtype_bytes: int = 2,
                           hw: cm.HardwareSpec = cm.TPU_V5E,
                           allow_bidir: bool = True,
                           wire_bytes: float | None = None) -> OverlapPolicy:
    """Pick the schedule for a fused GEMM×collective.

    The paper's hiding condition (§3.1.3): per-ring-step compute must cover the
    per-step transfer. For GEMM+RS with N steps, step compute = 2*m*n*k/N
    flops, step transfer = (m/N)*n*s bytes -> hidden iff K >= s*R/(2*B*links).

    A quantized wire (``wire_bytes``) shrinks s: the transfer side of the
    hiding condition is priced at the on-wire element width (scales
    included) while compute stays at the tensor's own dtype — so shapes
    whose bf16 ring was only partially hidden can become fully hidden at
    half the wire bytes.
    """
    if axis_size <= 1:
        return OverlapPolicy("none", 1, 1.0, "single device on axis")
    links = 2 if (allow_bidir and axis_size % 2 == 0) else 1
    k_eff = k * axis_size if kind == "all_gather" else k
    elem_bytes = float(dtype_bytes) if wire_bytes is None else float(wire_bytes)
    threshold = cm.hiding_threshold_k(max(int(math.ceil(elem_bytes)), 1),
                                      hw, links=links)
    t_comp = cm.gemm_cost(m, n, k_eff, dtype_bytes, hw)
    shard_bytes = m * n * elem_bytes / axis_size
    t_comm = cm.transfer_cost(
        cm.ring_collective_bytes(shard_bytes, axis_size, kind), hw, links=links)
    if wire_bytes is not None:
        t_comm += 2.0 * cm.quantize_cost(
            cm.ring_collective_bytes(shard_bytes / elem_bytes, axis_size,
                                     kind),
            hw, src_bytes=dtype_bytes, wire_bytes=elem_bytes)
    if t_comm == 0.0:
        return OverlapPolicy("none", 1, 1.0, "no transfer")
    hidden = min(1.0, t_comp / t_comm)
    if t_comp < 20 * hw.remote_sync_s * axis_size:
        # Sync overhead of the decomposed schedule would dominate the GEMM —
        # the paper's "small problem sizes" regime where Flux/CUTLASS fall
        # below the non-overlapped baseline (Fig. 7). Stay bulk.
        return OverlapPolicy("none", 1, 0.0,
                             f"GEMM too small vs sync cost (t_comp={t_comp:.2e}s)")
    strategy = "ring_bidir" if links == 2 else "ring"
    reason = (f"K_eff={k_eff} vs hiding threshold {threshold} "
              f"({'fully' if k_eff >= threshold else 'partially'} hidden; "
              f"hidden_frac={hidden:.2f})")
    return OverlapPolicy(strategy, axis_size, hidden, reason)


def choose_gemm_chunks(m: int, n: int, k: int, *, axis_size: int, kind: str,
                       dtype_bytes: int = 2,
                       hw: cm.HardwareSpec = cm.TPU_V5E,
                       candidates=CHUNK_CANDIDATES,
                       wire_bytes: float | None = None,
                       fused: bool = False) -> ChunkSchedule:
    """Sub-chunk count + chunk dimension for a chunk-pipelined ring.

    Argmin of ``costmodel.chunk_pipeline_cost`` over ``candidates``: more
    chunks shrink the pipeline fill (the first chunk's exposed transfer) but
    pay per-chunk launch + sync overhead — on a calibrated spec both sides
    are priced on *measured* constants, so a mesh with expensive hops (the
    CPU-emulated one) resolves to 1 chunk while a real ICI mesh with cheap
    sync resolves to more. Call sites degrade the count to the chunked
    sub-shape's largest divisor via ``fit_chunks``.

    ``fused=True`` prices the single-kernel Pallas pipeline with
    ``costmodel.fused_pipeline_cost`` instead: one launch, VMEM-resident
    operands, local-sync chunk handoffs. Its argmin usually sits at a finer
    chunk count than the jax-level ring for the same shape, which is the
    point of the fused path. Fused kernels ship full precision, so
    ``wire_bytes`` is ignored there.
    """
    dim = GEMM_CHUNK_DIM[kind]
    if axis_size <= 1:
        return ChunkSchedule(1, dim, "single device on axis")
    best, best_t = 1, float("inf")
    for c in candidates:
        if fused:
            t = cm.fused_pipeline_cost(m, n, k, axis_size=axis_size,
                                       sub_chunks=c, dtype_bytes=dtype_bytes,
                                       kind=kind, hw=hw).total
        else:
            t = cm.chunk_pipeline_cost(m, n, k, axis_size=axis_size,
                                       sub_chunks=c, dtype_bytes=dtype_bytes,
                                       kind=kind, hw=hw,
                                       wire_bytes=wire_bytes).total
        if t < best_t:
            best, best_t = c, t
    model = "fused_pipeline_cost" if fused else "chunk_pipeline_cost"
    return ChunkSchedule(
        best, dim,
        f"argmin of {model} over {tuple(candidates)} "
        f"-> {best} (t={best_t:.2e}s)")


def a2a_chunk_axis(shape, split_axis: int, concat_axis: int,
                   n_chunks: int) -> tuple[int, int] | None:
    """(axis, fitted chunk count) for a chunked all-to-all, or None.

    Chunks are cut along a bystander dim (neither split nor concat) so the
    chunked op stays bit-identical to bulk. The requested count is validated
    against the *chunked sub-shape*: a dim that `n_chunks` does not divide
    degrades to its largest feasible divisor instead of rejecting the config
    (the old behavior — requiring the full dim to divide exactly — bulked
    legal chunked configs). Returns None only when no bystander dim can be
    split at all.
    """
    best: tuple[int, int] | None = None
    for d, extent in enumerate(shape):
        if d in (split_axis, concat_axis) or extent <= 1:
            continue
        c = fit_chunks(extent, n_chunks)
        if c > 1 and (best is None or c > best[1]):
            best = (d, c)
    return best


def choose_a2a_chunks(payload_bytes: float, *, axis_size: int,
                      downstream_compute_s: float,
                      hw: cm.HardwareSpec = cm.TPU_V5E,
                      shape=None, split_axis: int | None = None,
                      concat_axis: int | None = None) -> int:
    """Chunk count for a2a×compute overlap (Ulysses / MoE dispatch). More
    chunks -> finer overlap but more per-chunk launch+sync overhead; choose
    the largest count whose per-chunk overhead stays <10% of chunk time.

    When ``shape`` (with ``split_axis``/``concat_axis``) is given, the chosen
    count is additionally fitted to what the payload's bystander dims can
    actually split into — validation against the chunked sub-shape, so the
    policy never reports a chunking the op would have to bulk away.
    """
    t_comm = cm.transfer_cost(
        cm.ring_collective_bytes(payload_bytes, axis_size, "all_to_all"), hw)
    if t_comm <= 0:
        return 1
    best = 1
    for c in (2, 4, 8):
        per_chunk = max(t_comm, downstream_compute_s) / c
        if per_chunk > 10 * (hw.kernel_launch_s + hw.remote_sync_s):
            best = c
    if best > 1 and shape is not None:
        fit = a2a_chunk_axis(shape, split_axis, concat_axis, best)
        best = fit[1] if fit is not None else 1
    return best
