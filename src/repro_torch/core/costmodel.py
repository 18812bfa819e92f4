"""ParallelKittens cost model (paper §3.1.1), adapted to TPU v5e.

    T_kernel = T_launch + max(T_comp, T_mem, T_comm) + T_non_overlap + T_sync

Each T is derived from work sizes and achievable bandwidths. The model drives
two things in this framework:

  * the overlap *schedule* search (``core/schedule.py``) — e.g. the paper's
    communication-hiding condition ``K >= s*R/(2*B)`` (paper §3.1.3), re-derived
    for ICI bandwidth;
  * the roofline report (``roofline/model.py``) — the same three terms computed
    from the *compiled* HLO instead of analytically.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip hardware constants."""

    name: str
    peak_flops_bf16: float      # FLOP/s
    hbm_bandwidth: float        # bytes/s
    ici_bandwidth: float        # bytes/s per link direction
    ici_links: int              # usable ICI links per chip (2-D torus: 4)
    hbm_bytes: float            # HBM capacity in bytes
    vmem_bytes: float           # VMEM per core
    # Empirical-ish overheads (used for T_launch / T_sync terms).
    kernel_launch_s: float = 2e-6
    local_sync_s: float = 64e-9       # paper: intra-SM mbarrier ~64 ns
    remote_sync_s: float = 1.5e-6     # cross-chip semaphore signal visibility
    # Fraction of peak the MXU sustains on a dense GEMM. The analytic default
    # is the paper's ~90%; ``repro.core.autotune`` replaces it (and
    # ici_bandwidth / remote_sync_s) with measured values via ``calibrated``.
    gemm_efficiency: float = 0.9

    def calibrated(self, **overrides: float) -> "HardwareSpec":
        """A copy of this spec with measured correction factors applied.

        ``repro.core.autotune.CalibrationTable.spec`` calls this with the
        fitted ``ici_bandwidth`` / ``remote_sync_s`` / ``gemm_efficiency``
        (and optionally ``kernel_launch_s``) so the §3.1.1 cost model runs
        on achieved rather than datasheet numbers. Unknown field names are
        rejected by ``dataclasses.replace``.
        """
        return dataclasses.replace(self, **overrides)


# Grading constants given by the assignment: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_bandwidth=50e9,
    ici_links=4,
    hbm_bytes=16e9,
    vmem_bytes=64 * 2**20 // 4,  # 16 MiB usable working budget per core
)

# The paper's running example, kept for validating the analysis against the
# paper's own numbers (Table 3: hiding threshold K ~ 2197 on H100).
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=450e9,   # NVLink unidirectional
    ici_links=1,
    hbm_bytes=80e9,
    vmem_bytes=227 * 2**10,
)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The paper's decomposition for one kernel invocation (seconds)."""

    t_launch: float
    t_comp: float
    t_mem: float
    t_comm: float
    t_non_overlap: float
    t_sync: float

    @property
    def total(self) -> float:
        return (self.t_launch + max(self.t_comp, self.t_mem, self.t_comm)
                + self.t_non_overlap + self.t_sync)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_comm}
        return max(terms, key=terms.get)


def gemm_cost(m: int, n: int, k: int, dtype_bytes: int,
              hw: HardwareSpec = TPU_V5E, *,
              efficiency: float | None = None) -> float:
    """Seconds for a local GEMM at `efficiency` of peak.

    ``efficiency=None`` (the default) reads ``hw.gemm_efficiency``, so a
    calibrated spec automatically prices GEMMs at the *achieved* rate.
    """
    if efficiency is None:
        efficiency = hw.gemm_efficiency
    flops = 2.0 * m * n * k
    return flops / (hw.peak_flops_bf16 * efficiency)


def transfer_cost(nbytes: float, hw: HardwareSpec = TPU_V5E,
                  *, links: int = 1) -> float:
    """Seconds to move nbytes over `links` ICI link-directions."""
    return nbytes / (hw.ici_bandwidth * links)


def hiding_threshold_k(dtype_bytes: int, hw: HardwareSpec = TPU_V5E,
                       *, links: int = 1) -> int:
    """Paper §3.1.3: GEMM+RS communication is fully hidden when

        T_comp_tile >= T_comm_tile  <=>  K >= s*R / (2*B)

    For BF16 on H100 (s=2, R=989e12, B=450e9) the paper derives K >= 2197;
    on v5e with one ring link-pair this gives K >= 3940.
    """
    return math.ceil(dtype_bytes * hw.peak_flops_bf16
                     / (2.0 * hw.ici_bandwidth * links))


def ring_collective_bytes(shard_bytes: float, n_devices: int,
                          kind: str) -> float:
    """Per-device ICI traffic for ring collectives over an axis of size N.

    `shard_bytes` is the size of ONE shard (the unit each device owns).
    """
    if n_devices <= 1:
        return 0.0
    if kind in ("all_gather", "reduce_scatter"):
        return shard_bytes * (n_devices - 1)
    if kind == "all_reduce":  # RS + AG
        return 2.0 * shard_bytes * (n_devices - 1)
    if kind == "all_to_all":
        return shard_bytes * (n_devices - 1) / n_devices
    if kind == "ppermute":
        return shard_bytes
    raise ValueError(f"unknown collective kind: {kind}")


def collective_tensor_bytes(m: int, n: int, k: int, dtype_bytes: int,
                            kind: str) -> float:
    """Size of the tensor a GEMM×collective actually moves: AG+GEMM gathers
    the (m, k) *input*; RS/AR reduce the (m, n) *output*. Pricing AG on the
    output would be off by n/k whenever the projection changes width."""
    return (m * k if kind == "all_gather" else m * n) * dtype_bytes


#: pre-rename alias (the benchmarks/plan code used the private name)
_collective_tensor_bytes = collective_tensor_bytes


def quantize_cost(n_elems: float, hw: HardwareSpec = TPU_V5E, *,
                  src_bytes: float = 2.0, wire_bytes: float = 1.0) -> float:
    """Seconds for one quantize (or dequantize) pass over ``n_elems``.

    The quantize kernel is HBM-bound: it streams the full-precision operand
    in and the packed payload + scales out (symmetrically for dequantize),
    so its cost is the round-trip bytes over HBM bandwidth plus a launch.
    This is the extra term a quantized wire adds to the ring schedule —
    ``t_comm`` shrinks by ``src_bytes / wire_bytes`` but every moved element
    pays this pass on both ends of the hop.
    """
    return (hw.kernel_launch_s
            + n_elems * (src_bytes + wire_bytes) / hw.hbm_bandwidth)


def bulk_gemm_collective_cost(
    m: int, n: int, k: int, *, axis_size: int, dtype_bytes: int = 2,
    kind: str = "reduce_scatter", hw: HardwareSpec = TPU_V5E,
) -> KernelCost:
    """Analytic cost of the NON-overlapped baseline (GEMM, then collective).

    Nothing hides: the collective's transfer time is booked as
    ``t_non_overlap`` so ``KernelCost.total`` adds it serially after the
    GEMM. This is what the benchmark harness predicts for ``backend="bulk"``
    rows; the gap to ``overlapped_gemm_collective_cost`` is the predicted
    win the measured rows are checked against.
    """
    t_comp = gemm_cost(m, n, k, dtype_bytes, hw)
    out_bytes = m * n * dtype_bytes
    comm_bytes = ring_collective_bytes(
        _collective_tensor_bytes(m, n, k, dtype_bytes, kind)
        / max(axis_size, 1), axis_size, kind)
    t_comm = transfer_cost(comm_bytes, hw)
    t_mem = ((m * k + k * n) * dtype_bytes + out_bytes) / hw.hbm_bandwidth
    return KernelCost(t_launch=2.0 * hw.kernel_launch_s, t_comp=t_comp,
                      t_mem=t_mem, t_comm=0.0, t_non_overlap=t_comm,
                      t_sync=hw.remote_sync_s * max(axis_size - 1, 0))


def overlapped_gemm_collective_cost(
    m: int, n: int, k: int, *, axis_size: int, dtype_bytes: int = 2,
    kind: str = "reduce_scatter", n_chunks: int = 1,
    hw: HardwareSpec = TPU_V5E, wire_bytes: float | None = None,
) -> KernelCost:
    """Analytic cost of a chunked overlapped GEMM×collective (PK schedule).

    Models the decomposed ring schedule: the collective for chunk i+1 runs on
    the ICI DMA engines while chunk i's GEMM runs on the MXU. With C chunks the
    non-overlapped residue is one chunk's transfer (pipeline fill).

    ``wire_bytes`` prices a quantized wire: the ring payload travels at that
    (possibly fractional — scales included) element width instead of
    ``dtype_bytes``, and every moved element pays ``quantize_cost`` on both
    ends of the hop, booked under ``t_non_overlap`` (the quantize kernel
    runs on the VPU/HBM path serially with the chunk handoff, not under the
    GEMM). The compute and HBM terms stay at the tensor's own width.
    """
    t_comp = gemm_cost(m, n, k, dtype_bytes, hw)
    out_bytes = m * n * dtype_bytes
    elem_bytes = float(dtype_bytes) if wire_bytes is None else float(wire_bytes)
    moved_elems = (_collective_tensor_bytes(m, n, k, 1, kind)
                   / max(axis_size, 1))
    comm_bytes = ring_collective_bytes(moved_elems * elem_bytes,
                                       axis_size, kind)
    t_comm = transfer_cost(comm_bytes, hw)
    # HBM traffic: read A, B once; write C once (chunking re-reads one operand).
    t_mem = ((m * k + k * n) * dtype_bytes * max(1, n_chunks // 4 + 1)
             + out_bytes) / hw.hbm_bandwidth
    fill = t_comm / max(n_chunks, 1)
    if wire_bytes is not None:
        # quantize on send + dequantize on receive for every element moved
        n_hop_elems = ring_collective_bytes(moved_elems, axis_size, kind)
        fill += 2.0 * quantize_cost(n_hop_elems, hw, src_bytes=dtype_bytes,
                                    wire_bytes=elem_bytes)
    t_sync = 2.0 * n_chunks * hw.remote_sync_s * max(axis_size - 1, 0)
    return KernelCost(t_launch=hw.kernel_launch_s, t_comp=t_comp, t_mem=t_mem,
                      t_comm=t_comm, t_non_overlap=fill, t_sync=t_sync)


def fused_pipeline_cost(
    m: int, n: int, k: int, *, axis_size: int, sub_chunks: int,
    dtype_bytes: int = 2, kind: str = "reduce_scatter",
    hw: HardwareSpec = TPU_V5E,
) -> KernelCost:
    """Cost of the chunk-pipelined *fused* single-kernel schedule.

    Same pipeline geometry as ``chunk_pipeline_cost`` — every ring hop is
    split into ``sub_chunks`` double-buffered payloads whose DMA is issued
    ahead of the chunk GEMM — but priced for the in-kernel regime the fused
    Pallas path runs in:

      * one kernel launch total (the jax-level ring re-enters the runtime
        per chunked step, so its launch term hides inside XLA's schedule;
        the fused kernel pays exactly one ``t_launch``);
      * operands are VMEM-resident for the kernel's lifetime, so chunking
        never re-reads an operand from HBM — ``t_mem`` is a single pass
        regardless of chunk count;
      * per-chunk synchronization is a scalar-core DMA-descriptor issue plus
        a local semaphore wait (``local_sync_s``), not a cross-chip
        launch-visible handoff: only the first chunk of each hop pays
        ``remote_sync_s`` (the one-way cap-sem ack), the rest ride the
        already-open channel.

    The last point is the paper's thesis in cost-model form: the fused path
    tolerates much finer chunking than the jax-level rings, so its argmin
    sits at a higher chunk count for the same shape. Fused kernels ship
    full-precision payloads, so there is no ``wire_bytes`` axis here.
    """
    total = max(axis_size, 1) * max(sub_chunks, 1)
    t_comp = gemm_cost(m, n, k, dtype_bytes, hw)
    out_bytes = m * n * dtype_bytes
    comm_bytes = ring_collective_bytes(
        _collective_tensor_bytes(m, n, k, dtype_bytes, kind)
        / max(axis_size, 1), axis_size, kind)
    t_comm = transfer_cost(comm_bytes, hw)
    t_mem = ((m * k + k * n) * dtype_bytes + out_bytes) / hw.hbm_bandwidth
    fill = t_comm / max(total, 1)
    hops = max(axis_size - 1, 0) * (2 if kind == "all_reduce" else 1)
    t_sync = hops * (hw.remote_sync_s
                     + max(sub_chunks, 1) * hw.local_sync_s)
    return KernelCost(t_launch=hw.kernel_launch_s, t_comp=t_comp, t_mem=t_mem,
                      t_comm=t_comm, t_non_overlap=fill, t_sync=t_sync)


def chunk_pipeline_cost(
    m: int, n: int, k: int, *, axis_size: int, sub_chunks: int,
    dtype_bytes: int = 2, kind: str = "reduce_scatter",
    hw: HardwareSpec = TPU_V5E, wire_bytes: float | None = None,
) -> KernelCost:
    """Cost of the chunk-pipelined ring schedule (paper Fig. 2/11 regime).

    Each of the ``axis_size`` ring steps is split into ``sub_chunks``
    double-buffered chunks: chunk j's transfer for step i+1 is issued before
    step i's chunk GEMMs consume their operands, so the pipeline fill shrinks
    to one *chunk* transfer while per-chunk sync overhead grows linearly.
    ``core.schedule.choose_gemm_chunks`` takes the argmin of this total over
    candidate chunk counts — on a calibrated spec the tradeoff is priced on
    *measured* link bandwidth, sync and GEMM-efficiency constants.

    The sync term is per chunk-HOP: the ring makes ``axis_size - 1`` hops
    (2x for the AR re-derivation's trailing gather) and every hop moves
    ``sub_chunks`` independently-synchronized payloads — one semaphore pair
    each. (``overlapped_gemm_collective_cost``'s generic term additionally
    scales every chunk by the whole axis, which over-penalizes fine chunking
    by a factor of ``axis_size``.)
    """
    total = max(axis_size, 1) * max(sub_chunks, 1)
    base = overlapped_gemm_collective_cost(
        m, n, k, axis_size=axis_size, dtype_bytes=dtype_bytes, kind=kind,
        n_chunks=total, hw=hw, wire_bytes=wire_bytes)
    hops = max(axis_size - 1, 0) * (2 if kind == "all_reduce" else 1)
    return dataclasses.replace(
        base, t_sync=hops * max(sub_chunks, 1) * hw.remote_sync_s)
