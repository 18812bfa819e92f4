"""Unified policy-driven communication API — ``CommContext`` on virtual ranks.

The twin of ``repro/core/comms.py``. Every op takes STACKED tensors: dim 0
is the rank axis of the context's mesh axis (``core/pgl.py``), so a
collective is arithmetic over dim 0 — a reduction over it for ``psum`` /
``pmax``, a roll of it for a ring hop — and the fused backend is one CUDA
kernel that addresses every rank's slab through a pointer table.

Ported ops::

    ==============================  =======================================
    op                              backends
    ==============================  =======================================
    ``all_gather_matmul(x, w)``     bulk | ring | ring_bidir | fused
    ``matmul_reduce_scatter(x, w)`` bulk | ring | fused
    ``matmul_all_reduce(x, w)``     bulk | ring | fused
    ``psum(x)``                     bulk | ring
    ``pmax(x)``                     bulk
    ``all_gather(x, axis=)``        bulk | fused
    ``reduce_scatter(x, axis=)``    bulk | fused
    ``ring_shift(tree)``            bulk | fused
    ``all_to_all(x, split, concat)`` bulk | chunked
    ==============================  =======================================

``bulk``  — GEMM in f32, then the collective over ranks in rank order.
``ring``  — the rings of ``repro.core.comms``: AG+GEMM rotates the row
            shards one hop right per step and multiplies each on arrival;
            GEMM+RS and GEMM+AR run the accumulate-and-forward
            reduce-scatter ring (payload in the activation dtype, each
            hop's add in f32), GEMM+AR then gathers. JAX's sub-chunks cut
            independent rows or columns; here each step runs whole, so
            ``n_chunks`` / ``chunk_dim`` cannot change the result. Under a
            quantized wire (``wire="int8"``/``"int8_sr"``,
            ``core/quant.py``) each travelling shard or accumulator is
            quantized once per row and travels as an (int8, f32 scales)
            pair, dequantized and accumulated in f32 on arrival; GEMM+AR's
            gather ships one more pair. Plain PyTorch on every device, as
            JAX's rings are XLA.
``ring_bidir`` — AG+GEMM only: the shard's top rows (ceil half) travel
            right, the rest left.
``fused`` — ``kernels/collective_matmul.py``: the hand-written AG×GEMM,
            GEMM×RS and GEMM×AR kernels on a CUDA device, their plain
            PyTorch versions on the CPU; for ``all_gather`` /
            ``reduce_scatter`` the ring kernels of ``kernels/pk_comm.py``;
            for ``ring_shift`` its p2p kernel. The fused AG×GEMM and GEMM×RS
            are forward-only, as in JAX (ROADMAP C9).
``chunked`` — ``all_to_all`` only: the payload cut along a bystander dim
            (``schedule.a2a_chunk_axis``), one launch of the all-to-all
            kernel of ``kernels/pk_comm.py`` a chunk on a CUDA device, its
            plain version on the CPU; bulk where no bystander dim splits,
            as in JAX. Bulk is one strided torch copy. The op is a copy, so
            every chunk count gives bulk's bits.

Backend precedence is the JAX package's:
per-call ``backend=`` > context pin > policy, with the same ``ValueError``
shape guards. The policy prices on ``H100_SXM`` by default: ``"analytic"``
from its data-sheet constants, ``"measured"`` from a calibration table of
``core/autotune.py`` (its rows first, the island's own before the global
grid, then the analytic model on the table's corrected spec; a warning and
the analytic policy when no table matches the device), ``"auto"`` the same
without the warning. A quantized wire
reprices the ring's transfer at the wire's bytes an element, pins row
chunks, and keeps the policy off ``fused``: the fused kernels ship full
precision, as JAX's do, so only the rings put int8 on the wire; ``bulk``
and ``fused`` ignore the wire.

Every op records itself on the active step counters
(``roofline/counters.py``) under every backend — the comm trace the
dry-run prices: the collective's kind, a rank's output bytes in the wire's
dtype, the group size — and, when its output takes a gradient, the
transposed collective its backward runs (an all-gather's reduce-scatter
and back; all-reduce, all-to-all and permute their own kind). Nothing is
recorded without a counter. While an engine step is traced
(``core/trace.py``) every op is the span ``comm.<op>.<backend>``, opened
once its backend is resolved, and adds the same output bytes to the
counter ``comm.<op>.bytes``; a fused GEMM+collective's span holds its
GEMM.

``CommContext.fault`` is the scripted payload fault of
``runtime/health.py``: a ``(kind, hop)`` pair that NaNs the rings' hop
``hop`` after its shift — every element for ``"corrupt"``, the first
element of each travelling chunk for ``"bitflip"`` — on every rank, as
JAX's ``_poison_hop`` does after each ``ppermute``. Bulk and fused ignore
it: they have no hop to poison.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import pgl, trace
from repro_torch.core.quant import (WireFormat, dequantize_add,
                                    dequantize_blocks, quantize_blocks,
                                    resolve_wire, tree_map)
from repro_torch.core.schedule import (GEMM_CHUNK_DIM, ChunkSchedule,
                                       OverlapPolicy, a2a_chunk_axis,
                                       choose_a2a_chunks, choose_gemm_chunks,
                                       choose_gemm_collective, fit_chunks)
from repro_torch.roofline import counters

__all__ = ["CommContext", "OP_BACKENDS", "GEMM_OP_KIND",
           "all_gather_matmul_baseline", "pk_all_gather_matmul",
           "matmul_reduce_scatter_baseline", "pk_matmul_reduce_scatter",
           "matmul_all_reduce_baseline", "pk_matmul_all_reduce",
           "psum_bulk", "pk_psum_ring", "pmax_bulk"]

OP_BACKENDS: dict[str, tuple[str, ...]] = {
    "all_gather_matmul": ("bulk", "ring", "ring_bidir", "fused"),
    "matmul_reduce_scatter": ("bulk", "ring", "fused"),
    "matmul_all_reduce": ("bulk", "ring", "fused"),
    "all_to_all": ("bulk", "chunked"),
    "psum": ("bulk", "ring"),
    "all_gather": ("bulk", "fused"),
    "reduce_scatter": ("bulk", "fused"),
    "ring_shift": ("bulk", "fused"),
}

_ALL_BACKENDS = {b for bs in OP_BACKENDS.values() for b in bs}

#: GEMM×collective op -> cost-model "kind" (the §3.1.3 schedule coordinate).
GEMM_OP_KIND = {"all_gather_matmul": "all_gather",
                "matmul_reduce_scatter": "reduce_scatter",
                "matmul_all_reduce": "all_reduce"}


#: the collective an op's backward runs (JAX's transpose rules)
_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-reduce": "all-reduce", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


class _Transposed(torch.autograd.Function):
    """Identity whose backward records the transposed collective."""

    @staticmethod
    def forward(ctx, x, record):
        ctx.record = record
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        counters.collective(*ctx.record)
        return g, None


def _trace(out: torch.Tensor, kind: str, nbytes, n: int,
           lanes: int = 1) -> torch.Tensor:
    """Record a collective on the active counters (see the module
    docstring) and, where ``out`` takes a gradient, its transpose in the
    backward: an all-gather of ``out_bytes = nbytes()`` a rank is
    reduce-scattered back to ``out_bytes / n``, a reduce-scatter gathered
    to ``out_bytes · n``. ``out`` unchanged, and ``nbytes`` not called,
    without a counter."""
    if counters.active() is None or n <= 1:
        return out
    out_bytes = nbytes()
    counters.collective(kind, out_bytes, n, lanes)
    if not (torch.is_grad_enabled() and out.requires_grad):
        return out
    back = {"all-gather": out_bytes / n,
            "reduce-scatter": out_bytes * n}.get(kind, out_bytes)
    return _Transposed.apply(out, (_TRANSPOSE[kind], back, n, lanes))


def _span(op: str, be: str, nbytes):
    """The op's span ``comm.<op>.<backend>`` (``core/trace.py``) and its
    counter ``comm.<op>.bytes``, a rank's output bytes by the comm trace's
    ``nbytes``; without tracing the shared null context, ``nbytes`` not
    called."""
    if not trace.tracing():
        return trace.IDLE
    trace.count(f"comm.{op}.bytes", nbytes())
    return trace.span("comm", op, be)


def _wire_elem_bytes(x: torch.Tensor, fmt, be: str) -> float:
    """Bytes an element on the wire: the quantized wire's on the rings,
    the activation dtype's on bulk and fused (they ship full precision)."""
    if fmt is not None and be in ("ring", "ring_bidir"):
        return fmt.bytes_per_element
    return x.element_size()


@dataclasses.dataclass(frozen=True)
class CommContext:
    """One handle for every overlapped collective over a mesh axis.

    ``mesh`` is a ``core.pgl.VirtualMesh``; ops run on stacked ``(R, ...)``
    tensors whose dim 0 is this axis. ``backend`` pins every call (A/B
    runs); per-call ``backend=`` overrides even that."""

    #: a mesh axis, or a tuple of axes acting as one flattened axis
    #: (several dp axes; the long-context decode's ``(*dp_axes, tp)``)
    axis_name: Any
    mesh: Any = None
    hw: cm.HardwareSpec = cm.H100_SXM
    backend: str | None = None
    allow_bidir: bool = True
    #: "analytic" prices schedules from ``hw``'s data-sheet constants;
    #: "measured" dispatches from a ``core/autotune.py`` calibration table
    #: (the analytic policy, with a warning, when none matches the device);
    #: "auto" is measured when a matching table exists, silently.
    policy: str = "analytic"
    #: a ``CalibrationTable``, a path to one, or None (search the user cache
    #: then the seed tables). Ignored under policy="analytic".
    calibration: Any = None
    #: the island key (``autotune.island_key``) this context dispatches as:
    #: measured lookups prefer rows tagged with it, then the global rows.
    island: str | None = None
    chunks: int | None = None
    wire: Any = None
    #: scripted payload fault ``(kind, hop)`` of ``runtime/health.py``
    #: ("corrupt" or "bitflip"), applied to the ring GEMM×collectives' hop
    #: ``hop``; None everywhere outside scripted fault injection
    fault: Any = None

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("the port's CommContext needs a VirtualMesh")
        resolve_wire(self.wire)          # an unknown name raises here

    def wire_format(self, override: Any = None) -> WireFormat | None:
        """The call's quantized ``WireFormat`` (per-call ``wire=`` first,
        then the context's), or None for a full-precision wire."""
        return resolve_wire(override if override is not None else self.wire)

    # -- introspection -----------------------------------------------------

    @property
    def axis_size(self) -> int:
        return pgl.axes_size(self.mesh, self.axis_name)

    def available_backends(self, op: str) -> tuple[str, ...]:
        """Backends of `op` that can execute here: all of them (``fused``
        launches its kernel on a CUDA device and runs its plain version on
        the CPU)."""
        return OP_BACKENDS[op]

    def active_calibration(self):
        """The ``CalibrationTable`` this context's policy dispatches from,
        or None when the policy is analytic (explicitly, or by fallback
        because no table matches this device's fingerprint)."""
        if self.policy == "analytic":
            return None
        from repro_torch.core import autotune
        return autotune.resolve_table(self.calibration, self.hw.name,
                                      self.policy,
                                      device=self.mesh.device.type)

    def effective_hw(self) -> cm.HardwareSpec:
        """``hw`` with the measured corrections applied when the measured
        policy is active: the spec every cost-model query below runs on."""
        table = self.active_calibration()
        return table.spec(self.hw) if table is not None else self.hw

    # -- dispatch plumbing -------------------------------------------------

    def _resolve(self, op: str, override: str | None, auto) -> str:
        be = override if override is not None else self.backend
        if be in (None, "auto"):
            be = auto()
        elif override is None and be not in OP_BACKENDS[op]:
            # a context-wide pin naming a real backend this op lacks falls
            # back to the policy; an unknown name is an error
            if be not in _ALL_BACKENDS:
                raise ValueError(
                    f"unknown backend {be!r}; known backends: "
                    f"{sorted(_ALL_BACKENDS)}")
            be = auto()
        if be not in OP_BACKENDS[op]:
            raise ValueError(
                f"op {op!r} has no backend {be!r}; "
                f"available: {OP_BACKENDS[op]}")
        return be

    def _shape_guard(self, op: str, be: str, override: str | None,
                     ok: bool, constraint: str, fallback: str = "bulk") -> str:
        """A per-call backend that violates its shape constraint raises; a
        context pin degrades to ``fallback`` the way the policy would."""
        if ok or be == fallback:
            return be
        if override is not None:
            raise ValueError(
                f"{op}(backend={be!r}) requires {constraint} "
                f"(axis {self.axis_name!r} has size {self.axis_size})")
        return fallback

    def _prefer_fused(self) -> bool:
        """The policy picks the fused kernel on a CUDA device — and on
        ``meta``, where the dry-run describes the card — over at most the
        kernels' ``MAX_RANKS`` ranks (a 16-rank tp axis takes the ring).
        (The JAX package also checks that whole operands fit VMEM; the
        CUDA kernel tiles K through shared memory, so no such limit
        applies.)"""
        from repro_torch.kernels.collective_matmul import MAX_RANKS
        return self.mesh.device.type in ("cuda", "meta") \
            and self.axis_size <= MAX_RANKS

    def gemm_policy(self, m: int, n: int, k: int, *, kind: str,
                    dtype_bytes: int = 2, hw: cm.HardwareSpec | None = None,
                    wire: Any = None) -> OverlapPolicy:
        """The §3.1.3 schedule decision for a GEMM×collective of global
        shape (m, n, k) over this axis, priced on ``hw`` (None: on
        ``effective_hw()``); only AG+GEMM may credit the second link-pair
        of a bidirectional ring. A quantized wire prices the ring's
        transfer at its bytes an element, scales included."""
        fmt = self.wire_format(wire)
        return choose_gemm_collective(
            m, n, k, axis_size=self.axis_size, kind=kind,
            dtype_bytes=dtype_bytes,
            hw=hw if hw is not None else self.effective_hw(),
            allow_bidir=self.allow_bidir and kind == "all_gather",
            wire_bytes=fmt.bytes_per_element if fmt is not None else None)

    def auto_gemm_backend(self, op: str, m: int, n: int, k: int, *,
                          dtype_bytes: int = 2, fused_ok: bool = False,
                          bidir_ok: bool = True, wire: Any = None) -> str:
        """The backend ``backend=None`` resolves to, trace-free. Under the
        measured policy the feasible backends measured near (m, n, k) are
        compared on measured microseconds (``CalibrationTable.
        best_backend``, the island's rows first, at the wire's width); the
        analytic model answers where the table has no comparison, on the
        table's corrected spec. Under a quantized wire it is never
        ``fused``: the fused kernels ship full precision, so the rings are
        what put int8 on the wire."""
        fmt = self.wire_format(wire)
        q_bytes = fmt.dtype_bytes if fmt is not None else dtype_bytes
        table = self.active_calibration()
        if table is not None:
            allowed = ["bulk", "ring"]
            if (op == "all_gather_matmul" and bidir_ok and self.allow_bidir
                    and self.axis_size % 2 == 0):
                allowed.append("ring_bidir")
            if fused_ok:
                allowed.append("fused")
            best = table.best_backend(op, m, n, k, allowed=allowed,
                                      axis_size=self.axis_size,
                                      dtype_bytes=q_bytes,
                                      island=self.island)
            if best is not None:
                return best
        pol = self.gemm_policy(
            m, n, k, kind=GEMM_OP_KIND[op], dtype_bytes=dtype_bytes,
            hw=table.spec(self.hw) if table is not None else self.hw,
            wire=wire)
        if not pol.enabled:
            return "bulk"
        if fused_ok and fmt is None:
            return "fused"
        if (op == "all_gather_matmul" and pol.strategy == "ring_bidir"
                and bidir_ok):
            return "ring_bidir"
        return "ring"

    def gemm_chunk_schedule(self, op: str, m: int, n: int, k: int, *,
                            backend: str, dtype_bytes: int = 2,
                            n_chunks: int | None = None,
                            chunk_dim: str | None = None,
                            wire: Any = None) -> ChunkSchedule:
        """Chunk-pipeline decision: per-call ``n_chunks`` > context
        ``chunks`` > the chunk count measured in the calibration table (the
        island's rows first, at the wire's width) > the analytic argmin
        (``fused=True`` prices the fused kernel). The fused kernel chunks
        the payload's rows, and a quantized wire pins row chunks too (its
        blocks are per row); the fused schedule ignores the wire."""
        kind = GEMM_OP_KIND[op]
        fused = backend == "fused"
        fmt = self.wire_format(wire) if not fused else None
        if fused or fmt is not None:
            chunk_dim = "m"
        dim = chunk_dim if chunk_dim is not None else GEMM_CHUNK_DIM[kind]
        if backend not in ("ring", "ring_bidir", "fused"):
            return ChunkSchedule(1, dim, f"{backend} path takes no sub-chunks")
        if n_chunks is not None:
            return ChunkSchedule(max(1, n_chunks), dim, "per-call n_chunks=",
                                 source="explicit")
        if self.chunks is not None:
            return ChunkSchedule(max(1, self.chunks), dim,
                                 "context chunks= (RunConfig.comm_chunks)",
                                 source="explicit")
        q_bytes = fmt.dtype_bytes if fmt is not None else dtype_bytes
        table = self.active_calibration()
        if table is not None:
            c = table.best_chunks(op, backend, m, n, k,
                                  axis_size=self.axis_size,
                                  dtype_bytes=q_bytes, island=self.island)
            if c is not None:
                return ChunkSchedule(c, dim, "measured chunk sweep argmin",
                                     source="measured")
        sched = choose_gemm_chunks(
            m, n, k, axis_size=self.axis_size, kind=kind,
            dtype_bytes=dtype_bytes,
            hw=table.spec(self.hw) if table is not None else self.hw,
            wire_bytes=fmt.bytes_per_element if fmt is not None else None,
            fused=fused)
        return sched if chunk_dim is None else dataclasses.replace(
            sched, chunk_dim=chunk_dim)

    @staticmethod
    def a2a_coords(shape, split_axis: int, concat_axis: int
                   ) -> tuple[int, int, int]:
        """The (m, n, k) an ``all_to_all`` calibration row is stored and
        queried under: (local payload elements, split-dim extent, concat-dim
        extent) — one convention for the per-island sweep and every
        dispatch query."""
        return (int(math.prod(shape)), int(shape[split_axis]),
                int(shape[concat_axis]))

    def a2a_chunk_schedule(self, shape, split_axis: int, concat_axis: int, *,
                           dtype_bytes: int = 2,
                           downstream_compute_s: float = 0.0
                           ) -> ChunkSchedule:
        """Chunk count for an ``all_to_all`` of local payload ``shape``.

        Measured first: where the calibration table has a2a rows near
        :meth:`a2a_coords` (``calibrate --per-island`` sweeps the Ulysses
        and MoE-dispatch islands; the island's rows preferred), bulk vs
        chunked and the count are the measured argmin; otherwise the
        analytic ``schedule.choose_a2a_chunks`` answers. The count is
        fitted to the payload's splittable bystander dims. The Ulysses
        island's ``ulysses_chunks = 0`` and the MoE island's ``moe_chunks
        = 0`` (auto) resolve through it."""
        m, n, k = self.a2a_coords(shape, split_axis, concat_axis)
        table = self.active_calibration()
        if table is not None:
            be = table.best_backend("all_to_all", m, n, k,
                                    allowed=("bulk", "chunked"),
                                    axis_size=self.axis_size,
                                    dtype_bytes=dtype_bytes,
                                    island=self.island)
            if be == "bulk":
                return ChunkSchedule(1, "a2a", "measured: bulk a2a wins",
                                     source="measured")
            if be == "chunked":
                c = table.best_chunks("all_to_all", "chunked", m, n, k,
                                      axis_size=self.axis_size,
                                      dtype_bytes=dtype_bytes,
                                      island=self.island)
                c = c if c is not None else 2
                fit = a2a_chunk_axis(shape, split_axis, concat_axis, c)
                if fit is not None and fit[1] > 1:
                    return ChunkSchedule(fit[1], "a2a",
                                         "measured chunk sweep argmin",
                                         source="measured")
                return ChunkSchedule(1, "a2a",
                                     "measured chunked win, but no "
                                     "bystander dim splits", source="measured")
        c = choose_a2a_chunks(
            math.prod(shape) * dtype_bytes, axis_size=self.axis_size,
            downstream_compute_s=downstream_compute_s,
            hw=table.spec(self.hw) if table is not None else self.hw,
            shape=shape, split_axis=split_axis,
            concat_axis=concat_axis)
        return ChunkSchedule(c, "a2a", f"choose_a2a_chunks -> {c}",
                             source="analytic")

    def _check_stacked(self, *ts: torch.Tensor) -> None:
        for t in ts:
            if t.shape[0] != self.axis_size:
                raise ValueError(
                    f"expected a stacked tensor with {self.axis_size} ranks "
                    f"on dim 0, got shape {tuple(t.shape)}")

    # -- GEMM × collective ops --------------------------------------------

    def all_gather_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                          backend: str | None = None,
                          n_chunks: int | None = None,
                          chunk_dim: str | None = None,
                          wire: Any = None) -> torch.Tensor:
        """x: (R, m_loc, k) row shards; w: (R, k, n_loc) each rank's own
        weight -> (R, R·m_loc, n_loc): the gathered rows times rank r's
        weight on rank r, in x's dtype (paper Fig. 7). ``ring_bidir`` needs
        ``m_loc >= 2`` on an even axis (an odd shard splits ceil/floor)."""
        self._check_stacked(x, w)
        n_dev = self.axis_size
        m_loc, k = x.shape[1], x.shape[2]
        n_out = w.shape[2]
        dtype_bytes = x.element_size()
        fmt = self.wire_format(wire)

        def auto() -> str:
            return self.auto_gemm_backend(
                "all_gather_matmul", m_loc * n_dev, n_out, k,
                dtype_bytes=dtype_bytes, fused_ok=self._prefer_fused(),
                bidir_ok=(m_loc >= 2), wire=fmt)

        be = self._resolve("all_gather_matmul", backend, auto)
        if be == "ring_bidir":
            be = self._shape_guard(
                "all_gather_matmul", be, backend,
                ok=(m_loc >= 2 or n_dev % 2 != 0),
                constraint="at least 2 local rows to split across the two "
                           "ring directions (m_loc >= 2)",
                fallback="ring")

        def nbytes():
            return n_dev * m_loc * k * _wire_elem_bytes(x, fmt, be)

        x = _trace(x, "all-gather", nbytes, n_dev)
        with _span("all_gather_matmul", be, nbytes):
            if be == "bulk":
                return all_gather_matmul_baseline(x, w)
            sched = self.gemm_chunk_schedule(
                "all_gather_matmul", m_loc * n_dev, n_out, k, backend=be,
                dtype_bytes=dtype_bytes, n_chunks=n_chunks,
                chunk_dim=chunk_dim, wire=fmt)
            if be in ("ring", "ring_bidir"):
                return pk_all_gather_matmul(
                    x, w, bidirectional=(be == "ring_bidir"),
                    n_chunks=sched.n_chunks, chunk_dim=sched.chunk_dim,
                    wire=fmt, fault=self.fault)
            from repro_torch.kernels import collective_matmul
            return collective_matmul.ag_matmul_fused(
                x, w, n_chunks=sched.n_chunks).to(x.dtype)

    def matmul_reduce_scatter(self, x: torch.Tensor, w: torch.Tensor, *,
                              backend: str | None = None,
                              n_chunks: int | None = None,
                              chunk_dim: str | None = None,
                              wire: Any = None) -> torch.Tensor:
        """x: (R, m, k_loc); w: (R, k_loc, n) -> (R, m/R, n): rank r holds
        row block r of the sum over ranks of ``x[r] @ w[r]``, in x's dtype
        (paper Fig. 8). Ring and fused need ``m`` divisible by the axis
        size."""
        self._check_stacked(x, w)
        n_dev = self.axis_size
        m, k_loc = x.shape[1], x.shape[2]
        n_out = w.shape[2]
        dtype_bytes = x.element_size()
        fmt = self.wire_format(wire)

        def auto() -> str:
            if m % n_dev != 0:
                return "bulk"            # ring needs m divisible by the axis
            return self.auto_gemm_backend(
                "matmul_reduce_scatter", m, n_out, k_loc,
                dtype_bytes=dtype_bytes, fused_ok=self._prefer_fused(),
                wire=fmt)

        be = self._resolve("matmul_reduce_scatter", backend, auto)
        if be != "bulk":
            be = self._shape_guard(
                "matmul_reduce_scatter", be, backend, ok=(m % n_dev == 0),
                constraint="m divisible by the axis size")

        def nbytes():
            return m // n_dev * n_out * _wire_elem_bytes(x, fmt, be)

        with _span("matmul_reduce_scatter", be, nbytes):
            out = self._gemm_rs(x, w, be, fmt, m, n_out, k_loc, dtype_bytes,
                                n_chunks, chunk_dim)
        return _trace(out, "reduce-scatter", nbytes, n_dev)

    def _gemm_rs(self, x, w, be, fmt, m, n_out, k_loc, dtype_bytes,
                 n_chunks, chunk_dim):
        if be == "bulk":
            return matmul_reduce_scatter_baseline(x, w)
        sched = self.gemm_chunk_schedule(
            "matmul_reduce_scatter", m, n_out, k_loc, backend=be,
            dtype_bytes=dtype_bytes, n_chunks=n_chunks, chunk_dim=chunk_dim,
            wire=fmt)
        if be == "ring":
            return pk_matmul_reduce_scatter(x, w, n_chunks=sched.n_chunks,
                                            chunk_dim=sched.chunk_dim,
                                            wire=fmt, fault=self.fault)
        from repro_torch.kernels import collective_matmul
        return collective_matmul.matmul_rs_fused(
            x, w, n_chunks=sched.n_chunks).to(x.dtype)

    def matmul_all_reduce(self, x: torch.Tensor, w: torch.Tensor, *,
                          backend: str | None = None,
                          n_chunks: int | None = None,
                          chunk_dim: str | None = None,
                          wire: Any = None) -> torch.Tensor:
        """x: (R, m, k_loc); w: (R, k_loc, n) -> (R, m, n) = AR(x @ w), the
        same on every rank, in x's dtype (paper Fig. 9). Ring and fused
        need ``m`` divisible by the axis size."""
        self._check_stacked(x, w)
        n_dev = self.axis_size
        m, k_loc = x.shape[1], x.shape[2]
        n_out = w.shape[2]
        dtype_bytes = x.element_size()
        fmt = self.wire_format(wire)

        def auto() -> str:
            if m % n_dev != 0:
                return "bulk"
            return self.auto_gemm_backend(
                "matmul_all_reduce", m, n_out, k_loc,
                dtype_bytes=dtype_bytes, fused_ok=self._prefer_fused(),
                wire=fmt)

        be = self._resolve("matmul_all_reduce", backend, auto)
        if be != "bulk":
            be = self._shape_guard(
                "matmul_all_reduce", be, backend, ok=(m % n_dev == 0),
                constraint="m divisible by the axis size")

        def nbytes():
            return m * n_out * _wire_elem_bytes(x, fmt, be)

        with _span("matmul_all_reduce", be, nbytes):
            out = self._gemm_ar(x, w, be, fmt, m, n_out, k_loc, dtype_bytes,
                                n_chunks, chunk_dim)
        return _trace(out, "all-reduce", nbytes, n_dev)

    def _gemm_ar(self, x, w, be, fmt, m, n_out, k_loc, dtype_bytes,
                 n_chunks, chunk_dim):
        if be == "bulk":
            return matmul_all_reduce_baseline(x, w)
        sched = self.gemm_chunk_schedule(
            "matmul_all_reduce", m, n_out, k_loc, backend=be,
            dtype_bytes=dtype_bytes, n_chunks=n_chunks, chunk_dim=chunk_dim,
            wire=fmt)
        if be == "ring":
            return pk_matmul_all_reduce(x, w, n_chunks=sched.n_chunks,
                                        chunk_dim=sched.chunk_dim, wire=fmt,
                                        fault=self.fault)
        from repro_torch.kernels import collective_matmul
        return collective_matmul.matmul_ar_fused(
            x, w, n_chunks=sched.n_chunks).to(x.dtype)

    def ring_shift(self, x, *, reverse: bool = False,
                   backend: str | None = None):
        """One-hop ring rotation of a pytree of stacked ``(R, ...)``
        tensors (KV blocks in ring attention, SSM boundary states):
        rank d's leaf moves to rank d+1 (``reverse``: to d-1). ``auto``
        resolves to bulk, as in JAX; fused sends right only."""
        be = self._resolve("ring_shift", backend, lambda: "bulk")
        if be == "fused" and reverse:
            raise ValueError("fused ring_shift sends right only")

        def shift(t):
            self._check_stacked(t)
            if be == "bulk":
                out = torch.roll(t, -1 if reverse else 1, 0)
            else:
                out = _RingShift.apply(t)
            return _trace(out, "collective-permute",
                          lambda: t[0].numel() * t.element_size(),
                          self.axis_size)

        def nbytes():
            sizes = []
            tree_map(lambda t: sizes.append(t[0].numel() * t.element_size()),
                     x)
            return sum(sizes)

        with _span("ring_shift", be, nbytes):
            return tree_map(shift, x)

    # -- data-movement ops -------------------------------------------------

    def all_to_all(self, x: torch.Tensor, *, split_axis: int,
                   concat_axis: int, backend: str | None = None,
                   n_chunks: int | None = None,
                   downstream_compute_s: float = 0.0) -> torch.Tensor:
        """Re-sharding all-to-all (paper Fig. 11/17: Ulysses head <->
        sequence, MoE dispatch): stacked (R, *local) -> (R, *local'), the
        local ``split_axis`` R times shorter and ``concat_axis`` R times
        longer; block r of rank s's split dim lands at concat position s on
        rank r. ``auto`` takes ``chunked`` when ``n_chunks`` (else the
        analytic ``choose_a2a_chunks``) is above 1; a pinned ``chunked``
        runs at least 2 chunks. The gradient is the same all-to-all with
        the axes swapped, on the same backend and chunk count."""
        self._check_stacked(x)
        from repro_torch.kernels import pk_comm
        local = tuple(x.shape[1:])
        pk_comm.a2a_local_shape(local, self.axis_size, split_axis,
                                concat_axis)

        def auto_chunks() -> int:
            return choose_a2a_chunks(
                math.prod(local) * x.element_size(),
                axis_size=self.axis_size,
                downstream_compute_s=downstream_compute_s,
                hw=self.effective_hw(),
                shape=local, split_axis=split_axis, concat_axis=concat_axis)

        def auto() -> str:
            c = n_chunks if n_chunks is not None else auto_chunks()
            return "chunked" if c > 1 else "bulk"

        be = self._resolve("all_to_all", backend, auto)
        c = 1
        if be == "chunked":
            want = max(2, n_chunks if n_chunks is not None
                       else auto_chunks())
            fit = a2a_chunk_axis(local, split_axis, concat_axis, want)
            c = fit[1] if fit is not None else 1

        def nbytes():
            return math.prod(local) * x.element_size()

        with _span("all_to_all", be, nbytes):
            out = _AllToAll.apply(x, split_axis, concat_axis, c)
        return _trace(out, "all-to-all", nbytes, self.axis_size)

    def all_gather(self, x: torch.Tensor, *, axis: int = 0,
                   backend: str | None = None, order=None, lanes: int = 1,
                   split: int = 1) -> torch.Tensor:
        """Tiled all-gather along ``axis`` of each rank's local tensor:
        stacked (R, *local) -> (R, *gathered), ``gathered.shape[axis] =
        R · local.shape[axis]``, the same on every rank (the FSDP param
        gather). ``auto`` resolves to bulk; fused is the ring kernel. The
        result is contiguous, or has its local dims in memory in ``order``
        (outermost first), under either backend. ``lanes`` and ``split``
        describe a stacked call that stands for several groups at once
        (the FSDP gather of a tp-stacked leaf, ``template.fsdp_gather``):
        it runs ``lanes`` groups, and a rank holds ``1 / split`` of the
        local tensor — what the comm trace records."""
        self._check_stacked(x)
        if x.dim() < 2:
            raise ValueError("all_gather takes a stacked (R, *local) tensor "
                             "with at least one local dim")
        be = self._resolve("all_gather", backend, lambda: "bulk")

        def nbytes():
            return (x[0].numel() * self.axis_size * x.element_size()
                    / split)

        with _span("all_gather", be, nbytes):
            out = _AllGather.apply(x, axis % (x.dim() - 1), be, order)
        return _trace(out, "all-gather", nbytes, self.axis_size, lanes)

    def reduce_scatter(self, x: torch.Tensor, *, axis: int = 0,
                       backend: str | None = None) -> torch.Tensor:
        """Tiled reduce-scatter along ``axis``: stacked (R, *local) ->
        (R, *scattered), rank r holding the sum over ranks of block r of
        ``axis`` (the FSDP gradient shard-reduce). ``auto`` resolves to
        bulk; fused takes ``axis=0`` only, as in JAX."""
        self._check_stacked(x)
        if x.dim() < 2:
            raise ValueError("reduce_scatter takes a stacked (R, *local) "
                             "tensor with at least one local dim")
        be = self._resolve("reduce_scatter", backend, lambda: "bulk")
        axis = axis % (x.dim() - 1)
        if be == "fused" and axis != 0:
            raise ValueError("fused reduce_scatter supports axis=0 only")
        if x.shape[1 + axis] % self.axis_size:
            raise ValueError(
                f"reduce_scatter: dim {axis} of the local shape "
                f"{tuple(x.shape[1:])} is not divisible by the axis size "
                f"{self.axis_size}")

        def nbytes():
            return x[0].numel() // self.axis_size * x.element_size()

        with _span("reduce_scatter", be, nbytes):
            out = _ReduceScatter.apply(x, axis, be)
        return _trace(out, "reduce-scatter", nbytes, self.axis_size)

    def psum(self, x: torch.Tensor, *,
             backend: str | None = None) -> torch.Tensor:
        """All-reduce over the rank axis. "ring" keeps the payload dtype and
        needs ``x.shape[1]`` (the local leading dim) divisible by the axis
        size. The policy asks the calibration table first (rows at (local
        leading dim, the rest of the local size, 1)), then picks the ring
        for bf16 payloads that split."""
        self._check_stacked(x)
        ring_ok = x.dim() >= 2 and x.shape[1] % self.axis_size == 0

        def auto() -> str:
            table = self.active_calibration()
            if table is not None and ring_ok:
                lead = x.shape[1]
                best = table.best_backend(
                    "psum", lead, max(x[0].numel() // max(lead, 1), 1), 1,
                    allowed=("bulk", "ring"), axis_size=self.axis_size,
                    dtype_bytes=x.element_size(), island=self.island)
                if best is not None:
                    return best
            return "ring" if ring_ok and x.dtype == torch.bfloat16 else "bulk"

        be = self._resolve("psum", backend, auto)
        if be == "ring":
            be = self._shape_guard(
                "psum", be, backend, ok=ring_ok,
                constraint="shape[0] divisible by the axis size")

        def nbytes():
            return x[0].numel() * x.element_size()

        with _span("psum", be, nbytes):
            out = psum_bulk(x) if be == "bulk" else pk_psum_ring(x)
        return _trace(out, "all-reduce", nbytes, self.axis_size)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the rank axis, broadcast back (``lax.pmax``)."""
        self._check_stacked(x)

        def nbytes():
            return x[0].numel() * x.element_size()

        with _span("pmax", "bulk", nbytes):
            out = pmax_bulk(x)
        return _trace(out, "all-reduce", nbytes, self.axis_size)


# ---------------------------------------------------------------------------
# Torch-level implementations on stacked tensors. Ring direction follows the
# JAX package: "send left" (j -> j-1), so after a hop rank d holds what rank
# d+1 held — a roll of dim 0 by -1.
# ---------------------------------------------------------------------------

def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in rank order (a fixed order, whatever the device)."""
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    return acc


def psum_bulk(x: torch.Tensor) -> torch.Tensor:
    return _rank_sum(x).unsqueeze(0).expand_as(x)


def pmax_bulk(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=0, keepdim=True).expand_as(x)


def pk_psum_ring(y: torch.Tensor) -> torch.Tensor:
    """All-reduce as an accumulate-and-forward ring (reduce-scatter) plus a
    gather, payload in its own dtype (``repro.core.comms.pk_psum_ring``)."""
    n = y.shape[0]
    if n == 1:
        return y
    lead = y.shape[1]
    if lead % n:
        return psum_bulk(y)
    parts = y.reshape(n, n, lead // n, *y.shape[2:])
    ranks = torch.arange(n, device=y.device)
    acc = parts[ranks, (ranks + 1) % n]
    for i in range(1, n):
        acc = torch.roll(acc, -1, 0) + parts[ranks, (ranks + 1 + i) % n]
    out = acc.reshape(n * (lead // n), *y.shape[2:])
    return out.unsqueeze(0).expand_as(y)


def all_gather_stacked(x: torch.Tensor, axis: int, backend: str,
                       order=None) -> torch.Tensor:
    """(R, *local) -> (R, *gathered) along local dim ``axis``, contiguous or
    with the local dims in memory in ``order`` (outermost first).
    ``fused`` runs the all-gather kernel on x's view as it is (an FSDP
    ``dp_view`` is strided) into that layout, no copy before or after it;
    ``bulk`` concatenates the shards in rank order."""
    from repro_torch.kernels import pk_comm
    if backend == "bulk":
        return pk_comm.gather_along_plain(x, axis, order)
    return pk_comm.all_gather_along(x, axis, order=order)


def reduce_scatter_stacked(x: torch.Tensor, axis: int,
                           backend: str) -> torch.Tensor:
    """(R, *local) -> (R, *scattered) along local dim ``axis``: rank r gets
    the sum over ranks of block r. ``fused`` moves the axis to the front and
    runs the ring kernel on (R, R, blk, ...); ``bulk`` sums over ranks in
    rank order in f32 and splits."""
    r = x.shape[0]
    if backend == "bulk":
        total = _rank_sum(x.float()).to(x.dtype)
        return torch.stack(total.chunk(r, dim=axis))
    from repro_torch.kernels import pk_comm
    front = x.movedim(1 + axis, 1)                 # (R, L, *rest)
    parts = front.unflatten(1, (r, front.shape[1] // r))
    return pk_comm.ring_reduce_scatter(parts).movedim(1, 1 + axis)


class _RingShift(torch.autograd.Function):
    """The fused hop: the p2p kernel forward. JAX's fused ring_shift has no
    gradient (a Pallas call with DMA semaphores has no VJP), so the
    backward is the bulk transpose of JAX's ``ppermute``: the cotangent
    rolled one hop left, in plain torch; no kernel runs there."""

    @staticmethod
    def forward(ctx, x):
        from repro_torch.kernels import pk_comm
        return pk_comm.p2p_ring_shift(x)

    @staticmethod
    def backward(ctx, g):
        return torch.roll(g, -1, 0)


def all_to_all_stacked(x: torch.Tensor, split_axis: int, concat_axis: int,
                       n_chunks: int) -> torch.Tensor:
    """The all-to-all of (R, *local): bulk (one strided torch copy) for one
    chunk, else the kernel of ``kernels/pk_comm.py``, one launch a chunk."""
    from repro_torch.kernels import pk_comm
    if n_chunks == 1:
        return pk_comm.all_to_all_plain(x, split_axis, concat_axis)
    return pk_comm.all_to_all(x, split_axis, concat_axis, n_chunks=n_chunks)


class _AllToAll(torch.autograd.Function):
    """The transpose of an all-to-all is the all-to-all with split and
    concat swapped (JAX's rule for ``lax.all_to_all``): a copy both ways."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, n_chunks):
        ctx.opts = (split_axis, concat_axis, n_chunks)
        return all_to_all_stacked(x, split_axis, concat_axis, n_chunks)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, n_chunks = ctx.opts
        return (all_to_all_stacked(g, concat_axis, split_axis, n_chunks),
                None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, backend, order):
        ctx.opts = (axis, backend)
        return all_gather_stacked(x, axis, backend, order)

    @staticmethod
    def backward(ctx, g):
        axis, backend = ctx.opts
        return reduce_scatter_stacked(g, axis, backend), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, backend):
        ctx.opts = (axis, backend)
        return reduce_scatter_stacked(x, axis, backend)

    @staticmethod
    def backward(ctx, g):
        axis, backend = ctx.opts
        return all_gather_stacked(g, axis, backend), None, None


def all_gather_matmul_baseline(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Bulk AG+GEMM: the row shards concatenated in rank order, then one
    f32 GEMM against each rank's weight, in x's dtype: (R, R·m_loc, n),
    ``out[d] = concat_s(x[s]) @ w[d]`` (also the fused kernel's plain
    version)."""
    x_full = x.reshape(-1, x.shape[2])
    return torch.matmul(x_full.float(), w.float()).to(x.dtype)


def _check_chunks(n_chunks: int, chunk_dim: str) -> None:
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    if chunk_dim not in ("m", "n"):
        raise ValueError(f"chunk_dim must be 'm' or 'n', not {chunk_dim!r}")


#: the seed every stochastic-rounding generator derives from (JAX
#: ``_wire_sr_key``'s PRNGKey(1729))
_SR_SEED = 1729


def _wire_generators(fmt: WireFormat | None, n: int, salt: int,
                     device) -> list | None:
    """One stochastic-rounding generator a rank for a quantized ring, or
    None for round-to-nearest. Seeded from a fixed seed, the op's salt and
    the rank (as ``repro.core.comms._wire_sr_key`` folds them into its key),
    so every call of the same schedule rounds the same way while no two
    ranks or ops share noise."""
    if fmt is None or not fmt.stochastic_round:
        return None
    return [torch.Generator(device=device).manual_seed(
        (_SR_SEED << 20) + (salt << 10) + r) for r in range(n)]


def _wire_quantize(t: torch.Tensor, fmt: WireFormat,
                   gens: list | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row block quantization of a stacked (R, rows, cols) payload:
    (int8 (R, rows, nb, block), f32 scales (R, rows, nb, 1)); a rank's
    stochastic rounding draws from its own generator."""
    if gens is None:
        return quantize_blocks(t, block=fmt.block)
    parts = [quantize_blocks(t[r], block=fmt.block, generator=g)
             for r, g in enumerate(gens)]
    return (torch.stack([q for q, _ in parts]),
            torch.stack([sc for _, sc in parts]))


def _poison_hop(fault, hop: int, t: torch.Tensor,
                starts: list[tuple[int, ...]]) -> torch.Tensor:
    """Scripted payload fault (``CommContext.fault``) on a stacked
    ``(R, ...)`` hop payload, every rank's arrival at once: when ``fault``
    = (kind, hop') targets ring hop ``hop``, "corrupt" NaNs the whole
    payload and "bitflip" one element of each travelling chunk of each
    rank, at the chunk's first index (``starts``, one a chunk, into a
    rank's payload). Float payloads only: a quantized wire is poisoned
    through its f32 scales (``repro.core.comms._poison_hop``)."""
    if fault is None or fault[1] != hop or not t.is_floating_point():
        return t
    if fault[0] == "bitflip":
        t = t.clone()
        for idx in starts:
            t[(slice(None), *idx)] = float("nan")
        return t
    return torch.full_like(t, float("nan"))


def _chunk_starts(extent: int, n_chunks: int, dim: int,
                  ndim: int) -> list[tuple[int, ...]]:
    """First index of each of the ``fit_chunks(extent, n_chunks)`` chunks
    JAX cuts along ``dim`` of an ``ndim``-dim payload (a rank's)."""
    c = fit_chunks(extent, n_chunks)
    return [tuple(j * (extent // c) if d == dim else 0
                  for d in range(ndim)) for j in range(c)]


def _ag_ring_lane(x: torch.Tensor, w: torch.Tensor, *, reverse: bool,
                  wire: WireFormat | None = None, n_chunks: int = 1,
                  chunk_dim: str = "m", fault=None) -> torch.Tensor:
    """One direction of the AG+GEMM ring (``repro.core.comms._ag_ring_lane``)
    on x (R, rows, k), w (R, k, n): at step i rank d holds the shard of rank
    (d - i) % R ((d + i) % R when ``reverse``), sends it one hop on and
    multiplies it by its own weight. Returns (R, R, rows, n): slot s of
    rank d is ``x[s] @ w[d]``. A quantized ``wire`` quantizes each shard
    once, per row, before the first hop; the (int8, scales) pair travels
    the ring and every arrival — the rank's own shard too — is dequantized
    to f32 for its GEMM. ``fault`` poisons hop i after the shift (the
    scales of a quantized pair); JAX's travelling chunks are the shard's
    row chunks (``chunk_dim="m"``) or the whole shard ("n")."""
    n, k = x.shape[0], x.shape[2]
    cur = x if wire is None else _wire_quantize(
        x, wire, _wire_generators(wire, n, 1 if reverse else 0, x.device))
    rows = x.shape[1]
    starts = (_chunk_starts(rows, n_chunks, 0, 2 if wire is None else 3)
              if chunk_dim == "m" else [(0,) * (2 if wire is None else 3)])
    steps = []
    for i in range(n):
        t = cur if wire is None else dequantize_blocks(*cur, k)
        steps.append(torch.matmul(t.float(), w.float()).to(x.dtype))
        if i < n - 1:
            cur = tree_map(lambda c: torch.roll(c, -1 if reverse else 1, 0),
                            cur)
            if wire is None:
                cur = _poison_hop(fault, i, cur, starts)
            else:
                cur = (cur[0], _poison_hop(fault, i, cur[1], starts))
    ranks = torch.arange(n, device=x.device)
    hops = ranks[None, :] - ranks[:, None] if reverse \
        else ranks[:, None] - ranks[None, :]
    # rank d computed slot s at step (d - s) % R ((s - d) % R reversed)
    return torch.stack(steps)[hops % n, ranks[:, None]]


def pk_all_gather_matmul(x: torch.Tensor, w: torch.Tensor, *,
                         bidirectional: bool = False, n_chunks: int = 1,
                         chunk_dim: str = "m",
                         wire: WireFormat | None = None,
                         fault=None) -> torch.Tensor:
    """The AG+GEMM ring of ``repro.core.comms.pk_all_gather_matmul``:
    x (R, m_loc, k), w (R, k, n) -> (R, R·m_loc, n) in x's dtype. The
    bidirectional ring sends the shard's top ceil(m_loc / 2) rows right
    and the rest left (even axis, m_loc >= 2; otherwise one ring).

    JAX splits each hop into ``n_chunks`` sub-chunks (rows, or output
    columns for ``chunk_dim="n"``) that GEMM on arrival; they cut
    independent rows and columns of the step's GEMM, so every count gives
    the same result. Here each step's GEMM runs whole, which makes that
    bit-identity hold by construction (per-chunk CPU GEMMs of a few rows
    round differently). A quantized ``wire`` (see :func:`_ag_ring_lane`)
    gives a bulk all-gather of the per-row-quantized shards."""
    _check_chunks(n_chunks, chunk_dim)
    n, m_loc = x.shape[0], x.shape[1]
    lane = dict(wire=wire, n_chunks=n_chunks, chunk_dim=chunk_dim,
                fault=fault)
    if not bidirectional or n % 2 != 0 or m_loc < 2:
        slots = _ag_ring_lane(x, w, reverse=False, **lane)
    else:
        h_r = (m_loc + 1) // 2
        slots = torch.cat([_ag_ring_lane(x[:, :h_r], w, reverse=False,
                                         **lane),
                           _ag_ring_lane(x[:, h_r:], w, reverse=True,
                                         **lane)],
                          dim=2)
    return slots.flatten(1, 2)


def matmul_reduce_scatter_baseline(x: torch.Tensor,
                                   w: torch.Tensor) -> torch.Tensor:
    """Bulk GEMM+RS: f32 partials summed over ranks in rank order; rank r
    keeps row block r, in x's dtype."""
    r, m = x.shape[0], x.shape[1]
    if m % r:
        raise ValueError(f"GEMM+RS needs m ({m}) divisible by {r}")
    partial = torch.matmul(x.float(), w.float())
    return _rank_sum(partial).to(x.dtype).view(r, m // r, -1)


def pk_matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, *,
                             n_chunks: int = 1, chunk_dim: str = "m",
                             wire: WireFormat | None = None,
                             fault=None) -> torch.Tensor:
    """The GEMM+RS ring of ``repro.core.comms.pk_matmul_reduce_scatter``:
    at step i rank d adds its partial for block (d+1+i) % R to the
    accumulator arriving from rank d+1, so after R-1 hops rank d holds
    block d fully reduced: x (R, m, k_loc), w (R, k_loc, n) -> (R, m/R, n).
    The accumulator travels in x's dtype and each hop's add runs in f32.
    As in ``pk_all_gather_matmul``, the sub-chunks cut independent rows or
    columns, so the partials are computed whole and every count gives the
    same bits. A quantized ``wire`` keeps the accumulator f32 on the rank
    and ships it quantized per row: quantize, shift, then dequantize and
    add as one fused multiply-add (``quant.dequantize_add``), as XLA
    compiles JAX's ring. ``fault`` poisons hop i - 1 of step i after the
    shift (a quantized pair's scales); JAX's travelling chunks are row
    chunks of the block, or its output columns for ``chunk_dim="n"``
    (a quantized wire forces rows)."""
    _check_chunks(n_chunks, chunk_dim)
    n, m = x.shape[0], x.shape[1]
    if m % n:
        raise ValueError(f"ring GEMM+RS needs m ({m}) divisible by {n}")
    m_blk = m // n
    parts = torch.matmul(x.float(), w.float()).view(n, n, m_blk, -1)
    ranks = torch.arange(n, device=x.device)
    if wire is not None:
        starts = _chunk_starts(m_blk, n_chunks, 0, 3)
        gens = _wire_generators(wire, n, 2, x.device)
        acc = parts[ranks, (ranks + 1) % n]
        for i in range(1, n):
            q, sc = _wire_quantize(acc, wire, gens)
            acc = dequantize_add(
                torch.roll(q, -1, 0),
                _poison_hop(fault, i - 1, torch.roll(sc, -1, 0), starts),
                parts.shape[-1], parts[ranks, (ranks + 1 + i) % n])
        return acc.to(x.dtype)
    starts = (_chunk_starts(parts.shape[-1], n_chunks, 1, 2)
              if chunk_dim == "n" else _chunk_starts(m_blk, n_chunks, 0, 2))
    acc = parts[ranks, (ranks + 1) % n].to(x.dtype)
    for i in range(1, n):
        hop = _poison_hop(fault, i - 1, torch.roll(acc, -1, 0), starts)
        acc = (hop.float() + parts[ranks, (ranks + 1 + i) % n]).to(x.dtype)
    return acc


def matmul_all_reduce_baseline(x: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """Bulk GEMM+AR: f32 partials, summed over ranks, in x's dtype."""
    partial = torch.matmul(x.float(), w.float())
    return psum_bulk(partial).to(x.dtype)


def pk_matmul_all_reduce(x: torch.Tensor, w: torch.Tensor, *,
                         n_chunks: int = 1, chunk_dim: str = "m",
                         wire: WireFormat | None = None,
                         fault=None) -> torch.Tensor:
    """The GEMM+AR ring of ``repro.core.comms.pk_matmul_all_reduce``: the
    GEMM+RS ring, then every rank gathers the R reduced blocks. A quantized
    ``wire`` applies to both halves: the gather ships each rank's reduced
    block as one more (int8, scales) pair, dequantized after it. ``fault``
    poisons the RS ring's hops, as in JAX (the gather has none)."""
    rs = pk_matmul_reduce_scatter(x, w, n_chunks=n_chunks,
                                  chunk_dim=chunk_dim, wire=wire, fault=fault)
    if wire is not None:
        q, sc = _wire_quantize(
            rs.float(), wire,
            _wire_generators(wire, x.shape[0], 3, x.device))
        rs = dequantize_blocks(q, sc, rs.shape[-1]).to(rs.dtype)
    out = rs.reshape(-1, rs.shape[2])
    return out.unsqueeze(0).expand(x.shape[0], *out.shape)
