"""Unified PK island template on virtual ranks — the twin of
``repro/core/template.py``.

An :class:`Island` is declared exactly as in the JAX package: named inputs
with partition specs, out_specs, a body ``body(ctx, **inputs)`` receiving a
ready :class:`~repro_torch.core.comms.CommContext`, a dense reference, a
fallback predicate and an optional :class:`Comm` descriptor for
:meth:`Island.plan`. What ``shard_map`` does there, ``Island.__call__``
does here over the stacked rank axis of ``core/pgl.py``:

1. each input is laid out as ``(R, *local)`` by its spec (a tensor already
   stored stacked — weights, KV caches — passes through untouched);
2. the body runs ONCE on the stacked tensors; collectives inside it act on
   dim 0 and ``lax.axis_index`` becomes :func:`rank_index`;
3. outputs are reassembled by ``out_specs``; an out spec wrapped in
   :class:`Stacked` is returned as ``(R, *local)`` (the KV cache stays
   stored per rank).

On a mesh whose dp axis is larger than 1 the island runs once per dp
group (``core/pgl.py``): each :class:`Gather` input is first all-gathered
over the FSDP axes by :func:`fsdp_gather` — ``CommContext.all_gather``
over the dp axis, so ``RunConfig.comm_backend`` decides bulk or the fused
ring kernel, as JAX's ``maybe_allgather`` runs inside ``shard_map`` — then
group g takes its slice of every dp-sharded input and copy g of every
gathered weight, and the groups' outputs are concatenated over dp. The
gather's autograd backward is the reduce-scatter of the copies' gradients.
An input stored stacked (a KV cache, a page pool) whose spec shards a dim
over dp is sliced along that dim after its rank axis, and a
:class:`Stacked` output is joined there: group g's KV cache rows, or its
partition of a page pool. An island whose axis takes in the dp axes
(:attr:`Island.spans_dp`) is the exception: it runs once over all their
ranks. An output marked :class:`Summed` is a partial
every dp group computes of the whole: the groups' outputs are summed in dp
order (JAX's ``psum`` / ``psum_scatter`` over the dp axes). Under
``RunConfig.comm_policy="measured"`` an island's context dispatches as its
:attr:`Island.island_key` and :meth:`Island.plan` reports measured
decisions (``source="measured"``) from the calibration table.

Runtime health (``runtime/health.py``): with ``RunConfig.island_guards``
each island that runs on its ranks checks, at its boundary, that every
float tensor it took in and gave back is finite. JAX sends the verdict to
the host through an asynchronous ``jax.debug.callback``; a host read at
every island of every layer would stall the card's queue, so here the
verdict stays on the device: each island adds its trips to its slot of
one int32 counter vector a device, and :func:`take_guard_trips` reads
every counter in one copy, once an engine step, beside the tokens the
engine reads back anyway. ``RunConfig.comm_fault`` (``(kind, island, hop)``, set
by the serving engine while a scripted corrupt or bitflip fault is
active) reaches the target island's ``CommContext.fault`` (``"*"``
targets every island). An island's input may be a tree of tensors
(dicts, lists, tuples) under one spec, or under a parallel tree of specs.
Each call is the span ``island.<name>`` of ``core/trace.py``, over the
dp-group loop, the fallback and the guard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import pgl, trace
from repro_torch.core.autotune import island_key as _island_key
from repro_torch.core.comms import GEMM_OP_KIND, OP_BACKENDS, CommContext
from repro_torch.core.pgl import P
from repro_torch.core.quant import tree_map
from repro_torch.core.schedule import a2a_chunk_axis

__all__ = ["Island", "Gather", "Comm", "IslandPlan", "Stacked", "Summed",
           "comm_context", "render_plans", "plan_overrides",
           "island_override", "rank_index", "fsdp_gather", "dp_groups",
           "record_guard_trip", "take_guard_trips"]


# ---------------------------------------------------------------------------
# Island boundary guards (RunConfig.island_guards). A trip is counted on the
# device, in the island's slot of its device's counter vector; the serving
# engine drains the counters once a step (the fleet steps its replicas one
# after another, so the plain dicts need no lock). runtime.health
# re-exports the drain.
# ---------------------------------------------------------------------------

#: trips counted on the host by ``record_guard_trip``: island -> count
_GUARD_TRIPS: dict[str, int] = {}
#: island -> its slot in every device's counter vector
_GUARD_SLOTS: dict[str, int] = {}
#: device -> int32 trip counters, one slot an island
_GUARD_FLAGS: dict[torch.device, torch.Tensor] = {}


def record_guard_trip(island: str, ok) -> None:
    """Count a trip of ``island`` on the host when ``ok`` is false (JAX's
    callback target; a tensor ``ok`` is read here)."""
    if not bool(ok):
        _GUARD_TRIPS[island] = _GUARD_TRIPS.get(island, 0) + 1


def _guard_counter(island: str, device: torch.device) -> torch.Tensor:
    """The island's counter slot on ``device``, a (1,) int32 view."""
    slot = _GUARD_SLOTS.setdefault(island, len(_GUARD_SLOTS))
    flags = _GUARD_FLAGS.get(device)
    if flags is None or flags.numel() <= slot:
        grown = torch.zeros(max(64, 2 * (slot + 1)), dtype=torch.int32,
                            device=device)
        if flags is not None:
            grown[:flags.numel()].copy_(flags)
        _GUARD_FLAGS[device] = flags = grown
    return flags.narrow(0, slot, 1)


def take_guard_trips() -> dict[str, int]:
    """Drain the guard trips: {island: trips since the last drain}. Each
    device's counters are read in one copy (a host sync) and zeroed."""
    out = dict(_GUARD_TRIPS)
    _GUARD_TRIPS.clear()
    names = {slot: name for name, slot in _GUARD_SLOTS.items()}
    for flags in _GUARD_FLAGS.values():
        counts = flags.tolist()
        if not any(counts):
            continue
        flags.zero_()
        for slot, n in enumerate(counts):
            if n:
                out[names[slot]] = out.get(names[slot], 0) + n
    return out


def _map_input(fn, a, spec):
    """``fn(tensor, spec)`` over an island input's tensors: one spec for
    every leaf of its tree, or a tree of specs parallel to it."""
    if isinstance(spec, P):
        return tree_map(
            lambda t: fn(t, spec) if isinstance(t, torch.Tensor) else t, a)
    return tree_map(
        lambda t, s: fn(t, s) if isinstance(t, torch.Tensor) else t, a, spec)


def _float_leaves(tree, acc: list) -> list:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and tree.numel():
            acc.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _float_leaves(v, acc)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _float_leaves(v, acc)
    return acc


def _boundary_guard(name: str, args, out) -> None:
    """One finite check over every float tensor of an island's inputs and
    outputs (JAX ``_boundary_guard``): each tensor's min and max (NaN
    propagates through both, an infinity reaches one), then one all-finite
    verdict added to the island's device counter. Nothing is read back."""
    leaves = _float_leaves((args, out), [])
    if not leaves:
        return
    with torch.no_grad():
        ext = torch.stack([v.float() for t in leaves
                           for v in torch.aminmax(t.detach())])
        bad = torch.isfinite(ext).all().logical_not().to(torch.int32)
        _guard_counter(name, ext.device).add_(bad)


def comm_context(run, axis: str, mesh=None, **overrides) -> CommContext:
    """The single CommContext construction point for every island."""
    kw: dict[str, Any] = {"axis_name": axis, "mesh": mesh}
    if run is not None:
        kw.update(backend=run.comm_backend, allow_bidir=run.pk_bidirectional,
                  policy=run.comm_policy, calibration=run.calibration_path,
                  chunks=run.comm_chunks, wire=run.comm_wire)
    kw.update(overrides)
    return CommContext(**kw)


def rank_index(x: torch.Tensor) -> torch.Tensor:
    """``lax.axis_index`` on a stacked tensor: ``arange(R)``, shape (R,)."""
    return torch.arange(x.shape[0], device=x.device)


def dp_groups(rules) -> tuple[Any, int]:
    """(dp axes, their size) of ``rules``' mesh; (None, 1) without one."""
    if rules is None:
        return None, 1
    return rules.dp, pgl.axes_size(rules.mesh, rules.dp)


def fsdp_gather(w: torch.Tensor, spec: P, rules, run, *,
                dim: int) -> torch.Tensor | None:
    """FSDP (ZeRO-3) weight gather — the twin of JAX's ``maybe_allgather``.

    ``w`` is a stored leaf of one layer (tp-stacked ``(R_tp, *local)`` when
    ``spec`` shards it over tp, else global) whose global dim ``dim`` the
    spec shards over ``rules.fsdp_axes``. Returns its ``(R_dp, *stored)``
    full copies, one per dp group, all-gathered by the dp axis' context
    (``run.comm_backend`` picks bulk or the fused ring kernel); None when
    the leaf is not FSDP-sharded or the dp axis has size 1 (nothing to
    gather). Each copy is laid out as the full weight: a leaf stacked over
    a tp-sharded dim other than its first keeps the tp rank dim next to
    that dim in memory, so every copy is the global weight, contiguous,
    seen stacked — what ``_col_proj``'s matmul reads in place (it would
    copy a stacked-contiguous one). A leaf stored with padded rows
    (``pgl.aligned_rows``: the head) is gathered with its rows' padding, so
    that each copy keeps the 16-byte rows the GEMM's tensor maps read.
    Several dp axes gather as one flattened axis, pod-major
    (``core/pgl.py``)."""
    if rules is None or rules.fsdp_axes is None \
            or spec[dim] != rules.fsdp_axes:
        return None
    f = rules.fsdp_axes
    n_dp = pgl.axes_size(rules.mesh, f)
    if n_dp == 1:
        return None
    stacked = w.dim() == len(spec) + 1
    sdim = dim + 1 if stacked else dim
    t = pgl.split_dim(spec, rules.mesh, rules.tp) if stacked else None
    order = (*range(1, t + 1), 0, *range(t + 1, len(spec) + 1)) if t \
        else None
    ctx = comm_context(run, f, mesh=rules.mesh)
    n = w.shape[-1]
    whole = sdim != w.dim() - 1 and pgl.padded_rows(w)
    if whole:
        w = _WholeRows.apply(w)
    # the stacked call stands for one gather a tp rank (a tp-stacked
    # leaf's slab, or a replicated leaf's copy): the comm trace's lanes
    r_tp = pgl.axes_size(rules.mesh, rules.tp)
    out = ctx.all_gather(pgl.dp_view(w, sdim, n_dp), axis=sdim, order=order,
                         lanes=r_tp, split=r_tp if stacked else 1)
    return out[..., :n] if whole else out


class _WholeRows(torch.autograd.Function):
    """A padded-rows leaf seen with its padding (``pgl.whole_rows``); the
    padding's gradient is dropped."""

    @staticmethod
    def forward(ctx, w):
        ctx.n = w.shape[-1]
        return pgl.whole_rows(w)

    @staticmethod
    def backward(ctx, g):
        return g[..., :ctx.n]


@dataclasses.dataclass(frozen=True)
class Gather:
    """FSDP all-gather instruction for one island input: gather ``dim`` back
    to ``size`` over the fsdp axes before the body runs."""
    dim: int
    size: int


@dataclasses.dataclass(frozen=True)
class Stacked:
    """Out spec marker: return this output as stacked ``(R, *local)``
    instead of reassembling the global tensor."""
    spec: P


@dataclasses.dataclass(frozen=True)
class Summed:
    """Out spec marker: on a dp > 1 mesh each dp group's output is a
    partial of the global tensor ``spec`` describes, and the groups'
    outputs are summed in dp order (the sum over the dp axes that JAX's
    body runs as a ``psum_scatter``)."""
    spec: P


@dataclasses.dataclass(frozen=True)
class Comm:
    """An island's dominant collective, for :meth:`Island.plan`."""
    op: str
    m: int = 0
    n: int = 0
    k: int = 0
    payload_bytes: float = 0.0
    dtype_bytes: int = 2
    n_chunks: int | None = None
    chunk_dim: str | None = None
    backend: str | None = None
    #: an all-to-all's local payload shape and axes, so plan() fits the
    #: chunk count to the splittable bystander dims as the runtime does
    shape: tuple[int, ...] | None = None
    split_axis: int | None = None
    concat_axis: int | None = None
    #: where a declared n_chunks came from ("plan" for a frozen override,
    #: "analytic" for the chunk policy); plan() reports it
    source: str | None = None


@dataclasses.dataclass(frozen=True)
class IslandPlan:
    """Trace-free overlap report for one island (paper §3.1.3 decision)."""
    island: str
    axis: Any
    axis_size: int
    fallback: bool
    reason: str
    op: str | None = None
    backend: str | None = None
    n_chunks: int | None = None
    chunk_dim: str | None = None
    hidden_fraction: float | None = None
    source: str = "analytic"
    wire: str | None = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        if self.fallback:
            return f"{self.island:<14} -> dense fallback ({self.reason})"
        hf = ("-" if self.hidden_fraction is None
              else f"{self.hidden_fraction:.2f}")
        return (f"{self.island:<14} op={self.op or '-':<22} "
                f"backend={self.backend or '-':<10} "
                f"chunks={self.n_chunks or 1:<3} hidden={hf:<5} "
                f"wire={self.wire or '-':<8} src={self.source}")


def render_plans(plans: Sequence[IslandPlan]) -> str:
    """One-line-per-island overlap schedule table."""
    head = "island         overlap schedule (backend / chunks / hidden frac)"
    return "\n".join([head, "-" * len(head)] + [str(p) for p in plans])


def plan_overrides(plans: Sequence[IslandPlan]) -> tuple:
    """Freeze resolved plans into ``RunConfig.island_overrides`` entries:
    ``(island, backend, sub-chunks per ring step)`` for GEMM×collective
    islands, ``(island, backend, total chunks)`` for all-to-all islands,
    ``(island, backend, None)`` for the others."""
    out = []
    for p in plans:
        if p.fallback or p.backend is None:
            continue
        chunks = None
        if (p.op in GEMM_OP_KIND and p.n_chunks
                and p.backend in ("ring", "ring_bidir", "fused")):
            chunks = max(1, p.n_chunks // max(p.axis_size, 1))
        elif p.op == "all_to_all":
            chunks = p.n_chunks
        out.append((p.island, p.backend, chunks))
    return tuple(out)


def island_override(run, name: str) -> tuple | None:
    """The ``(backend, chunks, source)`` override ``run.island_overrides``
    carries for island ``name`` (later entries win), or None."""
    entries = getattr(run, "island_overrides", ()) if run is not None else ()
    hit = None
    for entry in entries:
        if entry and entry[0] == name:
            hit = (entry[1], entry[2] if len(entry) > 2 else None,
                   entry[3] if len(entry) > 3 else "plan")
    return hit


def _map_specs(fn, specs, outs):
    """Apply ``fn(out, spec)`` over an out_specs tree (a spec or a tuple)."""
    if isinstance(specs, tuple) and not isinstance(specs, P):
        return tuple(_map_specs(fn, s, o) for s, o in zip(specs, outs))
    return fn(outs, specs)


def _join_groups(specs, outs: list, dp):
    """Concatenate the dp groups' outputs over each out spec's dp-sharded
    dim (group 0's output when the spec replicates it over dp); a
    :class:`Stacked` output that carries its rank axis is joined along that
    dim after the rank axis."""
    if isinstance(specs, tuple) and not isinstance(specs, P):
        return tuple(_join_groups(s, [o[i] for o in outs], dp)
                     for i, s in enumerate(specs))
    if isinstance(specs, Summed):
        acc = outs[0]
        for o in outs[1:]:
            acc = acc + o
        return acc
    spec = specs.spec if isinstance(specs, Stacked) else specs
    d = pgl.dp_dim(spec, dp)
    if d is None:
        return outs[0]
    return torch.cat(outs, dim=d + (outs[0].dim() - len(spec)))


class Island:
    """One declarative overlapped island over virtual ranks (see module
    docstring). Construction is cheap; ``plan()`` runs nothing."""

    def __init__(self, name: str, *, body: Callable | None = None,
                 inputs: Mapping[str, Any] | None = None,
                 out_specs: Any = None,
                 rules=None, mesh=None, axis=None, run=None,
                 reference: Callable | None = None,
                 gathers: Mapping[str, Gather] | None = None,
                 enable: bool = True,
                 divisible: Sequence[tuple[int, Any]] = (),
                 fallback_axes: Any = None,
                 comm: Comm | None = None):
        self.name = name
        self.rules = rules
        self.mesh = mesh if mesh is not None else (
            rules.mesh if rules is not None else None)
        self.axis = axis if axis is not None else (
            rules.tp if rules is not None else None)
        self.run = run
        self.body = body
        self.inputs = dict(inputs or {})
        self.out_specs = out_specs
        self.reference = reference
        self.gathers = dict(gathers or {})
        self.enable = enable
        self.divisible = tuple(divisible)
        self.fallback_axes = fallback_axes if fallback_axes is not None \
            else self.axis
        self.comm = comm

    # -- fallback predicate ------------------------------------------------

    @property
    def axis_size(self) -> int:
        return pgl.axes_size(self.mesh, self.axis)

    def fallback_reason(self) -> str | None:
        """Why this island routes to the dense reference (None = it runs on
        the stacked ranks): reference mode, single device, divisibility."""
        if self.mesh is None:
            return "no mesh (single-process reference mode)"
        if self.run is not None and self.run.reference_mode:
            return "RunConfig.reference_mode"
        if not self.enable:
            return "disabled by RunConfig"
        if self.mesh.size == 1:
            return "single-device mesh"
        if pgl.axes_size(self.mesh, self.fallback_axes) == 1:
            return f"axis {self.fallback_axes!r} has size 1"
        for size, axes in self.divisible:
            n = pgl.axes_size(self.mesh, axes)
            if n and size % n != 0:
                return (f"size {size} not divisible by axis {axes!r} "
                        f"(= {n})")
        return None

    # -- execution ---------------------------------------------------------

    @property
    def island_key(self) -> str | None:
        """The calibration-row key this island dispatches as (None without a
        ``Comm``): ``autotune.island_key(name, op, dtype)``. ``calibrate
        --per-island`` tags measured rows with it; the context built below
        prefers those rows over the global shape grid."""
        if self.comm is None:
            return None
        return _island_key(self.name, self.comm.op, self.comm.dtype_bytes)

    def make_context(self) -> CommContext:
        """The island's CommContext: ``RunConfig`` knobs and its island key,
        then this island's frozen plan (``island_overrides``) as backend pin
        and chunk default, the scripted payload fault of
        ``RunConfig.comm_fault`` when it targets this island, then a
        declared ``Comm.n_chunks`` unless ``comm_chunks`` is set."""
        kw: dict[str, Any] = {"island": self.island_key}
        ov = island_override(self.run, self.name)
        if ov is not None:
            be, chunks, _src = ov
            if be is not None:
                kw.setdefault("backend", be)
            if (chunks is not None and self.comm is not None
                    and self.comm.op in GEMM_OP_KIND):
                kw.setdefault("chunks", chunks)
        ft = self.run.comm_fault if self.run is not None else None
        if ft is not None and ft[1] in ("*", self.name):
            kw.setdefault("fault", (ft[0], ft[2] if len(ft) > 2 else 0))
        if (self.comm is not None and self.comm.n_chunks is not None
                and self.comm.op in GEMM_OP_KIND
                and (self.run is None or self.run.comm_chunks is None)):
            kw.setdefault("chunks", self.comm.n_chunks)
        return comm_context(self.run, self.axis, mesh=self.mesh, **kw)

    def _global(self, x, spec):
        """An input as the dense reference expects it: global (a tensor
        stored stacked over an axis of size 1 too)."""
        def one(t, s):
            if t.dim() == len(s) + 1 \
                    and pgl.split_dim(s, self.mesh, self.axis) is not None:
                return pgl.assemble(t, s, self.mesh, self.axis)
            return t
        return _map_input(one, x, spec)

    def __call__(self, **arrays):
        with trace.span("island", self.name):
            out = self._call(arrays)
            if self.run is not None and self.run.island_guards \
                    and self.fallback_reason() is None:
                # at the island's boundary: one check covers its logical
                # inputs and outputs, whatever the backend
                _boundary_guard(self.name, arrays, out)
        return out

    @property
    def spans_dp(self) -> bool:
        """Does the island's axis take in the dp axes? Then it runs once
        over all their ranks, not once per dp group: the long-context
        decode island over ``(*dp_axes, tp)`` (ROADMAP A8), the one island
        that does."""
        dp, n_dp = dp_groups(self.rules)
        if n_dp == 1 or self.axis is None or isinstance(self.axis, str):
            return False
        return set(pgl.axis_names(dp)) <= set(self.axis)

    def _call(self, arrays):
        dp, n_dp = dp_groups(self.rules)
        if n_dp == 1 or self.spans_dp:
            return self._run(arrays)
        copies = {}
        for n, g in self.gathers.items():
            if n in arrays and n in self.inputs:
                c = fsdp_gather(arrays[n], self.inputs[n], self.rules,
                                self.run, dim=g.dim)
                if c is not None:
                    # unbind: its backward stacks the groups' gradients in
                    # one copy (indexing would zero-fill and add per group)
                    copies[n] = c.unbind(0)
        outs = []
        for gi in range(n_dp):
            grp = {}
            for n, a in arrays.items():
                if n in copies:
                    grp[n] = copies[n][gi]
                    continue
                spec = self.inputs.get(n, P())
                d = pgl.dp_dim(spec, dp) if isinstance(a, torch.Tensor) \
                    else None
                if d is not None and a.dim() == len(spec) + 1:
                    d += 1               # stored stacked: after the rank axis
                grp[n] = pgl.dp_slice(a, d, n_dp, gi)
            outs.append(self._run(grp))
        return _join_groups(self.out_specs, outs, dp)

    def _run(self, arrays):
        """The island on one dp group's inputs (see the module docstring)."""
        reason = self.fallback_reason()
        if set(arrays) != set(self.inputs) and reason is None:
            raise TypeError(
                f"island {self.name!r} declared inputs "
                f"{sorted(self.inputs)}, got {sorted(arrays)}")
        if reason is not None:
            if self.reference is None:
                raise ValueError(
                    f"island {self.name!r} must fall back ({reason}) but "
                    "declares no dense reference")
            if self.mesh is None:
                return self.reference(**arrays)
            # stacked inputs -> global for the reference; outputs marked
            # Stacked go back to the per-rank layout the caller stores (a
            # spec that replicates them over the axis keeps them global)
            out = self.reference(**{
                n: self._global(a, self.inputs.get(n, P()))
                for n, a in arrays.items()})
            return _map_specs(
                lambda o, s: (pgl.layout(o, s.spec, self.mesh, self.axis,
                                         expand=False).contiguous()
                              if isinstance(s, Stacked) else o),
                self.out_specs, out)
        ctx = self.make_context()
        stacked = {n: _map_input(
            lambda t, s: pgl.layout(t, s, self.mesh, self.axis), a,
            self.inputs[n]) for n, a in arrays.items()}
        out = self.body(ctx, **stacked)
        return _map_specs(
            lambda o, s: (o if isinstance(s, Stacked) else pgl.assemble(
                o, s.spec if isinstance(s, Summed) else s, self.mesh,
                self.axis)),
            self.out_specs, out)

    # -- introspection -----------------------------------------------------

    def _measured_hidden(self, ctx: CommContext, backend: str,
                         kind: str) -> float | None:
        """Measured hidden fraction for the chosen backend, or None.

        On a calibrated mesh the bulk row is the serial GEMM-then-collective
        baseline and the ring (or fused) row the overlapped schedule, so the
        time saved over bulk IS the hidden communication: ``(us_bulk -
        us_overlapped) / t_comm`` clamped to [0, 1], ``t_comm`` priced on the
        calibrated spec. A measured bulk decision reports 0.0. Both sides of
        the delta come from one tier — the island's rows, else the global
        grid. None leaves the plan on the analytic prediction."""
        if backend not in ("bulk", "ring", "ring_bidir", "fused"):
            return None
        table = ctx.active_calibration()
        if table is None or self.comm is None:
            return None
        c = self.comm
        n_dev = self.axis_size
        ring_be = backend if backend != "bulk" else "ring"
        tiers: list[dict[str, Any]] = []
        if self.island_key is not None:
            tiers.append({"island": self.island_key, "island_only": True})
        tiers.append({"island": None})
        us_ov = us_bulk = None
        for sel in tiers:
            kw: dict[str, Any] = dict(axis_size=n_dev,
                                      dtype_bytes=c.dtype_bytes, **sel)
            us_ov = table.measured_us(c.op, ring_be, c.m, c.n, c.k, **kw)
            us_bulk = table.measured_us(c.op, "bulk", c.m, c.n, c.k, **kw)
            if us_ov is not None and us_bulk is not None:
                break
        if us_ov is None or us_bulk is None:
            return None
        if backend == "bulk":
            return 0.0          # nothing overlaps, by measurement
        # a quantized wire shrinks the denominator to what the ring ships
        fmt = ctx.wire_format()
        elem_bytes = (fmt.bytes_per_element if fmt is not None
                      else c.dtype_bytes)
        shard = (cm.collective_tensor_bytes(c.m, c.n, c.k, 1, kind)
                 * elem_bytes / max(n_dev, 1))
        t_comm_us = cm.transfer_cost(
            cm.ring_collective_bytes(shard, n_dev, kind),
            ctx.effective_hw(),
            links=2 if backend == "ring_bidir" else 1) * 1e6
        if t_comm_us <= 0:
            return None
        return max(0.0, min(1.0, (us_bulk - us_ov) / t_comm_us))

    def plan(self) -> IslandPlan:
        """The trace-free §3.1.3 decision this island will make: backend,
        chunk count, hidden fraction (measured on a calibrated mesh, else
        predicted) — or the fallback reason."""
        reason = self.fallback_reason()
        base = IslandPlan(self.name, self.axis, self.axis_size,
                          fallback=reason is not None,
                          reason=reason or "",
                          op=self.comm.op if self.comm else None)
        if reason is not None or self.comm is None:
            return base
        c = self.comm
        ctx = self.make_context()
        if c.op in GEMM_OP_KIND:
            n_dev = self.axis_size
            ring_ok = c.op == "all_gather_matmul" or c.m % n_dev == 0
            m_loc = c.m // n_dev if c.m % n_dev == 0 else c.m
            fused_ok = ctx._prefer_fused()
            if c.backend is not None:
                # a call-site pin is enforced by the runtime: a shape
                # violation raises there rather than degrading
                backend = c.backend
                reason = f"pinned backend={c.backend}" if ring_ok or \
                    backend == "bulk" else (
                        f"pinned backend={c.backend} violates m % axis == 0 "
                        "— the runtime raises ValueError for this call")
            elif ctx.backend in OP_BACKENDS.get(c.op, ()):
                backend = ctx.backend
                if backend != "bulk" and not ring_ok:
                    backend = "bulk"
                elif (backend == "ring_bidir" and n_dev % 2 == 0
                        and m_loc < 2):
                    backend = "ring"
                reason = f"context pin -> {backend}"
            elif not ring_ok:
                backend = "bulk"
                reason = f"m={c.m} not divisible by axis size {n_dev} -> bulk"
            else:
                backend = ctx.auto_gemm_backend(
                    c.op, c.m, c.n, c.k, dtype_bytes=c.dtype_bytes,
                    fused_ok=fused_ok, bidir_ok=(m_loc >= 2))
                reason = None
            pol = ctx.gemm_policy(c.m, c.n, c.k, kind=GEMM_OP_KIND[c.op],
                                  dtype_bytes=c.dtype_bytes)
            if backend in ("ring", "ring_bidir", "fused"):
                sched = ctx.gemm_chunk_schedule(
                    c.op, c.m, c.n, c.k, backend=backend,
                    dtype_bytes=c.dtype_bytes, chunk_dim=c.chunk_dim)
                n_chunks = n_dev * sched.n_chunks
                chunk_dim = sched.chunk_dim
                hidden = pol.hidden_fraction
                source = "measured" if sched.source == "measured" \
                    else "analytic"
            else:
                n_chunks = c.n_chunks if c.n_chunks is not None else 1
                chunk_dim, hidden, source = None, 0.0, "analytic"
            meas = self._measured_hidden(ctx, backend, GEMM_OP_KIND[c.op])
            if meas is not None:
                hidden, source = meas, "measured"
            ov = island_override(self.run, self.name)
            if ov is not None and ov[2] == "health" and ov[0] == backend:
                # a HealthMonitor demotion is the decision on record,
                # layered above the plan and measured dispatch
                source = "health"
                reason = f"health demotion -> {backend}"
            # only the rings ship a quantized wire; bulk and fused carry
            # full precision whatever the config says
            fmt = ctx.wire_format()
            wire = None
            if backend in ("ring", "ring_bidir"):
                wire = fmt.name if fmt is not None else "bf16"
            return dataclasses.replace(
                base, backend=backend, n_chunks=n_chunks,
                chunk_dim=chunk_dim, hidden_fraction=hidden,
                source=source, wire=wire,
                reason=reason if reason is not None else pol.reason)
        if c.op == "all_to_all":
            # the island's constructor resolved the count and its source
            # (Ulysses: ulysses_chunks, a frozen plan or the policy)
            n_chunks = c.n_chunks
            if n_chunks > 1:
                # the runtime's bystander-dim fit: never report a chunking
                # it would bulk away
                fit = a2a_chunk_axis(c.shape, c.split_axis, c.concat_axis,
                                     n_chunks)
                n_chunks = fit[1] if fit is not None else 1
            backend = c.backend or ("chunked" if n_chunks > 1 else "bulk")
            if backend == "chunked" and n_chunks <= 1:
                backend = "bulk"
            return dataclasses.replace(
                base, backend=backend, n_chunks=n_chunks,
                hidden_fraction=1.0 - 1.0 / n_chunks if n_chunks > 1
                else 0.0, source=c.source or "analytic",
                reason=f"a2a chunk policy -> {n_chunks} chunks")
        backend = c.backend
        if backend is None and ctx.backend in OP_BACKENDS.get(c.op, ()):
            backend = ctx.backend
        backend = backend or "bulk"
        n_chunks = c.n_chunks if c.n_chunks is not None else (
            self.axis_size if backend != "bulk" else 1)
        return dataclasses.replace(
            base, backend=backend, n_chunks=n_chunks,
            reason=f"{c.op} via {backend}")

    def __repr__(self) -> str:
        return (f"Island({self.name!r}, axis={self.axis!r}, "
                f"inputs={list(self.inputs)}, "
                f"fallback={self.fallback_reason()!r})")
