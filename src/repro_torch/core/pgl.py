"""Parallel Global Layout (PGL) on virtual ranks — paper §3.2.1.

A PGL is a set of identically-shaped buffers, one per rank, that a kernel
addresses by (rank, tile). The JAX package (``repro/core/pgl.py``) stores it
as a mesh-sharded array of global shape ``(axis_size, *local_shape)`` whose
slab d lives on device d. The port keeps exactly that layout as one torch
tensor with a leading rank axis, ``(R, *local_shape)``, on ONE device:

* :class:`VirtualMesh` stands in for ``jax.sharding.Mesh`` — named axes and
  their sizes, plus the torch device every rank's slab lives on;
* :class:`P` stands in for ``PartitionSpec``;
* :func:`layout` / :func:`assemble` convert between a global tensor and its
  stacked ``(R, *local)`` form by a spec (what ``shard_map`` does with
  ``in_specs`` / ``out_specs``);
* :func:`pointer_table` gives the per-rank base pointers a collective kernel
  addresses. On one card they are R slices of one allocation; on a
  multi-GPU node the same kernels take peer pointers instead.

Data-parallel axes (a ``(dp, tp)`` mesh) are emulated as follows. The
batch is split contiguously over the dp ranks, so activations stay global
tensors outside islands and a dp rank's slice is a view of them. An island
over the tp axis runs once per dp group (``core/template.py``): its inputs
are sliced to the group's batch, the body runs on that group's stacked tp
ranks, and the outputs are concatenated back over dp. Parameters keep the
tp-stacked storage of a tp-only mesh: the FSDP (ZeRO-3) shard of dp rank
``i`` is the i-th slice of its tp block along the FSDP dim, so the shards
of all dp ranks together are exactly that storage. An FSDP gather reads the
dp-stacked view of a leaf, ``(R_dp, *shard)``, and writes ``R_dp`` full
copies, ``(R_dp, *stored)`` (the all-gather kernel's ``(n_dev, blk, ...)``
output on every rank); dp group ``g`` computes with copy ``g``. The
gradient of the copies is then ``R_dp`` distinct partials, one per dp
group's batch slice, and its reduce-scatter is a real reduction. On one
card the shards share one allocation, so the ZeRO-3 memory saving does not
show; the gather traffic and the ``R_dp`` transient copies do.
:func:`dp_view` and :func:`dp_slice` give the dp-stacked and per-group
views. Several dp axes (``("pod", "data")``) act as one flattened dp axis,
pod-major: shard ``pod·n_data + data``, as ``P(("pod", "data"))`` orders it
in JAX.

A dim sharded over several axes at once — the long-context decode cache,
whose sequence runs over ``(*dp_axes, tp)`` (ROADMAP A8) — is stored
stacked over the flattened axes, ``(R_dp·R_tp, *local)``: flat rank ``r``
holds the ``r``-th contiguous slice of that dim. :func:`stack_axis` names
the axes a spec's storage stacks over, and every helper here takes a tuple
of axes wherever it takes one axis.
"""

from __future__ import annotations

import math

import torch


class P(tuple):
    """Partition spec: one entry per tensor dim — an axis name, a tuple of
    axis names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class VirtualMesh:
    """Named mesh axes over virtual ranks that share one torch device."""

    def __init__(self, shape, axes, device="cpu"):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             "length")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, device={self.device})"


def axes_size(mesh: VirtualMesh | None, axes) -> int:
    """Product of the named mesh axes (1 for None/empty)."""
    if mesh is None or axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def axis_names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def split_dim(spec: P, mesh: VirtualMesh, axis) -> int | None:
    """The dim ``spec`` shards over ``axis`` — one axis name, or a tuple of
    them flattened in order (None = replicated over it). Entries naming
    other axes only are left to the caller (a dp-sharded dim is sliced per
    dp group before the tp layout); an entry that names ``axis`` together
    with another axis of size > 1, or only some of a tuple ``axis``,
    raises: that dim is stored over other axes than the island runs on."""
    want = axis_names(axis)
    hit = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = axis_names(entry)
        if not set(names) & set(want):
            continue
        live = tuple(a for a in names
                     if a in want or mesh.shape.get(a, 1) != 1)
        if live != want:
            raise NotImplementedError(
                f"dim {i} is sharded over {names}; the island runs over "
                f"{want}")
        hit = i
    return hit


def stack_axis(spec: P, mesh: VirtualMesh, tp: str):
    """The axes a leaf of ``spec`` is stored stacked over: ``tp``, or the
    whole entry where a dim is sharded over ``tp`` and another axis of size
    > 1 at once (the long-context cache's ``(*dp_axes, tp)``)."""
    for entry in spec:
        if entry is None or isinstance(entry, str) or tp not in entry:
            continue
        if any(a != tp and mesh.shape.get(a, 1) != 1 for a in entry):
            return tuple(entry)
    return tp


def dp_dim(spec: P, dp) -> int | None:
    """The dim ``spec`` shards over the dp axes ``dp`` (an axis name or a
    tuple of them, as ``ShardingRules.dp``), None when replicated."""
    for i, entry in enumerate(spec):
        if entry is not None and entry == dp:
            return i
    return None


def dp_slice(x: torch.Tensor, dim: int | None, n_dp: int,
             g: int) -> torch.Tensor:
    """Dp group ``g``'s contiguous slice of ``x`` along ``dim`` (a view);
    ``x`` itself when ``dim`` is None (replicated over dp)."""
    if dim is None:
        return x
    if x.shape[dim] % n_dp:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not "
                         f"divisible by {n_dp} dp ranks")
    return x.unflatten(dim, (n_dp, x.shape[dim] // n_dp)).select(dim, g)


def dp_view(x: torch.Tensor, dim: int, n_dp: int) -> torch.Tensor:
    """The dp-stacked view ``(R_dp, *shard)`` of a stored leaf whose stored
    dim ``dim`` is FSDP-sharded: shard ``i`` is the i-th contiguous slice
    along that dim."""
    if x.shape[dim] % n_dp:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not "
                         f"divisible by {n_dp} dp ranks")
    return x.unflatten(dim, (n_dp, x.shape[dim] // n_dp)).movedim(dim, 0)


def layout(x: torch.Tensor, spec: P, mesh: VirtualMesh, axis, *,
           lead: int = 0, expand: bool = True) -> torch.Tensor:
    """Global tensor -> stacked layout over ``axis``, by ``spec``.

    The rank axis goes after ``lead`` leading dims (0 for island inputs;
    1 for the layer-period dim of stored parameters and caches), so the
    stacked shape is ``(*lead_dims, R, *local)``. A tensor that already
    carries the rank axis (``ndim == len(spec) + 1``) is returned as is:
    weights and KV caches are stored stacked once, so islands never
    re-slice them. A sharded dim becomes a view (``unflatten`` +
    ``movedim``); a replicated tensor is broadcast without a copy
    (``expand``), or left global when ``expand`` is False (storage)."""
    r = axes_size(mesh, axis)
    if x.dim() == len(spec) + 1:
        if x.shape[lead] != r:
            raise ValueError(f"stacked tensor has {x.shape[lead]} ranks, "
                             f"the mesh axis {axis!r} has {r}")
        return x
    if x.dim() != len(spec):
        raise ValueError(f"spec {spec} does not fit shape {tuple(x.shape)}")
    d = split_dim(spec, mesh, axis)
    if d is None:
        if not expand:
            return x
        if lead:
            raise ValueError("replicated inputs expand with lead=0 only")
        return x.unsqueeze(0).expand(r, *x.shape)
    if d < lead:
        raise ValueError(f"spec {spec} shards a leading dim")
    if x.shape[d] % r:
        raise ValueError(f"dim {d} of shape {tuple(x.shape)} is not "
                         f"divisible by {r} ranks")
    return x.unflatten(d, (r, x.shape[d] // r)).movedim(d, lead)


def assemble(x: torch.Tensor, spec: P, mesh: VirtualMesh, axis, *,
             lead: int = 0) -> torch.Tensor:
    """Stacked -> global tensor, by ``spec`` (the inverse of
    :func:`layout`): a sharded dim is concatenated over the ranks; a
    replicated stacked result is rank 0's slab (the body made every slab
    equal); a replicated tensor stored global is returned as is."""
    d = split_dim(spec, mesh, axis)
    if d is None:
        return x.select(lead, 0) if x.dim() == len(spec) + 1 else x
    return x.movedim(lead, d).flatten(d, d + 1)


def stacked_shape(shape, spec: P, mesh: VirtualMesh, axis, *,
                  lead: int = 0) -> tuple[int, ...]:
    """Shape of the stored layout of a global ``shape``: stacked when
    ``spec`` shards it over ``axis``, global when it is replicated."""
    d = split_dim(spec, mesh, axis)
    if d is None:
        return tuple(shape)
    r = axes_size(mesh, axis)
    out = list(shape)
    out[d] //= r
    return (*out[:lead], r, *out[lead:])


#: the row alignment a tensor map takes (TMA: row strides of 16 bytes)
ROW_ALIGN_BYTES = 16


def aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its rows (last dim) are contiguous and a multiple
    of 16 bytes long; else a copy in a buffer whose rows are padded with
    zeros to 16 bytes, seen at ``x``'s shape. The stored layout of a leaf
    the GEMM reads through a tensor map (a vocab shard of 12967 columns),
    so that no call copies it."""
    per = ROW_ALIGN_BYTES // x.element_size()
    n = x.shape[-1] if x.dim() else 0
    if x.dim() < 2 or (n % per == 0 and x.is_contiguous()):
        return x
    buf = x.new_zeros(*x.shape[:-1], -(-n // per) * per)
    buf[..., :n] = x
    return buf[..., :n]


def padded_rows(x: torch.Tensor) -> bool:
    """Is ``x`` seen in a buffer of longer rows that holds their padding
    (an :func:`aligned_rows` leaf or a slice of its rows)?"""
    if x.dim() < 2 or x.stride(-1) != 1 or x.stride(-2) <= x.shape[-1]:
        return False
    end = x.storage_offset() + sum((n - 1) * st for n, st in
                                   zip(x.shape, x.stride())) \
        + x.stride(-2) - x.shape[-1]
    return end < x.untyped_storage().nbytes() // x.element_size()


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """A :func:`padded_rows` tensor seen with its rows' padding: shape
    ``(..., x.stride(-2))``, the same strides."""
    return x.as_strided((*x.shape[:-1], x.stride(-2)), x.stride(),
                        x.storage_offset())


def is_split(spec: P, mesh: VirtualMesh | None, axis) -> bool:
    """Does ``spec`` shard a dim over ``axis`` on this mesh?"""
    if mesh is None or axis is None or axes_size(mesh, axis) == 1:
        return False
    return split_dim(spec, mesh, axis) is not None


def pointer_table(x: torch.Tensor) -> list[int]:
    """Per-rank base addresses of a stacked ``(R, *local)`` tensor: the
    addresses a collective kernel stores into and reads from. The slabs
    must be contiguous (each rank's buffer is one dense block)."""
    if not x.is_contiguous():
        raise ValueError("a PGL buffer must be contiguous")
    step = x[0].numel() * x.element_size()
    return [x.data_ptr() + i * step for i in range(x.shape[0])]
