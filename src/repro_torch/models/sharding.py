"""Sharding rules over a ``VirtualMesh`` — the twin of
``repro/models/sharding.py``.

The specs are the JAX package's, entry for entry (``core.pgl.P`` stands in
for ``PartitionSpec``), so the island declarations read the same. Dims are
sharded only when divisible by the axis size, else replicated. Specs here
always carry one entry per tensor dim: ``core.pgl.layout`` tells a global
tensor from its stacked per-rank form by rank. Data-parallel axes of any
size run as dp groups of virtual ranks (``core/pgl.py``), and ``fsdp``
shards every weight's other dim over them as the JAX rules do.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import RunConfig
from repro_torch.core.pgl import P, VirtualMesh, axes_size


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: VirtualMesh
    run: RunConfig

    @property
    def dp(self):  # batch axes
        a = self.run.dp_axes
        return a[0] if len(a) == 1 else a

    @property
    def tp(self) -> str:
        return self.run.tp_axis

    @property
    def fsdp_axes(self):
        return self.dp if self.run.fsdp else None

    def dim(self, size: int, axes):
        """Shard ``size`` over ``axes`` iff divisible, else replicate."""
        if axes is None:
            return None
        if isinstance(axes, str) and axes not in self.mesh.shape:
            return None
        if size % axes_size(self.mesh, axes) == 0:
            return axes
        return None

    def local_batch(self, b: int) -> int:
        if self.dim(b, self.dp) is None:
            return b
        return b // axes_size(self.mesh, self.dp)

    def w2d(self, d_in: int, d_out: int, *, tp_dim: int | None) -> P:
        """(d_in, d_out) weight; ``tp_dim`` says which dim (0/1/None) is TP."""
        f = self.fsdp_axes
        if tp_dim == 0:
            return P(self.dim(d_in, self.tp), self.dim(d_out, f))
        if tp_dim == 1:
            return P(self.dim(d_in, f), self.dim(d_out, self.tp))
        return P(self.dim(d_in, f), None)

    def stacked(self, spec: P) -> P:
        """Prepend the n_periods layer dim (replicated)."""
        return P(None, *spec)

    # --- activations ---

    def act_btd(self) -> P:           # (B, S, d) residual stream
        return P(self.dp, None, None)

    def act_bhsd(self, n_heads: int) -> P:  # (B, H, S, hd) head-sharded
        return P(self.dp, self.dim(n_heads, self.tp), None, None)

    def act_seq_sharded(self) -> P:   # (B, S, d) sequence-parallel
        return P(self.dp, self.tp, None)

    def ssm_cache(self, batch: int) -> P:
        """(B, d_inner, N) + conv (B, d_inner, ck-1): d_inner over tp."""
        return P(self.dim(batch, self.dp), self.tp, None)

    def kv_cache(self, n_kv: int, batch: int, *, long_ctx: bool = False) -> P:
        """(B, Hkv, S_max, hd): batch over dp, seq over tp; with
        ``long_ctx`` (long_500k, batch 1) seq over the dp and tp axes at
        once, flattened dp-major (ROADMAP A8)."""
        if not self.run.decode_seq_shard:
            return P(self.dim(batch, self.dp), self.dim(n_kv, self.tp),
                     None, None)
        if long_ctx:
            return P(None, None, (*self.run.dp_axes, self.tp), None)
        return P(self.dim(batch, self.dp), None, self.tp, None)

    def kv_pool(self, batch: int) -> P:
        """(N_pages, Hkv, page, hd), the paged twin of :meth:`kv_cache`:
        pages over dp iff the batch of ``batch`` slots shards (a slot's
        pages live in its dp group), the page interior over tp. With
        ``decode_seq_shard=False`` no island reads the pool per rank, so it
        is stored unsplit over tp (JAX shards its heads there)."""
        part = self.dp if self.dim(batch, self.dp) is not None else None
        return P(part, None, self.tp if self.run.decode_seq_shard else None,
                 None)
