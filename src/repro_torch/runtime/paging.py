"""Paged KV-cache subsystem: page pool geometry, allocator, prefix sharing —
the twin of ``repro/runtime/paging.py``.

The slab cache (``models/transformer.cache_template``) gives every slot a
dense ``padded_s_max`` strip, so memory — not compute — caps concurrent
users. The paged layout replaces the per-slot strips with one fixed pool of
``page_size``-token pages plus a per-slot block table mapping logical pages
to physical ones:

* **Pool**: per attention layer, ``(n_periods, n_pages, Hkv, page, hd)``
  global. The page *interior* is striped over the tp axis exactly like the
  slab's sequence dim (``page`` is rounded up to a multiple of |tp|): the
  port stores it stacked (``core/pgl.py``), ``(n_periods, R, n_pages, Hkv,
  page/R, hd)``, rank r holding cells ``[r·s_loc, (r+1)·s_loc)`` of every
  page, as it holds the slab's sequence stripe. The *page* dim is
  partitioned over the dp axes whenever the slot batch is: dp group ``d``
  owns the contiguous id range ``[d*ppp, (d+1)*ppp)`` and serves its local
  slots from it. With head-sharded caches (``decode_seq_shard=False``) no
  island reads the pool per rank, and it is stored global.
* **Block tables**: ``(batch, pages_per_slot)`` int32 of **global** page
  ids; ``-1`` marks an unmapped logical page. A free or mid-prefill slot's
  row is all ``-1`` and every decode-step write against it is dropped —
  what lets decode ticks interleave between a long prompt's prefill chunks
  without touching pages the chunk program is still filling.
* **Allocator**: host-side free list per partition with refcounted pages.
  Admission allocates the full ``ceil((L + max_new) / page)`` span up front
  (no mid-decode allocation, no preemption); exhaustion shows as admission
  backpressure, not an error.
* **Prefix sharing**: completed prefills register ``(prompt, pages)`` in a
  small per-partition registry. A later prompt sharing a prefix retains the
  donor's full pages (refcount++, no copy) and copies the boundary page on
  write; only positions ``>= write_from`` are (re)written, which is sound
  because causal attention makes K/V at position t a pure function of
  ``tokens[:t+1]``. Registry pages are released lazily, when allocation
  needs them.
"""

from __future__ import annotations

import dataclasses
import heapq

from repro_torch.compat import DTYPES
from repro_torch.configs.base import ArchConfig, RunConfig, ServeConfig
from repro_torch.core.pgl import P, axes_size
from repro_torch.models.sharding import ShardingRules


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Resolved paged-pool shape: all sizes already padded for the mesh."""
    page_size: int           # tokens per page (multiple of |tp|)
    n_pages: int             # pool pages in all (multiple of n_partitions)
    pages_per_slot: int      # block-table width (covers padded_s_max)
    n_partitions: int        # dp partitions of the pool (1 = shared pool)

    @property
    def pages_per_partition(self) -> int:
        return self.n_pages // self.n_partitions

    def pages_for(self, n_tokens: int) -> int:
        """Physical pages covering ``n_tokens`` cache positions."""
        return -(-max(n_tokens, 0) // self.page_size)

    def slot_partition(self, slot: int, max_batch: int) -> int:
        """Pool partition owning ``slot`` (contiguous batch sharding)."""
        return slot // (max_batch // self.n_partitions)

    def resident_capacity(self, n_tokens: int, max_batch: int) -> int:
        """How many ``n_tokens``-position requests fit resident at once."""
        need = max(self.pages_for(n_tokens), 1)
        per_part = self.pages_per_partition // need
        return min(per_part * self.n_partitions, max_batch)


def resolve_page_geometry(serve: ServeConfig, *, s_max: int,
                          tp_size: int = 1,
                          n_partitions: int = 1) -> PageGeometry:
    """Pad the page knobs to the mesh: page_size up to a multiple of |tp|
    (even stripes), n_pages up to a multiple of the dp partition count,
    defaulting (``n_pages=0``) to the slab-equivalent pool of ``max_batch``
    slots' worth of pages. ``s_max`` is the engine's *padded* cache
    length."""
    ps = _round_up(serve.page_size, max(tp_size, 1))
    pages_per_slot = -(-s_max // ps)
    n_pages = serve.n_pages or serve.max_batch * pages_per_slot
    n_pages = _round_up(n_pages, max(n_partitions, 1))
    geom = PageGeometry(page_size=ps, n_pages=n_pages,
                        pages_per_slot=pages_per_slot,
                        n_partitions=max(n_partitions, 1))
    if geom.pages_per_partition < pages_per_slot:
        raise ValueError(
            f"page pool too small: {geom.pages_per_partition} pages per "
            f"partition cannot hold one worst-case request "
            f"({pages_per_slot} pages of {ps} tokens)")
    if serve.prefill_chunk and serve.prefill_chunk % ps:
        raise ValueError(
            f"prefill_chunk ({serve.prefill_chunk}) must be a multiple of "
            f"the padded page size ({ps}; page_size {serve.page_size} was "
            f"rounded up to the tp axis size {tp_size}) — pick a page_size "
            f"that is already a multiple of |tp|")
    return geom


# ---------------------------------------------------------------------------
# Allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host-side refcounting page allocator over per-partition free lists.

    Physical ids are GLOBAL pool indices; partition ``d`` owns the
    contiguous range ``[d*ppp, (d+1)*ppp)``, so a dp group's island
    recovers its local index by subtracting its partition's first id, and
    the islands' dense reference indexes the global pool with the ids as
    they are. Allocation is all-or-nothing (None on exhaustion: admission
    backpressure) and deterministic (lowest free id first)."""

    def __init__(self, geom: PageGeometry):
        self.geom = geom
        ppp = geom.pages_per_partition
        self._free: list[list[int]] = [
            list(range(d * ppp, (d + 1) * ppp))
            for d in range(geom.n_partitions)]
        for f in self._free:
            heapq.heapify(f)
        self._ref: dict[int, int] = {}

    def free_pages(self, part: int) -> int:
        return len(self._free[part])

    @property
    def resident_pages(self) -> int:
        return self.geom.n_pages - sum(len(f) for f in self._free)

    def alloc(self, part: int, n: int) -> list[int] | None:
        """n fresh pages (refcount 1) from ``part``, or None if exhausted."""
        free = self._free[part]
        if n > len(free):
            return None
        pages = [heapq.heappop(free) for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, pages) -> None:
        """refcount++ on already-allocated pages (prefix sharing)."""
        for p in pages:
            self._ref[p] += 1

    def release(self, pages) -> int:
        """refcount--; pages reaching zero return to their partition's free
        list. Returns how many pages were freed."""
        ppp = self.geom.pages_per_partition
        freed = 0
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                heapq.heappush(self._free[p // ppp], p)
                freed += 1
        return freed

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)


# ---------------------------------------------------------------------------
# Prefix sharing registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefixEntry:
    tokens: tuple[int, ...]
    pages: tuple[int, ...]       # global ids, ceil(len/page) of them
    schedule: object             # chunk-schedule key; share only when equal


class PrefixCache:
    """Per-partition registry of completed prefills for copy-on-write
    prefix sharing.

    ``register`` retains the prompt's pages so they outlive the slot;
    ``lookup`` returns the best (longest common prefix) donor; ``evict_one``
    releases the oldest entry — the engine calls it when allocation fails,
    so registry history never causes spurious admission backpressure."""

    def __init__(self, allocator: PageAllocator, *, max_entries: int = 8):
        self.alloc = allocator
        self.max_entries = max_entries
        self._entries: list[list[_PrefixEntry]] = \
            [[] for _ in range(allocator.geom.n_partitions)]

    def register(self, part: int, tokens, pages, schedule) -> None:
        tokens = tuple(int(t) for t in tokens)
        if not tokens or not pages:
            return
        ent = self._entries[part]
        if any(e.tokens == tokens and e.schedule == schedule for e in ent):
            return
        self.alloc.retain(pages)
        ent.append(_PrefixEntry(tokens, tuple(pages), schedule))
        while len(ent) > self.max_entries:
            self._release(ent.pop(0))

    def lookup(self, part: int, tokens, schedule):
        """Longest-common-prefix donor: (match_len, entry) or (0, None)."""
        tokens = tuple(int(t) for t in tokens)
        best_m, best_e = 0, None
        for e in self._entries[part]:
            if e.schedule != schedule:
                continue
            m = 0
            for a, b in zip(tokens, e.tokens):
                if a != b:
                    break
                m += 1
            if m > best_m:
                best_m, best_e = m, e
        return best_m, best_e

    def evict_one(self, part: int) -> bool:
        ent = self._entries[part]
        if not ent:
            return False
        self._release(ent.pop(0))
        return True

    def _release(self, e: _PrefixEntry) -> None:
        self.alloc.release(e.pages)

    def __len__(self) -> int:
        return sum(len(e) for e in self._entries)


# ---------------------------------------------------------------------------
# Paged cache template
# ---------------------------------------------------------------------------

def page_partitions(rules: ShardingRules | None, batch: int) -> int:
    """dp partitions of the page pool — mirrors the slot-batch sharding:
    the pool partitions exactly when ``pos``/block-table rows shard, so a
    slot's pages always live in the dp group that computes it."""
    if rules is None or rules.dim(batch, rules.dp) is None:
        return 1
    return axes_size(rules.mesh, rules.dp)


def paged_cache_template(cfg: ArchConfig, run: RunConfig,
                         rules: ShardingRules | None, *, batch: int,
                         geom: PageGeometry, kv_dtype: str = "bf16") -> dict:
    """PD tree of the paged decode cache: per-layer page pools (stored by
    ``ShardingRules.kv_pool``), per-slot block tables (the engine fills
    them with −1 and maps rows at admission) and the per-slot position
    vector. Attention-only architectures: SSM recurrent state has no paged
    equivalent, and neither has an encoder-decoder's cross cache.
    ``kv_dtype="int8"`` stores the pools as int8 and adds per-(page
    position, head) f32 scale pools ``k_scale``/``v_scale`` (the pool's
    shape without hd, stored as the pool is); the paged islands quantize on
    write and dequantize on gather."""
    from repro_torch.models.transformer import PD

    if cfg.encoder_decoder:
        raise ValueError("paged cache_layout does not cover encoder-decoder")
    if any(sp.mixer != "attn" for sp in cfg.layer_pattern()):
        raise ValueError(
            f"cache_layout='paged' requires a pure-attention architecture; "
            f"{cfg.name} has SSM layers whose recurrent state cannot be "
            f"paged (use the slab layout / exact_buckets)")
    import torch

    dt = DTYPES[cfg.dtype]
    kv_dt = {"bf16": dt, "int8": torch.int8}[kv_dtype]
    hkv, hd, np_ = cfg.n_kv_heads, cfg.hd, cfg.n_periods
    pool_spec = rules.kv_pool(batch) if rules else P(None, None, None, None)
    bspec = rules.dim(batch, rules.dp) if rules else None
    tree = {
        "pos": PD((batch,), P(bspec), "zeros", torch.int32),
        "block_tables": PD((batch, geom.pages_per_slot), P(bspec, None),
                           "zeros", torch.int32),
        "blocks": {},
    }
    pool = PD((geom.n_pages, hkv, geom.page_size, hd), pool_spec, "zeros",
              kv_dt).stacked(np_)
    entry = {"k": pool, "v": pool}
    if kv_dtype == "int8":
        sc = PD((geom.n_pages, hkv, geom.page_size), P(*pool_spec[:3]),
                "zeros", torch.float32).stacked(np_)
        entry.update(k_scale=sc, v_scale=sc)
    for i, _spec in enumerate(cfg.layer_pattern()):
        tree["blocks"][f"pos{i}"] = dict(entry)
    return tree


def _kv_bytes_per_pos(cfg: ArchConfig, kv_dtype: str) -> int:
    """K/V cache bytes per cached position (all layers, K and V). int8
    pays 1 byte an element plus one f32 scale a (position, head, K|V)."""
    if kv_dtype == "int8":
        return cfg.n_layers * cfg.n_kv_heads * 2 * (cfg.hd + 4)
    dt_bytes = 2 if cfg.dtype == "bfloat16" else 4
    return cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2 * dt_bytes


def pool_hbm_bytes(cfg: ArchConfig, geom: PageGeometry,
                   kv_dtype: str = "bf16") -> int:
    """K/V pool bytes (all layers, K and V)."""
    return geom.n_pages * geom.page_size * _kv_bytes_per_pos(cfg, kv_dtype)


def slab_hbm_bytes(cfg: ArchConfig, batch: int, s_max: int,
                   kv_dtype: str = "bf16") -> int:
    """Slab-equivalent K/V bytes for the same slot count — the denominator
    of the paged-vs-slab memory comparison in ``cache_stats()``."""
    return batch * s_max * _kv_bytes_per_pos(cfg, kv_dtype)
