"""Model layers of the dense serving and training paths — the twin of
``repro/models/layers.py``.

Functional like the JAX module: ``fn(params_subtree, x, ...)``, with every
PK-overlapped path declared as a ``core.template.Island`` whose body runs on
the stacked ranks of ``core/pgl.py``. Outside islands tensors are global.
Weights may be stored stacked per rank (``build_engine`` lays every
tp-sharded weight out once); the helpers :func:`_col_proj` and
:func:`_row_weight` let global-level code use them without re-slicing.

Ported: norms, activations, RoPE, ``_full_attention``, the slab KV-cache
islands (``decode_island``, ``prefill_write_island``), prefill and
training attention — whose mix is ``kernels/flash_attention.py``, the
hand-written kernel on the card: causal, or non-causal in an
encoder-decoder's encoder and cross-attention (``cross_kv``), whose
one-token decode merges each rank's slice of the encoder's K/V
(``cross_decode_island``) — the GEMM+AR islands
(``attn_out_island``, ``mlp_island``), the vocab-parallel embedding, the
serving logits and the chunked vocab-parallel loss (``lm_loss_island``),
whose logits go through the GEMM kernel. With FSDP on a dp > 1 mesh
every sharded weight is gathered before use (``core.template.fsdp_gather``):
inside islands through their ``Gather`` declarations, and for the q/k/v
projections and mamba's ``in_proj``/``out_proj`` where they are used
(:func:`project`, :func:`row_project`: the gathers XLA inserts in JAX).
Sequence-parallel training attention (``attention_block(seq_sharded=
True)``) runs over the tp axis in ``sp_attention_island``: ring attention
(``core/ring_attention.py``: the p2p kernel and flash hops) or, under
``sp_attention="ulysses"``, Ulysses (``core/ulysses.py``: the all-to-all
kernel and one flash launch). Not ported: the XLA chunked
attention (the flash kernel computes the same function at any length),
the resident 2D-TP MoE serving layout (``serve_moe_tp_data``, A9c), paged
and int8 caches (A7, A11). The MoE island runs the replicated-dispatch
strategy (``core/moe.py``), whose expert GEMMs are the grouped-GEMM kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import moe as pk_moe
from repro_torch.core.pgl import P
from repro_torch.core.ring_attention import pk_ring_attention
from repro_torch.core.template import (Comm, Gather, Island, IslandPlan,
                                       Stacked, comm_context, fsdp_gather,
                                       island_override, rank_index)
from repro_torch.core.ulysses import pk_ulysses_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul, matmul_stacked
from repro_torch.models.sharding import ShardingRules

NEG_INF = -1e30


def _dtype_bytes(cfg: ArchConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _col_proj(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., d) @ w, where w is global (d, n) or stacked over its output
    dim, (R, d, n/R): the per-rank products are concatenated back. A tuple
    of per-dp-group FSDP copies projects each group's batch slice of x with
    its own copy."""
    if isinstance(w, tuple):
        n = len(w)
        if x.shape[0] % n:           # batch replicated over dp: one copy
            return _col_proj(x, w[0])
        return torch.cat([_col_proj(xg, wg)
                          for xg, wg in zip(x.chunk(n, 0), w)], 0)
    if w.dim() == 2:
        return torch.matmul(x, w)
    r, d, n_loc = w.shape
    y = torch.matmul(x.reshape(-1, d), w)                 # (R, T, n_loc)
    return y.movedim(0, 1).reshape(*x.shape[:-1], r * n_loc)


def _row_weight(w: torch.Tensor, ndim: int = 2) -> torch.Tensor:
    """Global view of a leaf stacked over its leading dim, (R, k/R, ...)
    -> (k, ...) for a leaf of ``ndim`` dims (a weight stacked over its
    input dim by default): rank slabs are contiguous row blocks, so this is
    a view."""
    return w if w.dim() == ndim else w.reshape(-1, *w.shape[2:])


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rms_norm(w, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def get_act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv
    if positions.dim() == 1:
        cos, sin = torch.cos(ang)[None, None], torch.sin(ang)[None, None]
    else:
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _full_attention(q, k, v, *, causal, window, q_offset=0, kv_len=None,
                    scale=None):
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Skv,hd). fp32 softmax, GQA grouped.
    ``kv_len`` (valid cache prefix) may be a scalar or a per-slot (B,)."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = q_offset + torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    if kv_len is not None:
        if torch.is_tensor(kv_len) and kv_len.dim():
            keep = keep[None] & (ki[None] < kv_len[:, None, None])
        else:
            keep = keep & (ki < kv_len)
    mask = keep if keep.dim() == 2 else keep[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def attn_out_island(cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, b: int, s: int) -> Island:
    """Attention out-projection as the PK GEMM+AR island (paper Fig. 9)."""
    hq, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    h_full = hq * hd

    def reference(o, wo):
        return torch.matmul(o, _row_weight(wo))

    if rules is None:
        return Island("attn_out", run=run, reference=reference)
    tp = rules.tp
    tp_size = rules.mesh.shape[tp]
    bspec = rules.dim(b, rules.dp)
    b_loc = rules.local_batch(b)

    def body(ctx, o, wo):
        t = o.reshape(o.shape[0], -1, o.shape[-1])
        out = ctx.matmul_all_reduce(t, wo)
        return out.reshape(o.shape[0], o.shape[1], s, d)

    return Island(
        "attn_out", rules=rules, run=run,
        inputs={"o": P(bspec, None, rules.dim(h_full, tp)),
                "wo": rules.w2d(h_full, d, tp_dim=0)},
        out_specs=P(bspec, None, None),
        body=body, reference=reference,
        gathers={"wo": Gather(dim=1, size=d)},
        enable=run.pk_attn_out_island,
        divisible=((h_full, tp), (b * s, tp)),
        comm=Comm("matmul_all_reduce", m=b_loc * s, n=d,
                  k=h_full // tp_size if h_full % tp_size == 0 else h_full,
                  dtype_bytes=_dtype_bytes(cfg)))


def sp_attention_island(cfg: ArchConfig, run: RunConfig,
                        rules: ShardingRules | None, b: int, s: int, *,
                        causal: bool = True, reference=None) -> Island:
    """Sequence-parallel attention island over the tp axis, q/k/v
    sequence-sharded on dim 2; once per dp group. Ring attention (paper
    §4.2), or Ulysses under ``sp_attention="ulysses"``: its all-to-all
    chunk count is ``run.ulysses_chunks``, or with 0 (auto) the island's
    frozen plan (``island_overrides``), then the analytic a2a chunk policy
    (measured rows are ROADMAP item 12, so JAX's calibration key for the
    island has no twin here)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if rules is None:
        return Island("attn_sp", run=run, reference=reference)
    axis = rules.tp
    tp_size = rules.mesh.shape[axis]
    spec = P(rules.dim(b, rules.dp), None, axis, None)
    b_loc = rules.local_batch(b)
    s_loc = max(s // tp_size, 1)
    dtb = _dtype_bytes(cfg)
    ulysses = run.sp_attention == "ulysses"
    divisible = [(s, axis)] + ([(hq, axis)] if ulysses else [])
    if ulysses:
        shape = (b_loc, hq, s_loc, hd)
        ov = island_override(run, "attn_ulysses")
        source = None
        if ov is not None and ov[1] is not None:
            a2a_chunks, source = max(1, ov[1]), ov[2]
        elif run.ulysses_chunks > 0:
            a2a_chunks = run.ulysses_chunks
        else:
            sched = comm_context(run, axis, mesh=rules.mesh
                                 ).a2a_chunk_schedule(shape, 1, 2,
                                                      dtype_bytes=dtb)
            a2a_chunks, source = sched.n_chunks, sched.source
        comm = Comm("all_to_all", n_chunks=a2a_chunks,
                    backend="chunked" if a2a_chunks > 1 else "bulk",
                    payload_bytes=b_loc * hq * s_loc * hd * dtb,
                    shape=shape, split_axis=1, concat_axis=2, source=source)

        def body(ctx, q, k, v):
            return pk_ulysses_attention(q, k, v, ctx=ctx, causal=causal,
                                        window=cfg.sliding_window,
                                        n_chunks=comm.n_chunks)
    else:
        comm = Comm("ring_shift", backend="bulk", n_chunks=tp_size,
                    payload_bytes=2 * b_loc * hkv * s_loc * hd * dtb)

        def body(ctx, q, k, v):
            return pk_ring_attention(q, k, v, ctx=ctx, causal=causal,
                                     window=cfg.sliding_window)

    return Island(f"attn_{run.sp_attention}", rules=rules, run=run,
                  inputs={"q": spec, "k": spec, "v": spec}, out_specs=spec,
                  body=body, reference=reference, divisible=divisible,
                  comm=comm)


def project(x: torch.Tensor, w, n: int, rules: ShardingRules | None,
            run: RunConfig) -> torch.Tensor:
    """x (..., d) @ w (d, n), a column-sharded projection (q, k, v; the
    cross-attention K/V of the encoder's output). With FSDP on a dp > 1
    mesh the weight is first gathered, one copy per dp group — the gather
    XLA inserts in JAX — and each group's batch slice of x is projected
    with its copy."""
    if rules is not None:
        c = fsdp_gather(w, rules.w2d(x.shape[-1], n, tp_dim=1), rules, run,
                        dim=0)
        if c is not None:
            w = tuple(c.unbind(0))
    return _col_proj(x, w)


def row_project(x: torch.Tensor, w, rules: ShardingRules | None,
                run: RunConfig) -> torch.Tensor:
    """x (..., k) @ w (k, n), a row-sharded projection whose output dim is
    FSDP-sharded (mamba's ``out_proj``): with FSDP on a dp > 1 mesh the
    weight is first gathered, one copy per dp group, and each group's
    batch slice of x is projected with its copy (one copy when the batch
    is replicated over dp)."""
    if rules is not None:
        c = fsdp_gather(w, rules.w2d(x.shape[-1], w.shape[-1], tp_dim=0),
                        rules, run, dim=1)
        if c is not None:
            return _col_proj(x, tuple(_row_weight(wg) for wg in c.unbind(0)))
    return torch.matmul(x, _row_weight(w))


def attention_block(p, x, cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None, *, causal=True,
                    positions=None, cross_kv=None, seq_sharded=False):
    """Full-sequence attention sub-layer without a cache (training):
    projections, RoPE, the GQA mix — the flash kernel, with its autograd
    backward; with ``seq_sharded`` ring or Ulysses attention over the tp
    axis in the SP island — and the out-projection island. x: (B, S, d).
    ``cross_kv``: the precomputed (k, v) (B, Hkv, Se, hd) of an
    encoder-decoder's cross-attention — no K/V projection, no RoPE, no
    window; the caller passes ``causal=False``, as in JAX."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = project(x, p["wq"], hq * hd, rules, run).reshape(
        b, s, hq, hd).transpose(1, 2)
    if cross_kv is None:
        k = project(x, p["wk"], hkv * hd, rules, run).reshape(
            b, s, hkv, hd).transpose(1, 2)
        v = project(x, p["wv"], hkv * hd, rules, run).reshape(
            b, s, hkv, hd).transpose(1, 2)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.sliding_window
    else:
        k, v = cross_kv
        window = None

    def dense_mix(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)

    if seq_sharded and rules is not None:
        island = sp_attention_island(cfg, run, rules, b, s, causal=causal,
                                     reference=dense_mix)
        o = island(q=q, k=k, v=v)
    else:
        o = dense_mix(q, k, v)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return attn_out_island(cfg, run, rules, b, s)(o=o, wo=p["wo"])


def _cache_write(cache, new, pos):
    """Write a one-token K/V block into the cache's seq dim at ``pos``
    (scalar, or a per-slot (B,) vector; out-of-range positions write
    nothing). Returns a new cache."""
    if not (torch.is_tensor(pos) and pos.dim()):
        out = cache.clone()
        p = int(pos)
        if 0 <= p < cache.shape[2]:
            out[:, :, p:p + 1] = new.to(cache.dtype)
        return out
    oh = torch.arange(cache.shape[2], device=cache.device)[None, :] \
        == pos[:, None]                                         # (B, S)
    return torch.where(oh[:, None, :, None], new.to(cache.dtype), cache)


def _sharded_mix(ctx, q, k_, v_, kvl, window, cfg: ArchConfig):
    """One query token (R, B, Hq, 1, hd) over a stacked, sequence-sharded
    K/V (R, B, Hkv, s_loc, hd): rank r's keys sit at global positions
    r·s_loc + j, visible iff < ``kvl`` (and, with a window, > kvl - 1 -
    window); each rank's partial softmax is merged by log-sum-exp over the
    ranks — the pmax / psum of the JAX decode island, acting on the stacked
    rank axis."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    r, s_loc = q.shape[0], k_.shape[3]
    g = hq // hkv
    qg = q.reshape(r, q.shape[1], hkv, g, 1, hd).float()
    sc = torch.einsum("rbkgqd,rbksd->rbkgqs", qg, k_.float()) * hd ** -0.5
    ki = ((rank_index(k_) * s_loc).view(r, 1, 1, 1, 1, 1)
          + torch.arange(s_loc, device=q.device))
    keep = ki < kvl
    if window is not None:
        keep = keep & (ki > (kvl - 1) - window)
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m_glob = ctx.pmax(sc.amax(dim=-1))
    p_ = torch.exp(sc - m_glob[..., None])
    l_glob = ctx.psum(p_.sum(dim=-1), backend="bulk")
    o_glob = ctx.psum(torch.einsum("rbkgqs,rbksd->rbkgqd", p_, v_.float()),
                      backend="bulk")
    o = o_glob / l_glob.clamp_min(1e-30)[..., None]
    return o.reshape(r, q.shape[1], hq, 1, hd).to(q.dtype)


def decode_island(cfg: ArchConfig, run: RunConfig,
                  rules: ShardingRules | None, b: int, s_max: int, *,
                  long_ctx: bool, pos, kv_len, window) -> Island:
    """One-token decode over the sequence-sharded KV cache: rank-local slot
    write + flash-decode log-sum-exp merge over the tp ranks
    (:func:`_sharded_mix`). ``pos`` is a scalar (lockstep) or a per-slot
    (B,) vector (the engine's pool)."""
    if long_ctx:
        raise NotImplementedError(
            "long-context decode over (dp × tp) is ROADMAP item A8")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    vec = torch.is_tensor(pos) and pos.dim() > 0

    def reference(q, cache_k, cache_v, k_new, v_new, **kw):
        p_ = kw.get("pos", pos)
        ck = _cache_write(cache_k, k_new, p_)
        cv = _cache_write(cache_v, v_new, p_)
        o = _full_attention(q, ck, cv, causal=False, window=window,
                            q_offset=0, kv_len=p_ + 1 if vec else kv_len)
        return o, ck, cv

    if rules is None:
        return Island("decode_attn", run=run, reference=reference)
    tp = rules.tp
    cache_spec = rules.kv_cache(hkv, b)
    bspec = rules.dim(b, rules.dp)
    qspec = P(bspec, None, None, None)

    def body(ctx, q, cache_k, cache_v, k_new, v_new, **kw):
        s_loc = cache_k.shape[3]
        offset = rank_index(cache_k) * s_loc                    # (R,)
        ar = torch.arange(s_loc, device=q.device)
        if vec:
            local = kw["pos"] - offset[:, None]                     # (R, B)
            hit = (local >= 0) & (local < s_loc)
            oh = (ar == local[..., None]) & hit[..., None]          # (R,B,s)
            mask = oh[:, :, None, :, None]
            kvl = (kw["pos"] + 1).view(*kw["pos"].shape, 1, 1, 1, 1)
        else:
            local = pos - offset                                    # (R,)
            hit = (local >= 0) & (local < s_loc)
            oh = (ar[None, :] == local[:, None]) & hit[:, None]     # (R, s)
            mask = oh[:, None, None, :, None]
            kvl = kv_len
        k_ = torch.where(mask, k_new.to(cache_k.dtype), cache_k)
        v_ = torch.where(mask, v_new.to(cache_v.dtype), cache_v)
        return _sharded_mix(ctx, q, k_, v_, kvl, window, cfg), k_, v_

    inputs = {"q": qspec, "cache_k": cache_spec, "cache_v": cache_spec,
              "k_new": qspec, "v_new": qspec}
    if vec:
        inputs["pos"] = P(bspec)
    return Island(
        "decode_attn", rules=rules, run=run, axis=tp, fallback_axes=tp,
        inputs=inputs,
        out_specs=(qspec, Stacked(cache_spec), Stacked(cache_spec)),
        body=body, reference=reference,
        enable=run.decode_seq_shard,
        divisible=((s_max, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1,
                  payload_bytes=2 * b * hq * hd * 4))


def cross_decode_island(cfg: ArchConfig, run: RunConfig,
                        rules: ShardingRules | None, b: int,
                        enc_len: int) -> Island:
    """One-token cross-attention of an encoder-decoder over the encoder's
    K/V (``cache["cross"]``), which JAX stores sequence-sharded over tp:
    every key is visible, and each rank's partial softmax over its slice
    of the ``enc_len`` positions is merged by log-sum-exp over the ranks
    (:func:`_sharded_mix`), with no cache write. JAX leaves the same
    ``_full_attention`` to XLA's partitioner."""
    hq, hd = cfg.n_heads, cfg.hd

    def reference(q, k, v):
        return _full_attention(q, k, v, causal=False, window=None,
                               q_offset=0, kv_len=enc_len)

    if rules is None:
        return Island("cross_decode_attn", run=run, reference=reference)
    tp = rules.tp
    bspec = rules.dim(b, rules.dp)
    qspec = P(bspec, None, None, None)
    kv_spec = P(bspec, None, rules.dim(enc_len, tp), None)

    def body(ctx, q, k, v):
        return _sharded_mix(ctx, q, k, v, enc_len, None, cfg)

    return Island(
        "cross_decode_attn", rules=rules, run=run, axis=tp,
        fallback_axes=tp, inputs={"q": qspec, "k": kv_spec, "v": kv_spec},
        out_specs=qspec, body=body, reference=reference,
        enable=run.decode_seq_shard, divisible=((enc_len, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1,
                  payload_bytes=2 * b * hq * hd * 4))


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ArchConfig,
                     run: RunConfig, rules: ShardingRules | None, *,
                     cross_kv=None):
    """One-token decode with KV cache. x: (B, 1, d); cache_k/v: global
    (B, Hkv, S_max, hd), or stacked per rank when sequence-sharded; pos:
    scalar or per-slot (B,). Returns (out (B, 1, d), new_k, new_v).
    ``cross_kv``: an encoder-decoder's cross-attention over the encoder's
    (k, v) (B, Hkv, Se, hd), stored like the cache — no cache, no RoPE, no
    window, every key visible (:func:`cross_decode_island` on a mesh) —
    returning (out, None, None)."""
    b, _, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _col_proj(x, p["wq"]).reshape(b, 1, hq, hd).transpose(1, 2)
    if cross_kv is not None:
        k, v = cross_kv
        enc_len = k.shape[-2] * (rules.mesh.shape[rules.tp]
                                 if rules is not None and k.dim() == 5
                                 else 1)
        o = cross_decode_island(cfg, run, rules, b, enc_len)(q=q, k=k, v=v)
        o = o.transpose(1, 2).reshape(b, 1, hq * hd)
        return torch.matmul(o, _row_weight(p["wo"])), None, None
    k_new = _col_proj(x, p["wk"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    v_new = _col_proj(x, p["wv"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    vec = torch.is_tensor(pos) and pos.dim() > 0
    positions = pos[:, None] if vec else torch.full(
        (1,), int(pos), device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    kv_len = pos + 1
    window = cfg.sliding_window
    if rules is not None and run.decode_seq_shard:
        s_max = cache_k.shape[-2] * (rules.mesh.shape[rules.tp]
                                     if cache_k.dim() == 5 else 1)
        island = decode_island(cfg, run, rules, b, s_max, long_ctx=False,
                               pos=pos, kv_len=kv_len, window=window)
        kw = {"pos": pos} if vec else {}
        o, cache_k, cache_v = island(q=q, cache_k=cache_k, cache_v=cache_v,
                                     k_new=k_new, v_new=v_new, **kw)
    else:
        cache_k = _cache_write(cache_k, k_new, pos)
        cache_v = _cache_write(cache_v, v_new, pos)
        o = _full_attention(q, cache_k, cache_v, causal=False, window=window,
                            q_offset=0, kv_len=kv_len)
    o = o.transpose(1, 2).reshape(b, 1, hq * hd)
    out = torch.matmul(o, _row_weight(p["wo"]))
    return out, cache_k, cache_v


def prefill_write_island(cfg: ArchConfig, run: RunConfig,
                         rules: ShardingRules | None, b: int,
                         L: int) -> Island:
    """Rank-local write of a prompt's K/V block into the sequence-sharded
    cache: rank r takes its own [r·s_loc, (r+1)·s_loc) window of the new
    (replicated) K/V."""
    hkv = cfg.n_kv_heads

    def reference(cache, new):
        out = cache.clone()
        out[:, :, :new.shape[2]] = new.to(cache.dtype)
        return out

    if rules is None:
        return Island("prefill_write", run=run, reference=reference)
    cache_spec = rules.kv_cache(hkv, b)
    bspec = rules.dim(b, rules.dp)

    def body(ctx, cache, new):
        s_loc = cache.shape[3]
        idx = (rank_index(cache) * s_loc)[:, None] \
            + torch.arange(s_loc, device=cache.device)              # (R, s)
        window = new[0][:, :, idx.clamp(0, L - 1)].movedim(2, 0)
        hit = (idx < L)[:, None, None, :, None]
        return torch.where(hit, window.to(cache.dtype), cache)

    return Island(
        "prefill_write", rules=rules, run=run,
        inputs={"cache": cache_spec, "new": P(bspec, None, None, None)},
        out_specs=Stacked(cache_spec),
        body=body, reference=reference,
        enable=run.decode_seq_shard)


def prefill_attention_block(p, x, cache_k, cache_v, cfg: ArchConfig,
                            run: RunConfig, rules: ShardingRules | None):
    """Batched prefill: causal attention over the whole (right-padded)
    prompt — the flash kernel on the card — with K/V written into the
    decode cache at positions [0, L). Rows past a slot's real length are
    causal-masked garbage the caller discards, as in the JAX package.
    Returns (out (B, L, d), new_cache_k, new_cache_v)."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _col_proj(x, p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = _col_proj(x, p["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _col_proj(x, p["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    positions = torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    write = prefill_write_island(cfg, run, rules, b, s)
    new_k = write(cache=cache_k, new=k)
    new_v = write(cache=cache_v, new=v)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    out = attn_out_island(cfg, run, rules, b, s)(o=o, wo=p["wo"])
    return out, new_k, new_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_island(cfg: ArchConfig, run: RunConfig,
               rules: ShardingRules | None, b: int, s: int) -> Island:
    """Megatron MLP as the PK GEMM+AR island (paper §4.1): x (replicated)
    × w1 (column shards) -> act -> × w2 (row shards) -> GEMM+AR."""
    act = get_act(cfg.act)
    d, ff = cfg.d_model, cfg.d_ff
    gated = cfg.gated_mlp

    def reference(x, w1, w3, w2):
        h = _col_proj(x, w1)
        h = act(h) * _col_proj(x, w3) if gated else act(h)
        return torch.matmul(h, _row_weight(w2))

    if rules is None:
        return Island("mlp", run=run, reference=reference)
    tp = rules.tp
    tp_size = rules.mesh.shape[tp]
    bspec = rules.dim(b, rules.dp)
    b_loc = rules.local_batch(b)
    w1s = rules.w2d(d, ff, tp_dim=1)
    w2s = rules.w2d(ff, d, tp_dim=0)

    def body(ctx, x, w1, w3, w2):
        t = x.reshape(x.shape[0], -1, d)
        h = torch.matmul(t, w1)
        h = act(h) * torch.matmul(t, w3) if gated else act(h)
        out = ctx.matmul_all_reduce(h.to(x.dtype), w2)
        return out.reshape(x.shape)

    gathers = {"w1": Gather(dim=0, size=d), "w2": Gather(dim=1, size=d)}
    if gated:
        gathers["w3"] = Gather(dim=0, size=d)
    return Island(
        "mlp", rules=rules, run=run,
        inputs={"x": P(bspec, None, None), "w1": w1s,
                "w3": w1s if gated else P(), "w2": w2s},
        out_specs=P(bspec, None, None),
        body=body, reference=reference, gathers=gathers,
        enable=run.pk_overlap,
        divisible=((ff, tp),),
        comm=Comm("matmul_all_reduce", m=b_loc * s, n=d,
                  k=ff // tp_size if ff % tp_size == 0 else ff,
                  dtype_bytes=_dtype_bytes(cfg)))


def mlp_block(p, x, cfg: ArchConfig, run: RunConfig,
              rules: ShardingRules | None):
    """Dense (optionally gated) MLP with TP through the MLP island."""
    b, s, _ = x.shape
    island = mlp_island(cfg, run, rules, b, s)
    w3 = p["w3"] if cfg.gated_mlp else torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
    return island(x=x, w1=p["w1"], w3=w3, w2=p["w2"])


def check_moe_run(run: RunConfig) -> None:
    """Refuse the MoE run options the port does not have yet."""
    if run.serve_moe_tp_data:
        raise NotImplementedError(
            "serve_moe_tp_data (resident 2D-TP expert weights, ff sliced over "
            "the dp axes) is ROADMAP item A9c; it needs serving on dp > 1 "
            "meshes (A7c)")


def moe_island(cfg: ArchConfig, run: RunConfig,
               rules: ShardingRules | None, b: int, s: int) -> Island:
    """MoE island over the tp axis with device-major expert weights
    (``core/moe.py``, replicated dispatch): one gating/capacity plan
    (``pk_moe.dispatch_plan``), the expert GEMMs of every virtual rank in
    one grouped-GEMM launch each, the combine a psum over tp. Returns
    (out, aux) with out_specs (P(b), P(b)). On a dp > 1 mesh it runs once
    a dp group on the group's ``b_loc·s`` tokens (the plan's count, as in
    JAX) with FSDP-gathered expert weights, and the groups' aux losses
    are joined over dp, so ``moe_block``'s mean is JAX's mean of the dp
    groups' values. It differentiates: routing, the capacity gather, the
    weighted combine and the psum are autograd ops, the grouped GEMM has
    its backward; with no mesh the dense oracle differentiates too."""
    check_moe_run(run)
    d = cfg.d_model
    gated = cfg.gated_mlp

    def _undo_device_major(w, *, ff_axis):
        # (M, E_loc, ...) device-major PGL -> (E, ...) with the full ff:
        # rank r = g*tp_ff + j holds expert group g's ff slice j, so regroup
        # to (ep, tp_ff, E_loc, ...), move the tp_ff axis next to its ff_loc
        # slice (``ff_axis`` is ff_loc's absolute axis in w) and merge both
        # pairs
        m_dev, e_loc = w.shape[0], w.shape[1]
        ep = cfg.n_experts // e_loc
        tp_ff = m_dev // ep
        w = w.reshape(ep, tp_ff, e_loc, *w.shape[2:]).movedim(1, ff_axis)
        shape = [ep * e_loc] + list(w.shape[2:])
        shape[ff_axis - 1:ff_axis + 1] = [shape[ff_axis - 1]
                                          * shape[ff_axis]]
        return w.reshape(shape)

    def reference(x, router, w1, w3, w2):
        # dense oracle: every expert on every token, no capacity drop
        y, aux = pk_moe.moe_reference_dense(
            x.reshape(-1, d), router, _undo_device_major(w1, ff_axis=3),
            _undo_device_major(w3, ff_axis=3) if gated else None,
            _undo_device_major(w2, ff_axis=2),
            n_experts=cfg.n_experts, top_k=cfg.top_k)
        return y.reshape(x.shape), aux.reshape(1)

    if rules is None:
        return Island("moe", run=run, reference=reference)
    tp = rules.tp
    f = rules.fsdp_axes
    bspec = rules.dim(b, rules.dp)
    n_tok = rules.local_batch(b) * s
    moe_chunks = run.moe_chunks
    if moe_chunks == 0:
        # auto: the analytic a2a chunk policy over the dispatch payload
        # (the JAX package asks its calibration table first, item 12)
        n_dev = rules.mesh.shape[tp]
        base = pk_moe.dispatch_plan(n_tok, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor)
        shape = (n_dev, max(cfg.n_experts // max(n_dev, 1), 1), base.cap, d)
        moe_chunks = comm_context(run, tp, mesh=rules.mesh) \
            .a2a_chunk_schedule(shape, 0, 0,
                                dtype_bytes=_dtype_bytes(cfg)).n_chunks
    plan = pk_moe.dispatch_plan(n_tok, n_experts=cfg.n_experts,
                                top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                n_chunks=moe_chunks)

    def body(ctx, x, router, w1, w3, w2):
        r = x.shape[0]
        t = x.reshape(r, -1, d)
        y, aux = pk_moe.pk_moe_replicated(
            t, router, w1[:, 0], w3[:, 0] if gated else None, w2[:, 0],
            ctx=ctx, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, plan=plan,
            ring_combine=run.pk_ring_psum)
        aux = ctx.psum(aux.reshape(1, 1).expand(r, 1), backend="bulk") / r
        return y.reshape(x.shape), aux

    # device-major PGL weights: (M, E_loc, d[, /fsdp], ff_loc)
    wspec = P(tp, None, rules.dim(d, f), None)
    w2spec = P(tp, None, None, rules.dim(d, f))
    gathers = {"w1": Gather(dim=2, size=d), "w2": Gather(dim=3, size=d)}
    if gated:
        gathers["w3"] = Gather(dim=2, size=d)
    return Island(
        "moe", rules=rules, run=run,
        inputs={"x": P(bspec, None, None), "router": P(None, None),
                "w1": wspec, "w3": wspec if gated else P(), "w2": w2spec},
        out_specs=(P(bspec, None, None), P(bspec)),
        body=body, reference=reference, gathers=gathers,
        comm=Comm("psum", backend="ring" if run.pk_ring_psum else "bulk",
                  n_chunks=plan.n_chunks,
                  payload_bytes=n_tok * d * _dtype_bytes(cfg)))


def moe_block(p, x, cfg: ArchConfig, run: RunConfig,
              rules: ShardingRules | None):
    """MoE sub-layer; returns (out, aux_loss)."""
    b, s, _ = x.shape
    island = moe_island(cfg, run, rules, b, s)
    w3 = p["w3"] if cfg.gated_mlp else torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
    out, aux = island(x=x, router=p["router"], w1=p["w1"], w3=w3, w2=p["w2"])
    return out, aux.float().mean()


# ---------------------------------------------------------------------------
# Vocab-parallel embedding, logits
# ---------------------------------------------------------------------------

def embed_island(run: RunConfig, rules: ShardingRules | None, v: int,
                 d_model: int, b: int) -> Island:
    """Megatron vocab-parallel embedding: each rank looks tokens up in its
    own (V/R, d) shard, a psum over ranks combines them."""

    def reference(emb, tok):
        return _row_weight(emb)[tok]

    if rules is None:
        return Island("embed", run=run, reference=reference)
    tp = rules.tp

    def body(ctx, emb, tok):
        v_loc = emb.shape[1]
        local = tok - (rank_index(emb) * v_loc).view(-1, 1, 1)
        ok = (local >= 0) & (local < v_loc)
        ranks = rank_index(emb).view(-1, 1, 1)
        x = emb[ranks, local.clamp(0, v_loc - 1)]                # (R,B,S,d)
        x = torch.where(ok[..., None], x, torch.zeros_like(x))
        return ctx.psum(x, backend="bulk")

    bspec = rules.dim(b, rules.dp)
    # FSDP shards the table's d over dp: the port gathers the table (JAX
    # all-gathers the looked-up activations instead, which mixes the dp
    # ranks' batches — ROADMAP C4)
    return Island(
        "embed", rules=rules, run=run,
        inputs={"emb": P(tp, rules.dim(d_model, rules.fsdp_axes)),
                "tok": P(bspec, None)},
        out_specs=P(bspec, None, None),
        body=body, reference=reference,
        gathers={"emb": Gather(dim=1, size=d_model)},
        divisible=((v, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1))


def embed_tokens(p, tokens, rules: ShardingRules | None,
                 run: RunConfig | None = None):
    """tokens (B, S) -> (B, S, d) through the vocab-parallel island."""
    emb = p["embed"]
    v, d_model = (emb.shape[0] * emb.shape[1], emb.shape[2]) \
        if emb.dim() == 3 else emb.shape
    island = embed_island(run if run is not None else RunConfig(),
                          rules, v, d_model, tokens.shape[0])
    return island(emb=emb, tok=tokens)


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(..., d) @ head (d, v) through the GEMM kernel, in f32."""
    y = matmul(x.reshape(-1, x.shape[-1]).contiguous(), head)
    return y.float().reshape(*x.shape[:-1], head.shape[-1])


def lm_loss_island(run: RunConfig, rules: ShardingRules | None, b: int,
                   d: int, v: int) -> Island:
    """Chunked vocab-parallel cross-entropy island: each rank's logits over
    its vocab shard (one stacked GEMM launch for all ranks), softmax
    statistics merged over tp with ``pmax`` (the max without gradient) and
    ``psum``; never holds (B, S, V) at once. Returns per-dp-rank (loss sum,
    weight sum)."""

    def reference(xc, tc, wc, head):
        tot = torch.zeros((), dtype=torch.float32, device=xc.device)
        cnt = torch.zeros((), dtype=torch.float32, device=xc.device)
        for xi, ti, wi in zip(xc, tc, wc):
            logits = _logits(xi, head)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, ti[..., None].long())[..., 0]
            tot = tot + ((lse - tgt) * wi).sum()
            cnt = cnt + wi.sum()
        return tot[None], cnt[None]      # (1,): the body's per-rank shape

    if rules is None:
        return Island("lm_loss", run=run, reference=reference)
    tp = rules.tp
    hspec = rules.w2d(d, v, tp_dim=1)

    def body(ctx, xc, tc, wc, head):
        r, v_loc = head.shape[0], head.shape[2]
        v0 = (rank_index(head) * v_loc).view(r, 1, 1)
        tot = torch.zeros((r, 1), dtype=torch.float32, device=xc.device)
        cnt = torch.zeros((r, 1), dtype=torch.float32, device=xc.device)
        for i in range(xc.shape[1]):
            # x, targets and weights are replicated over tp: rank 0's slab
            xi, ti, wi = xc[0, i], tc[:, i], wc[:, i]
            logits = matmul_stacked(xi.reshape(-1, xi.shape[-1]).contiguous(),
                                    head)
            logits = logits.float().reshape(r, *xi.shape[:-1], v_loc)
            m = ctx.pmax(logits.detach().amax(dim=-1))
            se = ctx.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                          backend="bulk")
            lse = m + torch.log(se)
            loc = ti.long() - v0
            ok = (loc >= 0) & (loc < v_loc)
            tgt = logits.gather(-1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
            tgt = ctx.psum(torch.where(ok, tgt, torch.zeros_like(tgt)),
                           backend="bulk")
            tot = tot + ((lse - tgt) * wi).sum(dim=(1, 2))[:, None]
            cnt = cnt + wi.sum(dim=(1, 2))[:, None]
        return tot, cnt

    bspec = rules.dim(b, rules.dp)
    return Island(
        "lm_loss", rules=rules, run=run,
        inputs={"xc": P(None, bspec, None, None),
                "tc": P(None, bspec, None), "wc": P(None, bspec, None),
                "head": hspec},
        out_specs=(P(bspec), P(bspec)),
        body=body, reference=reference,
        gathers={"head": Gather(dim=0, size=d)},
        divisible=((v, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1))


def lm_loss(p, x, targets, weights, cfg: ArchConfig, run: RunConfig,
            rules: ShardingRules | None, *, chunk: int = 512):
    """Chunked vocab-parallel cross-entropy. x: (B, S, d); targets,
    weights: (B, S). The weighted mean over tokens, f32."""
    head = p["lm_head"]
    b, s, d = x.shape
    v = head.shape[0] * head.shape[2] if head.dim() == 3 else head.shape[1]
    n_chunks = max(1, s // chunk) if s % chunk == 0 else 1
    xc = x.reshape(b, n_chunks, s // n_chunks, d).transpose(0, 1)
    tc = targets.reshape(b, n_chunks, s // n_chunks).transpose(0, 1)
    wc = weights.reshape(b, n_chunks, s // n_chunks).transpose(0, 1)
    tot, cnt = lm_loss_island(run, rules, b, d, v)(xc=xc, tc=tc, wc=wc,
                                                   head=head)
    return tot.sum() / cnt.sum().clamp_min(1.0)


def lm_logits(p, x):
    """Serving logits (B, S, V) in f32: bf16 products rounded like the JAX
    einsum, through the GEMM kernel (``kernels/matmul.py``) — one stacked
    launch over the ranks' vocab shards when the head is stored stacked."""
    head = p["lm_head"]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if head.dim() == 2:
        y = matmul(x2, head)
    else:
        y = matmul_stacked(x2, head).permute(1, 0, 2).reshape(x2.shape[0], -1)
    return y.float().reshape(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# Plan report
# ---------------------------------------------------------------------------

def _forward_islands(cfg: ArchConfig, run: RunConfig,
                     rules: ShardingRules | None, *, batch: int = 8,
                     seq: int = 128, phase: str = "all") -> list:
    """Every island a forward pass (and a decode step) builds: ``prefill``
    (GEMM islands at m = B·seq), ``decode`` (m = B·1 plus the decode
    attention island) or ``all`` (the union, plus the loss island — what
    the training launcher prints — and, unless ``run.sp_attention`` is
    "none", the sequence-parallel island of ``forward_train(seq_sharded=
    True)``, as JAX lists it). The attention islands only where a layer
    attends — mamba layers have none: their collectives are implicit in
    JAX's GSPMD program, and the port computes them on global activations
    (``models/ssm.py``)."""
    if phase not in ("all", "prefill", "decode"):
        raise ValueError(f"unknown island phase {phase!r}")
    pattern = cfg.layer_pattern()
    b = batch
    s = 1 if phase == "decode" else seq
    v = cfg.padded_vocab(rules.mesh.shape[rules.tp] if rules else 16)
    islands = [embed_island(run, rules, v, cfg.d_model, b)]
    if any(sp.mixer == "attn" for sp in pattern):
        if run.sp_attention != "none" and phase == "all":
            islands.append(
                sp_attention_island(cfg, run, rules, b, s, causal=True))
        islands.append(attn_out_island(cfg, run, rules, b, s))
        if phase in ("all", "decode"):
            islands.append(decode_island(cfg, run, rules, b, seq,
                                         long_ctx=False, pos=0, kv_len=1,
                                         window=cfg.sliding_window))
    if any(sp.mlp == "dense" for sp in pattern):
        islands.append(mlp_island(cfg, run, rules, b, s))
    if any(sp.mlp == "moe" for sp in pattern):
        islands.append(moe_island(cfg, run, rules, b, s))
    if phase == "all":
        islands.append(lm_loss_island(run, rules, b, cfg.d_model, v))
    return islands


def island_plans(cfg: ArchConfig, run: RunConfig,
                 rules: ShardingRules | None, *, batch: int = 8,
                 seq: int = 128, phase: str = "all") -> list[IslandPlan]:
    """Trace-free overlap schedule of every island of one serving bucket
    (``phase`` prefill / decode) or of a training forward (``all``)."""
    return [i.plan() for i in _forward_islands(cfg, run, rules, batch=batch,
                                               seq=seq, phase=phase)]
