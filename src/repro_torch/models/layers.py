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
kernel and one flash launch). The XLA chunked attention
(``_chunked_attention``) is the CPU's plain mix at kv lengths from
``XLA_ATTN_CHUNK_THRESHOLD`` on, as JAX picks it; the card runs the flash
kernel at every length. The paged KV cache (``runtime/paging.py``) has its
own islands, ``paged_decode_island`` and ``paged_prefill_island``: the page
interior is striped over tp like the slab's sequence dim, block tables map
each slot's logical pages to the pool, and their mix is plain torch, as
JAX's is XLA (no Pallas kernel). Head-sharded caches
(``decode_seq_shard=False``) run no island: their decode is
``_full_attention`` over the global cache, as in JAX. Every cache may be
int8 (``ServeConfig.kv_dtype="int8"``): one f32 scale a (token, head),
quantized on write and dequantized on read, in plain torch as JAX's XLA.
Under a quantized ``RunConfig.comm_wire`` the GEMM islands declare the
wire's element width, as JAX's do. The MoE island runs the
replicated-dispatch strategy (``core/moe.py``), whose expert GEMMs are the
grouped-GEMM kernel, with device-major expert weights or, for serving,
resident 2D-TP ones (``serve_moe_tp_data``: ff sliced over the dp axes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import moe as pk_moe
from repro_torch.core.autotune import IslandSweep, island_key
from repro_torch.core.comms import GEMM_OP_KIND, CommContext
from repro_torch.core.pgl import P
from repro_torch.core.pgl import axes_size as pgl_axes_size
from repro_torch.core.quant import resolve_wire
from repro_torch.core.ring_attention import pk_ring_attention
from repro_torch.core.template import (Comm, Gather, Island, IslandPlan,
                                       Stacked, Summed, comm_context,
                                       fsdp_gather, island_override,
                                       rank_index)
from repro_torch.core.ulysses import pk_ulysses_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul, matmul_stacked
from repro_torch.models.sharding import ShardingRules

NEG_INF = -1e30


def _dtype_bytes(cfg: ArchConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _wire_bytes(cfg: ArchConfig, run: RunConfig) -> int:
    """Element width a GEMM island's ``Comm`` declares: under a quantized
    ``RunConfig.comm_wire`` the wire's (1 for int8), else the dtype's."""
    fmt = resolve_wire(run.comm_wire)
    return fmt.dtype_bytes if fmt is not None else _dtype_bytes(cfg)


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


def _chunked_attention(q, k, v, *, causal, window, scale=None,
                       qc: int = 512, kc: int = 1024):
    """Memory-bounded attention (JAX ``_chunked_attention``): an online
    softmax over kv blocks of ``kc`` keys for each block of ``qc`` queries,
    f32 statistics; a kv block that the causal or window mask hides from
    the whole q block is skipped, as JAX skips it with ``lax.cond``."""
    b, hq, s, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qc, kc = min(qc, s), min(kc, skv)
    if s % qc or skv % kc:
        raise ValueError(f"chunks ({qc}, {kc}) do not divide ({s}, {skv})")
    qg = q.reshape(b, hkv, g, s, hd).float()
    ar_q = torch.arange(qc, device=q.device)[:, None]
    ar_k = torch.arange(kc, device=q.device)[None, :]
    outs = []
    for q_lo in range(0, s, qc):
        qblk = qg[:, :, :, q_lo:q_lo + qc]
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros_like(m)
        o = torch.zeros((b, hkv, g, qc, hd), dtype=torch.float32,
                        device=q.device)
        for k_lo in range(0, skv, kc):
            if causal and k_lo > q_lo + qc - 1:
                continue
            if window is not None and not k_lo + kc - 1 > q_lo - window:
                continue
            sc = torch.einsum("bkgqd,bksd->bkgqs", qblk,
                              k[:, :, k_lo:k_lo + kc].float()) * scale
            rows, cols = q_lo + ar_q, k_lo + ar_k
            keep = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                keep &= cols <= rows
            if window is not None:
                keep &= cols > rows - window
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p_ = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + p_.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p_, v[:, :, k_lo:k_lo + kc].float())
            m = m_new
        outs.append(o / l_.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=3).reshape(b, hq, s, hd).to(q.dtype)


#: kv lengths from here on take the chunked plain mix on the CPU (JAX's
#: threshold for its XLA chunked path)
XLA_ATTN_CHUNK_THRESHOLD = 8192


def _mix(q, k, v, *, causal, window):
    """The attention mix of training and prefill: the flash kernel on the
    card at every length; on the CPU its plain version, or
    :func:`_chunked_attention` at kv lengths >= ``XLA_ATTN_CHUNK_THRESHOLD``
    (where JAX leaves the full scores)."""
    if not q.is_cuda and k.shape[2] >= XLA_ATTN_CHUNK_THRESHOLD:
        return _chunked_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


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
                  dtype_bytes=_wire_bytes(cfg, run)))


def sp_attention_island(cfg: ArchConfig, run: RunConfig,
                        rules: ShardingRules | None, b: int, s: int, *,
                        causal: bool = True, reference=None) -> Island:
    """Sequence-parallel attention island over the tp axis, q/k/v
    sequence-sharded on dim 2; once per dp group. Ring attention (paper
    §4.2), or Ulysses under ``sp_attention="ulysses"``: its all-to-all
    chunk count is the island's frozen plan (``island_overrides``), else
    ``run.ulysses_chunks``, else with 0 (auto) the a2a chunk policy under
    the island key ``attn_ulysses|all_to_all|b<dtype>`` — measured rows of
    ``calibrate --per-island`` first, the analytic policy otherwise."""
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
            ctx = comm_context(run, axis, mesh=rules.mesh,
                               island=island_key("attn_ulysses",
                                                 "all_to_all", dtb))
            sched = ctx.a2a_chunk_schedule(shape, 1, 2, dtype_bytes=dtb)
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
        return _mix(q, k, v, causal=causal, window=window)

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
    nothing). Returns a new cache. A rank-3 (B, Hkv, S) cache is an int8
    cache's scale plane."""
    if not (torch.is_tensor(pos) and pos.dim()):
        out = cache.clone()
        p = int(pos)
        if 0 <= p < cache.shape[2]:
            out[:, :, p:p + 1] = new.to(cache.dtype)
        return out
    oh = torch.arange(cache.shape[2], device=cache.device)[None, :] \
        == pos[:, None]                                         # (B, S)
    mask = oh[:, None, :, None] if cache.dim() == 4 else oh[:, None, :]
    return torch.where(mask, new.to(cache.dtype), cache)


# int8 KV cache (``ServeConfig.kv_dtype="int8"``): K/V stored as int8 with
# one f32 scale a (token, head), quantized on write and dequantized on read,
# as in JAX. The scale planes are the cache's shape without hd and ride in
# the cache tree as "k_scale"/"v_scale"; a bf16 tree never takes this path.

KV_SCALE_EPS = 1e-12


def _kv_quantize(new):
    """Symmetric per-(token, head) int8: ``new (..., hd)`` -> ``(q int8,
    scale f32 of shape new.shape[:-1])``."""
    f = new.float()
    # times the f32 reciprocal of 127, as XLA compiles JAX's division
    scale = f.abs().amax(dim=-1).clamp_min(KV_SCALE_EPS) * (1.0 / 127.0)
    q = torch.round(f / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


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
                  long_ctx: bool, pos, kv_len, window,
                  quant: bool = False) -> Island:
    """One-token decode over the sequence-sharded KV cache: rank-local slot
    write + flash-decode log-sum-exp merge over the tp ranks
    (:func:`_sharded_mix`). ``pos`` is a scalar (lockstep) or a per-slot
    (B,) vector (the engine's pool). ``quant``: the cache is int8 with
    per-(token, head) f32 scale planes (``cache_ks``/``cache_vs`` inputs,
    stored like the cache) — the new token is quantized before its write
    and the whole cache dequantized for the mix, as in JAX."""
    if long_ctx:
        raise NotImplementedError(
            "long-context decode over (dp × tp) is ROADMAP item A8")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    vec = torch.is_tensor(pos) and pos.dim() > 0

    def reference(q, cache_k, cache_v, k_new, v_new, **kw):
        p_ = kw.get("pos", pos)
        kvl = p_ + 1 if vec else kv_len
        if quant:
            qk, sk = _kv_quantize(k_new)
            qv, sv = _kv_quantize(v_new)
            ck, cv = _cache_write(cache_k, qk, p_), _cache_write(cache_v,
                                                                 qv, p_)
            ks = _cache_write(kw["cache_ks"], sk, p_)
            vs = _cache_write(kw["cache_vs"], sv, p_)
            o = _full_attention(q, _kv_dequantize(ck, ks, q.dtype),
                                _kv_dequantize(cv, vs, q.dtype),
                                causal=False, window=window, q_offset=0,
                                kv_len=kvl)
            return o, ck, cv, ks, vs
        ck = _cache_write(cache_k, k_new, p_)
        cv = _cache_write(cache_v, v_new, p_)
        o = _full_attention(q, ck, cv, causal=False, window=window,
                            q_offset=0, kv_len=kvl)
        return o, ck, cv

    if rules is None:
        return Island("decode_attn", run=run, reference=reference)
    tp = rules.tp
    cache_spec = rules.kv_cache(hkv, b)
    scale_spec = P(*cache_spec[:3])
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

        def upd(c, n):                  # a scale plane lacks the hd dim
            m = mask if c.dim() == 5 else mask[..., 0]
            return torch.where(m, n.to(c.dtype), c)

        if quant:
            qk, sk = _kv_quantize(k_new)
            qv, sv = _kv_quantize(v_new)
            ck, cv = upd(cache_k, qk), upd(cache_v, qv)
            ks, vs = upd(kw["cache_ks"], sk), upd(kw["cache_vs"], sv)
            o = _sharded_mix(ctx, q, _kv_dequantize(ck, ks, q.dtype),
                             _kv_dequantize(cv, vs, q.dtype), kvl, window,
                             cfg)
            return o, ck, cv, ks, vs
        k_, v_ = upd(cache_k, k_new), upd(cache_v, v_new)
        return _sharded_mix(ctx, q, k_, v_, kvl, window, cfg), k_, v_

    inputs = {"q": qspec, "cache_k": cache_spec, "cache_v": cache_spec,
              "k_new": qspec, "v_new": qspec}
    outs = (qspec, Stacked(cache_spec), Stacked(cache_spec))
    if quant:
        inputs["cache_ks"] = inputs["cache_vs"] = scale_spec
        outs += (Stacked(scale_spec), Stacked(scale_spec))
    if vec:
        inputs["pos"] = P(bspec)
    return Island(
        "decode_attn", rules=rules, run=run, axis=tp, fallback_axes=tp,
        inputs=inputs,
        out_specs=outs,
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
                     cross_kv=None, k_scale=None, v_scale=None):
    """One-token decode with KV cache. x: (B, 1, d); cache_k/v: global
    (B, Hkv, S_max, hd), or stacked per rank when sequence-sharded; pos:
    scalar or per-slot (B,). Returns (out (B, 1, d), new_k, new_v).
    ``cross_kv``: an encoder-decoder's cross-attention over the encoder's
    (k, v) (B, Hkv, Se, hd), stored like the cache — no cache, no RoPE, no
    window, every key visible (:func:`cross_decode_island` on a mesh) —
    returning (out, None, None). int8 mode (``k_scale``/``v_scale``, the
    per-(token, head) scale planes stored like the cache): the new token
    is quantized on write, the cache dequantized on read, and the return
    grows to (out, new_k, new_v, new_k_scale, new_v_scale)."""
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
    quant = k_scale is not None
    scales = ()
    if rules is not None and run.decode_seq_shard:
        s_max = cache_k.shape[-2] * (rules.mesh.shape[rules.tp]
                                     if cache_k.dim() == 5 else 1)
        island = decode_island(cfg, run, rules, b, s_max, long_ctx=False,
                               pos=pos, kv_len=kv_len, window=window,
                               quant=quant)
        kw = {"pos": pos} if vec else {}
        if quant:
            kw.update(cache_ks=k_scale, cache_vs=v_scale)
        o, cache_k, cache_v, *scales = island(
            q=q, cache_k=cache_k, cache_v=cache_v, k_new=k_new, v_new=v_new,
            **kw)
    else:
        if quant:
            # the head-sharded fallback quantizes outside any island
            qk, sk = _kv_quantize(k_new)
            qv, sv = _kv_quantize(v_new)
            cache_k = _cache_write(cache_k, qk, pos)
            cache_v = _cache_write(cache_v, qv, pos)
            scales = (_cache_write(k_scale, sk, pos),
                      _cache_write(v_scale, sv, pos))
            k_att = _kv_dequantize(cache_k, scales[0], q.dtype)
            v_att = _kv_dequantize(cache_v, scales[1], q.dtype)
        else:
            cache_k = _cache_write(cache_k, k_new, pos)
            cache_v = _cache_write(cache_v, v_new, pos)
            k_att, v_att = cache_k, cache_v
        o = _full_attention(q, k_att, v_att, causal=False, window=window,
                            q_offset=0, kv_len=kv_len)
    o = o.transpose(1, 2).reshape(b, 1, hq * hd)
    out = torch.matmul(o, _row_weight(p["wo"]))
    return (out, cache_k, cache_v, *scales)


def prefill_write_island(cfg: ArchConfig, run: RunConfig,
                         rules: ShardingRules | None, b: int,
                         L: int, *, quant: bool = False) -> Island:
    """Rank-local write of a prompt's K/V block into the sequence-sharded
    cache: rank r takes its own [r·s_loc, (r+1)·s_loc) window of the new
    (replicated) K/V. A head-sharded cache (``decode_seq_shard=False``) is
    stored global, and the write is the reference's, as JAX's disabled
    island runs it. ``quant``: ``new`` is the quantized int8 block and
    ``new_s`` its per-(token, head) scale plane; both land in the (cache,
    scale) pair."""
    hkv = cfg.n_kv_heads

    def put(cache, new):
        out = cache.clone()
        out[:, :, :new.shape[2]] = new.to(cache.dtype)
        return out

    def window(cache, new):
        # rank r's [r·s_loc, (r+1)·s_loc) slice of the replicated block
        s_loc = cache.shape[3]
        idx = (rank_index(cache) * s_loc)[:, None] \
            + torch.arange(s_loc, device=cache.device)              # (R, s)
        win = new[0][:, :, idx.clamp(0, L - 1)].movedim(2, 0)
        hit = (idx < L)[:, None, None, :]
        if cache.dim() == 5:
            hit = hit[..., None]
        return torch.where(hit, win.to(cache.dtype), cache)

    if quant:
        def reference(cache, scale, new, new_s):
            return put(cache, new), put(scale, new_s)

        def body(ctx, cache, scale, new, new_s):
            return window(cache, new), window(scale, new_s)
    else:
        def reference(cache, new):
            return put(cache, new)

        def body(ctx, cache, new):
            return window(cache, new)

    if rules is None or not run.decode_seq_shard:
        return Island("prefill_write", run=run, reference=reference)
    cache_spec = rules.kv_cache(hkv, b)
    bspec = rules.dim(b, rules.dp)
    inputs = {"cache": cache_spec, "new": P(bspec, None, None, None)}
    outs = Stacked(cache_spec)
    if quant:
        scale_spec = P(*cache_spec[:3])
        inputs.update(scale=scale_spec, new_s=P(bspec, None, None))
        outs = (outs, Stacked(scale_spec))
    return Island(
        "prefill_write", rules=rules, run=run, inputs=inputs,
        out_specs=outs, body=body, reference=reference,
        enable=run.decode_seq_shard)


def prefill_attention_block(p, x, cache_k, cache_v, cfg: ArchConfig,
                            run: RunConfig, rules: ShardingRules | None, *,
                            k_scale=None, v_scale=None):
    """Batched prefill: causal attention over the whole (right-padded)
    prompt — the flash kernel on the card — with K/V written into the
    decode cache at positions [0, L). Rows past a slot's real length are
    causal-masked garbage the caller discards, as in the JAX package.
    Returns (out (B, L, d), new_cache_k, new_cache_v), plus the new scale
    planes in int8 mode (``k_scale``/``v_scale`` given): the prompt's K/V is
    quantized once and attended over dequantized, so the prefill sees what
    later decode steps read."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _col_proj(x, p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = _col_proj(x, p["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _col_proj(x, p["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    positions = torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    quant = k_scale is not None
    if quant:
        qk, sk = _kv_quantize(k)
        qv, sv = _kv_quantize(v)
        k = _kv_dequantize(qk, sk, q.dtype)
        v = _kv_dequantize(qv, sv, q.dtype)
    o = _mix(q, k, v, causal=True, window=cfg.sliding_window)
    write = prefill_write_island(cfg, run, rules, b, s, quant=quant)
    if quant:
        new_k, k_scale = write(cache=cache_k, scale=k_scale, new=qk,
                               new_s=sk)
        new_v, v_scale = write(cache=cache_v, scale=v_scale, new=qv,
                               new_s=sv)
        scales = (k_scale, v_scale)
    else:
        new_k = write(cache=cache_k, new=k)
        new_v = write(cache=cache_v, new=v)
        scales = ()
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    out = attn_out_island(cfg, run, rules, b, s)(o=o, wo=p["wo"])
    return (out, new_k, new_v, *scales)


# ---------------------------------------------------------------------------
# Paged KV cache (runtime/paging.py pool + block tables)
# ---------------------------------------------------------------------------
#
# The paged islands are the block-table twins of decode_island /
# prefill_write_island: the page interior is striped over the tp axis like
# the slab's sequence dim, so each rank writes its own stripe of every page
# and attention keeps the flash-decode log-sum-exp merge. The helpers take
# a leading rank axis (R, ...) — the stacked ranks in an island's body, one
# rank holding whole pages in the dense reference. Reads gather pages
# through the block table; writes go through a copy of the pool with one
# scratch page past its end, where every miss lands (JAX's
# ``.at[...].set(mode="drop")`` sends them out of range): rows whose block
# table is the engine's -1 sentinel (free slots, slots mid-prefill) write
# nothing, which is what makes decode ticks between prefill chunks safe.


def _paged_gather(pool, bt):
    """pool (R, N, Hkv, s[, hd]); bt (R, B, P) page ids (clipped into the
    pool) -> (R, B, Hkv, P*s[, hd]). A pool without hd is an int8 pool's
    scale pool."""
    r = pool.shape[0]
    ranks = torch.arange(r, device=pool.device).view(r, 1, 1)
    g = pool[ranks, bt.clamp(0, pool.shape[1] - 1).long()]  # (R,B,P,Hkv,s..)
    g = g.movedim(2, 3)
    return g.reshape(r, g.shape[1], g.shape[2], -1, *g.shape[5:])


def _page_positions(pmax: int, ps: int, off, s_loc: int):
    """Global cache position of every gathered cell, (R, P*s_loc): page p's
    cell j on the rank at stripe offset ``off`` (R,) is p·ps + off + j."""
    cells = (torch.arange(pmax, device=off.device)[:, None] * ps
             + torch.arange(s_loc, device=off.device)[None, :]).reshape(-1)
    return off[:, None] + cells


def _paged_mix(q, gk, gv, ki, *, kv_len=None, q_pos=None, window, ctx):
    """Attention of q (R, B, Hq, sq, hd) over gathered pages gk, gv
    (R, B, Hkv, P*s, hd) whose cells sit at global positions ``ki``
    (R, P*s). Masking is ``ki < kv_len`` (decode, (R, B)) or
    ``ki <= q_pos`` (a prefill chunk, causal against the queries' global
    positions (R, sq)), so allocated but unwritten page tails are never
    attended. ``ctx`` None = whole pages on each row (the dense
    reference); else shard-local partials merged by log-sum-exp over the
    ranks (``pmax``/``psum``, as :func:`_sharded_mix`)."""
    r, b, hq, sq, hd = q.shape
    hkv = gk.shape[2]
    g = hq // hkv
    qg = q.reshape(r, b, hkv, g, sq, hd).float()
    sc = torch.einsum("rbkgqd,rbksd->rbkgqs", qg, gk.float()) * hd ** -0.5
    kib = ki.view(r, 1, 1, 1, 1, -1)
    if kv_len is not None:
        lim = kv_len.view(r, b, 1, 1, 1, 1) - 1
        keep = kib <= lim
    else:
        lim = q_pos.view(r, 1, 1, 1, sq, 1)
        keep = kib <= lim
    if window is not None:
        keep = keep & (kib > lim - window)
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)
    if ctx is not None:
        m = ctx.pmax(m)
    p_ = torch.exp(sc - m[..., None])
    l_ = p_.sum(dim=-1)
    o = torch.einsum("rbkgqs,rbksd->rbkgqd", p_, gv.float())
    if ctx is not None:
        l_ = ctx.psum(l_, backend="bulk")
        o = ctx.psum(o, backend="bulk")
    o = o / l_.clamp_min(1e-30)[..., None]
    return o.reshape(r, b, hq, sq, hd).to(q.dtype)


def _with_scratch(pool):
    """A copy of pool (R, N, ...) with one more page, N, where dropped
    writes land; its first N pages are the result."""
    buf = pool.new_empty((pool.shape[0], pool.shape[1] + 1,
                          *pool.shape[2:]))
    buf[:, :pool.shape[1]] = pool
    return buf


def _paged_decode_write(pool, new, bt, pos, ps: int, off, s_loc: int):
    """Write one token a slot, new (R, B, Hkv, 1[, hd]), into its
    block-table page at ``pos`` (R, B). Misses (the position outside this rank's
    stripe, an unmapped page) are dropped. Returns the new pool."""
    r, n = pool.shape[:2]
    lp = (pos // ps).clamp(0, bt.shape[-1] - 1)
    pid = bt.gather(-1, lp[..., None].long())[..., 0]              # (R, B)
    rr = pos % ps
    o = off[:, None]
    hit = (rr >= o) & (rr < o + s_loc) & (pid >= 0)
    rl = (rr - o).clamp(0, s_loc - 1).long()
    buf = _with_scratch(pool)
    ranks = torch.arange(r, device=pool.device)[:, None]
    buf[ranks, torch.where(hit, pid, n).long(), :, rl] = \
        new[:, :, :, 0].to(pool.dtype)
    return buf[:, :n]


def _paged_chunk_write(pool, new, bt, c0, wf, ps: int, off, s_loc: int):
    """Write one prefill chunk's K/V, new (R, B, Hkv, sq, hd) at global
    positions [c0, c0+sq), into block-table pages: gather the touched
    pages, select per cell between the chunk's value and the current
    content, scatter whole pages back (unmapped ones dropped). The per-cell
    select is what makes copy-on-write prefix resume sound: positions below
    the per-slot floor ``wf`` (R, B) keep the donor pages' bytes even though
    the boundary chunk recomputes them. ``c0`` is (R,)."""
    r, n = pool.shape[:2]
    b, hk, sq = new.shape[1:4]
    pmax = bt.shape[-1]
    npg = -(-sq // ps)
    dev = pool.device
    pgs = c0.view(r, 1) // ps + torch.arange(npg, device=dev)    # (R, npg)
    pid = bt.gather(-1, pgs.clamp(0, pmax - 1)[:, None, :]
                    .expand(r, b, npg).long())                    # (R,B,npg)
    pid = torch.where((pgs < pmax)[:, None, :], pid, torch.full_like(pid, -1))
    tt = (torch.arange(npg, device=dev)[:, None] * ps
          + torch.arange(s_loc, device=dev)[None, :])[None] \
        + off.view(r, 1, 1)                                    # (R,npg,s)
    ranks = torch.arange(r, device=dev)
    rest = new.shape[4:]                     # (hd,), or () for a scale pool
    src = new[ranks[:, None], :, :, tt.clamp(0, sq - 1).reshape(r, -1)]
    src = src.reshape(r, npg, s_loc, b, hk, *rest).permute(
        0, 3, 1, 4, 2, *range(5, 5 + len(rest)))
    cur = pool[ranks.view(r, 1, 1), pid.clamp(0, n - 1).long()]
    t_glob = c0.view(r, 1, 1) + tt
    cell = ((tt < sq)[:, None, :, None, :]
            & (t_glob[:, None, :, None, :] >= wf.view(r, b, 1, 1, 1)))
    if rest:
        cell = cell[..., None]
    vals = torch.where(cell, src.to(pool.dtype), cur)
    buf = _with_scratch(pool)
    buf[ranks.view(r, 1, 1), torch.where(pid >= 0, pid, n).long()] = vals
    return buf[:, :n]


def _dp_pool_base(rules: ShardingRules | None, b: int, n_pages: int,
                  device) -> torch.Tensor:
    """The first global page id of each dp group's pool partition, (n_dp,),
    when the pool is partitioned (the batch of ``b`` slots shards over dp),
    else one 0: the paged islands' ``base`` input, which the dp groups
    slice like the batch (JAX's ``_dp_pool_base`` computes it from
    ``axis_index`` in the body)."""
    if rules is None or rules.dim(b, rules.dp) is None:
        return torch.zeros(1, dtype=torch.int64, device=device)
    n_dp = pgl_axes_size(rules.mesh, rules.dp)
    return torch.arange(n_dp, device=device) * (n_pages // n_dp)


def _local_pages(bt, base):
    """Global block-table page ids -> ids in the dp group's pool partition
    that starts at page ``base``; -1 (unmapped) stays -1."""
    return torch.where(bt >= 0, bt - base, -1)


def _zero_offset(x) -> torch.Tensor:
    """The stripe offset (1,) of the dense reference: one rank holding
    whole pages."""
    return torch.zeros(1, dtype=torch.int64, device=x.device)


def _paged_write_gather(write, pools, k_new, v_new, bt, quant: bool, qdt):
    """The paged islands' shared write and gather: ``write(pool, new)``
    into each pool, then the pages gathered through the block table ``bt``.
    ``pools`` is (pool_k, pool_v), or with ``quant`` also the scale pools:
    K/V are quantized before their writes and the gathered pages
    dequantized to ``qdt``. Returns (gk, gv, new pools)."""
    if not quant:
        pk, pv = write(pools[0], k_new), write(pools[1], v_new)
        return _paged_gather(pk, bt), _paged_gather(pv, bt), (pk, pv)
    (qk, sk), (qv, sv) = _kv_quantize(k_new), _kv_quantize(v_new)
    new = tuple(write(p, n) for p, n in zip(pools, (qk, qv, sk, sv)))
    gk, gv = (_kv_dequantize(_paged_gather(new[i], bt),
                             _paged_gather(new[i + 2], bt), qdt)
              for i in (0, 1))
    return gk, gv, new


def paged_decode_island(cfg: ArchConfig, run: RunConfig,
                        rules: ShardingRules | None, b: int, page_size: int,
                        *, window, quant: bool = False) -> Island:
    """One-token decode over the paged pool: block-table page write, page
    gather and the flash-decode log-sum-exp merge over the tp ranks. It
    keeps the slab ``decode_island``'s name and ``Comm`` — the merge
    collective is the same — so frozen per-bucket plans apply unchanged to
    the paged layout. ``quant``: int8 pools with per-(token, head) f32
    scale pools (``pool_ks``/``pool_vs``, each stored like its pool) — the
    token is quantized before its page write, gathers dequantize."""
    hq, hd = cfg.n_heads, cfg.hd

    def attend(q, pools, k_new, v_new, bt, pos, ps, off, s_loc, ctx):
        def write(pool, new):
            return _paged_decode_write(pool, new, bt, pos, ps, off, s_loc)
        gk, gv, new = _paged_write_gather(write, pools, k_new, v_new, bt,
                                          quant, q.dtype)
        ki = _page_positions(bt.shape[-1], ps, off, s_loc)
        o = _paged_mix(q, gk, gv, ki, kv_len=pos + 1, window=window, ctx=ctx)
        return (o, *new)

    def reference(q, pool_k, pool_v, k_new, v_new, bt, pos, base, **kw):
        pools = (pool_k, pool_v) + ((kw["pool_ks"], kw["pool_vs"])
                                    if quant else ())
        out = attend(q[None], tuple(t[None] for t in pools), k_new[None],
                     v_new[None], _local_pages(bt, base)[None], pos[None],
                     page_size, _zero_offset(q), page_size, None)
        return tuple(t[0] for t in out)

    if rules is None:
        return Island("decode_attn", run=run, reference=reference)
    tp = rules.tp
    bspec, pool_spec = rules.dim(b, rules.dp), rules.kv_pool(b)
    qspec = P(bspec, None, None, None)

    def body(ctx, q, pool_k, pool_v, k_new, v_new, bt, pos, base, **kw):
        s_loc = pool_k.shape[3]
        off = rank_index(pool_k) * s_loc
        bt_l = _local_pages(bt, base.view(-1, 1, 1))
        pools = (pool_k, pool_v) + ((kw["pool_ks"], kw["pool_vs"])
                                    if quant else ())
        return attend(q, pools, k_new, v_new, bt_l, pos, page_size, off,
                      s_loc, ctx)

    inputs, outs = _paged_specs(pool_spec, qspec, quant)
    return Island(
        "decode_attn", rules=rules, run=run, axis=tp, fallback_axes=tp,
        inputs={**inputs, "k_new": qspec, "v_new": qspec,
                "bt": P(bspec, None), "pos": P(bspec),
                "base": P(pool_spec[0])},
        out_specs=outs,
        body=body, reference=reference,
        enable=run.decode_seq_shard,
        divisible=((page_size, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1,
                  payload_bytes=2 * b * hq * hd * 4))


def _paged_specs(pool_spec: P, qspec: P, quant: bool) -> tuple[dict, tuple]:
    """The paged islands' query and pool inputs and their out_specs; int8
    pools add the scale pools (the pool's spec without hd)."""
    inputs = {"q": qspec, "pool_k": pool_spec, "pool_v": pool_spec}
    outs = (qspec, Stacked(pool_spec), Stacked(pool_spec))
    if quant:
        scale_spec = P(*pool_spec[:3])
        inputs.update(pool_ks=scale_spec, pool_vs=scale_spec)
        outs += (Stacked(scale_spec), Stacked(scale_spec))
    return inputs, outs


def paged_prefill_island(cfg: ArchConfig, run: RunConfig,
                         rules: ShardingRules | None, b: int, s: int,
                         page_size: int, *, window,
                         quant: bool = False) -> Island:
    """One prefill chunk over the paged pool: the chunk's K/V written into
    the group's block-table pages (rank-local stripes), then causal
    attention of the chunk's queries over every mapped page — a donor
    prefix, earlier chunks and the chunk itself — with the tp log-sum-exp
    merge. ``c0`` is the chunk's global start, ``wf`` the per-slot
    write_from floor below which writes are suppressed (copy-on-write
    prefix resume). ``quant``: int8 pools and scale pools; the chunk's K/V
    is quantized once before the write and the queries attend over
    dequantized pages, the chunk's own K/V included, as in JAX."""
    hq, hd = cfg.n_heads, cfg.hd

    def attend(q, pools, k_new, v_new, bt, c0, wf, ps, off, s_loc, ctx):
        def write(pool, new):
            return _paged_chunk_write(pool, new, bt, c0, wf, ps, off, s_loc)
        gk, gv, new = _paged_write_gather(write, pools, k_new, v_new, bt,
                                          quant, q.dtype)
        ki = _page_positions(bt.shape[-1], ps, off, s_loc)
        q_pos = c0.view(-1, 1) + torch.arange(s, device=q.device)
        o = _paged_mix(q, gk, gv, ki, q_pos=q_pos, window=window, ctx=ctx)
        return (o, *new)

    def reference(q, pool_k, pool_v, k_new, v_new, bt, c0, wf, base, **kw):
        pools = (pool_k, pool_v) + ((kw["pool_ks"], kw["pool_vs"])
                                    if quant else ())
        out = attend(q[None], tuple(t[None] for t in pools), k_new[None],
                     v_new[None], _local_pages(bt, base)[None], c0.view(1),
                     wf[None], page_size, _zero_offset(q), page_size, None)
        return tuple(t[0] for t in out)

    if rules is None:
        return Island("paged_prefill_attn", run=run, reference=reference)
    tp = rules.tp
    bspec, pool_spec = rules.dim(b, rules.dp), rules.kv_pool(b)
    qspec = P(bspec, None, None, None)

    def body(ctx, q, pool_k, pool_v, k_new, v_new, bt, c0, wf, base, **kw):
        s_loc = pool_k.shape[3]
        off = rank_index(pool_k) * s_loc
        bt_l = _local_pages(bt, base.view(-1, 1, 1))
        pools = (pool_k, pool_v) + ((kw["pool_ks"], kw["pool_vs"])
                                    if quant else ())
        return attend(q, pools, k_new, v_new, bt_l, c0, wf, page_size, off,
                      s_loc, ctx)

    inputs, outs = _paged_specs(pool_spec, qspec, quant)
    return Island(
        "paged_prefill_attn", rules=rules, run=run, axis=tp,
        fallback_axes=tp,
        inputs={**inputs, "k_new": qspec, "v_new": qspec,
                "bt": P(bspec, None), "c0": P(), "wf": P(bspec),
                "base": P(pool_spec[0])},
        out_specs=outs,
        body=body, reference=reference,
        enable=run.decode_seq_shard,
        divisible=((page_size, tp),),
        comm=Comm("psum", backend="bulk", n_chunks=1,
                  payload_bytes=2 * b * hq * s * hd * 4))


def paged_decode_attention(p, x, pool_k, pool_v, bt, pos, cfg: ArchConfig,
                           run: RunConfig, rules: ShardingRules | None, *,
                           page_size: int, k_scale=None, v_scale=None):
    """One-token decode against the paged pool (the block-table twin of
    :func:`decode_attention`). x: (B, 1, d); pool_k/v: one layer's pool as
    stored (``paging.paged_cache_template``) of ``page_size``-token pages
    (the engine's ``PageGeometry``); bt: (B, P) block table (−1 =
    unmapped: the write drops, so free and mid-prefill slots are inert);
    pos: per-slot (B,). Returns (out (B, 1, d), new_pool_k, new_pool_v),
    plus the new scale pools in int8 mode (``k_scale``/``v_scale`` given);
    the out-projection is a plain product, as in the slab decode."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _col_proj(x, p["wq"]).reshape(b, 1, hq, hd).transpose(1, 2)
    k_new = _col_proj(x, p["wk"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    v_new = _col_proj(x, p["wv"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    quant = k_scale is not None
    island = paged_decode_island(cfg, run, rules, b, page_size,
                                 window=cfg.sliding_window, quant=quant)
    kw = {"pool_ks": k_scale, "pool_vs": v_scale} if quant else {}
    o, *pools = island(
        q=q, pool_k=pool_k, pool_v=pool_v, k_new=k_new, v_new=v_new, bt=bt,
        pos=pos, base=_dp_pool_base(rules, b, pool_k.shape[-4], x.device),
        **kw)
    o = o.transpose(1, 2).reshape(b, 1, hq * hd)
    return (torch.matmul(o, _row_weight(p["wo"])), *pools)


def paged_prefill_attention_block(p, x, pool_k, pool_v, bt, chunk_start,
                                  write_from, cfg: ArchConfig,
                                  run: RunConfig,
                                  rules: ShardingRules | None, *,
                                  page_size: int, k_scale=None,
                                  v_scale=None):
    """One chunk of paged prefill attention: x (B, cl, d) are the chunk's
    hidden states at global positions [chunk_start, chunk_start+cl); its
    K/V land in the block table's ``page_size``-token pages and its queries
    attend over every mapped page. ``write_from`` (B,): the per-slot
    copy-on-write floor. Returns (out (B, cl, d), new_pool_k, new_pool_v),
    plus the new scale pools in int8 mode (``k_scale``/``v_scale`` given);
    the out-projection is the GEMM+AR island."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _col_proj(x, p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = _col_proj(x, p["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _col_proj(x, p["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    c0 = torch.as_tensor(chunk_start, dtype=torch.int64, device=x.device)
    positions = c0 + torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    quant = k_scale is not None
    island = paged_prefill_island(cfg, run, rules, b, s, page_size,
                                  window=cfg.sliding_window, quant=quant)
    kw = {"pool_ks": k_scale, "pool_vs": v_scale} if quant else {}
    o, *pools = island(
        q=q, pool_k=pool_k, pool_v=pool_v, k_new=k, v_new=v, bt=bt, c0=c0,
        wf=write_from, base=_dp_pool_base(rules, b, pool_k.shape[-4],
                                          x.device), **kw)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    out = attn_out_island(cfg, run, rules, b, s)(o=o, wo=p["wo"])
    return (out, *pools)


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
                  dtype_bytes=_wire_bytes(cfg, run)))


def mlp_block(p, x, cfg: ArchConfig, run: RunConfig,
              rules: ShardingRules | None):
    """Dense (optionally gated) MLP with TP through the MLP island."""
    b, s, _ = x.shape
    island = mlp_island(cfg, run, rules, b, s)
    w3 = p["w3"] if cfg.gated_mlp else torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
    return island(x=x, w1=p["w1"], w3=w3, w2=p["w2"])


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
    its backward; with no mesh the dense oracle differentiates too.

    ``run.serve_moe_tp_data`` (resident 2D-TP serving, JAX's other
    branch): the expert weights stay put, ff sliced over the dp axes; every
    dp group takes the tokens of all groups (its input is not sliced over
    dp: the all-gather of JAX's body), runs the replicated dispatch on them
    with its ff slice — the plan counts ``b·s`` tokens — and the groups' f32
    partials are summed in dp order (a :class:`Summed` output, JAX's
    ``psum_scatter``), each group keeping its own rows of the global
    result. No ring combine, and no FSDP gather of expert weights, as in
    JAX. The output is f32 there; ``moe_block`` casts it."""
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
    tp_data = run.serve_moe_tp_data
    # one gating/capacity plan: 2D-TP serving dispatches every dp group's
    # tokens, the default layout its own
    n_tok = b * s if tp_data else rules.local_batch(b) * s
    moe_chunks = run.moe_chunks
    if moe_chunks == 0:
        # auto: measured first off the `calibrate --per-island` MoE-dispatch
        # a2a rows (island "moe_dispatch"), the analytic a2a chunk policy
        # otherwise — the Ulysses island's order
        n_dev = rules.mesh.shape[tp]
        base = pk_moe.dispatch_plan(n_tok, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor)
        shape = (n_dev, max(cfg.n_experts // max(n_dev, 1), 1), base.cap, d)
        ctx = comm_context(run, tp, mesh=rules.mesh,
                           island=island_key("moe_dispatch", "all_to_all",
                                             _dtype_bytes(cfg)))
        moe_chunks = ctx.a2a_chunk_schedule(
            shape, 0, 0, dtype_bytes=_dtype_bytes(cfg)).n_chunks
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
            ring_combine=run.pk_ring_psum and not tp_data)
        aux = ctx.psum(aux.reshape(1, 1).expand(r, 1), backend="bulk") / r
        y = y.reshape(x.shape)
        return (y.float() if tp_data else y), aux

    gathers: dict[str, Gather] = {}
    xspec = yspec = P(bspec, None, None)
    if tp_data:
        # resident 2D-TP: (M, E_loc, d, ff_loc/dp), no FSDP gather
        dpff = rules.dim(cfg.d_ff // pk_moe.ep_tp_split(
            cfg.n_experts, rules.mesh.shape[tp])[1], rules.dp)
        wspec, w2spec = P(tp, None, None, dpff), P(tp, None, dpff, None)
        xspec, yspec = P(None, None, None), Summed(yspec)
    else:
        # device-major PGL weights: (M, E_loc, d[, /fsdp], ff_loc)
        wspec = P(tp, None, rules.dim(d, f), None)
        w2spec = P(tp, None, None, rules.dim(d, f))
        gathers = {"w1": Gather(dim=2, size=d), "w2": Gather(dim=3, size=d)}
        if gated:
            gathers["w3"] = Gather(dim=2, size=d)
    return Island(
        "moe", rules=rules, run=run,
        inputs={"x": xspec, "router": P(None, None),
                "w1": wspec, "w3": wspec if gated else P(), "w2": w2spec},
        out_specs=(yspec, P(bspec)),
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
    return out.to(x.dtype), aux.float().mean()


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
                     seq: int = 128, phase: str = "all",
                     page_size: int = 0) -> list:
    """Every island a forward pass (and a decode step) builds: ``prefill``
    (GEMM islands at m = B·seq), ``decode`` (m = B·1 plus the decode
    attention island) or ``all`` (the union, plus the loss island — what
    the training launcher prints — and, unless ``run.sp_attention`` is
    "none", the sequence-parallel island of ``forward_train(seq_sharded=
    True)``, as JAX lists it). The attention islands only where a layer
    attends — mamba layers have none: their collectives are implicit in
    JAX's GSPMD program, and the port computes them on global activations
    (``models/ssm.py``). ``page_size`` > 0 lists the paged cache's islands
    in the serving phases: decode keeps the ``decode_attn`` name and
    ``Comm`` (frozen plans apply unchanged) and prefill gains the
    ``paged_prefill_attn`` merge island the chunk step runs."""
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
        if page_size and phase == "prefill":
            islands.append(paged_prefill_island(
                cfg, run, rules, b, s, page_size, window=cfg.sliding_window))
        if page_size and phase == "decode":
            islands.append(paged_decode_island(
                cfg, run, rules, b, page_size, window=cfg.sliding_window))
        elif phase in ("all", "decode"):
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
                 seq: int = 128, phase: str = "all",
                 page_size: int = 0) -> list[IslandPlan]:
    """Trace-free overlap schedule of every island of one serving bucket
    (``phase`` prefill / decode; ``page_size`` > 0 for the paged cache) or
    of a training forward (``all``)."""
    return [i.plan() for i in _forward_islands(cfg, run, rules, batch=batch,
                                               seq=seq, phase=phase,
                                               page_size=page_size)]


def island_comm_sweeps(cfg: ArchConfig, run: RunConfig,
                       rules: ShardingRules | None, *, batch: int = 8,
                       seq: int = 128, phase: str = "all"):
    """Per-island calibration sweep specs (``autotune.IslandSweep``) for
    every active GEMM-collective and all-to-all island of this forward
    pass — the driver behind ``python -m repro_torch.autotune calibrate
    --per-island``. GEMM islands carry the exact (op, m, n, k, dtype) their
    ``CommContext`` dispatch queries with; a2a islands (Ulysses re-sharding)
    the local payload shape and split/concat axes, stored under
    ``CommContext.a2a_coords``. ``phase`` narrows to one serving bucket's
    inventory. A MoE model adds its dispatch payload under the key
    ``moe_dispatch|all_to_all|b<dtype>``, which ``moe_chunks = 0`` queries."""
    sweeps = []
    for isl in _forward_islands(cfg, run, rules, batch=batch, seq=seq,
                                phase=phase):
        c = isl.comm
        if c is None or isl.fallback_reason() is not None:
            continue
        if c.op in GEMM_OP_KIND:
            sweeps.append(IslandSweep(island=isl.island_key, op=c.op,
                                      m=c.m, n=c.n, k=c.k,
                                      dtype_bytes=c.dtype_bytes))
        elif c.op == "all_to_all" and c.shape is not None:
            m, n, k = CommContext.a2a_coords(c.shape, c.split_axis,
                                             c.concat_axis)
            sweeps.append(IslandSweep(
                island=isl.island_key, op="all_to_all", m=m, n=n, k=k,
                dtype_bytes=c.dtype_bytes, shape=tuple(c.shape),
                split_axis=c.split_axis, concat_axis=c.concat_axis))
    if any(sp.mlp == "moe" for sp in cfg.layer_pattern()) \
            and rules is not None:
        # the a2a dispatch payload (n_dev, E_loc, capacity, d), split ==
        # concat == 0: not a declared island Comm (the MoE island's is the
        # combine), but moe_chunks = 0 dispatches off these rows
        n_dev = rules.mesh.shape[rules.tp]
        if cfg.n_experts % n_dev == 0:
            b_loc = rules.local_batch(batch)
            s = 1 if phase == "decode" else seq
            n_tok = batch * s if run.serve_moe_tp_data else b_loc * s
            plan = pk_moe.dispatch_plan(n_tok, n_experts=cfg.n_experts,
                                        top_k=cfg.top_k,
                                        capacity_factor=cfg.capacity_factor)
            shape = (n_dev, cfg.n_experts // n_dev, plan.cap, cfg.d_model)
            m, n, k = CommContext.a2a_coords(shape, 0, 0)
            sweeps.append(IslandSweep(
                island=island_key("moe_dispatch", "all_to_all",
                                  _dtype_bytes(cfg)),
                op="all_to_all", m=m, n=n, k=k,
                dtype_bytes=_dtype_bytes(cfg), shape=shape,
                split_axis=0, concat_axis=0))
    return sweeps
