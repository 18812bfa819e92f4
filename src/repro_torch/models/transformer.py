"""Model assembly for the serving and training paths — the twin of
``repro/models/transformer.py``: parameter and cache templates (shape,
spec and init in one place), the training forward (``forward_train``),
the last-position prefill forward (``forward_prefill``), then the
cache-building prefill and the one-token decode steps, looping over layer
periods in Python where the JAX package scans.

Storage layout: a leaf whose spec shards a dim over the tensor-parallel
axis is stored stacked per rank, once (``core.pgl.layout`` with the rank
axis after the layer-period dim); replicated leaves are stored global.
With no mesh every leaf is global. Layers mix with attention or a mamba
block (``models/ssm.py``; its state cache ``h`` (np, R, B, di/R, N) f32
and conv tail (np, R, B, ck-1, di/R)) and have a dense, MoE (expert
weights device-major over tp, ``core/moe.py``) or no FFN, so dense, MoE,
SSM and hybrid decoders serve. An encoder-decoder (whisper) adds the
non-causal encoder (``enc_blocks``, ``enc_final_norm``) and a
cross-attention sub-block in every decoder layer; it trains
(``forward_train``), runs ``forward_prefill`` and decodes one token at a
time over the encoder's K/V in ``cache["cross"]``
(``decode_step_encdec``), as in JAX. Every family trains and runs
``forward_prefill``: the block loop runs attention or mamba mixers and
dense, MoE or no FFN, carrying the MoE aux loss, as JAX's does. The
serving steps run over the slab cache of ``cache_template`` or over the
page pool of ``runtime/paging.py``: ``decode_step`` routes a cache that
carries block tables through the paged islands, and
``prefill_paged_step`` prefills one chunk into the pool.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Iterator

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import DTYPES
from repro_torch.configs.base import ArchConfig, LayerSpec, RunConfig
from repro_torch.core import pgl
from repro_torch.core.moe import ep_tp_split
from repro_torch.core.pgl import P
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.sharding import ShardingRules


@dataclasses.dataclass(frozen=True)
class PD:
    """Parameter (or cache) definition: global shape, spec, init, dtype.
    ``periods`` marks a leading layer-period dim (spec entry None)."""
    shape: tuple[int, ...]
    spec: P
    init: str = "normal"          # normal | zeros | ones | a_log | dt_bias
    dtype: torch.dtype = torch.bfloat16
    periods: bool = False
    #: stored with 16-byte rows (``pgl.aligned_rows``): the GEMM reads it
    #: through a tensor map (the head, whose vocab shard may be ragged)
    aligned: bool = False

    def stacked(self, n: int) -> "PD":
        return dataclasses.replace(self, shape=(n, *self.shape),
                                   spec=P(None, *self.spec), periods=True)


def leaves(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted (jax.tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def set_path(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def has_ssm(cfg: ArchConfig) -> bool:
    """Does any layer mix with a mamba block?"""
    return any(sp.mixer == "mamba" for sp in cfg.layer_pattern())


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _attn_pds(cfg: ArchConfig, r: ShardingRules | None, dt) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sp = (lambda i, o, tp_dim: r.w2d(i, o, tp_dim=tp_dim)) if r else \
        (lambda i, o, tp_dim: P(None, None))
    return {
        "norm": PD((d,), P(None), "ones", dt),
        "wq": PD((d, hq * hd), sp(d, hq * hd, 1), "normal", dt),
        "wk": PD((d, hkv * hd), sp(d, hkv * hd, 1), "normal", dt),
        "wv": PD((d, hkv * hd), sp(d, hkv * hd, 1), "normal", dt),
        "wo": PD((hq * hd, d), sp(hq * hd, d, 0), "normal", dt),
    }


def _mlp_pds(cfg: ArchConfig, r: ShardingRules | None, dt) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    sp = (lambda i, o, tp_dim: r.w2d(i, o, tp_dim=tp_dim)) if r else \
        (lambda i, o, tp_dim: P(None, None))
    out = {
        "norm": PD((d,), P(None), "ones", dt),
        "w1": PD((d, ff), sp(d, ff, 1), "normal", dt),
        "w2": PD((ff, d), sp(ff, d, 0), "normal", dt),
    }
    if cfg.gated_mlp:
        out["w3"] = PD((d, ff), sp(d, ff, 1), "normal", dt)
    return out


def _moe_pds(cfg: ArchConfig, r: ShardingRules | None, dt) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    m = r.mesh.shape[r.tp] if r is not None else 1
    ep, tp_ff = ep_tp_split(e, m)
    e_loc, ff_loc = e // ep, ff // tp_ff
    fs = r.dim(d, r.fsdp_axes) if r is not None else None
    tp = r.tp if r is not None else None
    if r is not None and r.run.serve_moe_tp_data:
        # resident 2D-TP serving: ff_loc sharded over the dp axes, so
        # serving never gathers expert weights (JAX ``_moe_pds``)
        dpff = r.dim(ff_loc, r.dp)
        w1s, w2s = P(tp, None, None, dpff), P(tp, None, dpff, None)
    else:
        w1s, w2s = P(tp, None, fs, None), P(tp, None, None, fs)
    out = {
        "norm": PD((d,), P(None), "ones", dt),
        "router": PD((d, e), P(None, None), "normal", torch.float32),
        # device-major PGL layout over the tp axis (EP×TP)
        "w1": PD((m, e_loc, d, ff_loc), w1s, "normal", dt),
        "w2": PD((m, e_loc, ff_loc, d), w2s, "normal", dt),
    }
    if cfg.gated_mlp:
        out["w3"] = PD((m, e_loc, d, ff_loc), w1s, "normal", dt)
    return out


def _mamba_pds(cfg: ArchConfig, r: ShardingRules | None, dt) -> dict:
    d, di, n, ck, dtr = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.conv_kernel, cfg.dtr)
    tp = r.tp if r is not None else None
    fs = r.dim(d, r.fsdp_axes) if r is not None else None
    tpd = (lambda s: r.dim(s, tp)) if r is not None else (lambda s: None)
    return {
        "norm": PD((d,), P(None), "ones", dt),
        "in_proj": PD((d, 2 * di), P(fs, tpd(2 * di)), "normal", dt),
        "conv_w": PD((di, ck), P(tpd(di), None), "normal", dt),
        "conv_b": PD((di,), P(tpd(di)), "zeros", dt),
        "x_proj": PD((di, dtr + 2 * n), P(tpd(di), None), "normal", dt),
        "dt_proj": PD((dtr, di), P(None, tpd(di)), "normal", dt),
        "dt_bias": PD((di,), P(tpd(di)), "dt_bias", torch.float32),
        "A_log": PD((di, n), P(tpd(di), None), "a_log", torch.float32),
        "D": PD((di,), P(tpd(di)), "ones", torch.float32),
        "out_proj": PD((di, d), P(tpd(di), fs), "normal", dt),
    }


def _block_pds(spec: LayerSpec, cfg: ArchConfig, r, dt, *,
               cross: bool) -> dict:
    out = ({"attn": _attn_pds(cfg, r, dt)} if spec.mixer == "attn"
           else {"mamba": _mamba_pds(cfg, r, dt)})
    if cross:
        out["cross"] = _attn_pds(cfg, r, dt)
    if spec.mlp == "moe":
        out["moe"] = _moe_pds(cfg, r, dt)
    elif spec.mlp == "dense":
        out["mlp"] = _mlp_pds(cfg, r, dt)
    return out


def _stacked(pds: dict, n: int) -> dict:
    return {g: {k: pd.stacked(n) for k, pd in sub.items()}
            for g, sub in pds.items()}


def param_template(cfg: ArchConfig, run: RunConfig,
                   rules: ShardingRules | None) -> dict:
    """The full parameter tree as PDs (the JAX template's shapes/specs);
    an encoder-decoder adds a ``cross`` sub-tree to every decoder block,
    the encoder's ``enc_blocks`` and ``enc_final_norm``."""
    dt = DTYPES[cfg.dtype]
    d = cfg.d_model
    v = cfg.padded_vocab(rules.mesh.shape[rules.tp] if rules else 16)
    fs = rules.dim(d, rules.fsdp_axes) if rules is not None else None
    tpv = rules.dim(v, rules.tp) if rules is not None else None
    tree: dict[str, Any] = {
        "embed": PD((v, d), P(tpv, fs), "normal", dt),
        "final_norm": PD((d,), P(None), "ones", dt),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = PD((d, v), P(fs, tpv), "normal", dt,
                             aligned=True)
    tree["blocks"] = {
        f"pos{i}": _stacked(_block_pds(spec, cfg, rules, dt,
                                       cross=cfg.encoder_decoder),
                            cfg.n_periods)
        for i, spec in enumerate(cfg.layer_pattern())}
    if cfg.encoder_decoder:
        tree["enc_blocks"] = _stacked(
            _block_pds(LayerSpec("attn", "dense"), cfg, rules, dt,
                       cross=False), cfg.n_encoder_layers)
        tree["enc_final_norm"] = PD((d,), P(None), "ones", dt)
    return tree


def to_stored(x: torch.Tensor, pd: PD, rules: ShardingRules | None):
    """A global tensor in its stored layout (stacked when sharded; rows of
    16 bytes where ``pd.aligned``)."""
    if rules is not None:
        x = pgl.layout(x, pd.spec, rules.mesh, stack_axis(pd, rules),
                       lead=int(pd.periods), expand=False).contiguous()
    return pgl.aligned_rows(x) if pd.aligned else x


def stack_axis(pd: PD, rules: ShardingRules):
    """The axes ``pd``'s storage is stacked over: tp, or the long-context
    cache's ``(*dp_axes, tp)`` (``pgl.stack_axis``)."""
    return pgl.stack_axis(pd.spec, rules.mesh, rules.tp)


def stored_shape(pd: PD, rules: ShardingRules | None) -> tuple[int, ...]:
    if rules is None:
        return pd.shape
    return pgl.stacked_shape(pd.shape, pd.spec, rules.mesh,
                             stack_axis(pd, rules), lead=int(pd.periods))


# elements of one f32 draw in init_params (256 MiB): a leaf is drawn in
# slices of whole rows along its leading axis, at least one row a slice
_DRAW_ELEMS = 1 << 26


def init_params(template, generator: torch.Generator, d_model: int, *,
                rules: ShardingRules | None = None,
                device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` (normal leaves
    ~ N(0, 1/d_model); ``a_log`` is log(1..N) along the state dim, as in
    JAX; ``dt_bias`` the inverse softplus of U[1e-3, 1e-1]), laid out once
    in their stored form. Each normal
    leaf is drawn in slices along its leading axis (a layer of a stacked
    leaf, a block of rows of a matrix; at most 2^26 elements unless one
    row is larger), each slice in f32, cast to the
    leaf dtype and written in place, so the f32 transient is one slice —
    a full-width MoE expert leaf drawn whole in f32 would not fit the
    card. ``generator`` must live on ``device``."""
    device = torch.device(device) if device is not None \
        else generator.device
    scale = d_model ** -0.5
    out: dict = {}
    for path, pd in leaves(template):
        if pd.init in ("ones", "zeros"):
            x = (torch.ones if pd.init == "ones" else torch.zeros)(
                pd.shape, dtype=pd.dtype, device=device)
        elif pd.init == "a_log":
            n = pd.shape[-1]
            x = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)) \
                .expand(pd.shape).to(pd.dtype).contiguous()
        elif pd.init == "dt_bias":
            u = torch.rand(pd.shape, generator=generator, device=device,
                           dtype=torch.float32) * (1e-1 - 1e-3) + 1e-3
            x = (u + torch.log(-torch.expm1(-u))).to(pd.dtype)
        elif pd.init == "normal":
            x = torch.empty(pd.shape, dtype=pd.dtype, device=device)
            rows = x.view(len(x), -1)
            step = max(1, _DRAW_ELEMS // rows.shape[1])
            for i in range(0, rows.shape[0], step):
                part = rows[i:i + step]
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device,
                                       dtype=torch.float32).mul_(scale))
        else:
            raise NotImplementedError(f"init {pd.init!r}")
        set_path(out, path, to_stored(x, pd, rules))
    return out


def zeros(template, rules: ShardingRules | None, device) -> dict:
    """A zero tree in the stored layout of ``template``."""
    out: dict = {}
    for path, pd in leaves(template):
        set_path(out, path, torch.zeros(stored_shape(pd, rules),
                                        dtype=pd.dtype, device=device))
    return out


def cache_template(cfg: ArchConfig, run: RunConfig,
                   rules: ShardingRules | None, *, batch: int, s_max: int,
                   enc_len: int = 0, long_ctx: bool = False,
                   slot_pos: bool = False, kv_dtype: str = "bf16") -> dict:
    """Slab decode cache: per layer period (np, B, Hkv, S_max, hd) K and V
    (sequence-sharded over tp with a mesh) for attention layers, the f32
    state ``h`` (np, B, di, N) and conv tail (np, B, ck-1, di) (di over tp)
    for mamba layers, and the position — a scalar, or one per slot with
    ``slot_pos=True`` (the serving engine's pool). An encoder-decoder with
    ``enc_len`` adds ``cross``: the encoder's K and V for every decoder
    layer, (np·len(pattern), B, Hkv, enc_len, hd), sequence-sharded over
    tp as JAX shards them (replicated, they cost 27 GB a device there).
    Head-sharded caches (``decode_seq_shard=False``; JAX shards their heads
    over tp) are stored global: no island reads them per rank — the decode
    is ``_full_attention`` over the whole cache, as in JAX.
    ``kv_dtype="int8"`` stores K and V as int8 and adds the per-(token,
    head) f32 scale planes ``k_scale``/``v_scale`` (np, B, Hkv, S_max),
    stored as the K/V they scale are: stacked when those are, global when
    head-sharded. ``"bf16"`` keeps the tree as it was. ``long_ctx``
    shards K, V and the scale planes' sequence over ``(*dp_axes, tp)`` at
    once, stored stacked over those flattened ranks (ROADMAP A8)."""
    dt = DTYPES[cfg.dtype]
    kv_dt = {"bf16": dt, "int8": torch.int8}[kv_dtype]
    hkv, hd = cfg.n_kv_heads, cfg.hd
    bspec = rules.dim(batch, rules.dp) if rules else None
    kv_spec = (rules.kv_cache(hkv, batch, long_ctx=long_ctx)
               if rules is not None and run.decode_seq_shard
               else P(bspec, None, None, None))
    tree: dict[str, Any] = {
        "pos": (PD((batch,), P(bspec), "zeros", torch.int32) if slot_pos
                else PD((), P(), "zeros", torch.int32)),
        "blocks": {}}
    di, n, ck = cfg.d_inner, cfg.ssm_state, cfg.conv_kernel
    ssm_spec = rules.ssm_cache(batch) if rules else P(None, None, None)
    conv_spec = P(bspec, None, rules.dim(di, rules.tp) if rules else None)
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.mixer == "attn":
            kv = PD((batch, hkv, s_max, hd), kv_spec, "zeros", kv_dt)
            entry = {"k": kv, "v": kv}
            if kv_dtype == "int8":
                sc = PD((batch, hkv, s_max), P(*kv_spec[:3]), "zeros",
                        torch.float32)
                entry.update(k_scale=sc, v_scale=sc)
        else:
            entry = {"h": PD((batch, di, n), ssm_spec, "zeros",
                             torch.float32),
                     "conv": PD((batch, ck - 1, di), conv_spec, "zeros", dt)}
        tree["blocks"][f"pos{i}"] = {k: pd.stacked(cfg.n_periods)
                                     for k, pd in entry.items()}
    if cfg.encoder_decoder and enc_len:
        kv = _cross_pd(cfg, rules, batch, enc_len)
        tree["cross"] = {"k": kv, "v": kv}
    return tree


def _cross_pd(cfg: ArchConfig, rules: ShardingRules | None, batch: int,
              enc_len: int) -> PD:
    """One leaf of ``cache["cross"]``: a decoder layer's encoder K or V a
    row, (np·len(pattern), B, Hkv, enc_len, hd), enc_len over tp."""
    bspec = rules.dim(batch, rules.dp) if rules else None
    enc_sp = rules.dim(enc_len, rules.tp) if rules else None
    return PD((cfg.n_periods * len(cfg.layer_pattern()), batch,
               cfg.n_kv_heads, enc_len, cfg.hd),
              P(None, bspec, None, enc_sp, None), "zeros", DTYPES[cfg.dtype],
              periods=True)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

class _BF16GradBarrier(torch.autograd.Function):
    """Identity whose backward rounds an f32 residual-stream cotangent to
    bf16 (JAX ``_bf16_grad_barrier``: the backward all-reduces inherit that
    dtype). Other cotangent dtypes pass unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            return g.to(torch.bfloat16).to(g.dtype)
        return g


def _attn_sub(a, x, cfg, run, rules, *, causal, seq_sharded):
    return L.attention_block(a, L.rms_norm(a["norm"], x, cfg.norm_eps), cfg,
                             run, rules, causal=causal,
                             seq_sharded=seq_sharded)


def cross_kv(c, enc_out, cfg: ArchConfig, run: RunConfig, rules):
    """A decoder layer's cross-attention K and V, (B, Hkv, Se, hd) each:
    the encoder's output (B, Se, d) through the layer's ``cross.wk`` and
    ``cross.wv`` — column projections, FSDP-gathered like q, k and v (JAX
    computes the same einsums inline in ``_apply_block``)."""
    b, se, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    return tuple(L.project(enc_out, c[name], hkv * hd, rules, run).reshape(
        b, se, hkv, hd).transpose(1, 2) for name in ("wk", "wv"))


def _cross_sub(c, x, cfg, run, rules, *, enc_out):
    return L.attention_block(c, L.rms_norm(c["norm"], x, cfg.norm_eps), cfg,
                             run, rules, causal=False,
                             cross_kv=cross_kv(c, enc_out, cfg, run, rules))


def _mlp_sub(m, x, cfg, run, rules):
    return L.mlp_block(m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg, run,
                       rules)


def _mamba_sub(m, x, cfg, run, rules):
    h, _ = S.mamba_block(m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg,
                         run, rules)
    return h


def _moe_sub(m, x, cfg, run, rules):
    """(out, aux loss) of the MoE sub-block."""
    return L.moe_block(m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg, run,
                       rules)


def _apply_block(bp, spec: LayerSpec, x, cfg: ArchConfig, run: RunConfig,
                 rules, *, causal=True, enc_out=None, seq_sharded=False,
                 sub_remat=None):
    """One layer, pre-norm residual (JAX ``_apply_block``): the mixer —
    attention (causal or, in the encoder, not) or the mamba block — then,
    given the encoder's output ``enc_out``, cross-attention over it, then
    the FFN (dense MLP, MoE or none). Returns (x, the MoE aux loss, 0
    without one). With ``seq_sharded`` the attention mix is ring or Ulysses
    attention over the tp axis (``run.sp_attention``). ``sub_remat``
    (default: ``run.remat`` and ``run.save_collectives``) checkpoints each
    sub-block on its own, so its output survives to the backward while
    everything inside it is recomputed (the JAX policy saving
    ``subblock_out``; JAX leaves the cross sub-block's output unnamed and
    recomputes it, the port keeps it: one (B, S, d) more a layer, the same
    numbers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if run.bf16_backward_ars:
        x = _BF16GradBarrier.apply(x)
    if sub_remat is None:
        sub_remat = run.remat and run.save_collectives
    if spec.mixer == "attn":
        subs = [(functools.partial(_attn_sub, causal=causal,
                                   seq_sharded=seq_sharded), bp["attn"])]
    else:
        subs = [(_mamba_sub, bp["mamba"])]
    if enc_out is not None and "cross" in bp:
        subs.append((functools.partial(_cross_sub, enc_out=enc_out),
                     bp["cross"]))
    if spec.mlp == "dense":
        subs.append((_mlp_sub, bp["mlp"]))
    elif spec.mlp == "moe":
        subs.append((_moe_sub, bp["moe"]))
    for fn, sp in subs:
        if sub_remat:
            h = checkpoint(fn, sp, x, cfg, run, rules, use_reentrant=False)
        else:
            h = fn(sp, x, cfg, run, rules)
        if isinstance(h, tuple):
            h, a = h
            aux = aux + a
        x = x + h
    return x, aux


def _layers(blocks: list) -> list:
    """Per-layer views of stacked leaves, one unbind per leaf: its backward
    stacks the layers' gradients in one copy, where indexing each layer
    would zero-fill and add the whole stacked leaf once per layer."""
    return [{g: {k: t.unbind(0) for k, t in sub.items()}
             for g, sub in blk.items()} for blk in blocks]


def _layer(views: dict, li: int) -> dict:
    return {g: {k: ts[li] for k, ts in sub.items()}
            for g, sub in views.items()}


def _scan_blocks(blocks, x, cfg: ArchConfig, run: RunConfig, rules, *,
                 causal=True, enc_out=None, seq_sharded=False):
    """The layer periods in order (JAX ``lax.scan``), carrying the sum of
    the MoE aux losses; returns (x, aux). With ``run.remat`` and no
    ``save_collectives`` a whole period is checkpointed: only its input is
    kept and everything else is recomputed in the backward (the JAX policy
    ``None``)."""
    pattern = cfg.layer_pattern()
    layers = _layers([blocks[f"pos{i}"] for i in range(len(pattern))])

    def period(x, aux, li):
        for spec, views in zip(pattern, layers):
            x, a = _apply_block(_layer(views, li), spec, x, cfg, run, rules,
                                causal=causal, enc_out=enc_out,
                                seq_sharded=seq_sharded)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.n_periods):
        if run.remat and not run.save_collectives:
            x, aux = checkpoint(period, x, aux, li, use_reentrant=False)
        else:
            x, aux = period(x, aux, li)
    return x, aux


def _scan_encoder(enc_blocks, x, cfg: ArchConfig, run: RunConfig, rules):
    """The encoder's layers in order (JAX ``_scan_encoder``): non-causal
    attention and the MLP; with ``run.remat`` each layer is checkpointed
    whole, whatever ``save_collectives`` says (JAX's encoder remat has no
    policy)."""
    views, = _layers([enc_blocks])

    def layer(x, li):
        return _apply_block(_layer(views, li), LayerSpec("attn", "dense"), x,
                            cfg, run, rules, causal=False,
                            sub_remat=False)[0]

    for li in range(cfg.n_encoder_layers):
        x = (checkpoint(layer, x, li, use_reentrant=False) if run.remat
             else layer(x, li))
    return x


def encode(params, enc_embeds, cfg: ArchConfig, run: RunConfig, rules):
    """The encoder's output (B, Se, d): the stub frontend's frame
    embeddings through ``enc_blocks`` and ``enc_final_norm``."""
    x = _scan_encoder(params["enc_blocks"],
                      enc_embeds.to(params["enc_final_norm"].dtype), cfg,
                      run, rules)
    return L.rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def _merge_frontend(x_tok, frontend_embeds, cfg: ArchConfig):
    """VLM: replace the first ``n_frontend_tokens`` embeddings with the
    precomputed patch embeddings (JAX ``_merge_frontend``)."""
    if frontend_embeds is None or cfg.frontend != "vision":
        return x_tok
    n = cfg.n_frontend_tokens
    return torch.cat([frontend_embeds.to(x_tok.dtype), x_tok[:, n:]], dim=1)


def _hidden_states(params, batch, cfg: ArchConfig, run: RunConfig, rules,
                   *, seq_sharded=False):
    """Embedding, frontend merge, the encoder where there is one, the
    decoder blocks and the final norm: (B, S, d), and the blocks' summed
    MoE aux loss."""
    x = L.embed_tokens(params, batch["tokens"], rules, run)
    x = _merge_frontend(x, batch.get("frontend_embeds"), cfg)
    enc_out = (encode(params, batch["enc_embeds"], cfg, run, rules)
               if cfg.encoder_decoder else None)
    x, aux = _scan_blocks(params["blocks"], x, cfg, run, rules,
                          enc_out=enc_out, seq_sharded=seq_sharded)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward_train(params, batch, cfg: ArchConfig, run: RunConfig,
                  rules: ShardingRules | None, *, seq_sharded=False):
    """Returns (loss, metrics). batch: tokens (B, S), targets (B, S),
    weights (B, S) [+ frontend_embeds (B, n, d) for vision configs |
    enc_embeds (B, Se, d) for encoder-decoders]. Every family: dense, MoE,
    SSM, hybrid and encoder-decoder. The loss is the chunked
    vocab-parallel cross-entropy (``layers.lm_loss``); the total is loss +
    0.01·aux, aux the MoE layers' summed load-balance loss (0 without
    one). ``seq_sharded``: every decoder self-attention mix is ring or
    Ulysses attention (``run.sp_attention``) over the tp axis (the SP
    island), as in JAX; JAX's launcher never sets it, and neither does the
    port's."""
    x, aux = _hidden_states(params, batch, cfg, run, rules,
                            seq_sharded=seq_sharded)
    head = params["lm_head"] if "lm_head" in params else _head(params)
    loss = L.lm_loss({"lm_head": head}, x, batch["targets"],
                     batch["weights"], cfg, run, rules, chunk=run.loss_chunk)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


def forward_prefill(params, batch, cfg: ArchConfig, run: RunConfig,
                    rules: ShardingRules | None):
    """Prefill forward (JAX ``forward_prefill``): the training forward
    without the loss, returning the last position's logits (B, 1, V) f32
    through ``lm_logits``. batch: tokens (B, S) [+ frontend_embeds |
    enc_embeds]. Every family, as ``forward_train``."""
    x, _ = _hidden_states(params, batch, cfg, run, rules)
    return L.lm_logits({"lm_head": _head(params)}, x[:, -1:])


# ---------------------------------------------------------------------------
# Serving: prefill + decode with caches
# ---------------------------------------------------------------------------

def _head(params) -> torch.Tensor:
    """The LM head: ``lm_head``, or with tied embeddings the embedding's
    transpose, as JAX's ``params["embed"].T`` — on a mesh the embed's
    tp-stacked (R, V/R, d), spec ``P(tpv, fs)``, seen as (R, d, V/R), the
    head's ``P(fs, tpv)`` layout — in rows of 16 bytes."""
    if "lm_head" in params:
        return params["lm_head"]
    return pgl.aligned_rows(params["embed"].transpose(-2, -1))


def _ffn(bp, li, x, cfg: ArchConfig, run: RunConfig, rules):
    """Layer ``li``'s FFN sub-block of one pattern position (its dense MLP
    or its MoE, whichever ``bp`` holds) on the residual ``x``."""
    if "moe" in bp:
        m = {k: t[li] for k, t in bp["moe"].items()}
        h, _ = L.moe_block(m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg,
                           run, rules)
        return h
    m = {k: t[li] for k, t in bp["mlp"].items()}
    return L.mlp_block(m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg, run,
                       rules)


def _kv_args(kv: dict) -> dict:
    """The scale planes of one layer's int8 cache entry as the attention
    functions' keywords (none for a bf16 entry)."""
    return {k: kv[k] for k in ("k_scale", "v_scale") if k in kv}


def _serve_blocks(params, cache, x, cfg: ArchConfig, run: RunConfig,
                  rules, attend, cross=None):
    """Every layer in order (period by period, pattern position by
    position) over a serving cache: the mixer — ``attend(a, x_norm, kv) ->
    (h, k, v[, k_scale, v_scale])`` for attention, ``kv`` the layer's
    cache entry (K, V and an int8 cache's scale planes), the mamba block
    for SSM layers, whose new state the kernel writes straight into the new
    cache's slab — then, given the encoder's K/V ``cross`` (``cache[
    "cross"]``), the layer's one-token cross-attention over them, then the
    FFN if the layer has one. Returns (x, new cache blocks)."""
    pattern = cfg.layer_pattern()
    new = {}
    for i, spec in enumerate(pattern):
        cp = cache["blocks"][f"pos{i}"]
        new[f"pos{i}"] = ({k: [] for k in cp} if spec.mixer == "attn" else
                          {"h": torch.empty_like(cp["h"]), "conv": []})
    for li in range(cfg.n_periods):
        for i, spec in enumerate(pattern):
            bp, cp = params["blocks"][f"pos{i}"], cache["blocks"][f"pos{i}"]
            nc = new[f"pos{i}"]
            if spec.mixer == "attn":
                a = {k: t[li] for k, t in bp["attn"].items()}
                h, *kv = attend(a, L.rms_norm(a["norm"], x, cfg.norm_eps),
                                {k: t[li] for k, t in cp.items()})
                for k, t in zip(("k", "v", "k_scale", "v_scale"), kv):
                    nc[k].append(t)
            else:
                m = {k: t[li] for k, t in bp["mamba"].items()}
                h, (_, tail) = S.mamba_block(
                    m, L.rms_norm(m["norm"], x, cfg.norm_eps), cfg, run,
                    rules, cache=(cp["h"][li], cp["conv"][li]),
                    h_out=nc["h"][li])
                nc["conv"].append(tail)
            x = x + h
            if cross is not None:
                c = {k: t[li] for k, t in bp["cross"].items()}
                n = li * len(pattern) + i
                h, _, _ = L.decode_attention(
                    c, L.rms_norm(c["norm"], x, cfg.norm_eps), None, None,
                    cache["pos"], cfg, run, rules,
                    cross_kv=(cross["k"][n], cross["v"][n]))
                x = x + h
            if spec.mlp != "none":
                x = x + _ffn(bp, li, x, cfg, run, rules)
    return x, {name: {k: v if isinstance(v, torch.Tensor) else
                      torch.stack(v) for k, v in nc.items()}
               for name, nc in new.items()}


def _decode(params, cache, tokens, cfg: ArchConfig, run: RunConfig,
            rules, cross=None, page_size: int = 0, long_ctx: bool = False):
    pos = cache["pos"]
    bt = cache.get("block_tables")
    if bt is not None and not page_size:
        raise ValueError("a paged cache (block_tables) needs its page_size")
    x = L.embed_tokens(params, tokens, rules, run)

    def attend(a, xn, kv):
        if bt is not None:
            return L.paged_decode_attention(a, xn, kv["k"], kv["v"], bt, pos,
                                            cfg, run, rules,
                                            page_size=page_size,
                                            **_kv_args(kv))
        return L.decode_attention(a, xn, kv["k"], kv["v"], pos, cfg, run,
                                  rules, long_ctx=long_ctx, **_kv_args(kv))

    x, new_blocks = _serve_blocks(params, cache, x, cfg, run, rules, attend,
                                  cross)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_logits({"lm_head": _head(params)}, x)
    new = {"pos": pos + 1, "blocks": new_blocks}
    if bt is not None:
        new["block_tables"] = bt
    if "cross" in cache:
        new["cross"] = cache["cross"]
    return logits, new


def decode_step(params, cache, tokens, cfg: ArchConfig, run: RunConfig,
                rules: ShardingRules | None, *, page_size: int = 0,
                long_ctx: bool = False):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1, V) f32,
    new_cache) with ``pos`` advanced by one (a ``cross`` entry passes
    through unused, as in JAX). A cache carrying ``block_tables`` (the
    paged layout, ``runtime/paging.py``) attends through the paged
    islands over pages of ``page_size`` tokens. ``long_ctx``: the cache of
    ``cache_template(long_ctx=True)``, sequence-sharded over the dp and tp
    axes at once (ROADMAP A8, JAX's long_500k cell)."""
    return _decode(params, cache, tokens, cfg, run, rules,
                   page_size=page_size, long_ctx=long_ctx)


def decode_step_encdec(params, cache, tokens, cfg: ArchConfig,
                       run: RunConfig, rules: ShardingRules | None):
    """One decode step of an encoder-decoder (JAX ``decode_step_encdec``):
    in every decoder layer self-attention over the slab cache, then
    cross-attention over the encoder's K/V in ``cache["cross"]`` (filled
    by :func:`encode_cross`), then the MLP. Returns (logits (B, 1, V) f32,
    new_cache)."""
    return _decode(params, cache, tokens, cfg, run, rules, cache["cross"])


def encode_cross(params, cache, enc_embeds, cfg: ArchConfig, run: RunConfig,
                 rules: ShardingRules | None) -> dict:
    """``cache`` with ``cross`` filled for :func:`decode_step_encdec`: the
    encoder over ``enc_embeds`` (B, Se, d) (:func:`encode`), then every
    decoder layer's cross K/V (:func:`cross_kv`) — the helpers
    ``forward_train`` runs — written layer by layer into new leaves laid
    out as ``cache_template`` stores them."""
    enc_out = encode(params, enc_embeds, cfg, run, rules)
    b, se, _ = enc_out.shape
    pd = _cross_pd(cfg, rules, b, se)
    out = {name: torch.empty(stored_shape(pd, rules), dtype=pd.dtype,
                             device=enc_out.device) for name in ("k", "v")}
    for li in range(cfg.n_periods):
        for i in range(len(cfg.layer_pattern())):
            c = {k: t[li] for k, t in params["blocks"][f"pos{i}"]["cross"]
                 .items()}
            n = li * len(cfg.layer_pattern()) + i
            for name, t in zip(("k", "v"),
                               cross_kv(c, enc_out, cfg, run, rules)):
                out[name][n].copy_(t if rules is None else pgl.layout(
                    t, P(*pd.spec[1:]), rules.mesh, rules.tp, expand=False))
    return {**cache, "cross": out}


def prefill_step(params, cache, tokens, prompt_lens, cfg: ArchConfig,
                 run: RunConfig, rules: ShardingRules | None):
    """Batched cache-building prefill: one full-sequence forward over the
    right-padded prompts (B, L) writes every layer's K/V — and SSM state —
    into the cache and returns each slot's next-token logits (B, 1, V) at
    its last real position, with ``cache["pos"]`` set to the prompt
    lengths. SSM state cannot mask right-padding: SSM and hybrid callers
    prefill at the exact prompt length (the engine's ``exact_buckets``)."""
    if cfg.encoder_decoder:
        raise NotImplementedError(
            "batched cache prefill covers decoder-only models; the enc-dec "
            "path precomputes cross K/V separately (decode_step_encdec)")
    b, _ = tokens.shape
    x = L.embed_tokens(params, tokens, rules, run)

    def attend(a, xn, kv):
        return L.prefill_attention_block(a, xn, kv["k"], kv["v"], cfg, run,
                                         rules, **_kv_args(kv))

    x, new_blocks = _serve_blocks(params, cache, x, cfg, run, rules, attend)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    lens = torch.as_tensor(prompt_lens, device=x.device)
    idx = (lens.reshape(-1) - 1).expand(b) if lens.dim() == 0 or \
        lens.numel() == 1 else lens - 1
    x_last = x[torch.arange(b, device=x.device), idx.long()][:, None]
    logits = L.lm_logits({"lm_head": _head(params)}, x_last)
    if cache["pos"].dim():
        new_pos = torch.broadcast_to(lens, (b,)).to(torch.int32)
    else:
        new_pos = lens.reshape(()).to(torch.int32)
    return logits, {"pos": new_pos, "blocks": new_blocks}


def prefill_paged_step(params, cache, tokens, block_tables, prompt_lens,
                       chunk_start, write_from, cfg: ArchConfig,
                       run: RunConfig, rules: ShardingRules | None, *,
                       page_size: int):
    """One chunk of paged cache-building prefill (JAX
    ``prefill_paged_step``). tokens: (G, cl), the chunk's window at global
    positions [chunk_start, chunk_start+cl); block_tables: (G, P) the
    *group's* page mapping — not the live cache's rows, which stay at the
    −1 sentinel until the engine commits the last chunk, so decode ticks
    between chunks cannot touch half-built pages; prompt_lens: (G,) real
    lengths; write_from: (G,) per-slot floor below which K/V writes are
    suppressed (positions a shared prefix already holds); page_size: the
    pool's tokens a page (``PageGeometry``). Returns (logits
    (G, 1, V) f32 at each row's last real position clamped into this
    chunk — the engine keeps the chunk that holds L−1 — and the cache with
    new pools; ``pos`` and the live block tables pass through untouched).
    Attention-only architectures (``paging.paged_cache_template``
    checks)."""
    b, s = tokens.shape
    dev = tokens.device
    x = L.embed_tokens(params, tokens, rules, run)
    bt = torch.as_tensor(block_tables, device=dev)
    wf = torch.as_tensor(write_from, device=dev)
    c0 = int(chunk_start)

    def attend(a, xn, kv):
        return L.paged_prefill_attention_block(a, xn, kv["k"], kv["v"], bt,
                                               c0, wf, cfg, run, rules,
                                               page_size=page_size,
                                               **_kv_args(kv))

    x, new_blocks = _serve_blocks(params, cache, x, cfg, run, rules, attend)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    lens = torch.as_tensor(prompt_lens, device=dev).reshape(-1)
    idx = (lens - 1 - c0).clamp(0, s - 1).expand(b)
    x_last = x[torch.arange(b, device=dev), idx.long()][:, None]
    logits = L.lm_logits({"lm_head": _head(params)}, x_last)
    return logits, {"pos": cache["pos"], "blocks": new_blocks,
                    "block_tables": cache["block_tables"]}
