"""One-token decode attention over the stacked, sequence-sharded slab cache,
in one pass that also writes the new token in place.

Replaces no Pallas kernel: the JAX package's decode island
(``repro/models/layers.py::decode_island``) writes the new token with a
``dynamic_update_slice`` and leaves the mix to XLA. Here the island's cache
is the engine's stored slab, (R, B, Hkv, s_loc, hd) a layer, rank r holding
the global positions r·s_loc + j; q is (R, B, Hq, 1, hd) and the new K/V
(R, B, Hkv, 1, hd), replicated over the ranks; ``pos`` is a per-slot (B,)
vector or a scalar, and slot b sees the keys below pos_b + 1 (and, with a
window, at or above pos_b + 1 - window).

What bounds it on the card: bytes. A decode step's only necessary traffic
is one read of the live K/V, at most 2·R·B·Hkv·s_loc·hd elements, against
4·Hq·hd operations a key; the plain path (``_sharded_mix``) rewrote the
whole slab to place one token, cast all of it to f32, read that copy and
handed back a new slab for the model to stack. The design answers with
reading the visible keys once, in their stored type:

* a block takes one (rank, slot, kv head), and where R·B·Hkv blocks would
  leave the card's SMs idle (``decode_plan``: under four a SM, the
  long-context island's B = 1) also one of equal parts of the rank's
  visible keys, so that a window's few thousand keys still spread over
  the card;
* the block whose part holds ``pos`` writes k_new and v_new there, in
  place (a position past every rank's range, >= s_max, writes nothing, as
  the plain path drops it), then reads only its visible keys: tiles of K
  and V staged in shared memory by 16-byte ``cp.async`` copies in a ring
  of three stages, so the bytes a step follow the live tokens;
* the g = Hq / Hkv query heads of the group are read once into registers
  and every score, the online softmax (base 2, ``ex2.approx``) and P·V
  run in f32 on CUDA cores (with one query row the tensor cores would buy
  nothing, and rounding P to bf16 would be less precise than the f32 path
  it replaces);
* it returns each (rank, slot, query head)'s unnormalized ``o`` (hd, f32)
  with its running max ``m`` and sum ``l``; the island merges the ranks by
  log-sum-exp with the same pmax and two psums as before. A split's
  partials are merged in split order by a second small kernel, in the same
  C call.

On a CPU tensor the wrapper runs the plain twin (the same in-place write
and per-rank partial, in f32); on a CUDA tensor it launches the kernel or
raises; on ``meta`` it records the launches and the cost. Sums run in
another order than the twin's (a key's score over the lanes of its row,
then the lane groups, then the splits), so the two agree to f32 rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import H100_SMS, SMEM_LIMIT, sm_count
from repro_torch.roofline import counters

_TYPES = (torch.bfloat16, torch.float16)
#: query heads a group the kernel is built for (a group of g heads runs the
#: smallest that holds it)
GROUPS = (1, 2, 4, 8, 12)
THREADS = 128
#: keys a tile, stages of the ring (csrc/decode_attention.cu DA_KT,
#: DA_STAGES)
KEYS_TILE = 32
STAGES = 3
#: a rank's positions a key split stands for at least
MIN_SPLIT = 256
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the kernel runs one layer's decode attention."""
    group: int          # G: query heads a group, at least g
    elems: int          # D: elements of a key row a lane holds
    lanes: int          # lanes a key row (a power of two)
    splits: int         # parts of a rank's visible keys, one block each
    grid: tuple[int, int]   # (R·B·Hkv, splits)
    smem_bytes: int     # the stage ring, or the lane groups' merge


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(r: int, b: int, hkv: int, g: int, s_loc: int, hd: int,
                sms: int = H100_SMS) -> DecodePlan:
    """The launch for R ranks of B slots and Hkv kv heads of g query heads
    each, s_loc positions a rank, head dim ``hd``, on a card of ``sms``
    SMs. A lane holds 8 elements of a row where the group has at most 4
    heads, else 4 (so a lane's f32 sums, G·D, stay in registers). Where
    R·B·Hkv blocks are under four a SM, each rank's visible keys split into
    parts that bring the grid to eight blocks a SM, at most one a
    ``MIN_SPLIT`` of the rank's positions."""
    if g > GROUPS[-1]:
        raise ValueError(f"decode_attention takes at most {GROUPS[-1]} query "
                         f"heads a kv head, got {g}")
    group = next(x for x in GROUPS if x >= g)
    elems = 8 if group <= 4 else 4
    if hd % 8 or hd > 32 * elems:
        raise ValueError(f"decode_attention takes a head dim that is a "
                         f"multiple of 8 and at most {32 * elems} for {g} "
                         f"heads a group, got {hd}")
    lanes = 1
    while lanes * elems < hd:
        lanes *= 2
    blocks = r * b * hkv
    splits = 1
    if blocks < 4 * sms:
        splits = max(1, min(_cdiv(8 * sms, max(blocks, 1)),
                            s_loc // MIN_SPLIT))
    smem = max(STAGES * 2 * KEYS_TILE * hd * 2,
               (THREADS // lanes) * group * (hd + 2) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode_attention needs {smem} bytes of shared "
                         f"memory a block at hd {hd}, g {g}")
    return DecodePlan(group, elems, lanes, splits, (blocks, splits), smem)


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` as a (B,) int64 vector on ``device``."""
    p = pos.to(device=device, dtype=torch.long) if torch.is_tensor(pos) \
        else torch.tensor(int(pos), device=device)
    return p.expand(b) if p.dim() == 0 else p


def decode_attention_plain(q, cache_k, cache_v, k_new, v_new, pos,
                           window=None):
    """The kernel's algorithm in plain PyTorch: writes k_new, v_new into
    ``cache_k``, ``cache_v`` at ``pos`` where a rank holds it (in place),
    then each rank's partial over its visible keys in f32. Returns (o (R,
    B, Hq, hd), m (R, B, Hq), l (R, B, Hq)), o unnormalized."""
    r, b, hkv, s_loc, hd = cache_k.shape
    hq = q.shape[2]
    dev = cache_k.device
    off = torch.arange(r, device=dev) * s_loc
    p = _positions(pos, b, dev)
    local = p[None, :] - off[:, None]                          # (R, B)
    ri, bi = ((local >= 0) & (local < s_loc)).nonzero(as_tuple=True)
    li = local[ri, bi]
    cache_k[ri, bi, :, li] = k_new[ri, bi, :, 0].to(cache_k.dtype)
    cache_v[ri, bi, :, li] = v_new[ri, bi, :, 0].to(cache_v.dtype)
    kvl = p + 1
    ki = off[:, None] + torch.arange(s_loc, device=dev)        # (R, s)
    keep = ki[:, None, :] < kvl[None, :, None]                 # (R, B, s)
    if window is not None:
        keep = keep & (ki[:, None, :] >= (kvl - window)[None, :, None])
    keep = keep[:, :, None, None, :]
    qg = q.reshape(r, b, hkv, hq // hkv, hd).float()
    sc = torch.einsum("rbkgd,rbksd->rbkgs", qg, cache_k.float()) * hd ** -0.5
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)
    pr = torch.where(keep, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    o = torch.einsum("rbkgs,rbksd->rbkgd", pr, cache_v.float())
    return (o.reshape(r, b, hq, hd), m.reshape(r, b, hq),
            pr.sum(dim=-1).reshape(r, b, hq))


def _check(q, cache_k, cache_v, k_new, v_new, pos) -> None:
    if cache_k.dim() != 5 or cache_v.shape != cache_k.shape:
        raise ValueError(f"decode_attention takes caches (R, B, Hkv, s_loc, "
                         f"hd), got {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}")
    r, b, hkv, _, hd = cache_k.shape
    if q.dim() != 5 or q.shape[:2] != (r, b) or q.shape[3:] != (1, hd) \
            or q.shape[2] % hkv:
        raise ValueError(f"decode_attention takes q (R, B, Hq, 1, hd) with "
                         f"Hq a multiple of Hkv = {hkv}, got "
                         f"{tuple(q.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (r, b, hkv, 1, hd):
            raise ValueError(f"decode_attention takes {name} (R, B, Hkv, 1, "
                             f"hd) = {(r, b, hkv, 1, hd)}, got "
                             f"{tuple(t.shape)}")
    if torch.is_tensor(pos) and pos.dim() and pos.shape != (b,):
        raise ValueError(f"decode_attention takes pos (B,) = ({b},) or a "
                         f"scalar, got {tuple(pos.shape)}")


def _launch(q, cache_k, cache_v, k_new, v_new, pos, window):
    r, b, hkv, s_loc, hd = cache_k.shape
    hq = q.shape[2]
    if cache_k.dtype not in _TYPES:
        raise ValueError(f"the CUDA decode_attention takes a bf16 or f16 "
                         f"cache, got {cache_k.dtype}")
    es = cache_k.element_size()
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != cache_k.dtype or t.device != cache_k.device \
                or t.stride(-1) != 1:
            raise ValueError(f"the CUDA decode_attention takes {name} of the "
                             f"cache's type and device with a contiguous "
                             f"last dim")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.data_ptr() % 16 or any(
                st * es % 16 for n, st in zip(t.shape[:4], t.stride()[:4])
                if n > 1):
            raise ValueError(f"the CUDA decode_attention reads {name}'s rows "
                             f"by 16-byte copies: its address and strides "
                             f"must be 16-byte multiples, got strides "
                             f"{t.stride()}")
    pos_t, pos_scalar, pos_stride, pos64 = None, 0, 0, 0
    if torch.is_tensor(pos) and pos.device == cache_k.device:
        if pos.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"decode_attention takes an int32 or int64 pos, "
                             f"got {pos.dtype}")
        pos_t = pos
        pos_stride = pos.stride(0) if pos.dim() else 0
        pos64 = int(pos.dtype == torch.int64)
    else:
        pos_scalar = int(pos)
    p = decode_plan(r, b, hkv, hq // hkv, s_loc, hd,
                    sms=sm_count(cache_k.device))
    f32 = dict(dtype=torch.float32, device=cache_k.device)
    o = torch.empty((r, b, hq, hd), **f32)
    m = torch.empty((r, b, hq), **f32)
    l_ = torch.empty((r, b, hq), **f32)
    if p.splits > 1:
        po = torch.empty((r, b, hq, p.splits, hd), **f32)
        pm = torch.empty((r, b, hq, p.splits), **f32)
        pl = torch.empty((r, b, hq, p.splits), **f32)
    else:
        po, pm, pl = o, m, l_
    qs, kns, vns = q.stride(), k_new.stride(), v_new.stride()
    ks, vs = cache_k.stride(), cache_v.stride()
    err = _build.library().pk_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos_t.data_ptr() if pos_t is not None else None,
        pos_scalar, pos_stride, pos64, po.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), o.data_ptr(), m.data_ptr(), l_.data_ptr(), r, b, hkv,
        hq // hkv, s_loc, hd, -1 if window is None else int(window),
        float(hd ** -0.5), qs[0], qs[1], qs[2], kns[0], kns[1], kns[2],
        vns[0], vns[1], vns[2], ks[0], ks[1], ks[2], ks[3], vs[0], vs[1],
        vs[2], vs[3], p.group, p.elems, p.lanes, p.splits, p.smem_bytes, int(cache_k.dtype == torch.bfloat16),
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    _build.check(err, "pk_decode_attention")
    decode_attention.launches += 1 + (p.splits > 1)
    return o, m, l_


def cost(r: int, b: int, hq: int, hkv: int, s_loc: int, hd: int,
         elsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call, every position counted as visible (a
    counter cannot read ``pos``): q·k and p·v, 4·hd operations a (query
    head, key); K and V read once, q and the new K/V read, the new row
    written, and o, m, l written in f32."""
    keys = r * b * s_loc
    flops = 4 * hq * hd * keys
    nbytes = (2 * keys * hkv * hd * elsize + r * b * hq * hd * elsize
              + 4 * r * b * hkv * hd * elsize + 4 * r * b * hq * (hd + 2))
    return flops, nbytes


def decode_attention(q, cache_k, cache_v, k_new, v_new, pos, *, window=None):
    """q (R, B, Hq, 1, hd); caches (R, B, Hkv, s_loc, hd), written in place
    at ``pos`` (a (B,) vector or a scalar); k_new, v_new (R, B, Hkv, 1,
    hd). Returns each rank's (o (R, B, Hq, hd), m, l (R, B, Hq)) in f32, o
    unnormalized, for the island's log-sum-exp merge over the ranks."""
    _check(q, cache_k, cache_v, k_new, v_new, pos)
    r, b, hkv, s_loc, hd = cache_k.shape
    hq = q.shape[2]
    with counters.kernel("decode_attention", lambda: cost(
            r, b, hq, hkv, s_loc, hd, cache_k.element_size())):
        dev = cache_k.device.type
        if dev == "cuda":
            return _launch(q, cache_k, cache_v, k_new, v_new, pos, window)
        if dev == "meta":
            p = decode_plan(r, b, hkv, hq // hkv, s_loc, hd)
            counters.launched("decode_attention", 1 + (p.splits > 1))
            f32 = dict(dtype=torch.float32, device=cache_k.device)
            return (torch.empty((r, b, hq, hd), **f32),
                    torch.empty((r, b, hq), **f32),
                    torch.empty((r, b, hq), **f32))
        if dev != "cpu":
            raise ValueError(f"decode_attention runs on cpu or cuda, not "
                             f"{cache_k.device}")
        return decode_attention_plain(q, cache_k, cache_v, k_new, v_new, pos,
                                      window)


decode_attention.launches = 0
