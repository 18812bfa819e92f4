"""FlashAttention (online softmax, causal and/or sliding window, GQA).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_fa_kernel``): grid (B·H, q blocks, kv blocks) with the kv dim
sequential, m/l/acc in VMEM scratch, fully masked kv blocks skipped with
``pl.when``; GQA repeat and padding live in the JAX ``ops.flash_attention``.

CUDA route (``csrc/flash_attention.cu``; the design note is there). What
bounds it on the card: the tensor cores — 4·Sq·Skv·hd operations a head
where every key is visible, about half under the causal mask — with the
softmax's exponentials beside them; at the prefill shapes (S = 512) also
the bytes of q, k, v and o. The kernel is FlashAttention-3's forward on
the pieces of ``csrc/hopper_gemm.cuh``: a persistent grid of CTAs of
three warpgroups, each taking (128-query tile, b·Hq) tiles from the
launch's counter (one a stream, :func:`_tile_counter`), two consumer
warpgroups of 64 rows each and one producer thread; TMA reads q, k and v
through 4-D tensor maps over (D, S, H, B) at the caller's strides (so the
head-transposed views of prefill need no copy and GQA reads KV head
``h // (Hq/Hkv)`` in place), K and V blocks of 128 keys (64 at head_dim
128) stream through an mbarrier ring, S = QKᵀ is ``wgmma`` from shared
memory (K-major K), O += PV is ``wgmma`` with P from registers (rounded
to bf16 as the Pallas kernel rounds it to v's dtype), and m, l and O stay
in f32 registers. Key blocks are skipped by the
Pallas kernel's predicate (``flash_attention.py:37-41``) at the tile's
real rows and keys: :func:`kv_blocks` is the twin of the device's block
list. :func:`flash_plan` is the launch: the persistent grid and the
strides the tensor maps are encoded at, checked before any launch, beside
the tiles, stages and shared memory that the card tests hold against the
built kernel (:func:`kernel_config`). The ragged sequence edge comes
from TMA's per-dimension zero fill inside each head, and the element mask
drops it. The kernel is instantiated for head_dim 64 and 128; any other
head_dim up to 128 is zero-padded to the next of the two and the output
sliced back, as JAX's ``ops.flash_attention`` pads to 128 (zero columns
add nothing to q·k, and v's padded columns are dropped); the scale stays
that of the true width. The ``mma.sync`` kernel it replaced is kept as a
timing yardstick (``csrc/flash_mma_yardstick.cu``), which no wrapper
calls.

The hop (:func:`flash_attention_hop`) is one step of ring attention
(``core/ring_attention.py``), the same kernel with ``HOP``: the batch is R
ranks × B rows of stacked ``(R, B, H, S_loc, D)`` tensors, rank r's
queries sit at global rows ``r·S_loc + i`` and, at hop i, its keys at
``((r - i) mod R)·S_loc + j``; causal skip and mask use those global
positions, so a rank whose block lies wholly in the future exits at once.
It computes JAX's ``_block_update`` (``repro/core/ring_attention.py:38``)
from the zero state and returns the unnormalized f32 ``P V``, the row max
m (``NEG_INF`` where nothing is visible) and the row sum
``l = Σ exp(s - m)`` (0 there), which the caller merges; it never divides.
One launch covers all R ranks.

The plain version is the twin of ``ref.flash_attention_ref`` with GQA
grouping — the same function as ``layers._full_attention(causal=True)``.
On a CPU tensor the wrapper runs it; on a CUDA tensor it launches the
kernel or raises. Both wrappers are ``torch.autograd.Function``s: the
kernel in forward; in backward the gradient of the plain version,
recomputed in plain torch (f32 scores) from the saved q, k, v (for the hop
through o, m and l, since the merge uses all three). The Pallas kernel has no
backward kernel either — JAX trains through the XLA attention; a
hand-written backward kernel is queued in ROADMAP B7.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import H100_SMS, sm_count

NEG_INF = -1e30
#: head_dims the CUDA kernel is instantiated for; others pad up to one
KERNEL_HEAD_DIMS = (64, 128)
#: the kernel's tiles (``FA_BQ``, ``Cfg<D>::BK``, ``FA_STAGES`` and
#: ``FA_THREADS`` of csrc/flash_attention.cu): query rows a block (two
#: consumer warpgroups of 64), keys a ring stage by head_dim (at 128,
#: 64-key blocks keep S, P and O within a thread's registers), ring stages,
#: threads a block
BLOCK_Q = 128
BLOCK_K = {64: 128, 128: 64}
STAGES = 3
THREADS = 384
#: TMA's bound on a tensor map's strides, in bytes
TMA_STRIDE_LIMIT = 2 ** 40


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the kernel runs one call (``csrc/flash_attention.cu``)."""
    block_q: int
    block_k: int
    stages: int
    threads: int
    tiles: int                  # (query tile, b, head) tiles: ⌈Sq/128⌉·B·Hq
    grid: int                   # persistent blocks: one an SM at most
    smem_bytes: int             # dynamic shared memory a block
    # the element strides (b, h, s) of q, k and v the maps are encoded at,
    # a size-1 dimension's replaced by a valid one (its coordinate is 0)
    strides: tuple[int, ...]


def smem_bytes(head_dim: int) -> int:
    """The kernel's dynamic shared memory at ``head_dim``: the Q tile, the
    stages (K and V), 1 KB of slack for the 1024-byte alignment the
    swizzle needs, the mbarriers (q full, q empty, tile full and empty of
    two tile slots; k full, v full, empty a stage) and the tile slots."""
    return (BLOCK_Q * head_dim * 2 + STAGES * 2 * BLOCK_K[head_dim]
            * head_dim * 2 + 1024 + 8 * (6 + 3 * STAGES) + 8)


def _map_strides(name: str, shape, strides) -> tuple[int, int, int]:
    """The element strides (b, h, s) a (B, H, S, D) operand's 4-D map over
    (D, S, H, B) is encoded at; raises where TMA would refuse them."""
    b, h, s, d = shape
    if strides[3] != 1:
        raise ValueError(f"{name}: the CUDA flash kernel needs a unit "
                         f"head_dim stride, got strides {tuple(strides)}")
    # a dimension of extent 1 is read at coordinate 0 alone: give it the
    # stride of a contiguous layout, whatever the view says
    st_s = strides[2] if s > 1 else d
    st_h = strides[1] if h > 1 else st_s * s
    st_b = strides[0] if b > 1 else st_h * h
    for st in (st_s, st_h, st_b):
        if st % 8 or st <= 0 or st * 2 >= TMA_STRIDE_LIMIT:
            raise ValueError(
                f"{name}: TMA takes strides that are positive multiples of "
                f"16 bytes below 2^40 bytes (16-byte aligned rows), got "
                f"element strides {tuple(strides)} for shape {tuple(shape)}")
    return st_b, st_h, st_s


@functools.lru_cache(maxsize=256)
def flash_plan(q_shape, q_strides, k_shape, k_strides, v_strides, *,
               sms: int = H100_SMS) -> FlashPlan:
    """The launch of q (B, Hq, Sq, D) over k, v (B, Hkv, Skv, D) at element
    strides, D one of ``KERNEL_HEAD_DIMS`` (the wrapper pads others):
    tiles, the persistent grid on a card of ``sms`` SMs, stages, shared
    memory and the strides of the three tensor maps. Raises ValueError,
    before any launch, where TMA would refuse a map. Cached: the paths
    launch a handful of shapes, each many times."""
    b, hq, sq, d = q_shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    strides = (_map_strides("q", q_shape, q_strides)
               + _map_strides("k", k_shape, k_strides)
               + _map_strides("v", k_shape, v_strides))
    tiles = _cdiv(sq, BLOCK_Q) * b * hq
    return FlashPlan(block_q=BLOCK_Q, block_k=BLOCK_K[d], stages=STAGES,
                     threads=THREADS, tiles=tiles,
                     grid=max(1, min(tiles, sms)),
                     smem_bytes=smem_bytes(d), strides=strides)


def kv_blocks(q_tile: int, *, block_k: int, sq: int, skv: int,
              causal: bool, window: int | None, q_off: int = 0,
              kv_off: int = 0) -> range:
    """The key blocks (of ``block_k``) that query tile ``q_tile`` schedules
    — the twin of ``kv_range`` in csrc/flash_attention.cu. A block is
    scheduled iff it holds a (row, key) pair visible to a real row (< sq)
    at a real key (< skv), at global positions (``q_off`` + row, ``kv_off``
    + key) for the hop: the Pallas kernel's predicate
    (``flash_attention.py:37-41``) at the tile's real extent. The visible
    keys of the tile's rows r0..r1 form one interval, so the blocks are one
    range."""
    n_kb = _cdiv(skv, block_k)
    q_lo = q_tile * BLOCK_Q
    r0 = q_off + q_lo
    r1 = q_off + min(q_lo + BLOCK_Q, sq) - 1
    lo, hi = 0, n_kb
    if causal:                          # the block's first key <= r1
        d = r1 - kv_off
        hi = 0 if d < 0 else min(n_kb, d // block_k + 1)
    if window:                          # its last real key > r0 - window
        t = r0 - window + 1 - kv_off
        lo = 0 if t <= 0 else n_kb if t >= skv else t // block_k
    return range(lo, hi)


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          scale=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, Skv, D). f32 softmax, GQA grouped."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def _hop_offsets(b: int, ranks: int, hop: int, sq: int, skv: int,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (q, kv) offsets of each of the ``b = ranks · B`` rows of a
    hop: rank r = row // B holds queries from ``r·sq`` and, at hop ``hop``,
    the keys of rank ``(r - hop) mod ranks`` from that rank's ``·skv``."""
    if ranks < 1 or b % ranks:
        raise ValueError(f"batch {b} is not a multiple of {ranks} ranks")
    r = torch.arange(ranks, device=device).repeat_interleave(b // ranks)
    return r * sq, (r - hop) % ranks * skv


def flash_attention_hop_plain(q, k, v, *, ranks=1, hop=0, causal=True,
                              window=None, scale=None):
    """One hop of ring attention in f32 (see the module docstring): q
    (R·B, Hq, S, D), k, v (R·B, Hkv, Skv, D) -> (o (R·B, Hq, S, D), m, l
    (R·B, Hq, S)), all f32. A row with no visible key has m = NEG_INF,
    l = 0 and o = 0, so it merges as a no-op."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    q_off, kv_off = _hop_offsets(b, ranks, hop, sq, skv, q.device)
    qg = q.reshape(b, hkv, g, sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qi = q_off[:, None, None] + torch.arange(sq, device=q.device)[:, None]
    ki = kv_off[:, None, None] + torch.arange(skv, device=q.device)
    keep = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    drop = ~keep[:, None, None]
    s = s.masked_fill(drop, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(drop, 0.0)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return (o.reshape(b, hq, sq, hd), m.reshape(b, hq, sq),
            p.sum(dim=-1).reshape(b, hq, sq))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,Hq,S,D), k/v "
                         f"(B,Hkv,S,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError("q and k/v differ in batch or head_dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq ({q.shape[1]}) must be a multiple of Hkv "
                         f"({k.shape[1]})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _cuda_inputs(q, k, v, window, scale, name):
    """Check CUDA inputs and pad head_dim up to the kernel's next width.
    Returns (q, k, v, true head_dim, scale of the true head_dim)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA {name} takes bf16 q, k, v")
    hd = q.shape[3]
    width = next((w for w in KERNEL_HEAD_DIMS if hd <= w), None)
    if width is None:
        raise ValueError(f"head_dim must be at most {KERNEL_HEAD_DIMS[-1]}, "
                         f"got {hd}")
    if width != hd:
        q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs 16-byte aligned bases, got "
                             f"{t.data_ptr():#x}")
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    scale = scale if scale is not None else hd ** -0.5
    if not scale > 0:       # the kernel takes row maxima of the raw scores
        raise ValueError(f"the CUDA {name} takes a positive scale, got "
                         f"{scale}")
    plan = flash_plan(tuple(q.shape), q.stride(), tuple(k.shape), k.stride(),
                      v.stride(), sms=sm_count(q.device))
    return q, k, v, hd, scale, plan


_TILE_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counter(device: torch.device) -> tuple[int, int]:
    """The current stream's tile counter on ``device`` (two zeroed int32
    the kernel's last block resets) and the stream. Launches on one stream
    run in turn and reuse it; launches on two streams never share one, so
    neither takes the other's tiles."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    if key not in _TILE_COUNTERS:
        _TILE_COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _TILE_COUNTERS[key].data_ptr(), stream


def kernel_config(head_dim: int) -> tuple[int, ...]:
    """What the built kernel says of its launch at ``head_dim``: (query rows
    a block, keys a stage, stages, threads, shared memory bytes), to hold
    against :func:`flash_plan` on the card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().pk_flash_attention_config(head_dim, out),
                 "pk_flash_attention_config")
    return tuple(out)


def _forward(q, k, v, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    q, k, v, hd, scale, plan = _cuda_inputs(q, k, v, window, scale,
                                            "flash_attention")
    b, hq, sq, width = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, width), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out[..., :hd]
    lib = _build.library()
    err = lib.pk_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, hkv, sq, skv, width, *plan.strides,
        int(causal), int(window or 0), float(scale), plan.grid,
        *_tile_counter(q.device))
    _build.check(err, "pk_flash_attention_bf16")
    flash_attention.launches += 1
    return out[..., :hd]


def _hop_forward(q, k, v, ranks, hop, causal, window, scale):
    if q.device.type == "cpu":
        return flash_attention_hop_plain(q, k, v, ranks=ranks, hop=hop,
                                         causal=causal, window=window,
                                         scale=scale)
    q, k, v, hd, scale, plan = _cuda_inputs(q, k, v, window, scale,
                                            "flash_attention_hop")
    b, hq, sq, width = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if ranks < 1 or b % ranks:
        raise ValueError(f"batch {b} is not a multiple of {ranks} ranks")
    o = torch.empty((b, hq, sq, width), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    l_ = torch.empty_like(m)
    if b == 0 or sq == 0:
        return o[..., :hd], m, l_
    lib = _build.library()
    err = lib.pk_flash_attention_hop_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l_.data_ptr(), b, hq, hkv, sq, skv, width, *plan.strides,
        ranks, hop, int(causal), int(window or 0), float(scale), plan.grid,
        *_tile_counter(q.device))
    _build.check(err, "pk_flash_attention_hop_bf16")
    flash_attention_hop.launches += 1
    return o[..., :hd], m, l_


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.opts
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            o = flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Attention of q (B, Hq, S, D) over k, v (B, Hkv, Skv, D), out like q."""
    _check(q, k, v)
    return _Flash.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ranks, hop, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(ranks=ranks, hop=hop, causal=causal, window=window,
                        scale=scale)
        return _hop_forward(q, k, v, ranks, hop, causal, window, scale)

    @staticmethod
    def backward(ctx, do, dm, dl):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            outs = flash_attention_hop_plain(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(outs, (q, k, v), (do, dm, dl))
        return dq, dk, dv, None, None, None, None, None


def flash_attention_hop(q, k, v, *, ranks=1, hop=0, causal=True, window=None,
                        scale=None):
    """One ring-attention hop over ``ranks`` stacked ranks folded into the
    batch: q (R·B, Hq, S, D), k, v (R·B, Hkv, Skv, D) -> (o, m, l) in f32
    (see the module docstring)."""
    _check(q, k, v)
    return _Hop.apply(q, k, v, ranks, hop, causal, window, scale)


flash_attention_hop.launches = 0
