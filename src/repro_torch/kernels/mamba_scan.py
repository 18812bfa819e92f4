"""Mamba-1 selective scan — the SSM mixer's recurrence.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (the Pallas
``_scan_kernel``): dt, x (B, S, D); b, c (B, S, N); a (D, N) f32; h0
(B, D, N) f32 -> y (B, S, D) f32 and the last state (B, D, N) f32, with
``h_t = exp(dt_t·a)·h_{t-1} + (dt_t·x_t)·b_t`` and ``y_t = Σ_n h_t·c_t``
and no D skip (the model adds ``x·D``). On the TPU the grid is (B, S/chunk)
with the chunk axis sequential and the (D, N) state carried across chunks
in VMEM.

CUDA route (``csrc/mamba_scan.cu``). On Hopper the recurrence is
independent per (batch, channel, state), so a loop over t inside the block
takes the place of the sequential grid axis and the state never leaves
registers. The recurrence stays sequential in t: a parallel scan over S
would re-associate the products and break the bit identity below. A lane
holds K = min(4, N) states of one channel (K independent FMA chains) and N
/ K lanes make a channel, so y_t is the lane's K products summed in order
and a butterfly of log2(N / K) warp shuffles (2 at the path's N = 16). A
block covers a tile of 64 or 128 channels (``scan_plan``: 128 where the
batch rows still give every SM a block, so each staged row of dt is 512
contiguous bytes) of one batch row. Two kernels run the same step:

* staged (prefill, S > 1): a producer warp loads each run of steps' dt, x
  tiles [run x channels] and b, c [run x N] by TMA (3-D tensor maps,
  zero-filled past S and D) into a ring of 2 shared-memory stages under
  full and empty mbarriers, so the next run loads while this one is
  scanned. bf16 b and c are widened to f32 once a run by all the lanes
  together (each value is read by every channel), and y_t goes out through
  a double-buffered shared-memory tile in 16-byte words; one barrier of
  the consumer lanes a run covers both.
* direct (decode, S = 1, and operands a tensor map cannot take: an address
  or a row stride not a multiple of 16 bytes, b and c rows under 16 bytes,
  D not a multiple of 4): no staging and no block barrier; each lane reads
  its dt, x, b, c, a and state directly, steps, and writes y and the state.

Inputs come in their own types — dt f32 with x, b, c bf16 (the model's
path: softplus plus the f32 ``dt_bias`` promotes dt) or all f32 (the
tests); other mixes are refused — and are widened in the kernel, never cast
on the host. The state is read and written through strides, so the serving
cache's stacked per-rank layout (R, B, D/R, N) is used in place — one
launch covers the channels of every virtual rank — and ``h_out`` lets the
caller give the slab the new state goes to.

What bounds it on the card: bytes — dt, x and y over (B, S, D), b and c
over (B, S, N), the state read once and written once — against the
B·S·D·N exponentials and some dozen other instructions a state a step
(the exponentials alone run at 16 an SM a clock). It leaves ``x·D``, the
``silu(z)`` gate and the conv unfused. ``csrc/mamba_scan_yardstick.cu``
keeps the kernel it replaced, a timing yardstick the port never calls.

``chunk`` keeps the JAX signature: it caps the run of steps a stage holds
(``scan_plan``). Every channel runs the same rounded operations in the
same order whatever the run, the stage or the kernel, so the result is
bit-identical for every chunk, and a scan over S + k steps equals a scan
over S followed by k scans of one step chained through h0.

On a CPU tensor the wrapper runs the plain version (the sequential f32
recurrence); on a CUDA tensor it launches the kernel or raises.

Backward (``csrc/mamba_scan_bwd.cu``, no Pallas counterpart: JAX
differentiates its XLA associative scan). ``mamba_scan`` is an autograd
Function wherever an input requires a gradient: its forward is the kernel
above, its backward ``mamba_scan_bwd`` — the hand-written kernel on the
card, ``mamba_scan_bwd_plain`` on the CPU. With g_t = dy_t·c_t +
exp(dt_{t+1}·a)·g_{t+1} the reverse recurrence over the states, it
returns dx, ddt, db, dc and da (sums over n, over d and over (b, t)). A
lane holds K = min(4, N) states of one channel, as in the forward, and a
block of 256 lanes covers 256·K/N channels of one batch row. The sequence
runs in segments of min(S, 8) steps (``scan_bwd_plan``), each staged
in shared memory (dt, x, dy over the block's channels, b and c), widened
to f32, by coalesced loads. The block first runs the forward from h0 and
stores the state at every segment's start, then re-runs each segment
from its start, last segment first, keeping every h_{t-1} in shared
memory, and walks it backward with g in registers, keeping every g_t
there too; after the walk the block sums db and dc over its channels,
one (step, state) a thread. Sums over d go through one partial a block,
over (b, t) through one partial a batch row, summed in index order by a
second kernel: no float atomics, so the gradient is the same bits run to
run and for every segment length (``_launch_bwd``'s ``seg`` lets a test
shorten them). Training
starts from h0 = 0 and never reads ``h_last``: the Function refuses an h0
that requires a gradient and a ``h_last`` cotangent that is not zero.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import H100_SMS, SMEM_LIMIT, sm_count

_TYPES = (torch.float32, torch.bfloat16)
#: steps a stage holds at most, stages of the staged kernel's ring
RUN_MAX = 32
STAGES = 2
#: channels a block: wide where B·D/wide blocks still give every SM one
#: and the lanes fit, else narrow
CHANNELS = (128, 64)
#: consumer lanes a block at most (csrc/mamba_scan.cu SC_MAX_CONSUMERS)
MAX_CONSUMERS = 512
#: tensor-map strides stay below 2^40 bytes
_TMA_STRIDE_LIMIT = 1 << 40


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How the kernel runs a scan of (B, S, D) with N states."""
    staged: bool        # the TMA-staged kernel (else the direct one)
    k_states: int       # states a lane
    lanes: int          # lanes a channel, N / k_states
    channels: int       # channels a block
    run: int            # steps a stage (0: direct)
    stages: int         # (0: direct)
    threads: int        # consumer lanes, + a producer warp when staged
    grid: tuple[int, int]   # (channel tiles, B)
    smem_bytes: int     # dynamic shared memory a block: the .cu's
                        # ScLayout, which the launch checks


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def scan_plan(b: int, s: int, d: int, n: int, elsize: int, *,
              chunk: int = 256, tma_ok: bool = True,
              sms: int = H100_SMS) -> ScanPlan:
    """The launch of a scan of (B, S, D) with N states (a power of two <=
    32), x, b, c of ``elsize`` bytes, on a card of ``sms`` SMs. ``tma_ok``:
    every operand's address and (step, batch) strides are 16-byte
    multiples below 2^40 bytes (``_tma_ok``). The staged kernel takes S >
    1, D a multiple of 4 and b, c rows of at least 16 bytes; anything else
    runs the direct kernel. A block covers ``CHANNELS``' 128 channels where
    B·D/128 blocks still give every SM one and 128·N/K lanes fit, else 64.
    ``smem_bytes`` is the .cu's ``ScLayout``, which the launch checks."""
    if n < 1 or n > 32 or n & (n - 1):
        raise ValueError(f"the CUDA mamba_scan needs N a power of two <= 32, "
                         f"got N = {n}")
    k = min(4, n)
    lanes = n // k
    wide, narrow = CHANNELS
    ch = wide if (b * -(-d // wide) >= sms
                  and wide * lanes <= MAX_CONSUMERS) else narrow
    grid = (-(-d // ch), b)
    staged = (tma_ok and s > 1 and d % 4 == 0 and n * elsize >= 16)
    if not staged:
        return ScanPlan(False, k, lanes, ch, 0, 0, ch * lanes, grid, 0)
    run = max(1, min(chunk, RUN_MAX, s))
    return ScanPlan(True, k, lanes, ch, run, STAGES, ch * lanes + 32, grid,
                    staged_smem(ch, run, n, elsize, STAGES))


def staged_smem(ch: int, run: int, n: int, elsize: int, stages: int) -> int:
    """The staged kernel's shared memory, ``ScLayout`` in the .cu:
    ``stages`` stages of dt and x [run x ch] and b, c [run x N] (each
    128-byte aligned), two y tiles [run x ch] f32, for bf16 two runs of b
    and c widened to f32, and the mbarriers."""
    stage = (_align128(run * ch * 4) + _align128(run * ch * elsize)
             + 2 * _align128(run * n * elsize))
    widened = 2 * 2 * run * n * 4 if elsize == 2 else 0
    return stages * stage + 2 * run * ch * 4 + widened + 2 * stages * 8


def _tma_ok(*tensors) -> bool:
    """Every tensor's address and its two outer strides (the batch stride
    only where B > 1) are 16-byte multiples below 2^40 bytes."""
    for t in tensors:
        es = t.element_size()
        strides = [t.stride(1)] + ([t.stride(0)] if t.shape[0] > 1 else [])
        if t.data_ptr() % 16 or any(
                st * es % 16 or not 0 < st * es < _TMA_STRIDE_LIMIT
                for st in strides):
            return False
    return True


def mamba_scan_plain(dt, b_ssm, c_ssm, x, a, h0):
    """The sequential f32 recurrence: returns (y (B, S, D) f32, h_last f32
    in h0's layout, (B, D, N) or the stacked per-rank (R, B, D/R, N))."""
    dt, x = dt.float(), x.float()
    b_ssm, c_ssm, a = b_ssm.float(), c_ssm.float(), a.float()
    h = h0.float()
    if h0.dim() == 4:       # channel r·D/R + j is rank r's channel j
        h = h.movedim(0, 1).flatten(1, 2)
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * a) * h \
            + (dt_t * x[:, t, :, None]) * b_ssm[:, t, None, :]
        ys.append((h * c_ssm[:, t, None, :]).sum(-1))
    if h0.dim() == 4:
        h = h.unflatten(1, (h0.shape[0], h0.shape[2])).movedim(1, 0)
    return torch.stack(ys, 1), h


def _check(dt, b_ssm, c_ssm, x, a, h0, h_out) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"mamba_scan takes dt, x (B, S, D), got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    bsz, s, d = dt.shape
    n = a.shape[-1]
    if a.shape != (d, n) or b_ssm.shape != (bsz, s, n) \
            or c_ssm.shape != b_ssm.shape:
        raise ValueError(f"mamba_scan takes b, c (B, S, N) and a (D, N), "
                         f"got {tuple(b_ssm.shape)}, {tuple(c_ssm.shape)}, "
                         f"{tuple(a.shape)} for dt {tuple(dt.shape)}")
    if h0.dim() == 3:
        ok = h0.shape == (bsz, d, n)
    else:
        ok = h0.dim() == 4 and h0.shape[1] == bsz and h0.shape[3] == n \
            and h0.shape[0] * h0.shape[2] == d
    if not ok:
        raise ValueError(f"mamba_scan takes h0 (B, D, N) or stacked (R, B, "
                         f"D/R, N), got {tuple(h0.shape)} for B={bsz} "
                         f"D={d} N={n}")
    if h_out is not None and h_out.shape != h0.shape:
        raise ValueError(f"h_out {tuple(h_out.shape)} must have h0's shape "
                         f"{tuple(h0.shape)}")
    if len({t.device for t in (dt, b_ssm, c_ssm, x, a, h0)}) != 1:
        raise ValueError("mamba_scan's inputs must be on one device")


def _launch(dt, b_ssm, c_ssm, x, a, h0, chunk, h_out):
    """Check and launch at ``scan_plan``'s launch."""
    bsz, s, d = dt.shape
    n = a.shape[-1]
    if n > 32 or n & (n - 1):
        raise ValueError(f"the CUDA mamba_scan needs N a power of two <= 32, "
                         f"got N = {n}")
    low = x.dtype
    if dt.dtype != torch.float32 or low not in _TYPES \
            or b_ssm.dtype != low or c_ssm.dtype != low:
        raise ValueError(f"the CUDA mamba_scan takes dt f32 and x, b, c all "
                         f"f32 or all bf16, got dt {dt.dtype}, x {x.dtype}, "
                         f"b {b_ssm.dtype}, c {c_ssm.dtype}")
    for name, t in (("dt", dt), ("x", x), ("b", b_ssm), ("c", c_ssm)):
        if t.stride(2) != 1:
            raise ValueError(f"the CUDA mamba_scan takes {name} with a "
                             f"contiguous last dim, got strides {t.stride()}")
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError("the CUDA mamba_scan takes a contiguous f32 a")
    if h_out is None:
        h_out = torch.empty_like(h0, memory_format=torch.contiguous_format)
    for name, t in (("h0", h0), ("h_out", h_out)):
        if t.dtype != torch.float32 or t.stride(-1) != 1 \
                or t.stride(-2) != n or t.device != dt.device:
            raise ValueError(f"the CUDA mamba_scan takes an f32 {name} with "
                             f"contiguous (channel, state) dims on dt's "
                             f"device")
    if h0.dim() == 3:      # one rank: every channel in the rank's slab
        dl, h0r, h0b, hor, hob = d, 0, h0.stride(0), 0, h_out.stride(0)
    else:
        dl = h0.shape[2]
        h0r, h0b = h0.stride(0), h0.stride(1)
        hor, hob = h_out.stride(0), h_out.stride(1)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dt.device)
    p = scan_plan(bsz, s, d, n, x.element_size(), chunk=int(chunk),
                  tma_ok=_tma_ok(dt, x, b_ssm, c_ssm), sms=sm_count(dt.device))
    err = _build.library().pk_mamba_scan(
        dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        bsz, s, d, n, int(low == torch.bfloat16),
        dt.stride(0), dt.stride(1), x.stride(0), x.stride(1),
        b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1),
        dl, h0r, h0b, hor, hob, p.channels, p.run, p.stages, int(p.staged),
        p.smem_bytes, torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(err, "pk_mamba_scan")
    mamba_scan.launches += 1
    return y, h_out


def _scan(dt, b_ssm, c_ssm, x, a, h0, chunk, h_out):
    """The forward on ``dt``'s device: the kernel or the plain version."""
    dev = dt.device.type
    if dev == "cuda":
        return _launch(dt, b_ssm, c_ssm, x, a, h0, chunk, h_out)
    if dev != "cpu":
        raise ValueError(f"mamba_scan runs on cpu or cuda, not {dt.device}")
    y, h = mamba_scan_plain(dt, b_ssm, c_ssm, x, a, h0)
    if h_out is None:
        return y, h
    h_out.copy_(h)
    return y, h_out


class _ScanFn(torch.autograd.Function):
    """``mamba_scan`` with a gradient: forward the scan, backward
    ``mamba_scan_bwd`` from the saved inputs (h0 takes none)."""

    @staticmethod
    def forward(ctx, dt, b_ssm, c_ssm, x, a, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, b_ssm, c_ssm, x, a, h0)
        return _scan(dt, b_ssm, c_ssm, x, a, h0, chunk, None)

    @staticmethod
    def backward(ctx, dy, dh_last):
        if dh_last is not None and bool(dh_last.any()):
            raise NotImplementedError(
                "mamba_scan's backward takes no gradient of h_last (training "
                "never reads the last state)")
        dt, b_ssm, c_ssm, x, a, h0 = ctx.saved_tensors
        if dy is None:
            return (None,) * 7
        return (*mamba_scan_bwd(dt, b_ssm, c_ssm, x, a, h0, dy), None, None)


def mamba_scan(dt, b_ssm, c_ssm, x, a, h0, *, chunk: int = 128,
               h_out: torch.Tensor | None = None):
    """dt, x: (B, S, D); b_ssm, c_ssm: (B, S, N); a: (D, N) f32; h0:
    (B, D, N) f32, or the stacked per-rank (R, B, D/R, N). Returns
    (y (B, S, D) f32, h_last f32 in h0's layout — written into ``h_out``
    when one is given). Where grad mode is on and dt, b, c, x or a
    requires a gradient, the scan is an autograd Function whose backward is
    :func:`mamba_scan_bwd` (then h0 must not require one, and ``h_out`` is
    refused)."""
    _check(dt, b_ssm, c_ssm, x, a, h0, h_out)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, b_ssm, c_ssm, x, a, h0)):
        if h0.requires_grad:
            raise NotImplementedError(
                "mamba_scan's backward gives no gradient of h0 (training "
                "starts from a zero state)")
        if h_out is not None:
            raise ValueError("a differentiated mamba_scan returns a new "
                             "h_last; h_out is for serving")
        return _ScanFn.apply(dt, b_ssm, c_ssm, x, a, h0, int(chunk))
    return _scan(dt, b_ssm, c_ssm, x, a, h0, chunk, h_out)


mamba_scan.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

#: lanes a block of the backward kernel, steps a segment at most (shared
#: memory holds a segment's h and g), the pad of a row of lanes' states
BWD_THREADS = 256
BWD_SEG_MAX = 8
BWD_PAD = 16


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """How the backward kernel runs a scan of (B, S, D) with N states."""
    seg: int            # steps a segment
    nseg: int           # segments, ceil(S / seg)
    k_states: int       # states a lane
    channels: int       # channels a block, 256 / (N / k_states)
    nblk: int           # channel tiles: the partials of db and dc a step
    grid: tuple[int, int]   # (channel tiles, B)
    smem_bytes: int     # the .cu's sb_smem_floats, which the launch checks


def scan_bwd_plan(b: int, s: int, d: int, n: int) -> ScanBwdPlan:
    """The backward kernel's launch for a scan of (B, S, D), N states (a
    power of two <= 32): segments of min(S, 8) steps, K = min(4, N)
    states a lane, 256·K/N channels a block. Shared memory: a segment's
    h_{t-1} and last h and its g (rows of 256·K states, padded), the
    staged dt, x, dy and the dx, ddt rows (a segment's steps x the
    channels), the staged b and c."""
    return _bwd_plan(b, s, d, n, min(s, BWD_SEG_MAX))


def _bwd_plan(b: int, s: int, d: int, n: int, seg: int) -> ScanBwdPlan:
    """``scan_bwd_plan`` with segments of ``seg`` steps, 1 <= seg <=
    min(S, 8): tests reach short and ragged segments through it."""
    if not 1 <= seg <= min(s, BWD_SEG_MAX):
        raise ValueError(f"a segment takes 1 to min(S, {BWD_SEG_MAX}) = "
                         f"{min(s, BWD_SEG_MAX)} steps, got {seg}")
    if n < 1 or n > 32 or n & (n - 1):
        raise ValueError(f"the CUDA mamba_scan backward needs N a power of "
                         f"two <= 32, got N = {n}")
    k = min(4, n)
    ch = BWD_THREADS // (n // k)
    nblk = -(-d // ch)
    row = BWD_THREADS * k + BWD_PAD
    smem = ((2 * seg + 1) * row + 5 * seg * ch + 2 * seg * n) * 4
    return ScanBwdPlan(seg, -(-s // seg), k, ch, nblk, (nblk, b), smem)


def mamba_scan_bwd_plain(dt, b_ssm, c_ssm, x, a, h0, dy):
    """The reverse recurrence in f32 with a loop over S: given y's
    cotangent ``dy`` (B, S, D), returns (ddt, db, dc, dx, da) — ddt and da
    f32, db, dc and dx in x's dtype. h0 (B, D, N) f32."""
    dtf, xf = dt.float(), x.float()
    bf, cf, af, dyf = b_ssm.float(), c_ssm.float(), a.float(), dy.float()
    s = dt.shape[1]
    hs = [h0.float()]                       # h_{t-1} of every step
    for t in range(s - 1):
        dt_t = dtf[:, t, :, None]
        hs.append(torch.exp(dt_t * af) * hs[-1]
                  + (dt_t * xf[:, t, :, None]) * bf[:, t, None, :])
    g = torch.zeros_like(hs[0])
    a_next = torch.zeros_like(hs[0])
    ddt, dx, db, dc = (torch.empty_like(dtf), torch.empty_like(dtf),
                       torch.empty_like(bf), torch.empty_like(cf))
    da = torch.zeros_like(af)
    for t in reversed(range(s)):
        dt_t, x_t = dtf[:, t, :, None], xf[:, t, :, None]
        b_t, c_t = bf[:, t, None, :], cf[:, t, None, :]
        h_prev = hs[t]
        abar = torch.exp(dt_t * af)
        h_t = abar * h_prev + (dt_t * x_t) * b_t
        g = a_next * g + dyf[:, t, :, None] * c_t
        a_next = abar
        gb = (g * b_t).sum(-1)
        gh = g * h_prev
        dx[:, t] = dt_t[..., 0] * gb
        ddt[:, t] = x_t[..., 0] * gb + (gh * af * abar).sum(-1)
        da += (gh * dt_t * abar).sum(0)
        db[:, t] = (g * (dt_t * x_t)).sum(1)
        dc[:, t] = (dyf[:, t, :, None] * h_t).sum(1)
    low = x.dtype
    return ddt, db.to(low), dc.to(low), dx.to(low), da


def _launch_bwd(dt, b_ssm, c_ssm, x, a, h0, dy, seg: int | None = None):
    """Check and launch the backward at ``scan_bwd_plan``'s launch, or
    with segments of ``seg`` steps where a test gives one."""
    bsz, s, d = dt.shape
    n = a.shape[-1]
    low = x.dtype
    if dt.dtype != torch.float32 or low not in _TYPES \
            or b_ssm.dtype != low or c_ssm.dtype != low:
        raise ValueError(f"the CUDA mamba_scan backward takes dt f32 and x, "
                         f"b, c all f32 or all bf16, got dt {dt.dtype}, x "
                         f"{x.dtype}, b {b_ssm.dtype}, c {c_ssm.dtype}")
    dy = dy.float()
    for name, t in (("dt", dt), ("x", x), ("b", b_ssm), ("c", c_ssm),
                    ("dy", dy)):
        if t.stride(2) != 1:
            raise ValueError(f"the CUDA mamba_scan backward takes {name} "
                             f"with a contiguous last dim, got strides "
                             f"{t.stride()}")
    a, h0 = a.float().contiguous(), h0.float().contiguous()
    p = (scan_bwd_plan(bsz, s, d, n) if seg is None
         else _bwd_plan(bsz, s, d, n, seg))
    dev = dt.device
    f32 = dict(dtype=torch.float32, device=dev)
    ckpt = torch.empty((bsz, p.nseg, d, n), **f32)
    part_db = torch.empty((bsz, s, p.nblk, n), **f32)
    part_dc = torch.empty_like(part_db)
    part_da = torch.empty((bsz, d, n), **f32)
    ddt = torch.empty((bsz, s, d), **f32)
    dx = torch.empty((bsz, s, d), dtype=low, device=dev)
    db = torch.empty((bsz, s, n), dtype=low, device=dev)
    dc = torch.empty_like(db)
    da = torch.empty((d, n), **f32)
    err = _build.library().pk_mamba_scan_bwd(
        dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), h0.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
        ddt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), part_db.data_ptr(), part_dc.data_ptr(),
        part_da.data_ptr(), bsz, s, d, n, int(low == torch.bfloat16), p.seg,
        p.smem_bytes, dt.stride(0), dt.stride(1), x.stride(0), x.stride(1),
        b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1),
        dy.stride(0), dy.stride(1),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pk_mamba_scan_bwd")
    mamba_scan_bwd.launches += 1
    return ddt, db, dc, dx, da


def mamba_scan_bwd(dt, b_ssm, c_ssm, x, a, h0, dy):
    """The scan's gradients given y's cotangent ``dy`` (B, S, D): (ddt f32,
    db, dc, dx in x's dtype, da (D, N) f32) for the forward from h0 (B, D,
    N) f32. The kernel on a CUDA tensor (or raises), the plain version on
    a CPU one."""
    _check(dt, b_ssm, c_ssm, x, a, h0, None)
    if h0.dim() != 3 or dy.shape != dt.shape:
        raise ValueError(f"mamba_scan_bwd takes h0 (B, D, N) and dy like dt, "
                         f"got {tuple(h0.shape)}, {tuple(dy.shape)}")
    dev = dt.device.type
    if dev == "cuda":
        return _launch_bwd(dt, b_ssm, c_ssm, x, a, h0, dy)
    if dev != "cpu":
        raise ValueError(f"mamba_scan_bwd runs on cpu or cuda, not "
                         f"{dt.device}")
    return mamba_scan_bwd_plain(dt, b_ssm, c_ssm, x, a, h0, dy)


mamba_scan_bwd.launches = 0
