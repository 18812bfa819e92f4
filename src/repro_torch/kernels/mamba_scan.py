"""Mamba-1 selective scan — the SSM mixer's recurrence.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (the Pallas
``_scan_kernel``): dt, x (B, S, D); b, c (B, S, N); a (D, N) f32; h0
(B, D, N) f32 -> y (B, S, D) f32 and the last state (B, D, N) f32, with
``h_t = exp(dt_t·a)·h_{t-1} + (dt_t·x_t)·b_t`` and ``y_t = Σ_n h_t·c_t``
and no D skip (the model adds ``x·D``). On the TPU the grid is (B, S/chunk)
with the chunk axis sequential and the (D, N) state carried across chunks
in VMEM.

CUDA route (``csrc/mamba_scan.cu``). On Hopper the recurrence is
independent per (batch, channel), so a loop over t inside the block takes
the place of the sequential grid axis and the state never leaves
registers. One thread per (channel, state n) — 16 lanes a channel at the
path's N = 16 — rather than one thread per channel: a B = 1 prefill then
has B·D·N = 131,072 threads where one a channel would give 8,192 and leave
half of the 132 SMs idle, and at decode each lane reads and writes one f32
of the state, coalesced. y_t is the sum over the N lanes by a butterfly of
warp shuffles. dt and x (read coalesced across the block's channels) and
b, c (N values a step, shared by every channel of the row) are staged
through shared memory for a run of steps; y is staged back and written
coalesced. Inputs come in their own types — dt f32 with x, b, c bf16 (the
model's path: softplus plus the f32 ``dt_bias`` promotes dt) or all f32
(the tests); other mixes are refused — and are widened in the kernel,
never cast on the host. The state is read and written through strides, so the
serving cache's stacked per-rank layout (R, B, D/R, N) is used in place —
one launch covers the channels of every virtual rank — and ``h_out`` lets
the caller give the slab the new state goes to.

What bounds it on the card: bytes — dt, x and y over (B, S, D), b and c
over (B, S, N), the state read once and written once; the B·S·D·N
exponentials and products are below the f32 rate. This first version is
far from that bound at prefill: each lane runs one serial chain over S,
some 35 instructions a step with four dependent shuffles, so it is
issue-bound (PERF.md has its times). It has no chunked parallel scan, no
TMA load pipeline, and leaves ``x·D``, the ``silu(z)`` gate and the conv
unfused.

``chunk`` keeps the JAX signature: it is the run of steps staged at once
(at most 128). Every channel runs the same rounded operations in the same
order whatever it is, so the result is bit-identical for every chunk, and
a scan over S + k steps equals a scan over S followed by k scans of one
step chained through h0.

On a CPU tensor the wrapper runs the plain version (the sequential f32
recurrence); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_TYPES = (torch.float32, torch.bfloat16)


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
    err = _build.library().pk_mamba_scan(
        dt.data_ptr(), x.data_ptr(), b_ssm.data_ptr(), c_ssm.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        bsz, s, d, n, int(chunk), int(low == torch.bfloat16),
        dt.stride(0), dt.stride(1), x.stride(0), x.stride(1),
        b_ssm.stride(0), b_ssm.stride(1), c_ssm.stride(0), c_ssm.stride(1),
        dl, h0r, h0b, hor, hob,
        torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(err, "pk_mamba_scan")
    mamba_scan.launches += 1
    return y, h_out


def mamba_scan(dt, b_ssm, c_ssm, x, a, h0, *, chunk: int = 128,
               h_out: torch.Tensor | None = None):
    """dt, x: (B, S, D); b_ssm, c_ssm: (B, S, N); a: (D, N) f32; h0:
    (B, D, N) f32, or the stacked per-rank (R, B, D/R, N). Returns
    (y (B, S, D) f32, h_last f32 in h0's layout — written into ``h_out``
    when one is given)."""
    _check(dt, b_ssm, c_ssm, x, a, h0, h_out)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
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


mamba_scan.launches = 0
