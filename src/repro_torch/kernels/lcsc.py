"""The LCSC program template (paper §3.2.3) on Hopper, and the ring
all-gather written on it.

Replaces ``repro/kernels/lcsc.py::lcsc_kernel`` and ``::lcsc_ring_all_gather``.
On the TPU the paper's four workers — loader, consumer, storer,
communicator — are issue streams of one core: per ring step the
communicator starts the next remote DMA, the others work while it flies,
and the step closes on the hop's DMA semaphores. The ring all-gather
written on it stages the local shard into its own output slot, then at
step i forwards the shard that arrived i hops ago to the right neighbour.

CUDA route (``csrc/lcsc.cuh``, the template; ``csrc/lcsc.cu``, the
all-gather on it; flags and stores from ``csrc/pk.cuh``). Blocks run in
parallel and in no order, and a block that spin-waits on one not yet
resident deadlocks. The ring's step i forwards what arrived at step i - 1,
so unlike the store-and-count kernels this one must wait. The wait is made
safe by construction:

* a persistent grid of R ranks x P parts: each block moves its part of a
  slot at every step;
* P from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, so that every
  block is resident, and a cooperative launch
  (``cudaLaunchCooperativeKernel``), which CUDA refuses rather than
  run a grid that cannot be co-resident — a refusal raises here, with no
  fallback to the ring kernel of ``pk_comm.py`` or to a plain copy;
* each block waits (``pk::wait``, acquire) only on its counterpart's
  (rank, step, part) flag — the left neighbour's same part, which signals
  (release, after a fence) before it waits itself;
* the spin is bounded: past ~2^32 SM cycles the block traps, so a bug
  fails the launch instead of hanging the card.

The flags (one int per (rank, step, part)) are zeroed on the stream before
each launch, in scratch cached per (device, stream). A copy is exact, so
the result is bit-identical to ``all_gather_plain`` and to
``pk_comm.ring_all_gather``. What bounds it: bytes — R·blk read and R²·blk
written — plus one flag round trip per step of the R - 1 dependent steps.

Stacked layout (``core/pgl.py``): x (R, *local), rank r's shard at x[r],
-> (R, R, *local), any dtype. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import pgl
from repro_torch.kernels import _build
from repro_torch.kernels.pk_comm import _check_cuda, all_gather_plain

#: arrival-flag scratch per (device, stream), in ints; the launcher fits
#: the parts per rank to it
FLAG_INTS = 1 << 16

_FLAGS: dict[tuple, torch.Tensor] = {}


def _flags(device, stream: int) -> torch.Tensor:
    key = (device, stream)
    if key not in _FLAGS:
        _FLAGS[key] = torch.empty((FLAG_INTS,), dtype=torch.int32,
                                  device=device)
    return _FLAGS[key]


def lcsc_ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """x (R, *local) stacked shards -> (R, R, *local): every rank holds
    every shard, in x's dtype, bit for bit."""
    if x.dim() < 1:
        raise ValueError("lcsc_ring_all_gather takes a stacked (R, ...) "
                         "tensor")
    if x.device.type == "cpu":
        return all_gather_plain(x)
    _check_cuda(x, "lcsc_ring_all_gather")
    x = x.contiguous()
    r = x.shape[0]
    out = torch.empty((r, *x.shape), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().pk_lcsc_all_gather(
        _build.host_table(pgl.pointer_table(x)),
        _build.host_table(pgl.pointer_table(out)),
        _flags(x.device, stream).data_ptr(), FLAG_INTS, r,
        x[0].numel() * x.element_size(), stream)
    _build.check(err, "pk_lcsc_all_gather")
    lcsc_ring_all_gather.launches += 1
    return out


lcsc_ring_all_gather.launches = 0
