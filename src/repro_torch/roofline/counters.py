"""One counter for a step's FLOPs, bytes, collectives, kernel launches and
live memory — what the dry-run (``launch/dryrun.py``) reads where JAX reads
``compiled.cost_analysis()`` and ``memory_analysis()``.

:class:`StepCounter` is a ``TorchDispatchMode``: every aten op that runs
under it, on any device, is counted —

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (the GEMM,
  attention and convolution ops; elementwise ops count none, as there);
* **bytes**: each input read once and each output written once, a view
  (an op whose output aliases its input) moving none, a broadcast input
  counted at its stored extent (stride-0 dims once);
* **live bytes**: every storage an op creates counts from its creation
  until it is freed (``weakref.finalize`` on the storage), and
  :attr:`StepCounter.peak_bytes` is their peak — an estimate of a step's
  transient memory beside the arguments (:meth:`StepCounter.ignore`), not
  an allocator's reading.

A hand-written kernel's wrapper enters :func:`kernel` with the kernel's
FLOPs and bytes by its own formula — the same function on the CPU, on the
card and on ``meta``, called only under a counter — and the aten ops inside
it (its plain version, or the buffers the launch allocates) are not counted
again. A wrapper's ``meta`` branch launches nothing: it records the launches
the card would make with :func:`launched` (:attr:`StepCounter.launches`),
while the wrapper's ``.launches`` counts only the card's launches, read
before and after a step on the card (:func:`launch_counts`). ``core/comms.py`` records every collective it runs
with :func:`collective` — the kind, the output bytes a rank in the wire's
dtype, the group size and how many such groups the call stands for — the
comm trace ``roofline/hlo.py`` prices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["StepCounter", "CommRecord", "kernel", "launched", "collective",
           "active", "launch_counts", "tensor_bytes"]


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One collective call: ``kind`` (JAX's HLO names: all-gather,
    all-reduce, reduce-scatter, all-to-all, collective-permute), the output
    bytes of one rank in the wire's dtype, the group size ``n`` and the
    number of groups ``lanes`` the stacked call runs at once."""
    kind: str
    out_bytes: float
    n: int
    lanes: int = 1


#: the counters entered, innermost last
_STACK: list["StepCounter"] = []


def active() -> "StepCounter | None":
    return _STACK[-1] if _STACK else None


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span once: stride-0 (broadcast) dims
    count once."""
    n = t.numel()
    if n and 0 in t.stride():
        n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(tree, acc: list) -> list:
    """The tensors of an op's arguments or results (flat, or one level of
    lists: ``cat``'s inputs)."""
    if isinstance(tree, torch.Tensor):
        acc.append(tree)
        return acc
    for v in tree:
        if isinstance(v, torch.Tensor):
            acc.append(v)
        elif isinstance(v, (list, tuple)):
            acc.extend(t for t in v if isinstance(t, torch.Tensor))
    return acc


_ATEN = torch.ops.aten
#: ops that move no bytes: allocation without a write, autograd plumbing
_NO_BYTES = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
             _ATEN.empty_like.default, _ATEN.new_empty.default,
             _ATEN.new_empty_strided.default, _ATEN.detach.default,
             _ATEN.lift_fresh.default, _ATEN._local_scalar_dense.default}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


class StepCounter(TorchDispatchMode):
    """Counts what runs under it (see the module docstring). Use as a
    context manager; read :attr:`flops`, :attr:`bytes`, :attr:`comms`,
    :attr:`kernels` (name -> FLOPs, bytes, calls), :attr:`launches` (the
    modelled launches of the ``meta`` branches) and :attr:`peak_bytes`
    after it exits."""

    def __init__(self, device: str | None = None):
        super().__init__()
        #: count only ops that touch a tensor on this device type ("meta",
        #: "cuda"); host-side ops (a CPU position, the RNG state a
        #: checkpoint stashes) are not the step's device work. None: all.
        self.device = device
        self.flops = 0                  # exact integers
        self.bytes = 0
        self.comms: list[CommRecord] = []
        self.kernels: dict[str, list[int]] = defaultdict(
            lambda: [0, 0, 0])
        #: wrapper name -> launches the card would make (``meta`` only)
        self.launches: dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: set[int] = set()
        self._depth = 0                 # > 0 inside a kernel entry

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    # -- recording ---------------------------------------------------------

    def ignore(self, tensors) -> "StepCounter":
        """Leave these tensors' storages out of the live bytes: a step's
        arguments, which an in-place op (an optimizer's update) or a view
        hands back as its output, exist before the step and after it."""
        for t in tensors:
            self._seen.add(t.untyped_storage()._cdata)
        return self

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out, []) if isinstance(out, (torch.Tensor, list,
                                                     tuple)) else []
        ins = _tensors(args, [])
        if kwargs:
            _tensors(tuple(kwargs.values()), ins)
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + outs):
            return out
        for t in outs:
            self._track(t)
        if self._depth == 0:
            packet = func._overloadpacket
            if packet in _flop_registry():
                self.flops += int(_flop_registry()[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view and func not in _NO_BYTES:
                self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        flops, nbytes = int(flops), int(nbytes)
        k = self.kernels[name]
        k[0] += flops
        k[1] += nbytes
        k[2] += 1
        self.flops += flops
        self.bytes += nbytes


#: the entry without a counter: no cost computed, nothing recorded
_IDLE = contextlib.nullcontext()


def kernel(name: str, cost):
    """A hand-written kernel's entry: ``cost()`` gives its (FLOPs, bytes)
    by formula for the active counters, and the aten ops inside are not
    counted again. Without a counter ``cost`` is not called."""
    if not _STACK:
        return _IDLE
    return _entry(name, *cost())


def launched(name: str, n: int = 1) -> None:
    """Record ``n`` launches of the kernel whose wrapper is ``name`` on the
    active counters: a ``meta`` branch's, the card's launches it stands
    for. A wrapper's ``.launches`` is left to the card's launch sites."""
    if n:
        for c in _STACK:
            c.launches[name] += int(n)


@contextlib.contextmanager
def _entry(name: str, flops: int, nbytes: int):
    for c in _STACK:
        c.add_kernel(name, flops, nbytes)
        c._depth += 1
    try:
        yield
    finally:
        for c in _STACK:
            c._depth -= 1


def collective(kind: str, out_bytes: float, n: int, lanes: int = 1) -> None:
    """Record one collective on the active counters (nothing without one).
    A call inside a kernel entry is the kernel's own traffic and is
    recorded all the same: the trace prices what the wire carries."""
    if n <= 1:
        return
    for c in _STACK:
        c.comms.append(CommRecord(kind, float(out_bytes), int(n),
                                  int(lanes)))


_NATIVE_META: list = []


def use_native_meta_kernels() -> int:
    """Run ``meta`` ops on ATen's C++ meta kernels where an op has one.

    PyTorch registers Python meta functions (``torch._meta_registrations``)
    over the C++ ones of most ops; they cost ~0.2 ms an op, and a
    production-mesh step runs millions. This drops those registrations and
    puts back the Python ones only for ops without a C++ meta kernel, for
    the rest of the process: call it only where a process starts (the
    dry-run's command line, ``launch/dryrun.py::cli``, or a worker process
    of its own), never from library code. The C++ kernels give an output
    the strides the card's kernels give it (TensorIterator's rules), so the
    counts of ``meta`` and the card stay one. Returns the number of ops
    moved to
    their C++ kernels (0 if already done, or if this PyTorch has no such
    registry)."""
    if _NATIVE_META:
        return 0
    try:
        import torch._meta_registrations as MR
        from torch._decomp import global_decomposition_table
        old = MR._meta_lib_dont_use_me_use_register_meta
        names = {n.split("/")[1] for n in old._op_impls}
    except (ImportError, AttributeError):
        return 0
    table = {}
    for typ in ("meta", "post_autograd", "pre_autograd"):
        for op, fn in global_decomposition_table[typ].items():
            table.setdefault(op, fn)
    old._destroy()
    lib = torch.library.Library("aten", "IMPL", "Meta")
    moved = 0
    for op, fn in table.items():
        if not isinstance(op, torch._ops.OpOverload):
            continue
        name = op.name()
        short = name.split("::", 1)[1]
        if short not in names:
            continue
        if torch._C._dispatch_has_kernel_for_dispatch_key(name, "Meta"):
            moved += 1
        else:
            lib.impl(op, fn)
    _NATIVE_META.append(lib)
    return moved


def launch_counts() -> dict[str, int]:
    """Every hand-written kernel's ``.launches`` count, by wrapper name."""
    from repro_torch.kernels import (collective_matmul, decode_attention,
                                     flash_attention, grouped_matmul, lcsc,
                                     mamba_scan, matmul, pk_comm)
    fns = [matmul.matmul, flash_attention.flash_attention,
           decode_attention.decode_attention,
           flash_attention.flash_attention_hop,
           grouped_matmul.grouped_matmul, mamba_scan.mamba_scan,
           mamba_scan.mamba_scan_bwd, pk_comm.ring_all_gather,
           pk_comm.ring_reduce_scatter, pk_comm.p2p_ring_shift,
           pk_comm.all_to_all, collective_matmul.matmul_ar_fused,
           collective_matmul.ag_matmul_fused,
           collective_matmul.matmul_rs_fused, lcsc.lcsc_ring_all_gather]
    return {f.__name__: f.launches for f in fns}
