"""Low-precision wire formats: per-block int8 quantization with f32 scales —
the twin of ``repro/core/quant.py``.

One quantization implementation for both wire paths of the port:

* the ring GEMM-collectives (``core/comms.py`` ``wire="int8"``): each
  travelling shard or accumulator is quantized per row into int8 blocks
  with f32 scales, travels as an (int8 payload, f32 scales) pair and is
  dequantized and accumulated in f32 on arrival;
* the gradient compressor (``optim/compress.py``), which re-exports
  ``quant_dequant`` / ``ErrorFeedbackInt8`` from here.

Block layout: blocks are cut along the LAST axis (per row), the last axis
zero-padded to a block multiple. Row chunks leave every scale group intact,
so quantized values are the same whatever rows a chunk holds.

Quantize and dequantize are plain PyTorch on every device, as they are XLA
in JAX: no Pallas kernel quantizes. Stochastic rounding draws its noise from
an explicit ``torch.Generator`` where JAX takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

#: default quantization block (elements sharing one f32 scale).
BLOCK = 256

#: int8 symmetric range.
QMAX = 127.0

#: scale floor — keeps all-zero blocks from dividing by zero.
SCALE_EPS = 1e-12

#: scales are block maxima times this (f32) reciprocal of QMAX: XLA folds
#: JAX's division by the constant into that multiply in every compiled
#: program (eager JAX divides, and differs in the last bit of some scales)
INV_QMAX = 1.0 / QMAX


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """The on-wire element format of a transfer schedule: ``dtype_bytes``
    is the payload element width the cost model prices, ``block`` the
    per-row quantization block (elements a f32 scale), and
    ``stochastic_round`` selects unbiased stochastic rounding instead of
    round-to-nearest."""

    name: str
    dtype_bytes: int
    block: int = BLOCK
    stochastic_round: bool = False

    @property
    def quantized(self) -> bool:
        return self.dtype_bytes < 2

    @property
    def bytes_per_element(self) -> float:
        """Wire bytes a payload element, scales included: 1 + 4/256 =
        1.015625 B at the default block."""
        if not self.quantized:
            return float(self.dtype_bytes)
        return self.dtype_bytes + 4.0 / self.block


#: the formats ``resolve_wire`` accepts by name: "bf16" ships the payload in
#: its own dtype, "int8" is round-to-nearest block quantization, "int8_sr"
#: adds stochastic rounding.
WIRE_FORMATS: dict[str, WireFormat] = {
    "bf16": WireFormat("bf16", dtype_bytes=2),
    "int8": WireFormat("int8", dtype_bytes=1),
    "int8_sr": WireFormat("int8_sr", dtype_bytes=1, stochastic_round=True),
}


def resolve_wire(wire: Any) -> WireFormat | None:
    """None, a registry name or a ``WireFormat`` -> the quantized format,
    or None for a full-precision wire ("bf16" included)."""
    if wire is None:
        return None
    if isinstance(wire, WireFormat):
        return wire if wire.quantized else None
    if isinstance(wire, str):
        try:
            fmt = WIRE_FORMATS[wire]
        except KeyError:
            raise ValueError(
                f"unknown wire format {wire!r}; expected one of "
                f"{sorted(WIRE_FORMATS)}") from None
        return fmt if fmt.quantized else None
    raise TypeError(f"wire must be None, a name, or a WireFormat; "
                    f"got {type(wire).__name__}")


def wire_dtype_bytes(wire: Any, dtype_bytes: int = 2) -> int:
    """Element width a transfer keyed on ``wire`` ships (the tensor's own
    ``dtype_bytes`` for a full-precision wire)."""
    fmt = resolve_wire(wire)
    return fmt.dtype_bytes if fmt is not None else int(dtype_bytes)


def wire_payload_bytes(n_elems: float, wire: Any,
                       dtype_bytes: int = 2) -> float:
    """On-wire bytes of ``n_elems`` payload elements, scales included."""
    fmt = resolve_wire(wire)
    if fmt is None:
        return float(n_elems) * float(dtype_bytes)
    return float(n_elems) * fmt.bytes_per_element


# ---------------------------------------------------------------------------
# Per-block quantize / dequantize
# ---------------------------------------------------------------------------

def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """x zero-padded along its last axis and reshaped to (..., nb, block)."""
    pad = (-x.shape[-1]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, block)


def quantize_blocks(x: torch.Tensor, *, block: int = BLOCK,
                    generator: torch.Generator | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to int8 in blocks along the last axis: ``(q, scales)``,
    q int8 of shape ``(*x.shape[:-1], nb, block)`` and scales f32 of shape
    ``(*x.shape[:-1], nb, 1)``, nb = ceil(x.shape[-1] / block). Padding
    quantizes to 0 and ``dequantize_blocks`` drops it. With ``generator``
    the round is stochastic, ``floor(v + u)`` with u ~ U[0, 1) drawn from
    it (on x's device)."""
    fp = _blocked(x.float(), block)
    scales = fp.abs().amax(dim=-1, keepdim=True) * INV_QMAX
    scales = scales.clamp_min(SCALE_EPS)
    v = fp / scales
    if generator is not None:
        v = torch.floor(v + torch.rand(fp.shape, generator=generator,
                                       device=fp.device))
    else:
        v = torch.round(v)
    return v.clamp(-QMAX, QMAX).to(torch.int8), scales


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      cols: int) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: f32 of shape
    ``(*q.shape[:-2], cols)``."""
    full = q.float() * scales
    return full.reshape(*q.shape[:-2], -1)[..., :cols]


def dequantize_add(q: torch.Tensor, scales: torch.Tensor, cols: int,
                   addend: torch.Tensor) -> torch.Tensor:
    """``dequantize_blocks(q, scales, cols) + addend`` rounded once to f32,
    as one fused multiply-add: XLA contracts JAX's dequantize-accumulate
    into an FMA. The product of an int8 and an f32 scale is exact in f64,
    so the f64 sum rounded to f32 is the FMA's result."""
    full = (q.double() * scales.double()).reshape(*q.shape[:-2], -1)
    return (full[..., :cols] + addend.double()).float()


def quant_dequant(x: torch.Tensor, *, block: int = BLOCK,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Round-trip ``x`` through per-block int8 over its flattened elements
    (blocks span rows: right for gradients, whose shape is incidental).
    Returns f32 of x's shape."""
    flat = x.float().reshape(1, -1)
    q, scales = quantize_blocks(flat, block=block, generator=generator)
    return dequantize_blocks(q, scales, flat.shape[-1]).reshape(x.shape)


# ---------------------------------------------------------------------------
# Error feedback
# ---------------------------------------------------------------------------

def tree_map(fn, *trees, is_leaf=None):
    """``fn`` over the leaves of parallel trees of dicts, lists and tuples
    (``is_leaf`` stops the descent early)."""
    t0 = trees[0]
    if is_leaf is not None and is_leaf(t0):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in t0}
    if isinstance(t0, (list, tuple)) and not hasattr(t0, "_fields"):
        return type(t0)(tree_map(fn, *xs, is_leaf=is_leaf)
                        for xs in zip(*trees))
    return fn(*trees)


def _is_pair(t) -> bool:
    return (isinstance(t, tuple) and len(t) == 2
            and all(isinstance(x, torch.Tensor) for x in t))


class EFState(NamedTuple):
    """Error-feedback residual (one f32 leaf a gradient)."""

    residual: Any


class ErrorFeedbackInt8:
    """EF-SGD compressor: add the residual, quantize, carry the new
    residual. The quantization error is fed back instead of dropped, so the
    accumulated compressed gradient tracks the true sum to one quantum.
    ``transform`` is a pure function of (grads, state): the caller threads
    the state from step to step."""

    def __init__(self, *, block: int = BLOCK):
        self.block = block

    def init(self, params: Any) -> EFState:
        return EFState(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def _compress(self, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(quant_dequant(c), c - it): the residual rounded once, as XLA's
        FMA contraction of JAX's subtraction rounds it."""
        flat = c.reshape(1, -1)
        q, sc = quantize_blocks(flat, block=self.block)
        n = flat.shape[-1]
        return (dequantize_blocks(q, sc, n).reshape(c.shape),
                dequantize_add(-q, sc, n, flat).reshape(c.shape))

    def transform(self, grads: Any, state: EFState) -> tuple[Any, EFState]:
        out = tree_map(lambda g, r: self._compress(g.float() + r), grads,
                        state.residual)
        return (tree_map(lambda o: o[0], out, is_leaf=_is_pair),
                EFState(residual=tree_map(lambda o: o[1], out,
                                           is_leaf=_is_pair)))
