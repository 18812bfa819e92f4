"""Gradient compression for the data-parallel all-reduce: int8
block-quantized gradients with error feedback — the twin of
``repro/optim/compress.py``.

The quantization lives in ``core/quant.py`` (the format the ring
collectives ship under ``wire="int8"``) and is re-exported here, so the two
paths cannot drift. Two layers:

* ``ErrorFeedbackInt8.transform(grads, state)`` — quantize→dequantize with
  the residual carried (``train.step.make_train_step``'s ``grad_transform``
  hook runs it on the accumulated gradient before the update);
* ``compressed_psum(x)`` — the compressed all-reduce itself over a stacked
  ``(R, ...)`` tensor: int8 payload plus one f32 scale a block, the scale
  shared (the ranks' max), the int8 values summed in int32 in rank order.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import (BLOCK, INV_QMAX, QMAX,  # noqa: F401
                                    SCALE_EPS, WIRE_FORMATS, EFState,
                                    ErrorFeedbackInt8,
                                    WireFormat, quant_dequant,
                                    wire_payload_bytes)

#: the wire format the compressed all-reduce ships — the ring collectives'
#: "int8" wire, so both paths price payloads off one descriptor.
COMPRESS_WIRE: WireFormat = WIRE_FORMATS["int8"]


def compressed_payload_bytes(n_elems: float) -> float:
    """On-wire bytes ``compressed_psum`` ships for ``n_elems`` gradient
    elements (int8 payload plus one f32 scale a block)."""
    return wire_payload_bytes(n_elems, COMPRESS_WIRE)


def compressed_psum(x: torch.Tensor) -> torch.Tensor:
    """int8 all-reduce with per-block scales of a stacked ``(R, ...)``
    tensor (dim 0 the ranks): each rank's flattened slab cut into blocks of
    ``COMPRESS_WIRE.block``, one scale a block shared by all ranks (their
    max), the int8 values summed in int32 in rank order, so the sum is
    exact in the quantized values. Returns ``(R, ...)`` in x's dtype, the
    same on every rank."""
    r = x.shape[0]
    flat = x.float().reshape(r, -1)
    n = flat.shape[1]
    pad = (-n) % COMPRESS_WIRE.block
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(
        r, -1, COMPRESS_WIRE.block)
    scale = fp.abs().amax(dim=2, keepdim=True) * INV_QMAX
    scale = scale.amax(dim=0).clamp_min(SCALE_EPS)          # shared scale
    q = torch.round(fp / scale).clamp(-QMAX, QMAX).to(torch.int8)
    total = q[0].to(torch.int32)
    for i in range(1, r):
        total = total + q[i].to(torch.int32)
    out = (total.float() * scale).reshape(-1)[:n]
    return out.reshape(x.shape[1:]).to(x.dtype).unsqueeze(0).expand_as(x)
