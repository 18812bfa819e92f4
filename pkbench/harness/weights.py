"""Weights and seeds made by the benchmark.

Every weight is drawn from ``--seed`` on the device by one
``torch.Generator``, in a few large calls: the normal weights of one dtype
are views of one flat buffer filled 2**28 values at a time. The list of
weights, their shapes and their initializers is the reference's
(``param_specs``), so the program and the reference get the same values:
normal ~ N(0, 1/d), ``a_log`` = log(1..N) along the state, ``dt_bias`` the
inverse softplus of U[1e-3, 1e-1], ``ones`` and ``zeros``.
"""

from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CHUNK = 1 << 28


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, batches, traffic) of a run."""
    h = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def make(specs, seed: int, d_model: int, device) -> dict:
    """name -> tensor for (name, shape, init, dtype) ``specs``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    scale = d_model ** -0.5
    out: dict = {}
    for dt in ("bf16", "f32"):
        normal = [(n, s) for n, s, i, t in specs
                  if i == "normal" and t == dt]
        total = sum(math.prod(s) for _, s in normal)
        if not total:
            continue
        flat = torch.empty(total, dtype=DTYPES[dt], device=device)
        for i in range(0, total, CHUNK):
            part = flat[i:i + CHUNK]
            part.copy_(torch.randn(part.shape, generator=gen, device=device)
                       .mul_(scale))
        off = 0
        for n, s in normal:
            k = math.prod(s)
            out[n] = flat[off:off + k].view(s)
            off += k
    for n, s, init, dt in specs:
        if init == "normal":
            continue
        if init in ("ones", "zeros"):
            x = (torch.ones if init == "ones" else torch.zeros)(
                s, dtype=DTYPES[dt], device=device)
        elif init == "a_log":
            x = torch.log(torch.arange(1, s[-1] + 1, dtype=torch.float32,
                                       device=device)).expand(s) \
                .to(DTYPES[dt]).contiguous()
        elif init == "dt_bias":
            u = torch.rand(s, generator=gen, device=device) \
                * (1e-1 - 1e-3) + 1e-3
            x = (u + torch.log(-torch.expm1(-u))).to(DTYPES[dt])
        else:
            raise ValueError(f"unknown init {init!r}")
        out[n] = x
    return out


def as_f32(weights: dict) -> dict:
    """A float32 copy of each weight, freeing the originals as it goes."""
    out = {}
    for k in list(weights):
        out[k] = weights.pop(k).float().clone()
    return out
