"""Plain float32 pieces the references share.

Imports torch alone: nothing of the port and nothing of JAX. Matrix
products run in float32 with TF32 off (set on import). ``Precision`` is
how a reference computes its products: ``"f32"`` is the reference;
``"fp8"`` is the benchmark's control, the same model with both operands of
every product rounded to float8 e4m3 under one scale a tensor (the
precision below bfloat16 that a faster port would be tempted by), the
gradient passed straight through.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0     # the largest finite float8 e4m3 value


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """a @ b in float32, or with both operands rounded to fp8."""
    if prec == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.matmul(a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, the halves of the head rotated together
    (GPT-NeoX order). x: (B, H, S, hd); positions: (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[:, None] * inv
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """Mean token cross-entropy of (T, V) logits."""
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.gather(-1, targets[:, None])[:, 0]).mean()
