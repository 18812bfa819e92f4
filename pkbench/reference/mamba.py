"""Plain float32 reference of an attention-free Mamba-1 decoder (the
Falcon-Mamba configuration as the port runs it).

Each layer: pre-norm, an input projection to the SSM branch and the gate,
a depthwise causal convolution and SiLU, the data-dependent projections to
dt (low rank, then softplus with a bias), B and C, the selective scan
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t h_t + D x_t``
from a zero state (one position after another under gradients; a chunk
of positions at a time for the long prompts of serving), the SiLU gate,
and the
output projection into the residual. The head is an untied projection.
Departures from the published model are listed in the configuration file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pkbench.reference.common import cross_entropy, mm, rms_norm


def dims(cfg: dict) -> dict:
    return {
        "layers": cfg["num_hidden_layers"], "d": cfg["hidden_size"],
        "di": cfg["intermediate_size"], "n": cfg["state_size"],
        "ck": cfg["conv_kernel"], "dtr": cfg["time_step_rank"],
        "vocab": cfg["vocab_size"], "eps": cfg["layer_norm_epsilon"]}


def param_specs(dm: dict) -> list[tuple[str, tuple, str, str]]:
    """(name, shape, init, dtype), in the order the benchmark draws them;
    layer weights stacked over the layers."""
    L, d, di, n, ck, r, v = (dm["layers"], dm["d"], dm["di"], dm["n"],
                             dm["ck"], dm["dtr"], dm["vocab"])
    return [
        ("embed", (v, d), "normal", "bf16"),
        ("lm_head", (d, v), "normal", "bf16"),
        ("final_norm", (d,), "ones", "bf16"),
        ("norm", (L, d), "ones", "bf16"),
        ("in_proj", (L, d, 2 * di), "normal", "bf16"),
        ("conv_w", (L, di, ck), "normal", "bf16"),
        ("conv_b", (L, di), "zeros", "bf16"),
        ("x_proj", (L, di, r + 2 * n), "normal", "bf16"),
        ("dt_proj", (L, r, di), "normal", "bf16"),
        ("dt_bias", (L, di), "dt_bias", "f32"),
        ("A_log", (L, di, n), "a_log", "f32"),
        ("D", (L, di), "ones", "f32"),
        ("out_proj", (L, di, d), "normal", "bf16"),
    ]


def scan(dt, x, b, c, a):
    """The selective scan from a zero state. dt, x: (B, S, di); b, c:
    (B, S, N); a: (di, N). Returns y (B, S, di) without the skip."""
    h = torch.zeros(dt.shape[0], dt.shape[2], a.shape[1], device=dt.device)
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * x[:, t, :, None]) \
            * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1)


def scan_chunked(dt, x, b, c, a, chunk: int = 8):
    """The same scan, ``chunk`` positions at a time: within a chunk
    ``h_t = exp(L_t) h_0 + sum_{s <= t} exp(L_t - L_s) dt_s x_s B_s`` with
    ``L`` the running sum of ``dt A`` (so every exponent is <= 0), one
    chunk's state carried into the next. Float32 as the recurrence, in
    another order; for long sequences without gradients (serving)."""
    h = torch.zeros(dt.shape[0], dt.shape[2], a.shape[1], device=dt.device)
    ys = []
    for s0 in range(0, dt.shape[1], chunk):
        dtc = dt[:, s0:s0 + chunk, :, None]                   # (B, L, di, 1)
        lg = torch.cumsum(dtc * a, 1)                          # (B, L, di, N)
        u = dtc * x[:, s0:s0 + chunk, :, None] * b[:, s0:s0 + chunk, None, :]
        n = lg.shape[1]
        later = torch.ones(n, n, dtype=torch.bool, device=dt.device).tril()
        diff = (lg[:, :, None] - lg[:, None, :]).masked_fill(
            ~later[None, :, :, None, None], float("-inf"))
        hs = torch.exp(lg) * h[:, None] + (torch.exp(diff) * u[:, None]).sum(2)
        ys.append((hs * c[:, s0:s0 + chunk, None, :]).sum(-1))
        h = hs[:, -1]
    return torch.cat(ys, 1)


def layer(x, w: dict, dm, prec="f32", scan_fn=scan):
    """One residual Mamba layer; ``w`` holds this layer's weights."""
    di, n, ck, r = dm["di"], dm["n"], dm["ck"], dm["dtr"]
    xz = mm(rms_norm(x, w["norm"], dm["eps"]), w["in_proj"], prec)
    xs, z = xz.split(di, -1)
    s = xs.shape[1]
    pad = F.pad(xs, (0, 0, ck - 1, 0))
    conv = sum(pad[:, i:i + s] * w["conv_w"][:, i] for i in range(ck))
    xc = F.silu(conv + w["conv_b"])
    dt, b, c = mm(xc, w["x_proj"], prec).split([r, n, n], -1)
    dt = F.softplus(mm(dt, w["dt_proj"], prec) + w["dt_bias"])
    y = scan_fn(dt, xc, b, c, -torch.exp(w["A_log"])) + xc * w["D"]
    return x + mm(y * F.silu(z), w["out_proj"], prec)


_LAYER_KEYS = ("norm", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
               "dt_bias", "A_log", "D", "out_proj")


def hidden(p, tokens, dm, prec="f32", remat: bool = False, scan_fn=scan):
    """Final-normed hidden states (B, S, d). ``remat`` recomputes each
    layer in the backward, so one layer's scan is live at a time."""
    x = p["embed"][tokens]
    for li in range(dm["layers"]):
        w = {k: p[k][li] for k in _LAYER_KEYS}
        if remat:
            x = checkpoint(layer, x, w, dm, prec, scan_fn,
                           use_reentrant=False)
        else:
            x = layer(x, w, dm, prec, scan_fn)
    return rms_norm(x, p["final_norm"], dm["eps"])


def loss(p, batch, dm, groups: int = 1, prec="f32"):
    """Mean token cross-entropy (``groups`` is the transformer's routing
    split; a Mamba layer has nothing routed)."""
    x = hidden(p, batch["tokens"], dm, prec, remat=True)
    logits = mm(x.reshape(-1, x.shape[-1]), p["lm_head"], prec)
    return cross_entropy(logits, batch["targets"].reshape(-1))


def logits(p, tokens, dm, prec="f32", start: int = 0):
    """Logits (B, S - start, V) of the positions from ``start`` on."""
    x = hidden(p, tokens, dm, prec, scan_fn=scan_chunked)
    return mm(x[:, start:], p["lm_head"], prec)
