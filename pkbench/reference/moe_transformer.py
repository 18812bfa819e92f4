"""Plain float32 reference of a decoder of attention and routed-expert
layers (the Moonlight configuration as the port runs it).

Each layer: pre-norm multi-head attention with rotary positions and a
causal softmax, then a pre-norm layer of routed experts: a softmax router
in float32, the top-k experts a token (weights renormalized to sum to 1),
each expert a SwiGLU FFN. With a capacity factor, an expert takes at most
``ceil(T k / E * factor)`` of the ``T`` tokens routed together, keeping
those of largest weight (ties to the earlier token) and dropping the rest;
without one (the configuration's ``run_as.capacity_factor`` null, as
Moonlight is published) no token is dropped. Tokens are routed together
within a group: one data-parallel group of one microbatch in training. The loss is the mean
token cross-entropy plus ``aux_weight`` times the summed switch
load-balance loss of the layers, each layer's the mean over its groups.
Departures from the published model are listed in the configuration file.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pkbench.reference.common import cross_entropy, mm, rms_norm, rope


def dims(cfg: dict) -> dict:
    """The sizes this reference reads from a configuration file."""
    run = cfg["run_as"]
    return {
        "layers": cfg["num_hidden_layers"], "d": cfg["hidden_size"],
        "heads": cfg["num_attention_heads"],
        "kv_heads": cfg["num_key_value_heads"], "hd": run["head_dim"],
        "ff": cfg["moe_intermediate_size"], "experts": cfg["n_routed_experts"],
        "top_k": cfg["num_experts_per_tok"], "vocab": cfg["vocab_size"],
        "eps": cfg["rms_norm_eps"], "theta": float(cfg["rope_theta"]),
        "capacity_factor": run["capacity_factor"],
        "aux_weight": run["aux_loss_weight"]}


def param_specs(dm: dict) -> list[tuple[str, tuple, str, str]]:
    """(name, shape, init, dtype) of every weight, in the order the
    benchmark draws them. Layer weights are stacked over the layers; an
    expert weight is (layers, experts, in, out)."""
    L, d, h, kv, hd = dm["layers"], dm["d"], dm["heads"], dm["kv_heads"], \
        dm["hd"]
    e, f, v = dm["experts"], dm["ff"], dm["vocab"]
    return [
        ("embed", (v, d), "normal", "bf16"),
        ("lm_head", (d, v), "normal", "bf16"),
        ("final_norm", (d,), "ones", "bf16"),
        ("attn_norm", (L, d), "ones", "bf16"),
        ("wq", (L, d, h * hd), "normal", "bf16"),
        ("wk", (L, d, kv * hd), "normal", "bf16"),
        ("wv", (L, d, kv * hd), "normal", "bf16"),
        ("wo", (L, h * hd, d), "normal", "bf16"),
        ("moe_norm", (L, d), "ones", "bf16"),
        ("router", (L, d, e), "normal", "f32"),
        ("w1", (L, e, d, f), "normal", "bf16"),
        ("w3", (L, e, d, f), "normal", "bf16"),
        ("w2", (L, e, f, d), "normal", "bf16"),
    ]


def _topk_stable(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(x, router, w1, w3, w2, dm, prec="f32"):
    """x: (T, d) -> ((T, d), switch loss) for one routing group."""
    t = x.shape[0]
    e, k = dm["experts"], dm["top_k"]
    probs = torch.softmax(mm(x, router, prec), -1)
    top_vals, top_idx = _topk_stable(probs, k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = torch.zeros(t, e, dtype=x.dtype, device=x.device).scatter(
        1, top_idx, top_vals).t()                               # (E, T)
    cf = dm["capacity_factor"]
    cap = t if cf is None else min(max(1, math.ceil(t * k / e * cf)), t)
    sel_gate, sel_idx = _topk_stable(gates, cap)                # (E, C)
    sel_gate = sel_gate * (sel_gate > 0)
    xs = x[sel_idx]                                             # (E, C, d)
    hid = F.silu(mm(xs, w1, prec)) * mm(xs, w3, prec)
    out = mm(hid, w2, prec) * sel_gate[..., None]
    y = torch.zeros_like(x).index_add(0, sel_idx.reshape(-1),
                                      out.reshape(-1, x.shape[1]))
    frac = torch.zeros(e, device=x.device).index_add(
        0, top_idx.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
    return y, e * (frac * probs.mean(0)).sum()


def attention(x, p, li, dm, prec="f32"):
    b, s, _ = x.shape
    h, kv, hd = dm["heads"], dm["kv_heads"], dm["hd"]
    q = mm(x, p["wq"][li], prec).view(b, s, h, hd).transpose(1, 2)
    k = mm(x, p["wk"][li], prec).view(b, s, kv, hd).transpose(1, 2)
    v = mm(x, p["wv"][li], prec).view(b, s, kv, hd).transpose(1, 2)
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, dm["theta"]), rope(k, pos, dm["theta"])
    k = k.repeat_interleave(h // kv, 1)
    v = v.repeat_interleave(h // kv, 1)
    sc = mm(q, k.transpose(-1, -2), prec) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(sc, -1), v, prec).transpose(1, 2).reshape(b, s, -1)
    return mm(o, p["wo"][li], prec)


def hidden(p, tokens, dm, groups: int = 1, prec="f32"):
    """Final-normed hidden states (B, S, d) and the summed aux loss.
    ``groups`` splits the batch rows into contiguous routing groups."""
    x = p["embed"][tokens]
    b, s, d = x.shape
    aux = torch.zeros((), device=x.device)
    for li in range(dm["layers"]):
        x = x + attention(rms_norm(x, p["attn_norm"][li], dm["eps"]), p, li,
                          dm, prec)
        hn = rms_norm(x, p["moe_norm"][li], dm["eps"])
        ys, auxs = [], []
        for hg in hn.chunk(groups, 0):
            y, a = moe(hg.reshape(-1, d), p["router"][li], p["w1"][li],
                       p["w3"][li], p["w2"][li], dm, prec)
            ys.append(y.view(hg.shape))
            auxs.append(a)
        x = x + torch.cat(ys, 0)
        aux = aux + torch.stack(auxs).mean()
    return rms_norm(x, p["final_norm"], dm["eps"]), aux


def loss(p, batch, dm, groups: int = 1, prec="f32"):
    """The trained total: mean cross-entropy + aux_weight * aux."""
    x, aux = hidden(p, batch["tokens"], dm, groups, prec)
    logits = mm(x.reshape(-1, x.shape[-1]), p["lm_head"], prec)
    ce = cross_entropy(logits, batch["targets"].reshape(-1))
    return ce + dm["aux_weight"] * aux


def logits(p, tokens, dm, prec="f32", start: int = 0):
    """Logits (B, S - start, V) of the positions from ``start`` on, every
    token keeping its top-k experts (the published model is dropless)."""
    x, _ = hidden(p, tokens, dm | {"capacity_factor": None},
                  groups=tokens.shape[0], prec=prec)
    return mm(x[:, start:], p["lm_head"], prec)
