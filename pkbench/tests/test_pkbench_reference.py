"""The reference against the port's plain CPU path at a tiny size.

Training: with float32 parameters the port's step and the reference agree
to round-off on the loss, every gradient and every weight's change; with
the configuration's bfloat16 parameters the losses and gradients agree to
bfloat16's precision, but the RMSNorm weights (1.0, where half an ulp is
3.9e-3) do not move at the cells' learning rate while the reference moves
them: the fault that keeps the training cells out of the benchmark.
Serving: the engine's served tokens are, nearly all, the reference's first
choices."""

import dataclasses
import time

import pkbench_tiny
import pytest

from pkbench.families import mamba as fam_mamba
from pkbench.families import moe_transformer as fam_moe
from pkbench.harness import weights
from pkbench.modes import serve, train

TRAIN = ["moonshot-train", "falcon-mamba-train"]


def _train(name, seconds=0.1):
    cell, cfg, mix = pkbench_tiny.cell(name)
    return train.run(cell, cfg, mix, pkbench_tiny.SEED, seconds, False,
                     "cpu", time.time())


@pytest.mark.parametrize("name", TRAIN)
def test_float32_port_trains_as_the_reference(name, monkeypatch):
    for fam in (fam_moe, fam_mamba):
        arch = fam.arch
        monkeypatch.setattr(fam, "arch", lambda c, d, a=arch:
                            dataclasses.replace(a(c, d), dtype="float32"))
    make = weights.make
    monkeypatch.setattr(weights, "make", lambda specs, *a, **k: make(
        [(n, s, i, "f32") for n, s, i, _ in specs], *a, **k))
    out = _train(name)
    c = out["compared"]
    assert c["loss_gap"] < 1e-5 and c["grad_gap"] < 1e-4
    assert c["change_gap"] < 1e-4
    assert c["nonfinite_window_losses"] == 0


@pytest.mark.parametrize("name", TRAIN)
def test_bfloat16_port_leaves_the_norms_unmoved(name):
    out = _train(name)
    c = out["compared"]
    assert c["loss_gap"] < 1e-2 and c["grad_gap"] < 2e-2
    p, r = out["program"]["change_norms"], out["reference"]["change_norms"]
    norms = [k for k in r if "norm" in k]
    assert norms and all(p[k] == 0.0 and r[k] > 0.0 for k in norms)


@pytest.mark.parametrize("name", ["moonshot-serve-longdoc",
                                  "falcon-mamba-serve-chat"])
def test_served_tokens_are_the_references(name):
    cell, cfg, mix = pkbench_tiny.cell(name)
    with pkbench_tiny.one_thread():
        out = serve.run(cell, cfg, mix, pkbench_tiny.SEED, 3.0, False, "cpu",
                        time.time())
    assert out["checked"]["tokens"] >= 1
    # nearly every served token is the reference's first choice; a routing
    # flip between bfloat16 and float32 moves a few (``checks`` module)
    assert out["compared"]["served_logit_gap_mean"] < 0.02
    assert out["failed"] == 0 and out["attempted"] > 0


def test_chunked_scan_is_the_recurrence():
    import torch
    from pkbench.reference import mamba
    g = torch.Generator().manual_seed(1)
    b, s, di, n = 2, 45, 8, 4
    dt = torch.nn.functional.softplus(torch.randn(b, s, di, generator=g))
    x = torch.randn(b, s, di, generator=g)
    bb, cc = torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                            generator=g)
    a = -torch.exp(torch.randn(di, n, generator=g))
    y = mamba.scan(dt, x, bb, cc, a)
    assert torch.allclose(mamba.scan_chunked(dt, x, bb, cc, a), y,
                          rtol=1e-5, atol=1e-5)
