"""The check fails what it should: each fault a cell can have, planted in
the port under a run driven as the benchmark drives it (the harness's
look for a GPU skipped, the port's plain CPU path at a tiny size), and the
control, the reference computed with fp8 products, read against the same
served tokens."""

import importlib
import time

import pkbench_tiny
import pytest
import torch

from pkbench.harness import checks, spec, weights
from pkbench.modes import serve, train
from pkbench.traffic import closed_loop

SERVE = ["moonshot-serve-longdoc", "falcon-mamba-serve-chat"]
# the serving cells of BENCHMARK.json
CELLS = [w["name"] for w in spec.benchmark()["workloads"]
         if spec.load("workloads", w["name"])["mode"] == "serve"]


def _serve(name, seconds=3.0):
    cell, cfg, mix = pkbench_tiny.cell(name)
    with pkbench_tiny.one_thread():
        out = serve.run(cell, cfg, mix, pkbench_tiny.SEED, seconds, False,
                        "cpu", time.time())
    return cell, cfg, out, checks.judge(out["compared"], cell["limits"])[0]


@pytest.mark.parametrize("name", SERVE)
def test_sound_run_is_correct(name):
    assert _serve(name)[3]


@pytest.mark.parametrize("name", SERVE)
def test_altered_token_is_not_correct(name, monkeypatch):
    from repro_torch.runtime.serving import ServingEngine
    read = ServingEngine._read_rows

    def altered(self, logits):
        tok, ok = read(self, logits)
        return (tok + 1) % self.cfg.vocab_size, ok

    monkeypatch.setattr(ServingEngine, "_read_rows", altered)
    assert not _serve(name)[3]


@pytest.mark.parametrize("name", SERVE)
def test_one_slot_altered_is_not_correct(name, monkeypatch):
    """A sparse fault: one decode slot of eight serves a wrong token."""
    from repro_torch.runtime.serving import ServingEngine
    read = ServingEngine._read_rows

    def altered(self, logits):
        tok, ok = read(self, logits)
        if logits.shape[0] == self.serve.max_batch:
            tok = tok.copy()
            tok[0] = (tok[0] + 1) % self.cfg.vocab_size
        return tok, ok

    monkeypatch.setattr(ServingEngine, "_read_rows", altered)
    assert not _serve(name)[3]


@pytest.mark.parametrize("name", SERVE)
def test_exchange_left_out_is_not_correct(name, monkeypatch):
    """Every sum over the model axis returns each rank's own part."""
    from repro_torch.core.comms import CommContext
    monkeypatch.setattr(CommContext, "psum",
                        lambda self, x, **kw: x)
    assert not _serve(name)[3]


def _greedy_requests(name):
    """Four prompts of the cell's mix, each with 24 tokens that are the
    float32 reference's own first choices."""
    cell, cfg, mix = pkbench_tiny.cell(name)
    ref = importlib.import_module(f"pkbench.reference.{cfg['family']}")
    dm = ref.dims(cfg)
    p = weights.as_f32(weights.make(ref.param_specs(dm), pkbench_tiny.SEED,
                                    dm["d"], "cpu"))
    gen = closed_loop.ClosedLoop(mix, dm["vocab"], pkbench_tiny.SEED)
    prompts, tokens = {}, {}
    with torch.no_grad():
        for r in range(4):
            seq = list(gen.next(r)[0])
            prompts[r] = list(seq)
            for _ in range(24):
                lg = ref.logits(p, torch.tensor([seq]), dm)[0, -1]
                seq.append(int(lg[:dm["vocab"]].argmax()))
            tokens[r] = seq[len(prompts[r]):]
    return cell, cfg, prompts, tokens


@pytest.mark.parametrize("name", SERVE)
def test_control_moves_the_first_choice(name):
    """Tokens that are the reference's own first choices read a gap of
    (almost) nothing; the fp8 control, read on the same positions, moves
    some first choices (its separation at the cells' sizes is measured
    on the card: PERF.md)."""
    cell, cfg, prompts, tokens = _greedy_requests(name)
    args = (cfg, cell["check"], pkbench_tiny.SEED, "cpu", prompts, tokens)
    own = serve.reference_gaps(*args)
    ctrl = serve.reference_gaps(*args, pick="fp8")
    assert len(own) == len(ctrl) == 96
    assert max(own) < 1e-4
    assert sum(ctrl) > 0.0 and sum(ctrl) > 10 * sum(own)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_judged_not_correct(name):
    """The control goes through the cell's own limits, as a run's program
    does, and comes out not correct; the reference's own tokens pass."""
    from pkbench import control
    cell, cfg, prompts, tokens = _greedy_requests(name)
    ok, judged, _ = control.judge_control(cell, cfg, pkbench_tiny.SEED,
                                          "cpu", prompts, tokens)
    assert not ok and set(judged) == set(cell["limits"])
    own = serve.reference_gaps(cfg, cell["check"], pkbench_tiny.SEED, "cpu",
                               prompts, tokens)
    assert checks.judge(serve.compared(own), cell["limits"])[0]


def _train(name, seconds=0.1):
    cell, cfg, mix = pkbench_tiny.cell(name)
    return train.run(cell, cfg, mix, pkbench_tiny.SEED, seconds, False,
                     "cpu", time.time())["compared"]


@pytest.mark.parametrize("name", ["moonshot-train", "falcon-mamba-train"])
def test_training_faults_read_far_above_a_sound_run(name, monkeypatch):
    sound = _train(name)
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.train import step as TS
    make = TS.make_train_step

    with monkeypatch.context() as m:
        # the update hands back its state as it found it
        m.setattr(AdamW, "update", lambda self, g, st, p: (
            p, AdamWState(st.step + 1, st.m, st.v), self.global_norm(g)))
        still = _train(name)
    assert still["change_gap"] == pytest.approx(1.0)
    assert still["grad_gap"] == pytest.approx(1.0)

    def half(*a, **k):
        fn = make(*a, **k)

        def step(state, batch):
            b = batch["tokens"].shape[0] // 2
            return fn(state, {k: torch.cat([v[:b], v[:b]])
                              for k, v in batch.items()})
        return step

    monkeypatch.setattr(TS, "make_train_step", half)
    halved = _train(name)
    assert halved["loss_gap"] > 10 * sound["loss_gap"]
    assert halved["grad_gap"] > 10 * sound["grad_gap"]
