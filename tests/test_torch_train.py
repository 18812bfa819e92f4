"""The port's training path against the JAX package, in float32 on the CPU.

The reduced tinyllama (2 layers, d = 64, 4 heads of 16, 2 KV heads, vocab
256) is initialised by the JAX package and converted with
``convert.params_from_jax``. Both packages get one numpy batch.

* ``forward_train`` loss and every parameter gradient, with no mesh and on
  (1, 4), (2, 2) and (2, 4) virtual meshes with FSDP on (as the JAX
  launcher sets it), ``pk_overlap`` on and off, and with the fused
  (ring-kernel) and bulk gather backends: atol 1e-5 on the loss and the
  gradients (largest |g| about 0.3; the sums differ only in order). On
  meshes with a data axis larger than 1 the batch's dp halves (in each
  microbatch) carry the same tokens: the JAX embedding island under FSDP
  all-gathers looked-up activations and so mixes the dp ranks' batches
  (ROADMAP C4), which equal halves hide. With distinct halves the port is held against the JAX
  function with no mesh instead.
* one ``make_train_step`` (AdamW, clipping, warmup-cosine) with 1 and 2
  microbatches: loss and grad norm rtol 1e-5; the updated parameters
  within atol 2·lr + 1e-6 — at step 1 AdamW moves each entry by about
  lr·sign(g), so an entry whose tiny gradient rounds to the other sign in
  the other framework moves by 2·lr the other way — and at least 99.9% of
  the entries within 1e-6.
* ``build_and_train`` as JAX's ``test_system.py`` runs it, and a crash at
  step 7 resumed from the checkpoint equals the clean run.
* int8 gradient compression with error feedback: 2 steps of
  ``make_train_step`` with ``ErrorFeedbackInt8.transform`` on (2, 2) with
  FSDP against JAX's ``make_train_step`` with the same transform, its
  residual carried out of and back into the compiled step: loss rtol 1e-5,
  the updated parameters within 1e-4 (at step 1 AdamW moves each entry by
  about lr·sign(g), and the quantized gradients agree but at rounding
  ties), the residuals within 1e-6 but at those ties (at most 0.1% of the
  entries, each off by one quantum: twice the residual's largest
  magnitude); ``build_and_train(compress_grads=True)``
  learns, as JAX's ``test_end_to_end_train_compressed_grads``, with a
  nonzero residual; JAX's launcher pattern, whose compiled step reads the
  residual once as a constant, repeats its output (ROADMAP C14), the
  port's does not.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import warmup_cosine as jax_wc  # noqa: E402
from repro.optim.compress import ErrorFeedbackInt8 as JaxEF  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.optim.adamw import AdamW, warmup_cosine  # noqa: E402
from repro_torch.optim.compress import ErrorFeedbackInt8  # noqa: E402
from repro_torch.train.step import TrainState, make_train_step  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
B, S = 4, 32


def _cfgs():
    return (dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                dtype="float32"))


def _batch(seed=0, equal_halves=False, microbatches=1):
    """A numpy batch; ``equal_halves``: in every microbatch the second dp
    half's tokens and targets repeat the first's (the weights differ)."""
    rng = np.random.default_rng(seed)
    v = 256
    tok = rng.integers(0, v, (B, S)).astype(np.int32)
    tgt = rng.integers(0, v, (B, S)).astype(np.int32)
    if equal_halves:
        for a in (tok, tgt):
            mb = a.reshape(microbatches, 2, B // microbatches // 2, S)
            mb[:, 1] = mb[:, 0]
    w = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": tok, "targets": tgt, "weights": w}


def _both(mesh_shape, **run_kw):
    """(jax side, port side) dicts: cfg, run, rules, params — FSDP on
    whenever there is a mesh, as both launchers set it."""
    jcfg, tcfg = _cfgs()
    backend = run_kw.pop("comm_backend", None)
    kw = dict(fsdp=mesh_shape is not None, **run_kw)
    jrun, trun = JaxRun(**kw), RunConfig(comm_backend=backend, **kw)
    jmesh = (compat.make_mesh(mesh_shape, ("data", "model"))
             if mesh_shape else None)
    jrules = JaxRules(jmesh, jrun) if jmesh is not None else None
    trules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")), trun)
              if mesh_shape else None)
    jtmpl = JT.param_template(jcfg, jrun, jrules)
    jparams = JT.init_params(jtmpl, jax.random.PRNGKey(0), jcfg.d_model)
    if jrules is not None:
        jparams = jax.tree.map(jax.device_put, jparams,
                               JSP.named(jmesh, JT.param_specs(jtmpl)))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, trun, trules)
    return (dict(cfg=jcfg, run=jrun, rules=jrules, params=jparams),
            dict(cfg=tcfg, run=trun, rules=trules, params=tparams))


def _jax_loss_grads(j, batch):
    f = jax.jit(jax.value_and_grad(lambda p, bt: JT.forward_train(
        p, bt, j["cfg"], j["run"], j["rules"])[0]))
    loss, grads = f(j["params"], {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    return float(loss), grads


def _port_loss_grads(t, batch):
    for _, leaf in T.leaves(t["params"]):
        leaf.requires_grad_(True)
    loss, _ = T.forward_train(
        t["params"], {k: torch.from_numpy(v) for k, v in batch.items()},
        t["cfg"], t["run"], t["rules"])
    loss.backward()
    grads: dict = {}
    for path, leaf in T.leaves(t["params"]):
        T.set_path(grads, path, leaf.grad)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    return float(loss.detach()), convert.tree_to_numpy(grads, tmpl,
                                                     t["rules"])


def _assert_grads(got, want, atol=ATOL):
    n = 0
    for path, g in T.leaves(got):
        w = want
        for k in path:
            w = w[k]
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg="/".join(path))
        n += 1
    assert n >= 10


@pytest.fixture(scope="module")
def single_device_reference():
    """JAX loss and grads with no mesh on a batch with distinct dp halves."""
    j, _ = _both(None)
    return _jax_loss_grads(j, _batch(seed=1))


@pytest.mark.parametrize("mesh_shape,pk,backend", [
    (None, True, None), (None, False, None),
    ((1, 4), True, "fused"), ((1, 4), False, None),
    ((2, 2), True, "fused"), ((2, 2), False, "bulk"),
    ((2, 4), True, "fused"), ((2, 4), False, None)])
def test_forward_train_matches_jax(mesh_shape, pk, backend):
    j, t = _both(mesh_shape, pk_overlap=pk, comm_backend=backend)
    batch = _batch(equal_halves=True)
    jl, jg = _jax_loss_grads(j, batch)
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL, (tl, jl)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_fsdp_forward_train_matches_single_device(mesh_shape,
                                                  single_device_reference):
    jl, jg = single_device_reference
    _, t = _both(mesh_shape, comm_backend="fused")
    tl, tg = _port_loss_grads(t, _batch(seed=1))
    assert abs(tl - jl) <= ATOL, (tl, jl)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("run_kw", [
    dict(remat=False), dict(save_collectives=True),
    dict(bf16_backward_ars=True), dict(pk_attn_out_island=True),
    dict(reference_mode=True)], ids=lambda kw: next(iter(kw)))
def test_forward_train_run_options_match_jax(run_kw):
    j, t = _both((2, 2), comm_backend="fused", **run_kw)
    batch = _batch(equal_halves=True)
    jl, jg = _jax_loss_grads(j, batch)
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL, (tl, jl)
    # bf16_backward_ars rounds every residual cotangent to bf16 in both
    # frameworks; the rounding points agree, sums before them differ by
    # ~1e-7, which can tip a bf16 rounding: 2^-8 relative of |g| <= 0.3
    _assert_grads(tg, jg, atol=2e-3 if "bf16_backward_ars" in run_kw
                  else ATOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    lr = 1e-3
    j, t = _both((2, 2), comm_backend="fused", microbatches=microbatches)
    batch = _batch(equal_halves=True, microbatches=microbatches)
    jopt = JaxAdamW(lr=jax_wc(lr, 2, 10), weight_decay=0.01)
    jstate = JS.TrainState(j["params"], jopt.init(j["params"]))
    jstate, jm = jax.jit(JS.make_train_step(j["cfg"], j["run"], j["rules"],
                                            jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    topt = AdamW(lr=warmup_cosine(lr, 2, 10), weight_decay=0.01)
    tstate = TrainState(t["params"], topt.init(t["params"]))
    step = make_train_step(t["cfg"], t["run"], t["rules"], topt)
    tstate, tm = step(tstate, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert tm["step"] == int(jm["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    got = convert.tree_to_numpy(tstate.params, tmpl, t["rules"])
    close = total = 0
    for path, p in T.leaves(got):
        want = jstate.params
        for k in path:
            want = want[k]
        diff = np.abs(p - np.asarray(want))
        assert diff.max() <= 2 * lr + 1e-6, "/".join(path)
        close += int((diff <= 1e-6).sum())
        total += diff.size
    assert close >= 0.999 * total, (close, total)


def test_compressed_train_steps_match_jax():
    """Two steps with int8 error-feedback compression. JAX's hook is
    ``grads -> grads``; the residual is carried the way that works under
    ``jax.jit``: an input of the compiled step and one of its outputs."""
    lr = 1e-3
    j, t = _both((2, 2), comm_backend="fused")
    jopt = JaxAdamW(lr=jax_wc(lr, 2, 10), weight_decay=0.01)
    jef = JaxEF()

    def jstep(state, batch, residual):
        out = {}

        def transform(grads):
            g, out["ef"] = jef.transform(grads, residual)
            return g
        state, m = JS.make_train_step(j["cfg"], j["run"], j["rules"], jopt,
                                      grad_transform=transform)(state, batch)
        return state, m, out["ef"]

    jstep = jax.jit(jstep)
    jstate = JS.TrainState(j["params"], jopt.init(j["params"]))
    jres = jef.init(j["params"])
    topt = AdamW(lr=warmup_cosine(lr, 2, 10), weight_decay=0.01)
    tef = ErrorFeedbackInt8()
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    tstate = TrainState(t["params"], topt.init(t["params"]),
                        tef.init(T.zeros(tmpl, None, "cpu")))
    step = make_train_step(t["cfg"], t["run"], t["rules"], topt,
                           grad_transform=tef.transform)
    ties = total = 0
    for i in range(2):
        batch = _batch(seed=20 + i, equal_halves=True)
        jstate, jm, jres = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, jres)
        tstate, tm = step(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        got = convert.tree_to_numpy(tstate.params, tmpl, t["rules"])
        for path, p in T.leaves(got):
            want = jstate.params
            res = jres.residual
            for k in path:
                want, res = want[k], res[k]
            np.testing.assert_allclose(p, np.asarray(want), atol=1e-4,
                                       rtol=0, err_msg=f"{i}: {path}")
            r = tstate.grad_state.residual
            for k in path:
                r = r[k]
            assert r.shape == np.shape(res)          # the global layout
            diff = np.abs(r.numpy() - np.asarray(res))
            assert diff.max() <= 2 * np.abs(np.asarray(res)).max() + 1e-6
            ties += int((diff > 1e-6).sum())
            total += diff.size
    assert ties <= 1e-3 * total, (ties, total)
    assert any(float(r.abs().max()) > 0
               for _, r in T.leaves(tstate.grad_state.residual))


def test_jax_jitted_compress_grads_drops_error_feedback():
    """ROADMAP C14: JAX's launcher keeps the error-feedback state in a dict
    that the jitted function reads and writes. The trace reads the residual
    once, as a constant (zeros), so every call compresses the same gradient
    to the same output and the dict is left holding a tracer; the port's
    transform, with its state threaded, carries the residual and does
    not repeat."""
    g = {"w": _batch()["weights"][:, :7] * 0.01 + 1e-4}
    jef = JaxEF()
    ef_state = {"s": jef.init(jax.tree.map(jnp.asarray, g))}

    @jax.jit
    def jtransform(grads):
        out, ef_state["s"] = jef.transform(grads, ef_state["s"])
        return out

    jg = jax.tree.map(jnp.asarray, g)
    outs = [np.asarray(jtransform(jg)["w"]) for _ in range(3)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    assert isinstance(ef_state["s"].residual["w"], jax.core.Tracer)
    tef = ErrorFeedbackInt8()
    state = tef.init({"w": torch.from_numpy(g["w"])})
    touts = []
    for _ in range(3):
        out, state = tef.transform({"w": torch.from_numpy(g["w"])}, state)
        touts.append(out["w"].numpy())
    np.testing.assert_array_equal(touts[0], outs[0])  # step 1 agrees
    assert not np.array_equal(touts[0], touts[1])
    assert not np.array_equal(touts[1], touts[2])
    # what error feedback is for: the sum of the outputs tracks the sum of
    # the gradients to one quantum; the repeated output does not
    true = 3 * g["w"]
    quantum = np.abs(g["w"]).max() / 127
    assert np.abs(sum(touts) - true).max() <= 2 * quantum
    assert np.abs(sum(touts) - true).max() < np.abs(3 * outs[0] - true).max()


def test_build_and_train_compressed_grads(tmp_path):
    """The twin of JAX's ``test_end_to_end_train_compressed_grads``: int8 +
    error feedback still learns; the residual is nonzero after step 1 and
    survives a checkpoint round trip."""
    state, log = launch.build_and_train(
        "tinyllama-1.1b", steps=20, reduced=True, mesh_shape=None, batch=4,
        seq=32, ckpt_dir=str(tmp_path), lr=5e-3, compress_grads=True,
        log_every=1, ckpt_every=100, device="cpu")
    first = np.mean([m["loss"] for m in log[:3]])
    last = np.mean([m["loss"] for m in log[-3:]])
    assert last < first, "int8+EF compressed training must still learn"
    res = state.grad_state.residual
    assert all(r.dtype == torch.float32 for _, r in T.leaves(res))
    assert sum(float(r.abs().sum()) for _, r in T.leaves(res)) > 0
    restored, _ = CheckpointManager(tmp_path).restore(state)
    for (_, a), (_, b) in zip(T.leaves(restored.grad_state.residual),
                              T.leaves(res)):
        assert torch.equal(a, b)
    _, log1 = launch.build_and_train(
        "tinyllama-1.1b", steps=1, reduced=True, mesh_shape=(2, 2), batch=4,
        seq=16, ckpt_dir=str(tmp_path / "mesh"), compress_grads=True,
        comm_wire="int8", log_every=1, device="cpu")
    assert np.isfinite(log1[-1]["loss"])


def test_build_and_train_on_mesh(tmp_path):
    """The twin of JAX ``test_end_to_end_train_on_mesh``."""
    state, log = launch.build_and_train(
        "tinyllama-1.1b", steps=12, reduced=True, mesh_shape=(2, 4),
        mesh_axes=("data", "model"), batch=4, seq=32,
        ckpt_dir=str(tmp_path), lr=3e-3, microbatches=2, log_every=1,
        ckpt_every=6, comm_backend="fused", device="cpu")
    assert [m["step"] for m in log] == list(range(1, 13))
    assert all(np.isfinite(m["loss"]) for m in log)
    assert CheckpointManager(tmp_path).latest_step() == 12
    assert state.opt.step == 12


def test_crash_resume_equivalence(tmp_path):
    """A crash at step 7 and a restart from the step-6 checkpoint end
    where the uninterrupted run ends (JAX ``test_ckpt_ft.py``)."""

    class Crash(Exception):
        pass

    def hook(step):
        if step == 7:
            raise Crash()

    kw = dict(steps=12, reduced=True, mesh_shape=(2, 2), batch=2, seq=16,
              lr=1e-3, log_every=1, ckpt_every=3, device="cpu")
    with pytest.raises(Crash):
        launch.build_and_train("tinyllama-1.1b",
                               ckpt_dir=str(tmp_path / "crash"),
                               fault_hook=hook, **kw)
    assert CheckpointManager(tmp_path / "crash").latest_step() == 6
    _, resumed = launch.build_and_train(
        "tinyllama-1.1b", ckpt_dir=str(tmp_path / "crash"), **kw)
    _, clean = launch.build_and_train(
        "tinyllama-1.1b", ckpt_dir=str(tmp_path / "clean"), **kw)
    assert resumed[-1]["step"] == clean[-1]["step"] == 12
    np.testing.assert_allclose(resumed[-1]["loss"], clean[-1]["loss"],
                               rtol=1e-4)


def test_checkpoint_roundtrip_keep_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    state = TrainState({"a": torch.randn(3, 4).to(torch.bfloat16)},
                       AdamW().init({"a": torch.zeros(3, 4)}))
    for s in (1, 2, 3):
        mgr.save(s, state, {"note": s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert not list(tmp_path.glob("tmp_*"))
    restored, extra = mgr.restore(state)
    assert extra == {"step": 3, "note": 3}
    assert isinstance(restored, TrainState) and restored.opt.step == 0
    assert restored.params["a"].dtype == torch.bfloat16
    assert torch.equal(restored.params["a"], state.params["a"])


def test_checkpoint_restore_keeps_padded_rows(tmp_path):
    """A leaf stored in rows padded to 16 bytes (the head of a ragged vocab
    shard) comes back from a checkpoint in padded rows, not contiguous."""
    from repro_torch.core import pgl
    head = pgl.aligned_rows(torch.randn(2, 3, 13).to(torch.bfloat16))
    assert pgl.padded_rows(head) and head.stride(-2) == 16
    state = TrainState({"h": head}, AdamW().init({"h": head}))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, state)
    restored, _ = mgr.restore(state)
    got = restored.params["h"]
    assert got.stride() == head.stride() and torch.equal(got, head)
    assert restored.opt.m["h"].is_contiguous()


def test_data_pipeline_rule_and_determinism():
    data = SyntheticLM(DataConfig(vocab_size=97, seq_len=64,
                                  global_batch=8, seed=3, noise=0.0))
    a, b = data.batch(5), data.batch(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], data.batch(6)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    stride = (a["targets"] - a["tokens"]) % 97          # one rule per row
    assert bool((stride == stride[:, :1]).all())
    assert bool(((stride >= 1) & (stride <= 8)).all())


def test_grad_norm_counts_each_leaf_once():
    """The (2, 4)-mesh grads are stored tp-stacked once: their global norm
    equals the no-mesh one."""
    batch = _batch(equal_halves=True)
    norms = []
    for mesh_shape in (None, (2, 4)):
        _, t = _both(mesh_shape)
        _port_loss_grads(t, batch)
        grads: dict = {}
        for path, leaf in T.leaves(t["params"]):
            T.set_path(grads, path, leaf.grad)
        norms.append(float(AdamW.global_norm(grads)))
    np.testing.assert_allclose(norms[0], norms[1], rtol=1e-5)


def test_training_plans_and_options_that_raise(capsys, tmp_path):
    _, t = _both((2, 4))
    plans = L.island_plans(t["cfg"], t["run"], t["rules"], batch=4, seq=32)
    # the sequence-parallel island is listed, as JAX lists it
    assert [p.island for p in plans] == ["embed", "attn_ring", "attn_out",
                                        "decode_attn", "mlp", "lm_loss"]
    launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--mesh-shape",
                 "2", "2", "--steps", "1", "--batch", "2", "--seq", "8",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "lm_loss" in capsys.readouterr().out
    kw = dict(steps=1, reduced=True, mesh_shape=None, batch=2, seq=8,
              ckpt_dir=str(tmp_path), device="cpu")
    # int8 compression and wires run (once ROADMAP item 11)
    for i, extra in enumerate((dict(compress_grads=True),
                               dict(comm_wire="int8", mesh_shape=(1, 4)),
                               dict(comm_wire="int8_sr", mesh_shape=(2, 2),
                                    comm_backend="ring"))):
        _, log = launch.build_and_train(
            "tinyllama-1.1b", **dict(kw, ckpt_dir=str(tmp_path / str(i)),
                                     **extra))
        assert np.isfinite(log[-1]["loss"])
    with pytest.raises(ValueError, match="unknown wire format"):
        launch.build_and_train("tinyllama-1.1b", **dict(kw, comm_wire="fp4",
                                                        mesh_shape=(1, 4)))
    # MoE and SSM archs train (once ROADMAP A9b and A10b)
    for arch in ("moonshot-v1-16b-a3b", "falcon-mamba-7b"):
        _, log = launch.build_and_train(
            arch, **dict(kw, ckpt_dir=str(tmp_path / arch)))
        assert np.isfinite(log[-1]["loss"])
