"""The port's SSM and hybrid training against the JAX package's, in float32
on the CPU.

* The selective scan's backward: ``mamba_scan_bwd_plain`` (the reverse
  recurrence the hand-written kernel runs, ``csrc/mamba_scan_bwd.cu``)
  against ``jax.vjp`` of JAX's ``selective_scan_chunked`` — which JAX
  differentiates through an XLA associative scan — for every input's
  gradient within 1e-4 (JAX associates the recurrence as a tree); the
  autograd Function around ``mamba_scan`` on the CPU against autograd
  through ``mamba_scan_plain``, in f32 and with bf16 x, b, c; its
  refusals (a gradient of h0 or of h_last); the kernel's launch plan at
  the path's shapes.
* falcon-mamba-7b ``.reduced()`` (2 mamba layers, d = 64, d_inner 128, N
  = 8): ``forward_train`` loss and every gradient within 1e-4 of
  ``jax.value_and_grad`` with no mesh, on (1, 4), and on (2, 2) with FSDP
  (``in_proj`` and ``out_proj`` FSDP-gathered; the batch's dp halves
  carry the same tokens, ROADMAP C4), and with ``save_collectives`` (the
  sub-block remat policy).
* jamba-1.5-large-398b ``.reduced()`` (8 layers: attention, mamba, dense
  and MoE FFNs in one period) on (2, 2) with FSDP, the same limits.
* ``forward_prefill`` logits within 1e-4 for falcon-mamba, no mesh and (1,
  4); ``run.ssm_scan_dtype="bfloat16"`` raises naming ROADMAP A10e.
* ``build_and_train`` trains falcon-mamba and jamba on (2, 4), batch 4,
  seq 32 (JAX's ``test_system.py`` cases), with finite losses.
* A jamba state on (2, 2) with FSDP — MoE experts device-major, f32
  ``A_log``/``D``/``dt_bias``, AdamW moments — saved by the checkpoint
  manager restores bit for bit, and one more step from it gives the loss
  of a step without the round trip.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels.matmul import SMEM_LIMIT  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

import torch_parity as TP  # noqa: E402

torch.set_num_threads(1)

SSM, HYBRID = "falcon-mamba-7b", "jamba-1.5-large-398b"
ATOL = 1e-4


def _scan_inputs(b, s, d, n, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) - 2.0))
    return [a.astype(np.float32) for a in (
        dt, rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
        rng.standard_normal((b, s, d)),
        -np.exp(rng.standard_normal((d, n)) * 0.5),
        rng.standard_normal((b, s, d)))]


@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 12, 6, 4, 4),
                                           (1, 9, 16, 8, 9),
                                           (3, 16, 10, 16, 8)])
def test_scan_bwd_plain_matches_jax_vjp(b, s, d, n, chunk):
    dt, bm, cm, x, a, dy = _scan_inputs(b, s, d, n)
    h0 = np.zeros((b, d, n), np.float32)
    zero_skip = np.zeros((d,), np.float32)

    def f(dt, bm, cm, x, a):
        return JS.selective_scan_chunked(dt, bm, cm, x, a, zero_skip, h0,
                                         chunk=chunk)[0]

    _, vjp = jax.vjp(f, dt, bm, cm, x, a)
    want = vjp(jnp.asarray(dy))
    got = MS.mamba_scan_bwd_plain(*map(torch.from_numpy,
                                       (dt, bm, cm, x, a, h0, dy)))
    for name, g, w in zip(("dt", "b", "c", "x", "a"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=ATOL,
                                   atol=ATOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("low", [torch.float32, torch.bfloat16])
def test_scan_function_matches_autograd_of_plain(low):
    """The Function's backward is the plain reverse recurrence on the CPU:
    its gradients equal autograd through the sequential forward (dx, db,
    dc rounded once to x's dtype, as the kernel stores them)."""
    dt, bm, cm, x, a, dy = _scan_inputs(2, 11, 12, 8, seed=3)

    def leaves():
        out = [torch.from_numpy(dt), torch.from_numpy(bm).to(low),
               torch.from_numpy(cm).to(low), torch.from_numpy(x).to(low),
               torch.from_numpy(a)]
        return [t.requires_grad_(True) for t in out]

    h0 = torch.zeros(2, 12, 8)
    got_in, want_in = leaves(), leaves()
    y, h_last = MS.mamba_scan(*got_in, h0, chunk=4)
    y_ref, _ = MS.mamba_scan_plain(*want_in, h0)
    np.testing.assert_array_equal(y.detach().numpy(), y_ref.detach().numpy())
    got = torch.autograd.grad(y, got_in, torch.from_numpy(dy))
    want = torch.autograd.grad(y_ref, want_in, torch.from_numpy(dy))
    for g, w, t in zip(got, want, got_in):
        assert g.dtype == t.dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=1e-5, atol=1e-5 * float(
                                       w.float().abs().max()))


def test_scan_function_refuses_state_gradients():
    dt, bm, cm, x, a, _ = map(torch.from_numpy, _scan_inputs(1, 5, 4, 4))
    dt.requires_grad_(True)
    h0 = torch.zeros(1, 4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="h0"):
        MS.mamba_scan(dt, bm, cm, x, a, h0)
    y, h_last = MS.mamba_scan(dt, bm, cm, x, a, h0.detach())
    with pytest.raises(NotImplementedError, match="h_last"):
        (y.sum() + h_last.sum()).backward()
    with pytest.raises(ValueError, match="h_out"):
        MS.mamba_scan(dt, bm, cm, x, a, h0.detach(),
                      h_out=torch.empty(1, 4, 4))
    # a zero cotangent of h_last (or none) is taken
    y, h_last = MS.mamba_scan(dt, bm, cm, x, a, h0.detach())
    (y.sum() + 0.0 * h_last.sum()).backward()
    assert dt.grad is not None and torch.isfinite(dt.grad).all()


@pytest.mark.parametrize("b,s,d,n,seg", [(2, 512, 8192, 16, None),
                                         (4, 405, 8192, 16, None),
                                         (4, 32, 128, 8, None),
                                         (1, 7, 200, 32, 3)])
def test_scan_bwd_plan_at_the_path_shapes(b, s, d, n, seg):
    """Segments of min(S, 8) steps (or the ``seg`` a test gives) cover
    every step once, channel tiles every channel (K = min(4, N) states a
    lane, a channel's N / K lanes, 256 lanes a block), and a block's shared
    memory (a segment's h and g for 256 lanes, the staged inputs and output
    rows) stays within a block's limit, for two blocks an SM at the path's
    N = 16."""
    if seg is None:
        p = MS.scan_bwd_plan(b, s, d, n)
        assert p.seg == min(MS.BWD_SEG_MAX, s)
    else:
        p = MS._bwd_plan(b, s, d, n, seg)
        assert p.seg == seg
        for bad in (0, min(MS.BWD_SEG_MAX, s) + 1):
            with pytest.raises(ValueError, match="segment"):
                MS._bwd_plan(b, s, d, n, bad)
    assert (p.nseg - 1) * p.seg < s <= p.nseg * p.seg
    assert p.k_states == min(4, n)
    assert p.channels * (n // p.k_states) == MS.BWD_THREADS
    assert (p.nblk - 1) * p.channels < d <= p.nblk * p.channels
    assert p.grid == (p.nblk, b)
    row = MS.BWD_THREADS * p.k_states + MS.BWD_PAD
    assert p.smem_bytes == 4 * ((2 * p.seg + 1) * row
                                + p.seg * (5 * p.channels + 2 * n))
    assert p.smem_bytes <= SMEM_LIMIT
    if n == 16 and p.seg == MS.BWD_SEG_MAX:
        assert 2 * p.smem_bytes <= SMEM_LIMIT
    with pytest.raises(ValueError, match="power of two"):
        MS.scan_bwd_plan(b, s, d, 12)


@pytest.mark.parametrize("mesh_shape,run_kw", [
    (None, {}), ((1, 4), {}), ((2, 2), {}),
    ((2, 2), dict(save_collectives=True))],
    ids=["none", "1x4", "2x2", "2x2-save_collectives"])
def test_ssm_forward_train_matches_jax(mesh_shape, run_kw):
    j, t = TP.both(SSM, mesh_shape, **run_kw)
    dp = mesh_shape is not None and mesh_shape[0] > 1
    bt = TP.batch(seed=1, equal_halves=dp)
    paths = TP.assert_matches(j, t, bt, atol_loss=ATOL, atol_grad=ATOL)
    assert {p[-1] for p in paths if "mamba" in p} >= {
        "in_proj", "out_proj", "A_log", "D", "dt_bias", "conv_w", "x_proj"}


def test_hybrid_forward_train_matches_jax():
    j, t = TP.both(HYBRID, (2, 2))
    bt = TP.batch(seed=2, equal_halves=True)
    paths = TP.assert_matches(j, t, bt, atol_loss=ATOL, atol_grad=ATOL)
    groups = {p[2] for p in paths if p[0] == "blocks"}
    assert groups == {"attn", "mamba", "mlp", "moe"}


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_ssm_forward_prefill_matches_jax(mesh_shape):
    j, t = TP.both(SSM, mesh_shape)
    toks = {"tokens": TP.batch(seed=4)["tokens"]}
    want = jax.jit(partial(JT.forward_prefill, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))(
        j["params"], {k: jnp.asarray(v) for k, v in toks.items()})
    with torch.no_grad():
        got = T.forward_prefill(t["params"], {k: torch.from_numpy(v)
                                              for k, v in toks.items()},
                                t["cfg"], t["run"], t["rules"])
    assert got.shape == (TP.B, 1, TP.VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bf16_scan_dtype_raises_a10e():
    """A10e no longer raises: training and prefill with the bf16 scan
    agree with JAX's within 2e-2 (``tests/test_torch_ssm_bf16.py`` sets
    the rule)."""
    j, t = TP.both(SSM, None, ssm_scan_dtype="bfloat16")
    bt = TP.batch()
    TP.assert_matches(j, t, bt, atol_loss=2e-2, atol_grad=2e-2)
    want = jax.jit(lambda p, x: JT.forward_prefill(
        p, x, j["cfg"], j["run"], None))(j["params"],
                                         {"tokens": bt["tokens"]})
    with torch.no_grad():
        got = T.forward_prefill(t["params"],
                                {"tokens": torch.from_numpy(bt["tokens"])},
                                t["cfg"], t["run"], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_build_and_train_ssm_and_hybrid(arch, tmp_path):
    _, log = launch.build_and_train(
        arch, steps=2, reduced=True, mesh_shape=(2, 4), batch=4, seq=32,
        ckpt_dir=str(tmp_path), log_every=1, device="cpu")
    assert len(log) == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["aux_loss"])
               for m in log)
    assert (log[0]["aux_loss"] > 0) == (arch == HYBRID)


def test_hybrid_checkpoint_round_trip(tmp_path):
    """jamba on (2, 2) with FSDP: one step, save, restore bit for bit
    (every parameter and AdamW moment, the MoE and mamba leaves among
    them), then a step from the restored state gives the loss and the
    parameters of a step from the original."""
    _, t = TP.both(HYBRID, (2, 2))
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    step = TS.make_train_step(t["cfg"], t["run"], t["rules"], opt)
    data = SyntheticLM(DataConfig(vocab_size=TP.VOCAB, seq_len=16,
                                  global_batch=4, seed=0), device="cpu")
    state, _ = step(TS.TrainState(t["params"], opt.init(t["params"])),
                    data.batch(0))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, state, {"data_cursor": 1})
    restored, extra = mgr.restore(state)
    assert extra["step"] == 1
    flat = dict(T.leaves({"p": state.params, "m": state.opt.m,
                          "v": state.opt.v}))
    back = dict(T.leaves({"p": restored.params, "m": restored.opt.m,
                          "v": restored.opt.v}))
    assert flat.keys() == back.keys()
    names = {p[-1] for p in flat}
    assert {"A_log", "D", "dt_bias", "router", "w1", "in_proj"} <= names
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v.detach()), k
    assert back[("p", "blocks", "pos1", "mamba", "A_log")].dtype \
        == torch.float32
    nxt = data.batch(1)
    s1, m1 = step(state, nxt)
    s2, m2 = step(restored, nxt)
    assert float(m1["loss"]) == float(m2["loss"])
    for (k, a), (_, b) in zip(T.leaves(s1.params), T.leaves(s2.params)):
        assert torch.equal(a, b), k
