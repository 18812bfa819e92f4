"""GPipe of the port (``repro_torch.train.pipeline``) against the JAX
package's ``repro.train.pipeline`` on its 8-device CPU mesh, case for case
of ``tests/test_pipeline.py``: the pipe over 4 ranks, its gradients through
``gpipe_loss``, the bubble masking (every rank but the last holds zeros),
the Island entry, the single-device and indivisible-stage fallbacks to the
sequential reference, and virtual stages (8 stages on 4 ranks). The stage
function is ``tanh(x @ w)`` on the same numpy-seeded weights in both, and
a ``.reduced()`` tinyllama-1.1b decoder layer with JAX's parameters
converted; forwards within 1e-5 of JAX's, gradients within 1e-4 (the
layer's relative to each gradient's largest entry). The
``fused`` handoff (an ``island_overrides`` entry; the p2p kernel's plain
version here) gives the ``bulk`` handoff's bits, forward and backward, and
the plan reports the declared ring shift.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import pipeline as JPL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LayerSpec, RunConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.core.template import comm_context  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import pipeline as TPL  # noqa: E402

torch.set_num_threads(1)

N_STAGES = 4
FUSED = RunConfig(island_overrides=(("gpipe", "fused", None),))


@pytest.fixture(scope="module")
def meshes():
    return (compat.make_mesh((N_STAGES,), ("pipe",)),
            VirtualMesh((N_STAGES,), ("pipe",)))


def _data(n_stages, m, d=8, mb=4, shift=0.0):
    rng = np.random.RandomState(n_stages * 10 + m)
    ws = (rng.standard_normal((n_stages, d, d)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((m, mb, d)) + shift).astype(np.float32)
    tgt = rng.standard_normal((m, mb, d)).astype(np.float32)
    return ws, x, tgt


def _jstage(w, x):
    return jnp.tanh(x @ w)


def _tstage(w, x):
    return torch.tanh(x @ w)


def _seq(ws, x):
    h = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        h = _tstage(w, h)
    return h


def _jax_apply(mesh, ws, x):
    """JAX's gpipe_apply on every rank, gathered: (n, M, mb, d)."""
    g = jax.jit(compat.shard_map(
        lambda ws_, x_: jax.lax.all_gather(
            JPL.gpipe_apply(_jstage, ws_[0], x_, "pipe"), "pipe"),
        mesh=mesh, in_specs=(JP("pipe"), JP()), out_specs=JP(None),
        check_vma=False))
    return np.asarray(g(ws, x))


def test_gpipe_matches_jax_and_sequential(meshes):
    jmesh, tmesh = meshes
    ws, x, _ = _data(N_STAGES, 6)
    ctx = comm_context(None, "pipe", mesh=tmesh)
    got = TPL.gpipe_apply(_tstage, torch.from_numpy(ws), torch.from_numpy(x),
                          ctx)
    want = _jax_apply(jmesh, ws, x)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[-1].numpy(), _seq(ws, x).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_gpipe_bubble_masking_matches_jax(meshes):
    jmesh, tmesh = meshes
    ws, x, _ = _data(N_STAGES, 6, shift=1.0)
    ctx = comm_context(None, "pipe", mesh=tmesh)
    got = TPL.gpipe_apply(_tstage, torch.from_numpy(ws), torch.from_numpy(x),
                          ctx).numpy()
    want = _jax_apply(jmesh, ws, x)
    np.testing.assert_array_equal(got[:-1], np.zeros_like(got[:-1]))
    np.testing.assert_array_equal(want[:-1], got[:-1])
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-5, atol=1e-5)
    assert np.all(np.abs(got[-1]) > 0)


@pytest.mark.parametrize("run", [None, FUSED], ids=["bulk", "fused"])
def test_gpipe_grads_match_jax(meshes, run):
    jmesh, tmesh = meshes
    ws, x, tgt = _data(N_STAGES, 6)

    def jloss_fn(outs, targets):
        return jnp.mean((outs - targets) ** 2)

    want = jax.jit(jax.grad(lambda w: compat.shard_map(
        lambda ws_, x_, t_: JPL.gpipe_loss(_jstage, jloss_fn, ws_[0], x_, t_,
                                           "pipe"),
        mesh=jmesh, in_specs=(JP("pipe"), JP(), JP()), out_specs=JP(),
        check_vma=False)(w, x, tgt)))(ws)
    backend = "fused" if run is not None else None
    ctx = comm_context(None, "pipe", mesh=tmesh, backend=backend)
    w = torch.from_numpy(ws).requires_grad_()
    loss = TPL.gpipe_loss(_tstage, lambda o, t: ((o - t) ** 2).mean(), w,
                          torch.from_numpy(x), torch.from_numpy(tgt), ctx)
    got, = torch.autograd.grad(loss, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_gpipe_island_matches_jax(meshes):
    jmesh, tmesh = meshes
    ws, x, _ = _data(N_STAGES, 6)
    island = TPL.gpipe_island(_tstage, tmesh, n_microbatches=6)
    assert island.fallback_reason() is None
    want = np.asarray(jax.jit(lambda ws, x: JPL.gpipe_forward(
        _jstage, ws, x, jmesh))(ws, x))
    got = TPL.gpipe_forward(_tstage, torch.from_numpy(ws),
                            torch.from_numpy(x), tmesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    fused = TPL.gpipe_forward(_tstage, torch.from_numpy(ws),
                              torch.from_numpy(x), tmesh, run=FUSED)
    assert torch.equal(fused, got)
    plan = island.plan()
    jplan = JPL.gpipe_island(_jstage, jmesh, n_microbatches=6).plan()
    assert (plan.op, plan.backend, plan.n_chunks, plan.fallback) == \
        (jplan.op, jplan.backend, jplan.n_chunks, jplan.fallback)


def test_gpipe_island_single_device_falls_back_like_jax():
    jmesh1 = compat.make_mesh((1,), ("pipe",))
    tmesh1 = VirtualMesh((1,), ("pipe",))
    ws, x, _ = _data(3, 3)
    jis = JPL.gpipe_island(_jstage, jmesh1, n_microbatches=3)
    tis = TPL.gpipe_island(_tstage, tmesh1, n_microbatches=3)
    assert tis.fallback_reason() == jis.fallback_reason() == \
        "single-device mesh"
    got = tis(stage_params=torch.from_numpy(ws), x_mb=torch.from_numpy(x))
    want = np.asarray(jis(stage_params=ws, x_mb=x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gpipe_island_virtual_stages_match_jax(meshes):
    jmesh, tmesh = meshes
    ws, x, _ = _data(8, 6)                       # 8 stages on 4 ranks
    want = np.asarray(jax.jit(lambda ws, x: JPL.gpipe_forward(
        _jstage, ws, x, jmesh))(ws, x))
    got = TPL.gpipe_forward(_tstage, torch.from_numpy(ws),
                            torch.from_numpy(x), tmesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _seq(ws, x).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_gpipe_island_indivisible_stages_fall_back_like_jax(meshes):
    jmesh, tmesh = meshes
    ws, x, _ = _data(6, 5)                       # 6 stages on 4 ranks
    jis = JPL.gpipe_island(_jstage, jmesh, n_microbatches=5, n_stages=6)
    tis = TPL.gpipe_island(_tstage, tmesh, n_microbatches=5, n_stages=6)
    assert tis.fallback_reason() == jis.fallback_reason()
    assert "not divisible" in tis.fallback_reason()
    got = TPL.gpipe_forward(_tstage, torch.from_numpy(ws),
                            torch.from_numpy(x), tmesh)
    want = np.asarray(JPL.gpipe_forward(_jstage, ws, x, jmesh))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decoder_layer_stages_match_jax(meshes):
    """The stage is a ``.reduced()`` tinyllama-1.1b decoder layer on no
    mesh (the card's phase runs the full-width one): 4 layers on 2 ranks,
    3 microbatches, JAX's parameters converted; the pipe's output and the
    input's and every layer parameter's gradient against JAX's
    ``gpipe_forward`` and ``jax.grad`` of the sequential layers."""
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="float32", n_layers=4)
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32", n_layers=4)
    jrun, trun = JaxRun(fsdp=False), RunConfig(fsdp=False)
    jtmpl = JT.param_template(jcfg, jrun, None)
    params = JT.init_params(jtmpl, jax.random.PRNGKey(2), jcfg.d_model)
    jblocks = params["blocks"]["pos0"]
    ttmpl = T.param_template(tcfg, trun, None)["blocks"]["pos0"]
    tblocks = convert.tree_from_numpy(
        jax.tree.map(np.asarray, jblocks), ttmpl, None)
    spec = jcfg.layer_pattern()[0]
    rng = np.random.RandomState(4)
    x = (rng.standard_normal((3, 2, 6, jcfg.d_model)) * 0.5) \
        .astype(np.float32)

    def jstage(bp, h):
        return JT._apply_block(bp, spec, h.reshape(-1, *h.shape[-2:]), jcfg,
                               jrun, None)[0].reshape(h.shape)

    def tstage(bp, h):
        return T._apply_block(bp, LayerSpec(spec.mixer, spec.mlp),
                              h.reshape(-1, *h.shape[-2:]), tcfg, trun,
                              None)[0].reshape(h.shape)

    jmesh2 = compat.make_mesh((2,), ("pipe",))
    tmesh2 = VirtualMesh((2,), ("pipe",))
    want = np.asarray(jax.jit(lambda bp, h: JPL.gpipe_forward(
        jstage, bp, h, jmesh2))(jblocks, x))
    xt = torch.from_numpy(x).requires_grad_()
    tleaves = {g: {k: v.clone().requires_grad_() for k, v in sub.items()}
               for g, sub in tblocks.items()}
    got = TPL.gpipe_forward(tstage, tleaves, xt, tmesh2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    fused = TPL.gpipe_forward(tstage, tleaves, xt, tmesh2, run=FUSED)
    assert torch.equal(fused, got)

    def jseq(bp, h):
        for i in range(jcfg.n_layers):
            h = jstage(jax.tree.map(lambda a: a[i], bp), h)
        return jnp.sum(h * h)

    jgx, jgp = jax.jit(jax.grad(lambda h, bp: jseq(bp, h),
                                argnums=(0, 1)))(x, jblocks)
    (got * got).sum().backward()

    def close(a, b, what):
        # within 1e-4 of the gradient's largest entry
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), what

    close(xt.grad.numpy(), jgx, "x")
    for g, sub in tleaves.items():
        for k, v in sub.items():
            close(v.grad.numpy(), jgp[g][k], f"{g}/{k}")
