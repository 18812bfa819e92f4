"""The port's sequence-parallel training forward and the vision frontend
merge against the JAX package, in float32 on the CPU.

* ``forward_train(seq_sharded=True)``: the loss and every parameter
  gradient against JAX's (the model function called directly on both
  sides, as no launcher sets ``seq_sharded``), on reduced tinyllama and on
  reduced h2o-danube-3-4b (sliding window 16), on (1, 2) and (1, 4) with
  the bulk and fused ring shift (JAX under its default backend: its fused
  ring shift has no gradient), and on (2, 2) with FSDP on batches whose dp
  halves carry equal tokens (ROADMAP C4) — atol 1e-5 on the loss, 1e-4 on
  the gradients (ring attention merges its hops in another order than
  JAX's sequential update).
* the same with ``sp_attention="ulysses"``: both archs on (1, 2), (1, 4)
  (2 KV heads repeated to 4 ranks) and (2, 2), the port at 1 and 2
  all-to-all chunks against JAX's at 2 (JAX's chunks are bulk's bits), the
  two chunk counts bit for bit;
* ``island_plans(phase="all")`` lists the ring island where JAX's does,
  and the Ulysses island with JAX's op, backend, chunk count and fallback
  for ``ulysses_chunks`` 0 (auto), 1 and 2;
* internvl2-26b ``.reduced()`` with ``frontend_embeds`` (ROADMAP C5): the
  first ``n_frontend_tokens`` embeddings replaced as in JAX — loss and
  every gradient within 1e-5, with no mesh and on (1, 4).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.core.template import plan_overrides  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4
B, S = 4, 32


def _both(arch, mesh_shape, *, backend=None, **run_kw):
    """(jax side, port side): cfg, run, rules, params (FSDP whenever there
    is a mesh, as both launchers set it); the port converts JAX's
    initialised parameters."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
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


def _batch(vocab, seed=0, equal_halves=False, frontend=None):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tgt = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if equal_halves:
        tok[B // 2:], tgt[B // 2:] = tok[:B // 2], tgt[:B // 2]
    batch = {"tokens": tok, "targets": tgt,
             "weights": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if frontend is not None:
        n, d = frontend
        batch["frontend_embeds"] = rng.standard_normal((B, n, d)).astype(
            np.float32)
    return batch


def _jax_loss_grads(j, batch, seq_sharded=False):
    f = jax.jit(jax.value_and_grad(lambda p, bt: JT.forward_train(
        p, bt, j["cfg"], j["run"], j["rules"], seq_sharded=seq_sharded)[0]))
    loss, grads = f(j["params"], {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    return float(loss), grads


def _port_loss_grads(t, batch, seq_sharded=False):
    for _, leaf in T.leaves(t["params"]):
        leaf.grad = None
        leaf.requires_grad_(True)
    loss, _ = T.forward_train(
        t["params"], {k: torch.from_numpy(v) for k, v in batch.items()},
        t["cfg"], t["run"], t["rules"], seq_sharded=seq_sharded)
    loss.backward()
    grads: dict = {}
    for path, leaf in T.leaves(t["params"]):
        T.set_path(grads, path, leaf.grad)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    return float(loss.detach()), convert.tree_to_numpy(grads, tmpl,
                                                     t["rules"])


def _assert_close(got, want, atol):
    np.testing.assert_allclose(got[0], want[0], atol=LOSS_ATOL, rtol=0)
    n = 0
    for path, g in T.leaves(got[1]):
        w = want[1]
        for k in path:
            w = w[k]
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg="/".join(path))
        n += 1
    assert n == len(jax.tree.leaves(want[1]))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("mesh_shape,backend", [
    ((1, 2), None), ((1, 4), None), ((1, 4), "fused"), ((2, 2), None)])
def test_seq_sharded_forward_train_matches_jax(arch, mesh_shape, backend):
    j, t = _both(arch, mesh_shape, backend=backend)
    batch = _batch(t["cfg"].vocab_size, seed=1,
                   equal_halves=mesh_shape[0] > 1)
    want = _jax_loss_grads(j, batch, seq_sharded=True)
    got = _port_loss_grads(t, batch, seq_sharded=True)
    _assert_close(got, want, GRAD_ATOL)
    # the same function as the dense mix (1e-5 on the loss)
    np.testing.assert_allclose(_port_loss_grads(t, batch)[0], got[0],
                               atol=LOSS_ATOL, rtol=0)


def test_seq_sharded_ring_island_runs_the_hops():
    """On (1, 4) every attention layer runs 4 hops and shifts k and v 3
    times each; with no mesh ``seq_sharded`` takes the dense mix."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pk_comm as PK
    _, t = _both("tinyllama-1.1b", (1, 4), backend="fused")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(t["cfg"].vocab_size).items()}
    with mock.patch.object(FA, "flash_attention_hop_plain",
                           wraps=FA.flash_attention_hop_plain) as hop, \
            mock.patch.object(PK, "ring_shift_plain",
                              wraps=PK.ring_shift_plain) as shift, \
            torch.no_grad():
        T.forward_train(t["params"], batch, t["cfg"], t["run"], t["rules"],
                        seq_sharded=True)
    n_layers = t["cfg"].n_layers
    assert [c.kwargs["hop"] for c in hop.call_args_list] \
        == [0, 1, 2, 3] * n_layers
    assert shift.call_count == 2 * 3 * n_layers
    _, t0 = _both("tinyllama-1.1b", None)
    with mock.patch.object(FA, "flash_attention_hop_plain",
                           side_effect=AssertionError("no hop")), \
            torch.no_grad():
        T.forward_train(t0["params"], batch, t0["cfg"], t0["run"],
                        t0["rules"], seq_sharded=True)


@pytest.mark.parametrize("sp_attention", ["ring", "none"])
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_island_plans_list_the_ring_island_as_jax(sp_attention,
                                                  mesh_shape):
    j, t = _both("tinyllama-1.1b", mesh_shape, sp_attention=sp_attention)
    for phase in ("prefill", "decode", "all"):
        want = JL.island_plans(j["cfg"], j["run"], j["rules"], batch=4,
                               seq=32, phase=phase)
        got = L.island_plans(t["cfg"], t["run"], t["rules"], batch=4,
                             seq=32, phase=phase)
        assert [p.island for p in got] == [p.island for p in want]
    ring = [p for p in got if p.island == "attn_ring"]
    assert len(ring) == (sp_attention == "ring")
    if ring:
        w = [p for p in want if p.island == "attn_ring"][0]
        assert (ring[0].op, ring[0].backend, ring[0].n_chunks,
                ring[0].fallback) == (w.op, w.backend, w.n_chunks,
                                      w.fallback) == ("ring_shift", "bulk",
                                                      mesh_shape[1], False)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)])
def test_seq_sharded_ulysses_forward_train_matches_jax(arch, mesh_shape):
    """Ulysses through ``forward_train(seq_sharded=True)``: loss 1e-5 and
    gradients 1e-4 against JAX, the chunked all-to-alls (2 chunks along
    head_dim, the kernel's wrapper on the card) bit for bit bulk's."""
    from unittest import mock

    from repro_torch.kernels import pk_comm as PK
    j, t = _both(arch, mesh_shape, sp_attention="ulysses", ulysses_chunks=2)
    batch = _batch(t["cfg"].vocab_size, seed=1,
                   equal_halves=mesh_shape[0] > 1)
    want = _jax_loss_grads(j, batch, seq_sharded=True)
    with mock.patch.object(PK, "all_to_all", wraps=PK.all_to_all) as kern:
        got = _port_loss_grads(t, batch, seq_sharded=True)
    # q, k, v and the output a layer and dp group, forward (twice under
    # remat) and backward
    passes = 2 if t["run"].remat else 1
    assert kern.call_count == (4 * t["cfg"].n_layers * mesh_shape[0]
                               * (passes + 1))
    _assert_close(got, want, GRAD_ATOL)
    t1 = dict(t, run=dataclasses.replace(t["run"], ulysses_chunks=1))
    bulk = _port_loss_grads(t1, batch, seq_sharded=True)
    assert bulk[0] == got[0]
    for path, g in T.leaves(got[1]):
        w = bulk[1]
        for k in path:
            w = w[k]
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))


@pytest.mark.parametrize("ulysses_chunks", [0, 1, 2])
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_island_plans_list_the_ulysses_island_as_jax(mesh_shape,
                                                     ulysses_chunks):
    """``attn_ulysses`` where JAX lists it, with its op, backend, chunk
    count and fallback (0: the analytic a2a policy, which prices on the
    H100 here and on the TPU in JAX; at these sizes both say 1)."""
    j, t = _both("tinyllama-1.1b", mesh_shape, sp_attention="ulysses",
                 ulysses_chunks=ulysses_chunks)
    for phase in ("prefill", "decode", "all"):
        want = JL.island_plans(j["cfg"], j["run"], j["rules"], batch=4,
                               seq=32, phase=phase)
        got = L.island_plans(t["cfg"], t["run"], t["rules"], batch=4,
                             seq=32, phase=phase)
        assert [p.island for p in got] == [p.island for p in want]
    (g,) = [p for p in got if p.island == "attn_ulysses"]
    (w,) = [p for p in want if p.island == "attn_ulysses"]
    assert (g.op, g.backend, g.n_chunks, g.fallback, g.source) \
        == (w.op, w.backend, w.n_chunks, w.fallback, w.source)
    assert g.op == "all_to_all" and g.backend == (
        "chunked" if ulysses_chunks == 2 else "bulk")
    # a frozen plan (RunConfig.island_overrides) wins over ulysses_chunks,
    # and plan_overrides freezes the all-to-all's total chunk count
    ov = (("attn_ulysses", "chunked", 2),)
    w = [p for p in JL.island_plans(
        j["cfg"], dataclasses.replace(j["run"], island_overrides=ov),
        j["rules"], batch=4, seq=32) if p.island == "attn_ulysses"][0]
    plans = L.island_plans(
        t["cfg"], dataclasses.replace(t["run"], island_overrides=ov),
        t["rules"], batch=4, seq=32)
    g = [p for p in plans if p.island == "attn_ulysses"][0]
    assert (g.backend, g.n_chunks, g.source) == (w.backend, w.n_chunks,
                                                 w.source) \
        == ("chunked", 2, "plan")
    assert ("attn_ulysses", "chunked", 2) in plan_overrides(plans)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_vision_frontend_merge_matches_jax(mesh_shape):
    """ROADMAP C5: internvl2's ``frontend_embeds`` replace the first
    ``n_frontend_tokens`` embeddings; the loss and every gradient equal
    JAX's within 1e-5, and differ from the loss without them."""
    j, t = _both("internvl2-26b", mesh_shape)
    cfg = t["cfg"]
    assert cfg.frontend == "vision" and cfg.n_frontend_tokens > 0
    batch = _batch(cfg.vocab_size, seed=2,
                   frontend=(cfg.n_frontend_tokens, cfg.d_model))
    want = _jax_loss_grads(j, batch)
    got = _port_loss_grads(t, batch)
    _assert_close(got, want, LOSS_ATOL)
    plain = {k: v for k, v in batch.items() if k != "frontend_embeds"}
    assert abs(_port_loss_grads(t, plain)[0] - got[0]) > 1e-3
