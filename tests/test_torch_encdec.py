"""The port's encoder-decoder (whisper-medium) against the JAX package, in
float32 on the CPU.

The reduced whisper (2 encoder and 2 decoder layers, d = 64, 4 heads of
16, 2 KV heads, ff 128, vocab 256; RMSNorm, RoPE on self-attention only,
no biases, a stub frontend: the encoder takes ``enc_embeds``) is
initialised by the JAX package and converted with
``convert.params_from_jax``; both packages get the same numpy inputs.

* ``params_from_jax`` round-trips every leaf of whisper's tree, the
  encoder's and the cross-attention's among them, in JAX's leaf order.
* ``forward_train`` loss within atol 1e-4 and every gradient within 1e-5
  (largest |g| about 0.3; the sums differ only in order), with no mesh,
  on (1, 2) and (1, 4), and on (2, 2) with FSDP: there the batch's dp
  halves carry the same tokens (JAX's FSDP embedding mixes the dp ranks'
  batches, ROADMAP C4; the encoder's frames differ per half), and with
  distinct halves the port is held against JAX with no mesh. One
  ``make_train_step`` with 2 microbatches: loss and grad norm rtol 1e-5.
* ``forward_prefill`` logits within 1e-4 for whisper and tinyllama (the
  dense archs of JAX's ``test_prefill_smoke``), and for moonshot (MoE,
  once ROADMAP A9b) and falcon-mamba (SSM, once A10b), JAX's other
  ``test_prefill_smoke`` archs.
* 4 chained ``decode_step_encdec`` steps, logits and self cache within
  1e-4, with no mesh, on (1, 2) and (1, 4), from one random cache (self
  and cross) made by the JAX package and converted.
* ``encode_cross`` — the encoder, then each decoder layer's cross K/V
  (``cross_kv``) — against JAX's ``_scan_encoder`` and the inline einsums
  of its ``_apply_block``, within 1e-5.
"""

import dataclasses
from functools import partial

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
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ServeConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.runtime.serving import ServingEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

torch.set_num_threads(1)

ATOL_LOSS, ATOL_GRAD, ATOL_LOGITS = 1e-4, 1e-5, 1e-4
ARCH = "whisper-medium"
B, S, SE, S_MAX = 4, 16, 24, 16


def _both(mesh_shape, arch=ARCH, *, fsdp=None, vocab=None, **run_kw):
    """(jax side, port side): cfg, run, rules, params (and the JAX mesh).
    FSDP on a mesh with a data axis larger than 1, as the launchers set it;
    the decode cache's sequence dim sharded over tp on a mesh; ``vocab``
    replaces the reduced config's 256."""
    cut = dict(dtype="float32") | ({} if vocab is None
                                   else dict(vocab_size=vocab))
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **cut)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **cut)
    if fsdp is None:
        fsdp = mesh_shape is not None and mesh_shape[0] > 1
    backend = run_kw.pop("comm_backend", "fused" if fsdp else None)
    kw = dict(fsdp=fsdp, decode_seq_shard=mesh_shape is not None, **run_kw)
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
    return (dict(cfg=jcfg, run=jrun, rules=jrules, params=jparams,
                 mesh=jmesh),
            dict(cfg=tcfg, run=trun, rules=trules, params=tparams))


def _batch(seed=0, equal_halves=False, microbatches=1, vocab=256):
    """Tokens, targets, weights and the encoder's frame embeddings;
    ``equal_halves``: in every microbatch the second dp half's tokens and
    targets repeat the first's (the frames and weights differ)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tgt = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if equal_halves:
        for a in (tok, tgt):
            mb = a.reshape(microbatches, 2, B // microbatches // 2, S)
            mb[:, 1] = mb[:, 0]
    return {"tokens": tok, "targets": tgt,
            "weights": (rng.random((B, S)) > 0.1).astype(np.float32),
            "enc_embeds": rng.standard_normal((B, SE, 64)).astype(
                np.float32)}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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


def _assert_grads(got, want):
    paths = [p for p, _ in T.leaves(got)]
    # the encoder's and the cross-attention's gradients are among them
    assert any(p[0] == "enc_blocks" for p in paths)
    assert any("cross" in p for p in paths)
    for path, g in T.leaves(got):
        np.testing.assert_allclose(g, np.asarray(_get(want, path)),
                                   atol=ATOL_GRAD, rtol=0,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (2, 2)])
def test_params_round_trip(mesh_shape):
    j, t = _both(mesh_shape)
    tmpl = T.param_template(t["cfg"], t["run"], t["rules"])
    jpaths = [tuple(k.key for k in kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(j["params"])[0]]
    assert [p for p, _ in T.leaves(tmpl)] == jpaths     # JAX's leaf order
    assert {"enc_blocks", "enc_final_norm"} <= set(tmpl)
    assert set(tmpl["blocks"]["pos0"]) == {"attn", "cross", "mlp"}
    assert set(tmpl["enc_blocks"]) == {"attn", "mlp"}
    back = convert.tree_to_numpy(t["params"], tmpl, t["rules"])
    for path, leaf in T.leaves(back):
        np.testing.assert_array_equal(leaf, np.asarray(_get(j["params"],
                                                            path)))


@pytest.mark.parametrize("mesh_shape", [None, (1, 2), (1, 4), (2, 2)])
def test_forward_train_matches_jax(mesh_shape):
    j, t = _both(mesh_shape)
    batch = _batch(equal_halves=True)
    jl, jg = _jax_loss_grads(j, batch)
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL_LOSS, (tl, jl)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("run_kw", [dict(remat=False),
                                    dict(save_collectives=True),
                                    dict(pk_attn_out_island=True)],
                         ids=lambda kw: next(iter(kw)))
def test_forward_train_run_options_match_jax(run_kw):
    j, t = _both((2, 2), **run_kw)
    batch = _batch(seed=3, equal_halves=True)
    jl, jg = _jax_loss_grads(j, batch)
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL_LOSS, (tl, jl)
    _assert_grads(tg, jg)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_forward_train_ragged_vocab_shard_matches_jax(mesh_shape):
    """A vocab of 250: shards of 63 (1, 4) or 125 (2, 2) columns, f32 rows
    of no multiple of 16 bytes, as whisper's 12967-column bf16 shard on the
    card. The head is stored in rows padded to 16 bytes (the GEMM's tensor
    maps read them so, with no copy a call), the FSDP gather's copies keep
    that padding, and the loss and every gradient match JAX's."""
    from repro_torch.core import pgl
    from repro_torch.core.template import fsdp_gather
    j, t = _both(mesh_shape, vocab=250)
    head = t["params"]["lm_head"]
    assert head.stride(-2) % 4 == 0 and head.stride(-2) > head.shape[-1]
    assert pgl.padded_rows(head)
    if t["run"].fsdp:
        spec = T.param_template(t["cfg"], t["run"],
                                t["rules"])["lm_head"].spec
        got = fsdp_gather(head, spec, t["rules"], t["run"], dim=0)
        assert got.stride(-2) % 4 == 0
        want = fsdp_gather(head.contiguous(), spec, t["rules"], t["run"],
                           dim=0)
        assert torch.equal(got, want)
    batch = _batch(equal_halves=True, vocab=250)
    jl, jg = _jax_loss_grads(j, batch)
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL_LOSS, (tl, jl)
    _assert_grads(tg, jg)


def test_fsdp_forward_train_matches_single_device():
    j, _ = _both(None)
    batch = _batch(seed=1)
    jl, jg = _jax_loss_grads(j, batch)
    _, t = _both((2, 2))
    tl, tg = _port_loss_grads(t, batch)
    assert abs(tl - jl) <= ATOL_LOSS, (tl, jl)
    _assert_grads(tg, jg)


def test_train_step_with_microbatches_matches_jax():
    """One AdamW step, 2 microbatches on (2, 2) with FSDP: the microbatch
    split carries ``enc_embeds`` with the tokens."""
    j, t = _both((2, 2), microbatches=2)
    batch = _batch(seed=2, equal_halves=True, microbatches=2)
    jopt = JaxAdamW(lr=1e-3, weight_decay=0.01)
    jstate = JS.TrainState(j["params"], jopt.init(j["params"]))
    _, jm = jax.jit(JS.make_train_step(j["cfg"], j["run"], j["rules"],
                                       jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    topt = AdamW(lr=1e-3, weight_decay=0.01)
    step = TS.make_train_step(t["cfg"], t["run"], t["rules"], topt)
    _, tm = step(TS.TrainState(t["params"], topt.init(t["params"])),
                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-medium", "tinyllama-1.1b"])
@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_forward_prefill_matches_jax(arch, mesh_shape):
    j, t = _both(mesh_shape, arch)
    batch = _batch(seed=4)
    del batch["targets"], batch["weights"]
    if arch != ARCH:
        del batch["enc_embeds"]
    want = jax.jit(partial(JT.forward_prefill, cfg=j["cfg"], run=j["run"],
                           rules=j["rules"]))(
        j["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    prefill = TS.make_prefill_step(t["cfg"], t["run"], t["rules"])
    with torch.no_grad():
        got = prefill(t["params"], {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert got.shape == (B, 1, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("arch,item", [("moonshot-v1-16b-a3b", "A9b"),
                                       ("falcon-mamba-7b", "A10b")])
def test_forward_prefill_refuses_moe_and_ssm(arch, item):
    """The MoE and SSM prefill that ROADMAP ``item`` refused runs, and its
    logits equal JAX's ``forward_prefill`` with no mesh."""
    j, t = _both(None, arch)
    batch = {"tokens": _batch(seed=4)["tokens"]}
    want = jax.jit(partial(JT.forward_prefill, cfg=j["cfg"], run=j["run"],
                           rules=None))(
        j["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = T.forward_prefill(t["params"], {k: torch.from_numpy(v)
                                              for k, v in batch.items()},
                                t["cfg"], t["run"], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_LOGITS, rtol=0, err_msg=item)


def _jax_cache(j, batch, *, seed=5):
    """A whisper decode cache from the JAX template — self and cross K/V
    random, the position 6 — placed on the JAX mesh."""
    tmpl = JT.cache_template(j["cfg"], j["run"], j["rules"], batch=batch,
                             s_max=S_MAX, enc_len=SE)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda pd: jnp.asarray(rng.standard_normal(pd.shape).astype(
            np.float32) if pd.shape else 6, pd.dtype),
        tmpl, is_leaf=lambda x: isinstance(x, JT.PD))
    if j["rules"] is not None:
        tree = jax.tree.map(jax.device_put, tree,
                            JSP.named(j["mesh"], JT.param_specs(tmpl)))
    return tree


def _port_template(t, batch):
    return T.cache_template(t["cfg"], t["run"], t["rules"], batch=batch,
                            s_max=S_MAX, enc_len=SE)


@pytest.mark.parametrize("mesh_shape", [None, (1, 2), (1, 4)])
def test_decode_step_encdec_matches_jax(mesh_shape):
    j, t = _both(mesh_shape)
    jc = _jax_cache(j, B)
    tmpl = _port_template(t, B)
    tc = convert.tree_from_numpy(jax.tree.map(np.asarray, jc), tmpl,
                                 t["rules"])
    if mesh_shape is not None:      # the encoder positions over tp ranks
        r = mesh_shape[1]
        assert tc["cross"]["k"].shape == (2, r, B, 2, SE // r, 16)
    jdec = jax.jit(JS.make_serve_step(j["cfg"], j["run"], j["rules"]))
    tdec = TS.make_serve_step(t["cfg"], t["run"], t["rules"])
    nxt = np.random.default_rng(6).integers(0, 256, (B, 1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jdec(j["params"], jc, nxt)
        with torch.no_grad():
            tl, tc = tdec(t["params"], tc, torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL_LOGITS, rtol=0)
        got = convert.tree_to_numpy(tc, tmpl, t["rules"])
        for path, leaf in T.leaves(got):
            np.testing.assert_allclose(leaf, np.asarray(_get(jc, path)),
                                       atol=ATOL_LOGITS, rtol=0,
                                       err_msg="/".join(path))
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(
            np.int32)[:, None]
    assert int(tc["pos"]) == 10


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
def test_encode_cross_matches_jax(mesh_shape):
    """The cross K/V helper against JAX's encoder and inline einsums
    (``transformer.py:247-252``), written into the cache's layout."""
    j, t = _both(mesh_shape)
    enc = _batch(seed=7)["enc_embeds"]
    jcfg, jp = j["cfg"], j["params"]

    @jax.jit
    def jax_cross(params, enc):
        out = JT._scan_encoder(params["enc_blocks"], enc, jcfg, j["run"],
                               j["rules"])
        out = JL.rms_norm(params["enc_final_norm"], out, jcfg.norm_eps)
        cp = params["blocks"]["pos0"]["cross"]
        ks, vs = [], []
        for li in range(jcfg.n_periods):
            for name, acc in (("wk", ks), ("wv", vs)):
                acc.append(jnp.einsum("bsd,dh->bsh", out, cp[name][li])
                           .reshape(B, SE, 2, 16).transpose(0, 2, 1, 3))
        return jnp.stack(ks), jnp.stack(vs)

    wk, wv = jax_cross(jp, jnp.asarray(enc))
    tmpl = _port_template(t, B)
    with torch.no_grad():
        tc = T.encode_cross(t["params"],
                            T.zeros(tmpl, t["rules"], "cpu"),
                            torch.from_numpy(enc), t["cfg"], t["run"],
                            t["rules"])
    got = convert.tree_to_numpy(tc, tmpl, t["rules"])["cross"]
    np.testing.assert_allclose(got["k"], np.asarray(wk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["v"], np.asarray(wv), atol=1e-5, rtol=0)


def test_encdec_guards(tmp_path):
    """What refuses an encoder-decoder, in JAX's words where JAX refuses:
    the continuous-batching engine, the batched cache prefill and the
    training launcher (whose data pipeline feeds no ``enc_embeds``)."""
    _, t = _both((1, 4))
    with pytest.raises(NotImplementedError, match="decoder-only models"):
        ServingEngine(t["cfg"], t["run"], t["rules"], t["params"],
                      ServeConfig(), device="cpu")
    cache = T.zeros(_port_template(t, B), t["rules"], "cpu")
    with pytest.raises(NotImplementedError, match="precomputes cross K/V"):
        T.prefill_step(t["params"], cache, torch.zeros(B, 4).long(), 4,
                       t["cfg"], t["run"], t["rules"])
    with pytest.raises(NotImplementedError, match="enc_embeds"):
        launch.build_and_train(ARCH, steps=1, reduced=True, mesh_shape=None,
                               batch=2, seq=8, ckpt_dir=str(tmp_path),
                               device="cpu")
