"""The port's selective scan and mamba block against the JAX package's, in
float32 on the CPU.

* ``mamba_scan`` (on CPU tensors its plain version, the sequential f32
  recurrence) against ``ref.mamba_scan_ref`` and the Pallas
  ``mamba_scan(..., interpret=True)`` at the JAX test's shapes, at an S
  that is not a multiple of the chunk and at S = 1 with a nonzero h0:
  rtol = atol = 1e-5. The chunk never changes the result, a scan over
  S + k steps equals S steps then k single steps chained through h0, and
  the stacked per-rank state layout gives the global layout's numbers.
* ``mamba_mix`` and ``mamba_block``, with and without a cache, on global
  and on per-rank stacked weights (mesh (1, 4)), against JAX's
  ``selective_scan_chunked`` path (the associative scan) with the same
  weights: rtol = atol = 1e-5; the conv tail, a slice of the input,
  exactly.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_scan  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
ARCH = "falcon-mamba-7b"


def _scan_inputs(b, s, d, n, seed=0):
    """The JAX test's distributions: dt = softplus(normal), b, c, x, h0
    normal, a = -exp(normal)."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(b, s, d))).astype(np.float32)
    return dict(dt=dt, b_ssm=f(b, s, n), c_ssm=f(b, s, n), x=f(b, s, d),
                a=-np.exp(f(d, n)), h0=f(b, d, n))


def _torch(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _order(inp):
    return (inp["dt"], inp["b_ssm"], inp["c_ssm"], inp["x"], inp["a"],
            inp["h0"])


@pytest.mark.parametrize("b,s,d,n,chunk", [
    (2, 256, 64, 8, 64),          # the JAX test's shapes
    (1, 128, 32, 16, 128),
    (2, 100, 48, 16, 64),         # S not a multiple of the chunk
    (3, 1, 32, 8, 128),           # decode: S = 1, nonzero h0
])
def test_scan_matches_jax(b, s, d, n, chunk):
    inp = _scan_inputs(b, s, d, n)
    y, h = MS.mamba_scan(*_order(_torch(inp)), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    want_ref = jref.mamba_scan_ref(*map(jnp.asarray, _order(inp)))
    want_pallas = pallas_scan(*map(jnp.asarray, _order(inp)), chunk=chunk,
                              interpret=True)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), rtol=TOL,
                                   atol=TOL)
    assert ops.mamba_scan is MS.mamba_scan
    assert ref.mamba_scan_ref is MS.mamba_scan_plain


def test_scan_chunk_and_chaining_bit_identical():
    """Every chunk gives the same bits; S + k steps in one call equal S
    steps then k calls of one step chained through h0."""
    s, k = 37, 4
    t = _torch(_scan_inputs(2, s + k, 32, 16, seed=1))
    full = MS.mamba_scan(*_order(t), chunk=128)
    for chunk in (1, 64, 256):
        y, h = MS.mamba_scan(*_order(t), chunk=chunk)
        assert torch.equal(y, full[0]) and torch.equal(h, full[1])
    head = {kk: (v[:, :s] if v.dim() == 3 and v.shape[1] == s + k else v)
            for kk, v in t.items()}
    y, h = MS.mamba_scan(*_order(head))
    ys = [y]
    for i in range(s, s + k):
        step = {kk: (v[:, i:i + 1] if v.dim() == 3 and v.shape[1] == s + k
                     else v) for kk, v in t.items()}
        step["h0"] = h
        y, h = MS.mamba_scan(*_order(step))
        ys.append(y)
    assert torch.equal(torch.cat(ys, 1), full[0])
    assert torch.equal(h, full[1])


def test_scan_stacked_state_layout():
    """h0 stacked per rank, (R, B, D/R, N), gives the global layout's y and
    h_last, in the stacked layout, written into ``h_out`` when given."""
    r = 4
    t = _torch(_scan_inputs(3, 9, 32, 8, seed=2))
    want_y, want_h = MS.mamba_scan(*_order(t))
    h0 = t["h0"].reshape(3, r, 8, 8).movedim(1, 0).contiguous()
    t_st = dict(t, h0=h0)
    y, h = MS.mamba_scan(*_order(t_st))
    assert h.shape == (r, 3, 8, 8)
    assert torch.equal(y, want_y)
    assert torch.equal(h.movedim(0, 1).reshape(3, 32, 8), want_h)
    out = torch.empty(2, r, 3, 8, 8)
    y2, h2 = MS.mamba_scan(*_order(t_st), h_out=out[1])
    assert h2.data_ptr() == out[1].data_ptr() and torch.equal(h2, h)
    assert torch.equal(y2, want_y)


def test_scan_rejects_bad_inputs():
    t = _torch(_scan_inputs(2, 4, 16, 8))
    with pytest.raises(ValueError, match="h0"):
        MS.mamba_scan(*_order(dict(t, h0=t["h0"][:, :8])))
    with pytest.raises(ValueError, match="b, c"):
        MS.mamba_scan(*_order(dict(t, b_ssm=t["b_ssm"][..., :4])))
    with pytest.raises(ValueError, match="chunk"):
        MS.mamba_scan(*_order(t), chunk=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        MS.mamba_scan(*_order({k: v.to("meta") for k, v in t.items()}))


# ---------------------------------------------------------------------------
# The mamba block
# ---------------------------------------------------------------------------

def _layer(mesh_shape):
    """Layer 0's mamba weights: (jax numpy tree, port tree, port cfg,
    port rules), the port's stacked per rank on a mesh."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    run = dict(fsdp=False, decode_seq_shard=mesh_shape is not None)
    jparams = JT.init_params(JT.param_template(jcfg, JaxRun(**run), None),
                             jax.random.PRNGKey(0), jcfg.d_model)
    rules = (ShardingRules(VirtualMesh(mesh_shape, ("data", "model")),
                           RunConfig(**run)) if mesh_shape else None)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, RunConfig(**run), rules)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["mamba"])
    tp = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mamba"].items()}
    return jcfg, jp, tcfg, tp, rules


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
@pytest.mark.parametrize("cached", [False, True])
def test_mamba_mix_matches_jax(mesh_shape, cached):
    """The mix from a zero state, or from a state and conv tail (returning
    the new ones), on global or per-rank stacked weights."""
    jcfg, jp, tcfg, tp, _ = _layer(mesh_shape)
    b, s, di, n, ck = 3, 7, tcfg.d_inner, tcfg.ssm_state, tcfg.conv_kernel
    x = _np((b, s, di), 1)
    state = dict(h0=_np((b, di, n), 2),
                 conv_state=_np((b, ck - 1, di), 3)) if cached else {}
    want = jax.jit(partial(JS.mamba_mix, cfg=jcfg, return_state=cached))(
        jp, x, **state)
    with torch.no_grad():
        got = S.mamba_mix(tp, torch.from_numpy(x), tcfg, return_state=cached,
                          **{k: torch.from_numpy(v) for k, v in state.items()})
    if cached:
        want, got = (want[0], *want[1]), (got[0], *got[1])
        tail = got[2]              # owns its storage: frees the layer input
        assert tail.untyped_storage().nbytes() == \
            tail.numel() * tail.element_size()
    else:
        want, got = (want,), (got,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("mesh_shape", [None, (1, 4)])
@pytest.mark.parametrize("cached", [False, True])
def test_mamba_block_matches_jax(mesh_shape, cached):
    """The block on global weights (no mesh) or per-rank stacked ones (the
    x/z split of in_proj crosses ranks on (1, 4)); with a cache the state
    and conv tail go in and come out in the serving cache's layout."""
    jcfg, jp, tcfg, tp, rules = _layer(mesh_shape)
    b, s, d = 3, 6, tcfg.d_model
    di, n, ck = tcfg.d_inner, tcfg.ssm_state, tcfg.conv_kernel
    x = _np((b, s, d), 4)
    h0, conv = _np((b, di, n), 5), _np((b, ck - 1, di), 6)
    jrun, trun = JaxRun(fsdp=False), RunConfig(fsdp=False)
    jcache = (h0, conv) if cached else None
    want, wcache = jax.jit(partial(JS.mamba_block, cfg=jcfg, run=jrun,
                                   rules=None))(jp, x, cache=jcache)
    tcache = None
    if cached:
        th0, tconv = torch.from_numpy(h0), torch.from_numpy(conv)
        if rules is not None:       # the serving cache's stacked layout
            th0 = th0.unflatten(1, (4, di // 4)).movedim(1, 0).contiguous()
            tconv = tconv.unflatten(2, (4, di // 4)).permute(2, 0, 1, 3) \
                .contiguous()
        tcache = (th0, tconv)
    with torch.no_grad():
        got, gcache = S.mamba_block(tp, torch.from_numpy(x), tcfg, trun,
                                    rules, cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if not cached:
        assert gcache is None and wcache is None
        return
    gh, gconv = gcache
    if rules is not None:
        assert gh.shape == (4, b, di // 4, n)
        assert gconv.shape == (4, b, ck - 1, di // 4)
        gh = gh.movedim(0, 1).reshape(b, di, n)
        gconv = gconv.permute(1, 2, 0, 3).reshape(b, ck - 1, di)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wcache[0]), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(gconv.numpy(), np.asarray(wcache[1]))


def test_causal_conv_and_init_cache_match_jax():
    rng = np.random.default_rng(7)
    x, w, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 5, 12), (12, 4), (12,)))
    np.testing.assert_allclose(
        S._causal_conv1d(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(JS._causal_conv1d(x, w, b)), atol=TOL, rtol=TOL)
    tcfg = get_config(ARCH).reduced()
    jcfg = jax_config(ARCH).reduced()
    for got, want in zip(S.init_mamba_cache(tcfg, 3),
                         JS.init_mamba_cache(jcfg, 3)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()


def test_bf16_scan_dtype_is_training_only():
    """The serving path (a block with a cache) does not read the bf16 scan
    dtype, as in JAX: the block still equals JAX's under that run option.
    The training forward, which would read it, raises naming A10b."""
    from repro_torch.models import transformer as T
    jcfg, jp, tcfg, tp, _ = _layer(None)
    b, s, d = 2, 4, tcfg.d_model
    di, n, ck = tcfg.d_inner, tcfg.ssm_state, tcfg.conv_kernel
    x = _np((b, s, d), 8)
    cache = (_np((b, di, n), 9), _np((b, ck - 1, di), 10))
    want, _ = jax.jit(partial(
        JS.mamba_block, cfg=jcfg, run=JaxRun(fsdp=False,
                                             ssm_scan_dtype="bfloat16"),
        rules=None))(jp, x, cache=cache)
    run = RunConfig(fsdp=False, ssm_scan_dtype="bfloat16")
    with torch.no_grad():
        got, _ = S.mamba_block(tp, torch.from_numpy(x), tcfg, run, None,
                               cache=tuple(map(torch.from_numpy, cache)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    with pytest.raises(NotImplementedError, match="A10b"):
        T.forward_train({}, {}, tcfg, run, None)
