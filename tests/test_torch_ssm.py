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


#: (B, S, D, N, bytes of x, b, c): falcon-mamba-7b's scan at the SSM
#: serving path's shapes (prefill groups of 4 rows, a B = 1 prefill,
#: decode of 8 rows), the reduced config's width and the widths the card's
#: tests take
SCAN_PLAN_SHAPES = [(4, 60, 8192, 16, 2), (4, 174, 8192, 16, 2),
                    (4, 405, 8192, 16, 2), (1, 405, 8192, 16, 2),
                    (8, 1, 8192, 16, 2), (2, 64, 128, 8, 2),
                    (2, 129, 200, 16, 2), (3, 70, 96, 8, 4),
                    (1, 5, 64, 32, 4), (2, 70, 200, 8, 2),
                    (2, 70, 200, 32, 4), (2, 33, 98, 16, 2),
                    (2, 7, 64, 4, 2), (1, 9, 40, 1, 4)]
#: what two blocks an SM may take each (233,472 bytes an SM, 1 KB reserved
#: a block)
TWO_A_SM = 233472 // 2 - 1024


@pytest.mark.parametrize("b,s,d,n,elsize", SCAN_PLAN_SHAPES)
def test_scan_plan_covers_every_row_channel_and_state_once(b, s, d, n,
                                                          elsize):
    """The CUDA scan's launch, held on the CPU: blocks (channel tile, row)
    and lanes (channel, state group) give every (row, channel, state)
    exactly one lane; whole warps; the staged kernel where TMA takes the
    operands and S > 1, with a run of steps that fits and shared memory
    within a block's limit — two blocks an SM at the path's prefill."""
    p = MS.scan_plan(b, s, d, n, elsize)
    consumers = p.channels * p.lanes
    assert p.k_states == min(4, n) and p.k_states * p.lanes == n
    assert consumers % 32 == 0 and consumers <= MS.MAX_CONSUMERS
    assert p.grid == (-(-d // p.channels), b)
    tid = np.arange(consumers)
    ch, group = tid // p.lanes, tid % p.lanes
    covered = np.zeros((b, d, n), np.int16)
    for tile in range(p.grid[0]):
        dd = tile * p.channels + ch
        live = dd < d
        for j in range(p.k_states):
            covered[:, dd[live], group[live] * p.k_states + j] += 1
    assert (covered == 1).all()
    assert p.staged == (s > 1 and d % 4 == 0 and n * elsize >= 16)
    if p.staged:
        assert 1 <= p.run <= min(MS.RUN_MAX, s) and p.stages == MS.STAGES
        assert p.threads == consumers + 32
        assert p.smem_bytes == MS.staged_smem(p.channels, p.run, n, elsize,
                                              p.stages) <= MS.SMEM_LIMIT
        if d == 8192:
            assert p.smem_bytes <= TWO_A_SM
    else:
        assert (p.run, p.stages, p.smem_bytes) == (0, 0, 0)
        assert p.threads == consumers


def test_scan_plan_chunk_caps_the_run_and_tma_ok_reads_the_operands():
    """``chunk`` caps the steps a stage holds (never the result, see the
    bit-identity tests); a view off 16 bytes or a row stride TMA cannot
    take sends the scan to the direct kernel."""
    assert MS.scan_plan(4, 405, 8192, 16, 2, chunk=1).run == 1
    assert MS.scan_plan(4, 405, 8192, 16, 2, chunk=7).run == 7
    assert MS.scan_plan(4, 5, 8192, 16, 2).run == 5
    assert not MS.scan_plan(4, 405, 8192, 16, 2, tma_ok=False).staged
    assert MS._tma_ok(torch.zeros(2, 9, 68)[:, :, :64])   # rows 272 B apart
    assert not MS._tma_ok(torch.zeros(2, 9, 65)[:, :, :64])   # 260 B
    flat = torch.zeros(2, 9, 64)
    assert MS._tma_ok(flat) and not MS._tma_ok(flat[:, :, 1:])  # base + 4 B
    # a batch of one has no batch stride to check
    odd = torch.zeros(1000).as_strided((1, 9, 64), (577, 64, 1))
    assert MS._tma_ok(odd) and not MS._tma_ok(
        torch.zeros(2000).as_strided((2, 9, 64), (577, 64, 1)))
    with pytest.raises(ValueError, match="power of two"):
        MS.scan_plan(1, 4, 64, 12, 2)


def test_scan_rejects_bad_inputs():
    t = _torch(_scan_inputs(2, 4, 16, 8))
    with pytest.raises(ValueError, match="h0"):
        MS.mamba_scan(*_order(dict(t, h0=t["h0"][:, :8])))
    with pytest.raises(ValueError, match="b, c"):
        MS.mamba_scan(*_order(dict(t, b_ssm=t["b_ssm"][..., :4])))
    with pytest.raises(ValueError, match="chunk"):
        MS.mamba_scan(*_order(t), chunk=0)
    # meta is the dry-run's device: the card's outputs, its launch recorded
    # on the counter (``.launches`` counts the card's alone), no data
    from repro_torch.roofline import counters
    n = MS.mamba_scan.launches
    with counters.StepCounter("meta") as c:
        y, h = MS.mamba_scan(*_order({k: v.to("meta")
                                      for k, v in t.items()}))
    assert y.is_meta and y.shape == t["dt"].shape and y.dtype == torch.float32
    assert h.shape == t["h0"].shape and dict(c.launches) == {"mamba_scan": 1}
    assert MS.mamba_scan.launches == n


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
    The forward without a cache reads it (ROADMAP A10e): JAX's bf16 scan,
    held within 2e-2 (bf16 terms; ``tests/test_torch_ssm_bf16.py``)."""
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
    want, _ = jax.jit(partial(
        JS.mamba_block, cfg=jcfg, run=JaxRun(fsdp=False,
                                             ssm_scan_dtype="bfloat16"),
        rules=None))(jp, x)
    with torch.no_grad():
        got, _ = S.mamba_block(tp, torch.from_numpy(x), tcfg, run, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)
    params = T.init_params(T.param_template(tcfg, run, None),
                           torch.Generator().manual_seed(0), tcfg.d_model,
                           device="cpu")
    batch = {"tokens": torch.zeros(b, s, dtype=torch.long),
             "targets": torch.zeros(b, s, dtype=torch.long),
             "weights": torch.ones(b, s)}
    total, _ = T.forward_train(params, batch, tcfg, run, None)
    assert torch.isfinite(total)
