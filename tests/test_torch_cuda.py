"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (marker ``gpu``);
run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The tolerances are those of chip_smoke.py: relative Frobenius error
<= 1e-2 for bf16 outputs (rounding of bf16 results, P rounded to bf16 in
the attention kernel) and <= 1e-3 for the f32 output of the GEMM+AR kernel
(f32 sums taken in another order).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale
            ).to(torch.bfloat16)


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (130, 264, 136),
                                   (8, 2048, 8000), (2048, 2048, 1408),
                                   (1024, 2048, 8000), (8, 4096, 16256)]
                         + [(m, k, n) for m in (1, 8, 16, 63, 64, 65, 200)
                            for k, n in ((40, 72), (264, 136))])
def test_matmul_kernel(cuda, m, k, n):
    from repro_torch.kernels import matmul as MM
    x = _randn(cuda, m, k, seed=1)
    w = _randn(cuda, k, n, scale=k ** -0.5, seed=2)
    before = MM.matmul.launches
    got = MM.matmul(x, w)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel(got, MM.matmul_plain(x, w)) <= 1e-2


@pytest.mark.parametrize("m,k,n,r", [(8, 2048, 8000, 4), (1024, 2048, 8000, 4),
                                     (65, 264, 136, 3), (1, 40, 72, 8),
                                     (200, 40, 72, 2)])
def test_matmul_stacked_kernel_equals_single_launches(cuda, m, k, n, r):
    """One launch over R stacked shards gives the bits of R launches, and a
    second call the same bits."""
    from repro_torch.kernels import matmul as MM
    x = _randn(cuda, m, k, seed=1)
    w = _randn(cuda, r, k, n, scale=k ** -0.5, seed=2)
    before = MM.matmul.launches
    got = MM.matmul_stacked(x, w)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + 1
    assert got.shape == (r, m, n) and got.dtype == torch.bfloat16
    assert _rel(got, MM.matmul_stacked_plain(x, w)) <= 1e-2
    assert torch.equal(got, torch.stack([MM.matmul(x, w[j])
                                         for j in range(r)]))
    assert torch.equal(got, MM.matmul_stacked(x, w))


def test_matmul_kernel_refuses_misaligned_views(cuda):
    """A view whose base is not 16-byte aligned raises before any launch."""
    from repro_torch.kernels import matmul as MM
    buf = _randn(cuda, 8 * 64 + 8, seed=1)
    x = buf[1:1 + 8 * 64].view(8, 64)             # base 2 bytes off
    w = _randn(cuda, 64, 64, seed=2)
    ws = _randn(cuda, 2, 64, 64, seed=3)
    before = MM.matmul.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        MM.matmul(x, w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        MM.matmul_stacked(x, ws)
    with pytest.raises(ValueError, match="16-byte aligned"):
        MM.matmul(x.contiguous(), buf[1:1 + 64 * 8].view(64, 8))
    assert MM.matmul.launches == before


@pytest.mark.parametrize("b,hq,hkv,s,hd,causal,window", [
    (1, 4, 2, 100, 64, True, None),
    (2, 8, 2, 200, 128, True, 32),
    (1, 2, 2, 64, 64, False, None),
    (1, 4, 1, 130, 128, True, None),
    (4, 32, 4, 512, 64, True, None),
])
def test_flash_attention_kernel(cuda, b, hq, hkv, s, hd, causal, window):
    from repro_torch.kernels import flash_attention as FA
    q = _randn(cuda, b, hq, s, hd, seed=1)
    k = _randn(cuda, b, hkv, s, hd, seed=2)
    v = _randn(cuda, b, hkv, s, hd, seed=3)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape
    assert _rel(got, want) <= 1e-2


def test_flash_attention_kernel_strided_qkv(cuda):
    """q/k/v as the prefill path passes them: head-transposed views."""
    from repro_torch.kernels import flash_attention as FA
    b, s, hq, hkv, hd = 2, 96, 8, 2, 64
    q = _randn(cuda, b, s, hq, hd, seed=1).transpose(1, 2)
    k = _randn(cuda, b, s, hkv, hd, seed=2).transpose(1, 2)
    v = _randn(cuda, b, s, hkv, hd, seed=3).transpose(1, 2)
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("r,m,k,n", [(2, 8, 64, 64), (4, 200, 96, 136),
                                     (4, 8, 1408, 2048), (4, 2048, 1408, 2048)])
def test_matmul_ar_kernel(cuda, r, m, k, n):
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, r, m, k, seed=1)
    w = _randn(cuda, r, k, n, scale=(r * k) ** -0.5, seed=2)
    want = CM.matmul_ar_plain(x, w)
    for _ in range(2):              # the arrival flags reset between launches
        got = CM.matmul_ar_fused(x, w, n_chunks=2)
        torch.cuda.synchronize()
        assert got.shape == (r, m, n) and got.dtype == torch.float32
        assert _rel(got, want) <= 1e-3
        assert torch.equal(got[0], got[-1])     # the same on every rank


@pytest.mark.parametrize("r,shape,dtype", [
    (2, (4, 24), torch.bfloat16), (4, (3, 5), torch.bfloat16),
    (8, (6, 7), torch.float32), (2, (5, 3), torch.uint8),
    (2, (4, 1024, 1408), torch.bfloat16), (8, (8, 2048), torch.float32)])
def test_ring_all_gather_kernel(cuda, r, shape, dtype):
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn((r, *shape), device=cuda) * 50).to(dtype)
    want = PK.all_gather_plain(x)
    before = PK.ring_all_gather.launches
    for nc in (1, 2, 3, 4):             # a copy: exact for every chunking
        got = PK.ring_all_gather(x, n_chunks=nc)
        torch.cuda.synchronize()
        assert got.shape == (r, r, *shape) and got.dtype == dtype
        assert torch.equal(got, want)
    assert PK.ring_all_gather.launches == before + 4


@pytest.mark.parametrize("r,shape,dtype", [
    (2, (4, 24), torch.bfloat16), (4, (3, 5), torch.bfloat16),
    (8, (6, 7), torch.float32), (4, (16, 2048), torch.float32),
    (2, (4, 1024, 1408), torch.bfloat16)])
def test_ring_reduce_scatter_kernel(cuda, r, shape, dtype):
    """f32 sums in rank order, rounded once: the plain version's arithmetic,
    so the results are equal, for every chunking and launch."""
    from repro_torch.kernels import pk_comm as PK
    x = torch.randn((r, r, *shape), device=cuda).to(dtype)
    want = PK.reduce_scatter_plain(x)
    for nc in (1, 3, 4, 1):
        got = PK.ring_reduce_scatter(x, n_chunks=nc)
        torch.cuda.synchronize()
        assert got.shape == (r, *shape) and got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("g,c,k,n", [(3, 1, 40, 72), (5, 70, 136, 64),
                                     (2, 3, 8, 8), (64, 1, 2048, 1408),
                                     (64, 240, 1408, 2048)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_kernel(cuda, g, c, k, n, out_dtype):
    """Every group in one launch, ragged C masked; f32 output against the
    plain f32 product within 1e-3 (sums in another order), bf16 within
    1e-2 (one rounding)."""
    from repro_torch.kernels import grouped_matmul as GM
    x = _randn(cuda, g, c, k, seed=1)
    w = _randn(cuda, g, k, n, scale=k ** -0.5, seed=2)
    before = GM.grouped_matmul.launches
    got = GM.grouped_matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert GM.grouped_matmul.launches == before + 1
    assert got.shape == (g, c, n) and got.dtype == out_dtype
    want = GM.grouped_matmul_plain(x, w, out_dtype=torch.float32)
    assert _rel(got, want) <= (1e-3 if out_dtype == torch.float32 else 1e-2)


def test_grouped_matmul_kernel_strided_groups(cuda):
    """A stacked weight viewed as groups without a copy, and x broadcast to
    every group with a group stride of 0 (the dense MoE oracle's input)."""
    from repro_torch.kernels import grouped_matmul as GM
    w = _randn(cuda, 2, 1, 3, 64, 48, scale=0.125, seed=3)
    x = _randn(cuda, 10, 64, seed=4).expand(6, 10, 64)
    got = GM.grouped_matmul(x, w.reshape(6, 64, 48), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, GM.grouped_matmul_plain(
        x, w.reshape(6, 64, 48), out_dtype=torch.float32)) <= 1e-3
    with pytest.raises(ValueError, match="N % 8"):
        GM.grouped_matmul(x, _randn(cuda, 6, 64, 12))
    with pytest.raises(ValueError, match="bf16"):
        GM.grouped_matmul(x.float(), w.reshape(6, 64, 48).float())


@pytest.mark.parametrize("c,k,n", [(1, 2048, 1408), (60, 1408, 2048),
                                   (240, 2048, 1408), (240, 1408, 2048)])
def test_grouped_matmul_kernel_bits_invariant_to_groups(cuda, c, k, n):
    """A group's output is the same bits launched among 64 groups, alone,
    among 16 and on a second call: the plan's tile is one group's, and each
    output element is one block's K loop, in order."""
    from repro_torch.kernels import grouped_matmul as GM
    x = _randn(cuda, 64, c, k, seed=10)
    w = _randn(cuda, 64, k, n, scale=k ** -0.5, seed=11)
    full = GM.grouped_matmul(x, w, out_dtype=torch.float32)
    assert torch.equal(GM.grouped_matmul(x, w, out_dtype=torch.float32), full)
    for z in (0, 17, 63):
        alone = GM.grouped_matmul(x[z:z + 1], w[z:z + 1],
                                  out_dtype=torch.float32)
        assert torch.equal(alone[0], full[z])
    assert torch.equal(GM.grouped_matmul(x[16:32], w[16:32],
                                         out_dtype=torch.float32),
                       full[16:32])


@pytest.mark.parametrize("k", [40, 136])
@pytest.mark.parametrize("broadcast", [False, True])
def test_grouped_matmul_kernel_zero_fills_inside_each_group(cuda, k,
                                                            broadcast):
    """Ragged K (and C, N) with every odd group's w filled with inf. TMA's
    zero fill is per dimension of the 3-D maps, so an even group's last K
    box reads zeros past K inside its own group, never the next group's
    inf rows (0 * inf would be NaN): the even groups' outputs are finite
    and match the plain version."""
    from repro_torch.kernels import grouped_matmul as GM
    g, c, n = 6, 5, 72
    x = (_randn(cuda, c, k, seed=12).expand(g, c, k) if broadcast
         else _randn(cuda, g, c, k, seed=12))
    w = _randn(cuda, g, k, n, scale=k ** -0.5, seed=13)
    w[1::2] = float("inf")
    want = GM.grouped_matmul_plain(x[0::2], w[0::2], out_dtype=torch.float32)
    for out_dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-2)):
        got = GM.grouped_matmul(x, w, out_dtype=out_dtype)[0::2]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= tol


def test_grouped_matmul_kernel_broadcast_weight(cuda):
    """One w serving every group (a group stride of 0 on w, a map of one
    group read at group 0) against the plain version."""
    from repro_torch.kernels import grouped_matmul as GM
    x = _randn(cuda, 5, 3, 136, seed=16)
    w = _randn(cuda, 136, 72, scale=136 ** -0.5, seed=17).expand(5, 136, 72)
    got = GM.grouped_matmul(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, GM.grouped_matmul_plain(
        x, w, out_dtype=torch.float32)) <= 1e-3


def test_grouped_matmul_kernel_refused_encode_raises(cuda):
    """A view the operand check accepts but cuTensorMapEncodeTiled refuses
    (a group stride of 2^40 elements: TMA strides stay below 2^40 bytes)
    raises, and counts no launch."""
    from repro_torch.kernels import grouped_matmul as GM
    x = torch.as_strided(_randn(cuda, 8, 64, seed=14), (1, 8, 64),
                         (2 ** 40, 64, 1))
    w = _randn(cuda, 1, 64, 64, seed=15)
    before = GM.grouped_matmul.launches
    with pytest.raises(RuntimeError, match="refused"):
        GM.grouped_matmul(x, w, out_dtype=torch.float32)
    assert GM.grouped_matmul.launches == before


def test_moe_on_card_matches_plain_gemm(cuda):
    """The replicated-dispatch MoE on 4 virtual ranks, bf16: the grouped
    GEMM kernel against the same function with the plain GEMM on the same
    inputs (the routing is the same, only the GEMM differs)."""
    from unittest import mock

    from repro_torch.core import moe
    from repro_torch.core.comms import CommContext
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.kernels import grouped_matmul as GM
    r, t, d, ff, e, k = 4, 64, 128, 96, 8, 2
    x = _randn(cuda, t, d, seed=5).expand(r, t, d)
    router = torch.randn(d, e, device=cuda).expand(r, d, e)
    w1, w3 = (_randn(cuda, r, e // r, d, ff, scale=d ** -0.5, seed=s)
              for s in (6, 7))
    w2 = _randn(cuda, r, e // r, ff, d, scale=ff ** -0.5, seed=8)
    ctx = CommContext(axis_name="model",
                      mesh=VirtualMesh((1, r), ("data", "model"), cuda))
    kw = dict(ctx=ctx, n_experts=e, top_k=k)
    got, _ = moe.pk_moe_replicated(x, router, w1, w3, w2, **kw)
    with mock.patch.object(moe, "grouped_matmul", GM.grouped_matmul_plain):
        want, _ = moe.pk_moe_replicated(x, router, w1, w3, w2, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= 1e-2


def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    y = fn(*xs)
    g = torch.randn(y.shape, device=y.device, generator=torch.Generator(
        device=y.device).manual_seed(9)).to(y.dtype)
    return y, torch.autograd.grad(y, xs, g)


def test_kernel_autograd_matches_plain(cuda):
    """The three autograd wrappers' gradients against plain-torch autograd
    of their plain versions (bf16 products: relative error <= 2e-2)."""
    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matmul as MM
    x, w = _randn(cuda, 256, 512, seed=1), _randn(cuda, 512, 384, seed=2)
    cases = [(MM.matmul, MM.matmul_plain, (x, w))]
    q = _randn(cuda, 2, 8, 128, 64, seed=3)
    k, v = _randn(cuda, 2, 2, 128, 64, seed=4), _randn(cuda, 2, 2, 128, 64,
                                                         seed=5)
    cases.append((lambda a, b, c: FA.flash_attention(a, b, c, causal=True),
                  lambda a, b, c: FA.flash_attention_plain(a, b, c,
                                                           causal=True),
                  (q, k, v)))
    xr, wr = _randn(cuda, 4, 64, 128, seed=6), _randn(cuda, 4, 128, 256,
                                                      scale=0.05, seed=7)
    cases.append((CM.matmul_ar_fused, CM.matmul_ar_plain, (xr, wr)))
    for fn, plain, args in cases:
        y, gs = _grads(fn, *args)
        y0, gs0 = _grads(plain, *args)
        assert _rel(y, y0) <= 2e-2
        for a, b in zip(gs, gs0):
            assert _rel(a, b) <= 2e-2


def test_train_on_card_runs_the_ring_kernels(cuda):
    """A small dense model (head_dim 64, as the flash kernel takes) trains
    on a (2, 2) virtual mesh with FSDP and every collective pinned to the
    kernels: each step gathers through the ring all-gather and reduces
    through the ring reduce-scatter; the losses stay finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import pk_comm as PK
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              d_model=256, head_dim=64, d_ff=512)
    run = RunConfig(fsdp=True, comm_backend="fused", microbatches=2)
    rules = ShardingRules(VirtualMesh((2, 2), ("data", "model"), cuda), run)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=cuda)
    opt = AdamW(lr=1e-3)
    state = TrainState(params, opt.init(params))
    step = make_train_step(cfg, run, rules, opt)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 4), device=cuda)
    PK.ring_all_gather.launches = PK.ring_reduce_scatter.launches = 0
    for i in range(2):
        state, m = step(state, data.batch(i))
        assert bool(torch.isfinite(m["loss"])) and m["step"] == i + 1
    assert PK.ring_all_gather.launches > 0
    assert PK.ring_reduce_scatter.launches > 0


def test_engine_on_card_continuous_matches_sequential(cuda):
    """A small dense model (head_dim 64, as the flash kernel takes) served on
    4 virtual ranks with every GEMM+AR site on the fused kernel."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.launch.serve import synthetic_trace
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.runtime.serving import ServingEngine

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              d_model=256, head_dim=64, d_ff=512)
    serve = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(16, 64),
                        max_new_tokens=6)
    run = RunConfig(fsdp=False, decode_seq_shard=True, comm_backend="fused",
                    pk_attn_out_island=True)
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), cuda), run)

    def engine():
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = T.init_params(T.param_template(cfg, run, rules), gen,
                               cfg.d_model, rules=rules, device=cuda)
        return ServingEngine(cfg, run, rules, params, serve, device=cuda)

    eng = engine()
    trace = synthetic_trace(5, serve, cfg.vocab_size, seed=0)
    done = eng.run(trace)
    assert len(done) == len(trace)
    for c in done[:2]:
        solo = engine().run([trace[c.rid]])[0]
        assert solo.tokens == c.tokens


def _scan_inputs(dev, b, s, d, n, *, bf16, seed=0, r=None):
    """dt f32 = softplus(normal); x, b, c bf16 (the model's types) or f32;
    a = -exp(normal); h0 f32 normal, stacked (R, B, D/R, N) when ``r``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def f(*sh):
        return torch.randn(sh, generator=g, device=dev)
    low = torch.bfloat16 if bf16 else torch.float32
    h0 = f(b, d, n)
    if r:
        h0 = h0.unflatten(1, (r, d // r)).movedim(1, 0).contiguous()
    return (torch.nn.functional.softplus(f(b, s, d)), f(b, s, n).to(low),
            f(b, s, n).to(low), f(b, s, d).to(low), -torch.exp(f(d, n)), h0)


@pytest.mark.parametrize("b,s,d,n,r,bf16", [
    (1, 60, 8192, 16, 4, True),         # prefill group, stacked state
    (8, 1, 8192, 16, 4, True),          # decode
    (2, 129, 200, 16, None, True),      # ragged channel block, global state
    (3, 70, 96, 8, 2, False),           # N = 8 (the reduced configs), f32
    (1, 5, 64, 32, None, False),        # N = 32: one channel a warp
])
def test_mamba_scan_kernel(cuda, b, s, d, n, r, bf16):
    from repro_torch.kernels import mamba_scan as MS
    args = _scan_inputs(cuda, b, s, d, n, bf16=bf16, r=r)
    before = MS.mamba_scan.launches
    y, h = MS.mamba_scan(*args)
    torch.cuda.synchronize()
    assert MS.mamba_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32 and h.shape == args[5].shape
    want_y, want_h = MS.mamba_scan_plain(*args)
    assert want_h.shape == h.shape
    assert _rel(y, want_y) <= 1e-3
    assert _rel(h, want_h) <= 1e-3


def test_mamba_scan_kernel_refuses_other_dtype_mixes(cuda):
    """The kernel takes dt f32 with x, b, c all bf16 or all f32."""
    from repro_torch.kernels import mamba_scan as MS
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, 1, 4, 64, 16, bf16=True)
    for args in ((dt.bfloat16(), bm, cm, x), (dt, bm.float(), cm, x),
                 (dt, bm, cm, x.float())):
        with pytest.raises(ValueError, match="all f32 or all bf16"):
            MS.mamba_scan(*args, a, h0)


def test_mamba_scan_kernel_bit_identical_over_chunks_and_chaining(cuda):
    """Every chunk gives the same bits, and S + k steps in one launch equal
    S steps then k single steps chained through h0 (written in place into
    a slab of a larger state tensor, as the decode step does)."""
    from repro_torch.kernels import mamba_scan as MS
    s, k = 61, 4
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, 2, s + k, 512, 16, bf16=True,
                                        r=4, seed=1)
    full = MS.mamba_scan(dt, bm, cm, x, a, h0)
    for chunk in (1, 64, 256):
        y, h = MS.mamba_scan(dt, bm, cm, x, a, h0, chunk=chunk)
        assert torch.equal(y, full[0]) and torch.equal(h, full[1])
    y, h = MS.mamba_scan(dt[:, :s], bm[:, :s], cm[:, :s], x[:, :s], a, h0)
    ys = [y]
    slab = torch.empty((k, *h0.shape), device=cuda)
    for i in range(s, s + k):
        y, h = MS.mamba_scan(dt[:, i:i + 1], bm[:, i:i + 1], cm[:, i:i + 1],
                             x[:, i:i + 1], a, h, h_out=slab[i - s])
        ys.append(y)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(ys, 1), full[0])
    assert torch.equal(h, full[1])


def test_ssm_engine_on_card_continuous_matches_sequential(cuda):
    """The reduced falcon-mamba served on 4 virtual ranks: every selective
    scan goes through the kernel (one launch a layer a step), and
    continuous batching equals one request at a time."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.launch.serve import build_engine, synthetic_trace

    serve = ServeConfig(max_batch=4, prefill_batch=2, bucket_edges=(16, 64),
                        max_new_tokens=6, exact_buckets=True)

    def engine():
        return build_engine("falcon-mamba-7b", reduced=True,
                            mesh_shape=(1, 4), serve=serve, device=cuda)

    eng = engine()
    trace = synthetic_trace(5, serve, eng.cfg.vocab_size, seed=0)
    MS.mamba_scan.launches = 0
    done = eng.run(trace)
    assert len(done) == len(trace)
    assert MS.mamba_scan.launches == eng.cfg.n_layers * eng.step_no
    for c in done[:2]:
        solo = engine().run([trace[c.rid]])[0]
        assert solo.tokens == c.tokens


@pytest.mark.parametrize("shape,dtype", [
    ((4, 1, 4, 2048, 64), torch.bfloat16), ((4, 3, 5, 7), torch.float32),
    ((2, 9), torch.bfloat16), ((3, 5), torch.uint8), ((8, 6, 130),
                                                      torch.float32)])
def test_p2p_ring_shift_kernel(cuda, shape, dtype):
    """A copy: bit-identical to the roll, for any element count (16-byte
    words down to single bytes); every rank's flag counts its tiles."""
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn(shape, device=cuda) * 50).to(dtype)
    before = PK.p2p_ring_shift.launches
    got = PK.p2p_ring_shift(x)
    torch.cuda.synchronize()
    assert PK.p2p_ring_shift.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, PK.ring_shift_plain(x))
    flags = PK.p2p_flags(x.device, torch.cuda.current_stream().cuda_stream)
    assert bool((flags[:shape[0]] > 0).all())
    assert len(set(flags[:shape[0]].tolist())) == 1


@pytest.mark.parametrize("hd", [64, 120, 16, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_attention_hop_kernel(cuda, hd, causal, window):
    """Each of the 4 hops of 4 ranks (rank folded into the batch) against
    the plain hop: o and l within relative 1e-2 (P rounded to bf16), m
    within 1e-3 (f32 of bf16 products); fully masked rows exactly
    (NEG_INF, 0, 0)."""
    from repro_torch.kernels import flash_attention as FA
    r, b, hq, hkv, s = 4, 2, 8, 2, 96
    q = _randn(cuda, r * b, hq, s, hd, seed=1)
    k = _randn(cuda, r * b, hkv, s, hd, seed=2)
    v = _randn(cuda, r * b, hkv, s, hd, seed=3)
    before = FA.flash_attention_hop.launches
    for hop in range(r):
        got = FA.flash_attention_hop(q, k, v, ranks=r, hop=hop,
                                     causal=causal, window=window)
        want = FA.flash_attention_hop_plain(q, k, v, ranks=r, hop=hop,
                                            causal=causal, window=window)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert a.shape == w.shape and a.dtype == torch.float32
        dead = want[2] == 0
        assert _rel(got[0], want[0]) <= 1e-2 and _rel(got[2], want[2]) <= 1e-2
        assert _rel(got[1][~dead], want[1][~dead]) <= 1e-3
        assert torch.equal(got[1][dead], want[1][dead])
        assert not bool(got[2][dead].any() or got[0][dead].any())
    assert FA.flash_attention_hop.launches == before + r


@pytest.mark.parametrize("hd", [120, 16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32)])
def test_flash_attention_kernel_pads_head_dim(cuda, hd, causal, window):
    """head_dims the kernel is not instantiated for are zero-padded to the
    next width and sliced back; the scale stays the true width's."""
    from repro_torch.kernels import flash_attention as FA
    b, hq, hkv, s = 2, 8, 2, 200
    q = _randn(cuda, b, s, hq, hd, seed=1).transpose(1, 2)
    k = _randn(cuda, b, s, hkv, hd, seed=2).transpose(1, 2)
    v = _randn(cuda, b, s, hkv, hd, seed=3).transpose(1, 2)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert _rel(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)) <= 1e-2
    with pytest.raises(ValueError, match="at most 128"):
        FA.flash_attention(*(_randn(cuda, 1, 2, 8, 136, seed=i)
                             for i in range(3)))


def test_seq_sharded_train_on_card_runs_ring_kernels(cuda):
    """tinyllama-1.1b at full width cut to 2 layers, seq 1024 on (1, 4)
    with the fused ring shift: forward_train(seq_sharded=True) and its
    backward go through the p2p kernel and the flash hops (remat reruns
    the forward: 2 passes x 2 layers x 3 hops x (k, v) shifts, 2 x 2 x 4
    hops); the loss is within 1e-2 of the dense mix's and every gradient
    is finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pk_comm as PK
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import ShardingRules

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    run = RunConfig(fsdp=False, comm_backend="fused")
    rules = ShardingRules(VirtualMesh((1, 4), ("data", "model"), cuda), run)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = T.init_params(T.param_template(cfg, run, rules), gen,
                           cfg.d_model, rules=rules, device=cuda)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, 1024, 1),
                        device=cuda).batch(0)
    leaves = [p for _, p in T.leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    PK.p2p_ring_shift.launches = FA.flash_attention_hop.launches = 0
    loss, _ = T.forward_train(params, batch, cfg, run, rules,
                              seq_sharded=True)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert PK.p2p_ring_shift.launches == 2 * 2 * 3 * 2
    assert FA.flash_attention_hop.launches == 2 * 2 * 4
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        dense, _ = T.forward_train(params, batch, cfg, run, rules)
    assert abs(float(loss) - float(dense)) <= 1e-2 * abs(float(dense))


@pytest.mark.parametrize("r,m_loc,k,n", [(2, 8, 16, 8), (4, 100, 264, 200),
                                         (4, 64, 128, 192), (8, 3, 40, 24),
                                         (8, 100, 264, 200),
                                         (4, 1024, 2048, 2816)])
def test_ag_matmul_kernel(cuda, r, m_loc, k, n):
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, r, m_loc, k, seed=1)
    w = _randn(cuda, r, k, n, scale=k ** -0.5, seed=2)
    want = CM.ag_matmul_plain(x, w)
    before = CM.ag_matmul_fused.launches
    first = CM.ag_matmul_fused(x, w)
    torch.cuda.synchronize()
    assert first.shape == (r, r * m_loc, n) and first.dtype == torch.bfloat16
    assert _rel(first, want) <= 1e-2
    for nc in (2, 3, 4):            # the tiles chunk implicitly: same bits
        assert torch.equal(CM.ag_matmul_fused(x, w, n_chunks=nc), first)
    assert CM.ag_matmul_fused.launches == before + 4


@pytest.mark.parametrize("r,m,k,n", [(2, 8, 16, 8), (4, 200, 136, 120),
                                     (4, 256, 128, 192), (8, 24, 40, 16)])
def test_matmul_rs_kernel(cuda, r, m, k, n):
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, r, m, k, seed=1)
    w = _randn(cuda, r, k, n, scale=(r * k) ** -0.5, seed=2)
    want = CM.matmul_rs_plain(x, w)
    first = CM.matmul_rs_fused(x, w)
    torch.cuda.synchronize()
    assert first.shape == (r, m // r, n) and first.dtype == torch.float32
    assert _rel(first, want) <= 1e-3
    for nc in (2, 3, 4):            # the arrival flags reset between launches
        assert torch.equal(CM.matmul_rs_fused(x, w, n_chunks=nc), first)


@pytest.mark.parametrize("r,m,k,n", [(4, 8, 1408, 2048), (4, 8, 512, 2048),
                                     (4, 200, 136, 120), (8, 24, 40, 16),
                                     (2, 260, 64, 72), (4, 4096, 1408, 2048)])
def test_matmul_rs_equals_ar_owner_rows(cuda, r, m, k, n):
    """GEMM×RS and GEMM×AR run one plan and one rank-ordered sum: RS's
    block o is AR's rows o·m/R.. on every rank, bit for bit, and a second
    call gives the same bits. Covers both decode shapes (m/R = 2: one tile
    spans every owner) and m/R not a multiple of the tile height."""
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, r, m, k, seed=1)
    w = _randn(cuda, r, k, n, scale=(r * k) ** -0.5, seed=2)
    before = (CM.matmul_ar_fused.launches, CM.matmul_rs_fused.launches)
    ar, rs = CM.matmul_ar_fused(x, w), CM.matmul_rs_fused(x, w)
    torch.cuda.synchronize()
    assert (CM.matmul_ar_fused.launches, CM.matmul_rs_fused.launches) == \
        (before[0] + 1, before[1] + 1)
    assert _rel(ar, CM.matmul_ar_plain(x, w)) <= 1e-3
    blk = m // r
    for o in range(r):
        for d in range(r):
            assert torch.equal(rs[o], ar[d, o * blk:(o + 1) * blk])
    assert torch.equal(CM.matmul_ar_fused(x, w), ar)
    assert torch.equal(CM.matmul_rs_fused(x, w), rs)


def test_matmul_reduce_kernels_refuse_misaligned_slabs(cuda):
    """A slab whose base is not 16-byte aligned raises before any launch
    (the kernels read every slab through a TMA tensor map)."""
    from repro_torch.kernels import collective_matmul as CM
    buf = _randn(cuda, 4 * 8 * 64 + 8, seed=1)
    x = buf[1:1 + 4 * 8 * 64].view(4, 8, 64)      # base 2 bytes off
    w = _randn(cuda, 4, 64, 64, seed=2)
    wbuf = _randn(cuda, 4 * 64 * 64 + 8, seed=3)
    w_off = wbuf[4:4 + 4 * 64 * 64].view(4, 64, 64)  # base 8 bytes off
    before = (CM.matmul_ar_fused.launches, CM.matmul_rs_fused.launches)
    for fn in (CM.matmul_ar_fused, CM.matmul_rs_fused):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(x, w)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(x.contiguous().clone(), w_off)
    assert (CM.matmul_ar_fused.launches,
            CM.matmul_rs_fused.launches) == before


@pytest.mark.parametrize("r,m,k,n", [(4, 8, 0, 64), (4, 0, 64, 64),
                                     (4, 8, 64, 0)])
def test_matmul_reduce_kernels_count_no_launch_when_empty(cuda, r, m, k, n):
    """A K = 0 or empty call returns zeros (or nothing) and launches no
    kernel, so it leaves both launch counts as they were."""
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, r, m, k, seed=1)
    w = _randn(cuda, r, k, n, seed=2)
    before = (CM.matmul_ar_fused.launches, CM.matmul_rs_fused.launches)
    ar, rs = CM.matmul_ar_fused(x, w), CM.matmul_rs_fused(x, w)
    assert (CM.matmul_ar_fused.launches,
            CM.matmul_rs_fused.launches) == before
    assert ar.shape == (r, m, n) and rs.shape == (r, m // r, n)
    assert not ar.any() and not rs.any()


def test_gemm_collective_kernels_refuse_gradients(cuda):
    from repro_torch.kernels import collective_matmul as CM
    x = _randn(cuda, 4, 16, 32, seed=1).requires_grad_(True)
    w = _randn(cuda, 4, 32, 16, seed=2)
    for fn in (CM.ag_matmul_fused, CM.matmul_rs_fused):
        with pytest.raises(NotImplementedError, match="C9"):
            fn(x, w)
        with torch.no_grad():
            fn(x, w)


@pytest.mark.parametrize("r,shape,dtype", [
    (2, (4, 24), torch.bfloat16), (4, (3, 5), torch.bfloat16),
    (8, (6, 7), torch.float32), (4, (1001,), torch.uint8),
    (2, (1024, 4, 1408), torch.bfloat16), (8, (256, 4, 1408), torch.bfloat16),
    (1, (8, 8), torch.float32)])
def test_lcsc_ring_all_gather_kernel(cuda, r, shape, dtype):
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn((r, *shape), device=cuda) * 50).to(dtype)
    before = LC.lcsc_ring_all_gather.launches
    for _ in range(2):              # the arrival flags reset between launches
        got = LC.lcsc_ring_all_gather(x)
        torch.cuda.synchronize()
        assert got.shape == (r, r, *shape) and got.dtype == dtype
        assert torch.equal(got, PK.all_gather_plain(x))
        assert torch.equal(got, PK.ring_all_gather(x))
    assert LC.lcsc_ring_all_gather.launches == before + 2
