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
import math

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
                                     (200, 40, 72, 2), (8, 1024, 12967, 4),
                                     (3, 40, 13, 2), (8, 2048, 8000, 16),
                                     (65, 264, 136, 11)])
def test_matmul_stacked_kernel_equals_single_launches(cuda, m, k, n, r):
    """One launch over R stacked shards gives the bits of R launches, and a
    second call the same bits; a row length N that is no multiple of 8
    (whisper's vocab shard, 12967 columns) takes w stored in rows padded
    to 16 bytes, as the head is, and gives a view of padded rows. More
    than ``MAX_SLABS`` (8) shards — 16 tp ranks, or an uneven 11 — take
    one launch a ``MAX_SLABS``, with the same bits."""
    from repro_torch.core import pgl
    from repro_torch.kernels import matmul as MM
    x = _randn(cuda, m, k, seed=1)
    w = pgl.aligned_rows(_randn(cuda, r, k, n, scale=k ** -0.5, seed=2))
    before = MM.matmul.launches
    got = MM.matmul_stacked(x, w)
    torch.cuda.synchronize()
    assert MM.matmul.launches == before + -(-r // MM.MAX_SLABS)
    assert got.shape == (r, m, n) and got.dtype == torch.bfloat16
    assert got.stride(-2) == -(-n // 8) * 8
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
    # a ragged row length in contiguous rows: the head is stored padded
    with pytest.raises(ValueError, match="16-byte aligned"):
        MM.matmul(x.contiguous(), _randn(cuda, 64, 13, seed=4))
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
    """A copy: bit-identical to the plain gather and to the kernel it ran on
    before for every chunking, on the TMA route or the word route as the
    plan names it; the output is contiguous."""
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn((r, *shape), device=cuda) * 50).to(dtype)
    want = PK.all_gather_plain(x)
    assert torch.equal(_chip_smoke().mm_tile_all_gather(x), want)
    before = PK.ring_all_gather.launches
    for nc in (1, 2, 3, 4):             # a copy: exact for every chunking
        got = PK.ring_all_gather(x, n_chunks=nc)
        torch.cuda.synchronize()
        assert got.shape == (r, r, *shape) and got.dtype == dtype
        assert got.is_contiguous() and torch.equal(got, want)
    assert PK.ring_all_gather.launches == before + 4
    p = PK.ag_plan(r, shape, x.stride()[1:], x.stride(0), 0,
                   x.element_size(), addr=x.data_ptr())
    assert p.route == ("tma" if shape[-1] in (24, 1408, 2048) else "word")


#: full-width tinyllama-1.1b's FSDP-sharded weights, tp-stacked over 4
#: ranks as stored, and the stored dim their gather runs along: rows (wq,
#: wk/wv, w1/w3, head) and columns (wo, w2, emb)
FSDP_WEIGHTS = [((4, 2048, 512), 1), ((4, 2048, 64), 1),
                ((4, 2048, 1408), 1), ((4, 2048, 8000), 1),
                ((4, 512, 2048), 2), ((4, 1408, 2048), 2),
                ((4, 8000, 2048), 2)]


@pytest.mark.parametrize("stored,sdim", FSDP_WEIGHTS)
@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "fsdp"])
def test_all_gather_fsdp_views_kernel(cuda, stored, sdim, r, layout):
    """The FSDP gather as the path runs it: the strided dp_view straight into
    the kernel (TMA route), into a contiguous output or the memory order
    fsdp_gather gives it (the global weight: the tp rank dim next to the
    dim tp shards), bit-identical to the bulk backend, to the plain gather
    and to the old kernel behind its old wrapper (a copy before, a strided
    view after)."""
    from repro_torch.core import pgl
    from repro_torch.core.comms import all_gather_stacked
    from repro_torch.kernels import pk_comm as PK
    w = _randn(cuda, *stored, seed=sdim)
    x = pgl.dp_view(w, sdim, r)
    assert not x.is_contiguous()
    order = {1: (1, 0, 2), 2: None}[sdim] if layout == "fsdp" else None
    empty = PK.gathered_empty(x, sdim, order)
    p = PK.ag_plan(r, x.shape[1:], x.stride()[1:], x.stride(0), sdim, 2,
                   addr=x.data_ptr(), out_strides=empty.stride())
    assert p.route == "tma"
    before = PK.ring_all_gather.launches
    got = all_gather_stacked(x, sdim, "fused", order)
    torch.cuda.synchronize()
    assert PK.ring_all_gather.launches == before + 1
    assert got.shape == (r, *stored) and got.stride() == empty.stride()
    assert got.is_contiguous() == (order is None)
    want = all_gather_stacked(x, sdim, "bulk", order)
    bits = got.view(torch.int16)
    assert torch.equal(bits, want.view(torch.int16))
    assert torch.equal(bits, PK.gather_along_plain(x, sdim).view(torch.int16))
    old = _chip_smoke().mm_tile_path_gather(x, sdim)
    assert torch.equal(bits, old.view(torch.int16))
    assert torch.equal(got[r - 1], w)


def _chip_smoke():
    """chip_smoke.py, for the yardstick kernels' wrappers (the port never
    calls them)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("r,shape,dtype", [
    (2, (4, 24), torch.bfloat16), (4, (3, 5), torch.bfloat16),
    (8, (6, 7), torch.float32), (4, (16, 2048), torch.float32),
    (2, (4, 1024, 1408), torch.bfloat16),
    (4, (512, 4, 1408), torch.bfloat16),    # the MLP shard over 4 ranks
    (8, (256, 4, 1408), torch.bfloat16),    # and over 8
    (2, (5, 4, 7), torch.bfloat16),         # 280-byte blocks: element-wise
    (2, (1000, 4, 1408), torch.bfloat16)])  # items not a multiple of grid
def test_ring_reduce_scatter_kernel(cuda, r, shape, dtype):
    """f32 sums in rank order, rounded once: the plain version's arithmetic,
    so the results are equal bit for bit, for every chunking and launch,
    and equal to the store-and-count kernel the RS ran on before."""
    from repro_torch.kernels import pk_comm as PK
    x = torch.randn((r, r, *shape), device=cuda).to(dtype)
    want = PK.reduce_scatter_plain(x)
    before_kernel = _chip_smoke().mm_tile_reduce_scatter(x)
    blk, es = x[0, 0].numel(), x.element_size()
    p = PK.rs_plan(r, blk, blk, es, aligned=blk * es % 16 == 0,
                   sms=torch.cuda.get_device_properties(cuda)
                   .multi_processor_count)
    if shape == (5, 4, 7):
        assert not p.bulk
    if shape == (1000, 4, 1408):
        assert p.bulk and p.items % p.grid
    before = PK.ring_reduce_scatter.launches
    for nc in (1, 3, 4, 1):
        got = PK.ring_reduce_scatter(x, n_chunks=nc)
        torch.cuda.synchronize()
        assert got.shape == (r, *shape) and got.dtype == dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(got.view(torch.uint8),
                           before_kernel.view(torch.uint8))
    assert PK.ring_reduce_scatter.launches == before + 4


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
    from repro_torch.kernels import decode_attention as DA
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
    before = DA.decode_attention.launches
    done = eng.run(trace)
    assert len(done) == len(trace)
    # every decode step's attention layers went through the one-pass kernel
    assert DA.decode_attention.launches - before == (
        cfg.n_layers * eng.stats()["decode_steps"])
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
    (1, 5, 64, 32, None, False),        # N = 32: 8 lanes a channel
    (1, 405, 8192, 16, 4, True),        # B = 1 prefill: 64-channel tiles
    (2, 70, 200, 8, None, True),        # N = 8 bf16, ragged channel tile
    (2, 70, 200, 32, None, False),      # N = 32 f32, ragged channel tile
    (2, 33, 98, 16, None, True),        # D % 4 != 0: the direct kernel
])
def test_mamba_scan_kernel(cuda, b, s, d, n, r, bf16):
    from repro_torch.kernels import mamba_scan as MS
    args = _scan_inputs(cuda, b, s, d, n, bf16=bf16, r=r)
    p = MS.scan_plan(b, s, d, n, args[3].element_size(),
                     tma_ok=MS._tma_ok(*args[:4]))
    assert p.staged == (s > 1 and d % 4 == 0)
    before = MS.mamba_scan.launches
    y, h = MS.mamba_scan(*args)
    torch.cuda.synchronize()
    assert MS.mamba_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32 and h.shape == args[5].shape
    want_y, want_h = MS.mamba_scan_plain(*args)
    assert want_h.shape == h.shape
    assert _rel(y, want_y) <= 1e-3
    assert _rel(h, want_h) <= 1e-3


@pytest.mark.parametrize("kernel,shape", [
    ("scan", (1, 60, 512)), ("scan", (8, 1, 512)),
    ("rs", (2, 1024, 4, 64)), ("rs", (2, 5, 4, 7))])
def test_launch_refuses_a_plan_whose_shared_memory_is_not_the_kernels(
        cuda, monkeypatch, kernel, shape):
    """The plans' shared-memory sizes are the .cu's layouts: a launch given
    other bytes (staged or direct scan, bulk or element-wise RS) is
    refused, never run."""
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import pk_comm as PK
    mod, name = (MS, "scan_plan") if kernel == "scan" else (PK, "rs_plan")
    plan = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: dataclasses.replace(
        plan(*a, **k), smem_bytes=plan(*a, **k).smem_bytes + 128))
    if kernel == "scan":
        b, s, d = shape
        args = _scan_inputs(cuda, b, s, d, 16, bf16=True, r=4)
        with pytest.raises(RuntimeError, match="pk_mamba_scan"):
            MS.mamba_scan(*args)
    else:
        r = shape[0]
        x = torch.randn((r, *shape), device=cuda).to(torch.bfloat16)
        with pytest.raises(RuntimeError, match="pk_reduce_scatter"):
            PK.ring_reduce_scatter(x)


def test_mamba_scan_kernel_refuses_other_dtype_mixes(cuda):
    """The kernel takes dt f32 with x, b, c all bf16 or all f32."""
    from repro_torch.kernels import mamba_scan as MS
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, 1, 4, 64, 16, bf16=True)
    for args in ((dt.bfloat16(), bm, cm, x), (dt, bm.float(), cm, x),
                 (dt, bm, cm, x.float())):
        with pytest.raises(ValueError, match="all f32 or all bf16"):
            MS.mamba_scan(*args, a, h0)


def test_mamba_scan_kernel_bit_identical_over_chunks_and_chaining(cuda):
    """Every chunk gives the same bits, and S + k steps in one launch (the
    staged kernel) equal S steps then k single steps (the direct kernel,
    the decode path) chained through h0 (written in place into a slab of a
    larger state tensor, as the decode step does)."""
    from repro_torch.kernels import mamba_scan as MS
    s, k = 61, 4
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, 2, s + k, 512, 16, bf16=True,
                                        r=4, seed=1)
    assert MS.scan_plan(2, s + k, 512, 16, 2).staged
    assert not MS.scan_plan(2, 1, 512, 16, 2).staged
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


@pytest.mark.parametrize("b,s,d,n,bf16", [
    (2, 512, 8192, 16, True),           # falcon's training shape
    (2, 129, 200, 8, True),             # ragged channel tile, N = 8
    (3, 70, 96, 32, False),             # N = 32, f32
])
def test_mamba_scan_bwd_kernel(cuda, b, s, d, n, bf16):
    """The scan's backward kernel against the plain reverse recurrence
    (relative Frobenius error <= 1e-3 for the f32 ddt and da; dx, db, dc
    rounded once to x's dtype, <= 1e-2 in bf16), one count a call, and
    the same bits for segments of 1, 3 and 8 steps (the path's) and on a
    second call."""
    from repro_torch.kernels import mamba_scan as MS
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, b, s, d, n, bf16=bf16)
    h0 = torch.zeros_like(h0)
    dy = torch.randn(b, s, d, device=cuda)
    before = MS.mamba_scan_bwd.launches
    got = MS.mamba_scan_bwd(dt, bm, cm, x, a, h0, dy)
    torch.cuda.synchronize()
    assert MS.mamba_scan_bwd.launches == before + 1
    want = MS.mamba_scan_bwd_plain(dt, bm, cm, x, a, h0, dy)
    for name, gv, wv in zip(("ddt", "db", "dc", "dx", "da"), got, want):
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        tol = 1e-3 if gv.dtype == torch.float32 else 1e-2
        assert _rel(gv, wv) <= tol, name
    for seg in (1, 3, MS.BWD_SEG_MAX):
        again = MS._launch_bwd(dt, bm, cm, x, a, h0, dy, seg=seg)
        assert all(torch.equal(p, q) for p, q in zip(again, got)), seg
    again = MS.mamba_scan_bwd(dt, bm, cm, x, a, h0, dy)
    assert all(torch.equal(p, q) for p, q in zip(again, got))


def test_mamba_scan_autograd_launches_the_backward_kernel(cuda):
    """Through autograd the scan's backward is the kernel, never the plain
    version: one forward and one backward launch, the gradients those of
    ``mamba_scan_bwd``."""
    from repro_torch.kernels import mamba_scan as MS
    dt, bm, cm, x, a, h0 = _scan_inputs(cuda, 2, 64, 512, 16, bf16=True)
    h0 = torch.zeros_like(h0)
    ins = [t.clone().requires_grad_(True) for t in (dt, bm, cm, x, a)]
    dy = torch.randn(2, 64, 512, device=cuda)
    f0, b0 = MS.mamba_scan.launches, MS.mamba_scan_bwd.launches
    y, _ = MS.mamba_scan(*ins, h0)
    grads = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert MS.mamba_scan.launches == f0 + 1
    assert MS.mamba_scan_bwd.launches == b0 + 1
    want = MS.mamba_scan_bwd(dt, bm, cm, x, a, h0, dy)
    for gv, wv in zip(grads, want):
        assert torch.equal(gv, wv)


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
    """A copy: bit-identical to the roll and to the kernel it ran on before,
    for any element count (16-byte words down to single bytes), over
    consecutive launches; the flags are never reset, and after each launch
    every rank's flag has counted exactly the plan's tiles more."""
    from repro_torch.kernels import pk_comm as PK
    r = shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    flags = PK.p2p_flags(cuda, stream)
    blk = math.prod(shape[1:]) * torch.empty(0, dtype=dtype).element_size()
    tiles = PK.p2p_plan(r, blk).tiles
    before = PK.p2p_ring_shift.launches
    for i in range(3):
        x = (torch.randn(shape, device=cuda) * 50).to(dtype)
        start = flags.counts(r)
        assert start == flags.expected[:r]
        got = PK.p2p_ring_shift(x)
        torch.cuda.synchronize()
        assert PK.p2p_ring_shift.launches == before + i + 1
        assert got.dtype == dtype and torch.equal(got, PK.ring_shift_plain(x))
        assert torch.equal(got, _chip_smoke().mm_tile_p2p_ring_shift(x))
        assert flags.counts(r) == flags.expected[:r] == [
            (c + tiles) % 2 ** 32 for c in start]


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


def _qkv(dev, b, hq, hkv, sq, skv, hd, seed=0):
    return (_randn(dev, b, hq, sq, hd, seed=seed + 1),
            _randn(dev, b, hkv, skv, hd, seed=seed + 2),
            _randn(dev, b, hkv, skv, hd, seed=seed + 3))


@pytest.mark.parametrize("s", [1, 60, 130, 405])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 50)])
def test_flash_attention_kernel_ragged_lengths(cuda, s, hd, causal, window):
    """Sequence lengths that are no multiple of the 128-row tile: TMA
    zero-fills past S and the mask drops those keys."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(cuda, 2, 8, 2, s, s, hd)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _rel(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)) <= 1e-2


@pytest.mark.parametrize("sq,skv", [(448, 1500), (1, 1500), (60, 130),
                                    (130, 60)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_kernel_cross_lengths(cuda, sq, skv, hd):
    """Non-causal attention of queries over keys of another length, as an
    encoder-decoder's cross-attention runs it (whisper: the decoder's
    tokens over 1500 encoder frames), on the projections' head-transposed
    views; the ragged key edge is masked."""
    from repro_torch.kernels import flash_attention as FA
    b, hq, hkv = 2, 8, 2
    q = _randn(cuda, b, sq, hq, hd, seed=1).transpose(1, 2)
    k = _randn(cuda, b, skv, hkv, hd, seed=2).transpose(1, 2)
    v = _randn(cuda, b, skv, hkv, hd, seed=3).transpose(1, 2)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.shape == q.shape
    assert _rel(got, FA.flash_attention_plain(q, k, v, causal=False)) <= 1e-2


@pytest.mark.parametrize("sq,skv", [(60, 130), (130, 60), (405, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_hop_kernel_sq_ne_skv(cuda, sq, skv, causal):
    """The hop with query and key blocks of different lengths: global
    offsets r·Sq and src·Skv."""
    from repro_torch.kernels import flash_attention as FA
    r, b = 4, 1
    q, k, v = _qkv(cuda, r * b, 8, 2, sq, skv, 64)
    for hop in range(r):
        got = FA.flash_attention_hop(q, k, v, ranks=r, hop=hop,
                                     causal=causal)
        want = FA.flash_attention_hop_plain(q, k, v, ranks=r, hop=hop,
                                            causal=causal)
        torch.cuda.synchronize()
        dead = want[2] == 0
        assert _rel(got[0], want[0]) <= 1e-2 and _rel(got[2], want[2]) <= 1e-2
        if bool((~dead).any()):
            assert _rel(got[1][~dead], want[1][~dead]) <= 1e-3
        assert torch.equal(got[1][dead], want[1][dead])
        assert not bool(got[2][dead].any() or got[0][dead].any())


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_kernel_reads_nothing_past_s(cuda, layout, hd):
    """q, k and v are views of buffers whose rows past S hold inf: the
    neighbouring head's rows (B, H, S', D) or the next batch's
    (B, S', H, D). TMA's zero fill is per dimension, so no box reads them
    (0·inf would be NaN); the output equals that of contiguous copies."""
    from repro_torch.kernels import flash_attention as FA
    b, hq, hkv, s, pad = 2, 8, 2, 130, 70

    def view(h, seed):
        shape = (b, h, s + pad, hd) if layout == "bhsd" else (b, s + pad, h,
                                                               hd)
        buf = torch.full(shape, float("inf"), device=cuda,
                         dtype=torch.bfloat16)
        if layout == "bhsd":
            buf[:, :, :s] = _randn(cuda, b, h, s, hd, seed=seed)
            return buf[:, :, :s]
        buf[:, :s] = _randn(cuda, b, s, h, hd, seed=seed)
        return buf[:, :s].transpose(1, 2)

    q, k, v = view(hq, 1), view(hkv, 2), view(hkv, 3)
    got = FA.flash_attention(q, k, v, causal=True)
    hop = FA.flash_attention_hop(q, k, v, ranks=2, hop=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert all(bool(torch.isfinite(t).all()) for t in hop)
    want = FA.flash_attention(*(t.contiguous() for t in (q, k, v)),
                              causal=True)
    assert torch.equal(got, want)
    assert _rel(got, FA.flash_attention_plain(q.contiguous(), k.contiguous(),
                                              v.contiguous())) <= 1e-2


@pytest.mark.parametrize("ratio", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_kernel_gqa_ratios(cuda, ratio, hd):
    """GQA reads KV head h // (Hq/Hkv) as a map coordinate: each head's
    output equals the kernel's on the repeated KV heads, bit for bit."""
    from repro_torch.kernels import flash_attention as FA
    hq = 16
    q, k, v = _qkv(cuda, 2, hq, hq // ratio, 300, 300, hd)
    got = FA.flash_attention(q, k, v, causal=True)
    rep = FA.flash_attention(q, k.repeat_interleave(ratio, 1),
                             v.repeat_interleave(ratio, 1), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, rep)
    assert _rel(got, FA.flash_attention_plain(q, k, v)) <= 1e-2


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_kernel_bits_invariant(cuda, hd):
    """A head's output is the same bits alone and among 32 heads, and a
    second call gives the first call's bits; so is the hop's."""
    from repro_torch.kernels import flash_attention as FA
    b, hq, hkv, s = 2, 32, 4, 400
    q, k, v = _qkv(cuda, b, hq, hkv, s, s, hd)
    full = FA.flash_attention(q, k, v, causal=True)
    assert torch.equal(FA.flash_attention(q, k, v, causal=True), full)
    for h in (0, 13, 31):
        kh = h // (hq // hkv)
        one = FA.flash_attention(q[:, h:h + 1], k[:, kh:kh + 1],
                                 v[:, kh:kh + 1], causal=True)
        assert torch.equal(one, full[:, h:h + 1])
    hop = FA.flash_attention_hop(q, k, v, ranks=2, hop=1)
    again = FA.flash_attention_hop(q, k, v, ranks=2, hop=1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(hop, again))


def test_flash_attention_plan_matches_the_built_kernel(cuda):
    """The plan's tiles, threads and shared memory are the kernel's own."""
    from repro_torch.kernels import flash_attention as FA
    for hd in FA.KERNEL_HEAD_DIMS:
        st = (512 * hd, 256 * hd, hd, 1)
        p = FA.flash_plan((1, 2, 256, hd), st, (1, 2, 256, hd), st, st)
        assert FA.kernel_config(hd) == (p.block_q, p.block_k, p.stages,
                                        p.threads, p.smem_bytes)


def test_flash_attention_kernel_any_grid_same_bits(cuda):
    """The launcher runs the grid the plan gives it: blocks take tiles from
    the counter, so 1, 5 or 132 blocks compute every tile, with the bits of
    the wrapper's own launch (forward and hop)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    b, hq, hkv, s, hd = 2, 8, 2, 300, 64
    q, k, v = _qkv(cuda, b, hq, hkv, s, s, hd)
    want = FA.flash_attention(q, k, v, causal=True)
    hop_want = FA.flash_attention_hop(q, k, v, ranks=2, hop=1)
    lib = _build.library()
    for sms in (1, 5, 132):
        p = FA.flash_plan(tuple(q.shape), q.stride(), tuple(k.shape),
                          k.stride(), v.stride(), sms=sms)
        assert p.grid == min(sms, p.tiles)
        out = torch.empty_like(q)
        _build.check(lib.pk_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, s, s, hd, *p.strides, 1, 0, hd ** -0.5, p.grid,
            *FA._tile_counter(cuda)), "pk_flash_attention_bf16")
        o, m, l_ = (torch.empty_like(t) for t in hop_want)
        _build.check(lib.pk_flash_attention_hop_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l_.data_ptr(), b, hq, hkv, s, s, hd, *p.strides,
            2, 1, 1, 0, hd ** -0.5, p.grid, *FA._tile_counter(cuda)),
            "pk_flash_attention_hop_bf16")
        torch.cuda.synchronize()
        assert torch.equal(out, want), sms
        assert all(torch.equal(g, w) for g, w in zip((o, m, l_), hop_want))


def test_flash_attention_kernel_on_two_streams(cuda):
    """Launches of one kernel in flight at once on two streams: each stream
    has its own tile counter, so neither launch takes the other's tiles and
    both give the bits of a launch alone. Both streams wait on one event
    behind a spin kernel, so their launches start together; each covers 64
    tiles, half the card's SMs. Outputs are overwritten with NaN once
    checked, so a later output that reuses their memory cannot pass with a
    tile left out."""
    from repro_torch.kernels import flash_attention as FA
    inputs = [_qkv(cuda, 1, 16, 4, 512, 512, hd, seed=10 * i)
              for i, hd in enumerate((64, 64, 128, 128))]
    flash = [FA.flash_attention(*t, causal=True) for t in inputs]
    hops = [FA.flash_attention_hop(*t, ranks=1, hop=0) for t in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for pair in ((0, 1), (2, 3)):
        for _ in range(3):
            torch.cuda._sleep(20_000_000)
            go = torch.cuda.Event()
            go.record()
            got = []
            for st, i in zip(streams, pair):
                st.wait_event(go)
                with torch.cuda.stream(st):
                    got.append((FA.flash_attention(*inputs[i], causal=True),
                                FA.flash_attention_hop(*inputs[i], ranks=1,
                                                       hop=0)))
            torch.cuda.synchronize()
            for i, (o, hop) in zip(pair, got):
                assert torch.equal(o, flash[i])
                assert all(torch.equal(g, w) for g, w in zip(hop, hops[i]))
                # a tile no block computed would keep this memory's bits
                for t in (o, *hop):
                    t.fill_(float("nan"))
            torch.cuda.synchronize()
    for t, o in zip(inputs, flash):
        assert _rel(o, FA.flash_attention_plain(*t)) <= 1e-2


def test_flash_attention_kernel_refused_map_raises(cuda):
    """A map cuTensorMapEncodeTiled refuses (a batch stride of 2^40 bytes)
    makes the launcher return minus its CUresult, which raises; a view the
    wrapper's own check refuses (rows 136 bytes apart) raises before any
    launch, and no launch is counted."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _qkv(cuda, 1, 2, 2, 64, 64, 64)
    out = torch.empty_like(q)
    st = [2 ** 39, 64 * 64, 64] + [2 * 64 * 64, 64 * 64, 64] * 2
    err = _build.library().pk_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 2, 2,
        64, 64, 64, *st, 1, 0, 0.125, 1, *FA._tile_counter(cuda))
    assert err < 0
    with pytest.raises(RuntimeError, match="refused"):
        _build.check(err, "pk_flash_attention_bf16")
    odd = _randn(cuda, 1, 2, 64, 68, seed=9)[..., :64]     # rows 136 B apart
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        FA.flash_attention(odd, k, v)
    assert FA.flash_attention.launches == before


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
    flags = PK.p2p_flags(cuda, torch.cuda.current_stream().cuda_stream)
    counted = flags.counts(4)
    loss, _ = T.forward_train(params, batch, cfg, run, rules,
                              seq_sharded=True)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert PK.p2p_ring_shift.launches == 2 * 2 * 3 * 2
    # no memset between the launches: each rank's flag counted every tile of
    # every launch (k and v: 1 x 4 heads x 256 tokens x 64 bf16 a rank)
    tiles = PK.p2p_plan(4, 4 * 256 * 64 * 2).tiles
    assert flags.counts(4) == flags.expected[:4] == [
        (c + 2 * 2 * 3 * 2 * tiles) % 2 ** 32 for c in counted]
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
    """Three launches of a shape in a row, each bit-identical to the plain
    gather and to B3's kernel; the never-reset flags hold each launch's
    epoch on every item after it."""
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn((r, *shape), device=cuda) * 50).to(dtype)
    before = LC.lcsc_ring_all_gather.launches
    for _ in range(3):
        got = LC.lcsc_ring_all_gather(x)
        torch.cuda.synchronize()
        assert got.shape == (r, r, *shape) and got.dtype == dtype
        assert torch.equal(got, PK.all_gather_plain(x))
        assert torch.equal(got, PK.ring_all_gather(x))
        _assert_lcsc_flags_stamped(x)
    assert LC.lcsc_ring_all_gather.launches == before + 3


def _lcsc_plan_of(x):
    from repro_torch.core import pgl
    from repro_torch.kernels import lcsc as LC
    bits = 0
    for a in pgl.pointer_table(x):
        bits |= a
    return LC.lcsc_plan(x.shape[0], x[0].numel() * x.element_size(),
                        x.element_size(), bits % 16,
                        sms=torch.cuda.get_device_properties(x.device)
                        .multi_processor_count)


def _assert_lcsc_flags_stamped(x):
    """After the last launch on x's stream, every item of x's plan holds
    that launch's epoch."""
    from repro_torch.kernels import lcsc as LC
    f = LC.lcsc_flags(x.device, torch.cuda.current_stream(x.device)
                      .cuda_stream)
    p = _lcsc_plan_of(x)
    assert (f.flags[:p.items] == f.epoch).all()


def test_lcsc_kernel_alternates_shapes_of_different_tile_counts(cuda):
    """Launches alternating between shapes of 1, 128, 88 and 352 tiles a
    rank and R 2, 4, 8 — each leaving flags of the others' items with old
    epochs — stay bit-identical to the plain gather and to B3's kernel."""
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    xs = [(torch.randn(s, device=cuda) * 50).to(torch.bfloat16)
          for s in ((8, 256, 4, 1408), (2, 4, 24), (2, 1024, 4, 64),
                    (4, 512, 4, 1408), (2, 1024, 4, 1408))]
    assert len({_lcsc_plan_of(x).tiles for x in xs}) >= 4
    for x in xs + xs[::-1] + xs:
        got = LC.lcsc_ring_all_gather(x)
        torch.cuda.synchronize()
        assert torch.equal(got, PK.all_gather_plain(x))
        assert torch.equal(got, PK.ring_all_gather(x))
        _assert_lcsc_flags_stamped(x)


@pytest.mark.parametrize("r,n,offset", [(2, 4096, 1), (4, 1000, 8),
                                        (8, 130, 2), (4, 1001, 0)])
def test_lcsc_kernel_word_route(cuda, r, n, offset):
    """Blocks or addresses off 16 bytes take the word route (the plan says
    why), bit for bit as the TMA route, over repeated launches."""
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    buf = torch.randint(0, 256, (offset + r * n,), dtype=torch.uint8,
                        device=cuda)
    x = buf[offset:].view(r, n)
    assert _lcsc_plan_of(x).route == "word"
    for _ in range(3):
        got = LC.lcsc_ring_all_gather(x)
        torch.cuda.synchronize()
        assert torch.equal(got, PK.all_gather_plain(x))
        _assert_lcsc_flags_stamped(x)


def test_lcsc_kernel_is_one_device_op_a_launch(cuda):
    """No memset before a launch: the profiler sees one device op, the
    kernel, for each of three launches (the TP run's hand-off gathers)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lcsc as LC
    x = (torch.randn((4, 1024, 2048), device=cuda)).to(torch.bfloat16)
    LC.lcsc_ring_all_gather(x)          # the plan and the flags exist
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [LC.lcsc_ring_all_gather(x) for _ in range(3)]
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 3, device
    assert all("lcsc_all_gather" in name for name in device), device
    del outs


def test_lcsc_kernel_refuses_cuda_graph_capture(cuda):
    """The epoch is chosen on the host at each launch, so a captured launch
    would replay one epoch and its waits could be met by the last replay's
    stamps: the wrapper raises under stream capture, launches nothing, and
    the next eager launch is still bit-identical."""
    from repro_torch.kernels import lcsc as LC
    from repro_torch.kernels import pk_comm as PK
    x = (torch.randn((2, 1024, 4, 64), device=cuda) * 50).to(torch.bfloat16)
    LC.lcsc_ring_all_gather(x)          # the plan and the flags exist
    torch.cuda.synchronize()
    before = LC.lcsc_ring_all_gather.launches
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            LC.lcsc_ring_all_gather(x)
    assert LC.lcsc_ring_all_gather.launches == before
    got = LC.lcsc_ring_all_gather(x)
    torch.cuda.synchronize()
    assert torch.equal(got, PK.all_gather_plain(x))
    _assert_lcsc_flags_stamped(x)


def _a2a_plans(x, out, a, c, n):
    """The plans of ``pk_comm.all_to_all``'s launches, as the wrapper
    makes them."""
    from repro_torch.kernels import pk_comm as PK
    plans = []
    for xi, oi in PK.a2a_chunks(x, out, a, c, n):
        addr = 0
        for t in list(xi.unbind(0)) + list(oi.unbind(0)):
            addr |= t.data_ptr() % 16
        plans.append(PK.a2a_plan(x.shape[0], xi.shape[1:], xi.stride()[1:],
                                 oi.stride()[1:], a, c, x.element_size(),
                                 addr=addr))
    return plans


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("shape,a,c,dtype", [
    ((2, 4, 40), 0, 1, torch.bfloat16),      # 40-byte rows: a tail
    ((3, 2, 5), 1, 0, torch.float32),
    ((2, 3, 7), 0, 2, torch.bfloat16),
    ((4, 1, 6), 1, 1, torch.uint8),
    ((2, 2, 2, 3), 1, 3, torch.float32),
    ((1, 4, 64, 64), 1, 2, torch.bfloat16)])
def test_all_to_all_kernel(cuda, r, shape, a, c, dtype):
    """Every chunk count 1-4, contiguous and with the last two dims
    transposed in memory: bit for bit ``all_to_all_plain``, one launch a
    chunk, the same bits on a second call."""
    from repro_torch.kernels import pk_comm as PK
    local = list(shape)
    local[a] *= r
    g = torch.Generator(device=cuda).manual_seed(r)
    x = torch.randint(0, 255, (r, *local), generator=g,
                      device=cuda).to(dtype)
    for view in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
        want = PK.all_to_all_plain(view, a, c)
        for n in (1, 2, 3, 4):
            out = torch.empty_like(want)
            chunks = len(PK.a2a_chunks(view, out, a, c, n))
            before = PK.all_to_all.launches
            got = PK.all_to_all(view, a, c, n_chunks=n)
            torch.cuda.synchronize()
            assert PK.all_to_all.launches == before + chunks
            assert got.is_contiguous()
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            assert torch.equal(PK.all_to_all(view, a, c, n_chunks=n), got)


@pytest.mark.parametrize("offset,elsize", [(1, 1), (2, 2), (4, 4), (8, 2),
                                          (0, 2)])
def test_all_to_all_kernel_words_and_tails(cuda, offset, elsize):
    """Addresses off 16 bytes narrow the word to what every row start
    allows; rows whose bytes the word does not divide copy a tail: bit for
    bit the plain version either way."""
    from repro_torch.kernels import pk_comm as PK
    dtype = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32}[elsize]
    r, n = 4, 4 * 3 * 40
    buf = torch.randint(0, 255, (offset // elsize + r * n,), device=cuda
                        ).to(dtype)
    x = buf[offset // elsize:].view(r, 4, 3, 40)
    want = PK.all_to_all_plain(x, 0, 1)
    plans = _a2a_plans(x, torch.empty_like(want), 0, 1, 2)
    assert plans[0].unit == (16 if offset == 0 else offset)
    if offset == 0 and elsize == 2:
        assert plans[0].tail > 0            # 40-byte rows chunked from 80
    got = PK.all_to_all(x, 0, 1, n_chunks=2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_all_to_all_ctx_gradient_on_card(cuda):
    """``CommContext.all_to_all`` chunked on the card, forward and backward,
    bit for bit the bulk backend's; an empty tensor launches nothing."""
    from repro_torch.core.comms import CommContext
    from repro_torch.core.pgl import VirtualMesh
    from repro_torch.kernels import pk_comm as PK
    ctx = CommContext("x", mesh=VirtualMesh((4,), ("x",), cuda))
    x = _randn(cuda, 4, 1, 32, 256, 64, seed=3)
    w = _randn(cuda, 4, 1, 8, 1024, 64, seed=4)
    grads = {}
    for be, n in (("chunked", 2), ("bulk", None)):
        xt = x.clone().requires_grad_(True)
        before = PK.all_to_all.launches
        out = ctx.all_to_all(xt, split_axis=1, concat_axis=2, backend=be,
                             n_chunks=n)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        assert PK.all_to_all.launches == before + (4 if n else 0)
        grads[be] = (out.detach(), xt.grad)
    assert torch.equal(grads["chunked"][0], grads["bulk"][0])
    assert torch.equal(grads["chunked"][1], grads["bulk"][1])
    before = PK.all_to_all.launches
    empty = PK.all_to_all(torch.empty(4, 4, 0, device=cuda), 0, 1,
                          n_chunks=2)
    assert empty.shape == (4, 1, 0) and PK.all_to_all.launches == before


def _decode_case(dev, r, b, hq, hkv, s_loc, hd, pos, *, dtype=torch.bfloat16,
                 seed=0):
    """A layer's (R, B, Hkv, s_loc, hd) K and V as the second layer of a
    stored two-layer slab (a view, as the engine hands them), q and the new
    K/V replicated over the ranks, and the slab as it must be after the
    write: the new row at each ``pos`` that a rank holds, nothing past
    s_max."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    slab_k, slab_v = rn(2, r, b, hkv, s_loc, hd), rn(2, r, b, hkv, s_loc, hd)
    q = rn(1, b, hq, 1, hd).expand(r, -1, -1, -1, -1)
    kn, vn = (rn(1, b, hkv, 1, hd).expand(r, -1, -1, -1, -1)
              for _ in range(2))
    want_k, want_v = slab_k.clone(), slab_v.clone()
    for i, p in enumerate(pos.tolist() if pos.dim() else [int(pos)] * b):
        if p < r * s_loc:
            want_k[1, p // s_loc, i, :, p % s_loc] = kn[0, i, :, 0]
            want_v[1, p // s_loc, i, :, p % s_loc] = vn[0, i, :, 0]
    return slab_k, slab_v, q, kn, vn, want_k, want_v


def _merged(o, m, l_):
    """The island's log-sum-exp merge of the ranks' partials."""
    a = torch.exp(m - m.amax(0))
    return (o * a[..., None]).sum(0) / (l_ * a).sum(0).clamp_min(1e-30)[
        ..., None]


@pytest.mark.parametrize("case", [
    # the cell's: moonshot's 16 heads of 128 over a 64 x 8448 slab on 4
    # ranks, slot lengths 1 to s_max and one slot past s_max
    dict(r=4, b=64, hq=16, hkv=16, s_loc=2112, hd=128, window=None),
    # tinyllama's GQA 8 at hd 64, scalar (lockstep) pos
    dict(r=4, b=8, hq=32, hkv=4, s_loc=512, hd=64, window=None,
         scalar=1100),
    # h2o-danube's hd 120, GQA 4, window 4096
    dict(r=4, b=6, hq=32, hkv=8, s_loc=2048, hd=120, window=4096),
    # starcoder2's GQA 12 at hd 128, f16
    dict(r=2, b=3, hq=48, hkv=4, s_loc=640, hd=128, window=None,
         dtype=torch.float16),
    # long_ctx: B = 1 over 8 flat ranks, the keys split
    dict(r=8, b=1, hq=32, hkv=8, s_loc=16384, hd=120, window=4096,
         scalar=80000),
], ids=["cell", "gqa8-hd64-scalar", "hd120-window", "gqa12-f16",
        "long-ctx-split"])
def test_decode_attention_kernel(cuda, case):
    """The one-pass decode kernel against its plain twin: the slab written
    in place exactly at each slot's position (nothing else of it, nor of the
    neighbouring layer, changes), and each rank's (o, m, l) within f32
    rounding of the twin's: both sum in f32 but in another order (a score
    over a row's lanes, the keys over lane groups, then splits), so 1e-5
    relative."""
    from repro_torch.kernels import decode_attention as DA
    c = dict(case)
    r, b, hkv, s_loc = c["r"], c["b"], c["hkv"], c["s_loc"]
    s_max = r * s_loc
    if "scalar" in c:
        pos = torch.tensor(c["scalar"], dtype=torch.int32, device=cuda)
    else:
        pos = torch.linspace(0, s_max - 1, b - 1, device=cuda).long()
        pos = torch.cat([pos, pos.new_tensor([s_max + 5])])
    slab_k, slab_v, q, kn, vn, want_k, want_v = _decode_case(
        cuda, r, b, c["hq"], hkv, s_loc, c["hd"], pos,
        dtype=c.get("dtype", torch.bfloat16))
    tk, tv = slab_k[1].clone(), slab_v[1].clone()
    want = DA.decode_attention_plain(q, tk, tv, kn, vn, pos, c["window"])
    plan = DA.decode_plan(r, b, hkv, c["hq"] // hkv, s_loc, c["hd"])
    assert plan.splits > 1 or b > 1          # the long-context case splits
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, slab_k[1], slab_v[1], kn, vn, pos,
                              window=c["window"])
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1 + (plan.splits > 1)
    assert torch.equal(slab_k, want_k) and torch.equal(slab_v, want_v)
    assert torch.equal(slab_k[1], tk) and torch.equal(slab_v[1], tv)
    o, m, l_ = got
    assert o.shape == want[0].shape and m.shape == l_.shape == want[1].shape
    seen = want[2] > 0
    assert torch.equal(l_ > 0, seen)
    assert float((m - want[1])[seen].abs().max()) <= 1e-5 * max(
        1.0, float(want[1][seen].abs().max()))
    assert _rel(l_, want[2]) <= 1e-5
    assert _rel(_merged(*got), _merged(*want)) <= 1e-5


def test_decode_attention_refuses_f32_on_card(cuda):
    """On the card the wrapper launches the kernel or raises: an f32 cache
    is no type the kernel is built for, and no plain path stands in."""
    from repro_torch.kernels import decode_attention as DA
    pos = torch.tensor([0, 100], device=cuda)
    slab_k, slab_v, q, kn, vn, want_k, _ = _decode_case(
        cuda, 2, 2, 4, 4, 64, 64, pos, dtype=torch.float32)
    before = DA.decode_attention.launches
    with pytest.raises(ValueError, match="bf16 or f16"):
        DA.decode_attention(q, slab_k[1], slab_v[1], kn, vn, pos)
    assert DA.decode_attention.launches == before


def test_decode_attention_kernel_rewrite_is_idempotent(cuda):
    """A second call at the same positions gives the same slab and output:
    the engine may run a decode tick again over a cache it has written."""
    from repro_torch.kernels import decode_attention as DA
    pos = torch.tensor([0, 100, 700, 1023], device=cuda)
    slab_k, slab_v, q, kn, vn, want_k, want_v = _decode_case(
        cuda, 4, 4, 8, 2, 256, 128, pos)
    first = DA.decode_attention(q, slab_k[1], slab_v[1], kn, vn, pos)
    second = DA.decode_attention(q, slab_k[1], slab_v[1], kn, vn, pos)
    torch.cuda.synchronize()
    assert torch.equal(slab_k, want_k) and torch.equal(slab_v, want_v)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
