"""The GEMM kernel's plan and its stacked form, on the CPU.

``kernels/matmul.py::plan`` picks the configuration the Hopper mainloop
runs (``csrc/hopper_gemm.cuh``): the regime, the tile and the grid. It is
pure Python, so its promises are checked here at every shape
``chip_smoke.py`` phase 3 and the model paths give the kernel: decode
launches take the bytes-bound regime with at least one block an SM, every
TMA box fits the hardware's limits, and nothing that changes the bits
depends on how many problems a launch stacks. The reduce plan of GEMM×AR
and GEMM×RS is checked at every shape of theirs the paths and phase 3
launch, with the scratch the wrapper sizes from it, and is one plan for
both kernels whatever the chunk count or the card. The grouped expert
GEMM's plan (B9, 3-D tensor maps) is checked at every MoE shape, with its
tile independent of the group count, and its operand check raises before
any launch. ``matmul_stacked``'s plain
path is held against the JAX package's ``ops.matmul`` (Pallas, interpret
mode) rank by rank, numpy-seeded, in float32 (rtol = atol = 1e-5: the same
sums in another order); its gradients against autograd of the per-rank
plain products.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import collective_matmul as CM  # noqa: E402
from repro_torch.kernels import grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SMEM_PER_BLOCK = 232448         # an H100 block's shared memory limit
SMEM_PER_SM = 233472            # 228 KB an SM, 1 KB of it reserved a block

# (m, n, k, problems) as phase 3 and the model paths launch them: the
# serving paths' decode logits stacked over 4 vocab shards (tinyllama,
# moonshot, falcon-mamba and its prefill group), and phase 3's rows of one
# shard
DECODE = [(8, 8000, 2048, 4), (8, 40960, 2048, 4), (8, 16256, 4096, 4),
          (4, 16256, 4096, 4), (1, 8000, 2048, 4), (8, 40960, 2048, 1),
          (8, 16256, 4096, 1)]
COMPUTE = [(2048, 1408, 2048, 1), (1024, 8000, 2048, 4),
           (1024, 8000, 2048, 1), (512, 8000, 2048, 4),
           (2048, 8000, 2048, 4), (65, 72, 40, 1), (200, 136, 264, 1)]
AG = [(1024, 2816, 2048, 16), (1024, 1024, 1024, 16), (100, 200, 264, 16),
      (3, 24, 40, 64), (8, 8, 16, 4)]
# (m, n, k_loc, R) of GEMM×AR (B4) and GEMM×RS (B6) as the paths and
# phase 3 launch them: decode (m 8) at the attention out-projection (k_loc
# 512) and the MLP down-projection (1408), the prefill buckets (m 512,
# 2048), the training microbatch (1024) and the SP call (8192); the TP
# pair, the Fig. 8 sweep and phase 3's ragged shape; R 2 and 8; and the
# card tests' shapes
REDUCE = [(8, 2048, 512, 4), (8, 2048, 1408, 4), (512, 2048, 512, 4),
          (512, 2048, 1408, 4), (2048, 2048, 512, 4), (2048, 2048, 1408, 4),
          (1024, 2048, 512, 4), (1024, 2048, 1408, 4), (8192, 2048, 512, 4),
          (8192, 2048, 1408, 4), (4096, 2048, 1408, 4), (4096, 1024, 512, 4),
          (8192, 2048, 1024, 4), (16384, 4096, 2048, 4), (200, 120, 136, 4),
          (8, 2048, 1408, 2), (8, 2048, 1408, 8), (2048, 2048, 1408, 2),
          (2048, 2048, 1408, 8), (200, 120, 136, 8), (8, 64, 64, 2),
          (200, 136, 96, 4), (24, 16, 40, 8), (8, 8, 16, 2), (256, 192, 128, 4),
          (260, 72, 64, 2)]

# (g, c, k, n) of the grouped expert GEMM (B9) on moonshot-v1-16b-a3b's MoE
# path: 4 ranks x 16 experts, capacity 1 at decode, 60 and 240 in the 128
# and 512 buckets, w1/w3 (2048, 1408) and w2 (1408, 2048)
GROUPED = [(64, c, k, n) for c in (1, 60, 240)
           for k, n in ((2048, 1408), (1408, 2048))]


def _cdiv(a, b):
    return -(-a // b)


def _np(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("m,n,k,problems", DECODE)
def test_plan_decode_is_bytes_bound_on_every_sm(m, n, k, problems):
    p = MM.plan(m, n, k, problems)
    assert p.regime == "bytes" and (p.block_m, p.block_n) == (64, 64)
    assert p.blocks == problems * p.tiles >= MM.H100_SMS
    assert p.grid == min(p.blocks, 2 * MM.H100_SMS)
    # each block keeps >= 32 KB of w in flight: its ring's B stages
    assert p.stages * p.block_n * MM.BLOCK_K * 2 >= 32 * 1024


def test_plan_one_tinyllama_shard_keeps_whole_tiles():
    """One rank's shard of the tinyllama head alone has 125 tiles, fewer
    than the SMs; the plan does not split K for it (a split measured slower
    on the card), and the serving path launches the 4 shards stacked."""
    p = MM.plan(8, 8000, 2048)
    assert p.regime == "bytes" and p.blocks == p.tiles == 125
    assert MM.plan(8, 8000, 2048, 4).blocks == 500


@pytest.mark.parametrize("m,n,k,problems", DECODE + COMPUTE + AG)
def test_plan_fits_tma_and_shared_memory(m, n, k, problems):
    p = MM.plan(m, n, k, problems, count_all=(m, n, k, problems) in AG)
    for box in (p.a_box, p.b_box):
        assert all(1 <= d <= 256 for d in box)      # TMA's box limit
        assert box[0] * 2 <= 128                    # one 128-byte swizzle row
    assert p.a_box[1] % 8 == 0 and p.a_box[1] <= p.block_m
    assert p.a_box[1] >= min(m, p.block_m)
    # global row strides: 16-byte multiples for TMA
    assert (k * 2) % 16 == 0 and (n * 2) % 16 == 0
    assert p.smem_bytes <= SMEM_PER_BLOCK
    per_sm = MM.CONFIGS[p.cfg]["per_sm"]
    assert per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    assert p.threads == (p.block_m // 64 + 1) * 128
    assert 1 <= p.grid <= per_sm * MM.H100_SMS


@pytest.mark.parametrize("m,n,k,problems", COMPUTE)
def test_plan_compute_regime(m, n, k, problems):
    p = MM.plan(m, n, k, problems)
    assert p.regime == "compute"
    assert (p.block_m, p.block_n) in ((128, 192), (128, 256))
    # persistent: one block an SM, never more blocks than tiles
    tiles = problems * _cdiv(m, 128) * _cdiv(n, p.block_n)
    assert p.tiles * problems == tiles
    assert p.grid == min(tiles, MM.H100_SMS)


def test_plan_tile_width_fills_the_last_wave():
    # 2048 x 1408: 96 tiles of 256 leave 36 SMs idle, 128 of 192 leave 4
    assert MM.plan(2048, 1408, 2048).block_n == 192
    # the loss: 256 tiles of 256 are 2 waves, 336 of 192 would be 3
    assert MM.plan(1024, 8000, 2048).block_n == 256


@pytest.mark.parametrize("m,n,k,problems", DECODE + COMPUTE)
def test_plan_bits_do_not_depend_on_the_stack_or_card(m, n, k, problems):
    """What changes the bits (the configuration) is a function of (m, n,
    k): a stacked launch gives the bits of one launch a problem."""
    one = MM.plan(m, n, k, 1)
    for p in (MM.plan(m, n, k, problems), MM.plan(m, n, k, problems, sms=114),
              MM.plan(m, n, k, 8, sms=78)):
        assert (p.cfg, p.block_m, p.block_n) == \
            (one.cfg, one.block_m, one.block_n)


@pytest.mark.parametrize("m,n,k,problems", AG)
def test_plan_gather_counts_every_problem(m, n, k, problems):
    p = MM.plan(m, n, k, problems, count_all=True)
    assert p.blocks == problems * p.tiles
    assert p.grid == min(p.blocks, MM.CONFIGS[p.cfg]["per_sm"] * MM.H100_SMS)


@pytest.mark.parametrize("m,k,n,r", [(8, 64, 40, 4), (1, 16, 8, 8),
                                     (37, 50, 29, 3), (130, 64, 200, 2)])
def test_matmul_stacked_plain_matches_jax(m, k, n, r):
    x, w = _np(m, k, seed=1), _np(r, k, n, seed=2)
    before = MM.matmul.launches
    got = MM.matmul_stacked(torch.from_numpy(x), torch.from_numpy(w))
    assert MM.matmul.launches == before          # a CPU tensor: no kernel
    assert got.dtype == torch.float32 and got.shape == (r, m, n)
    for j in range(r):
        np.testing.assert_allclose(
            got[j].numpy(), np.asarray(jops.matmul(x, w[j], interpret=True)),
            **TOL)
        np.testing.assert_allclose(
            got[j].numpy(),
            MM.matmul(torch.from_numpy(x), torch.from_numpy(w[j])).numpy(),
            **TOL)


def test_matmul_stacked_gradients_match_per_rank_autograd():
    x, w = _np(12, 24, seed=3), _np(3, 24, 16, seed=4)
    gy = torch.from_numpy(_np(3, 12, 16, seed=5))

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y = fn(xt, wt)
        return [y, *torch.autograd.grad(y, (xt, wt), gy)]

    got = grads(MM.matmul_stacked)
    want = grads(lambda xt, wt: torch.stack(
        [MM.matmul_plain(xt, wt[j]) for j in range(wt.shape[0])]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)


def test_matmul_stacked_refuses_bad_shapes():
    with pytest.raises(ValueError, match="matmul takes"):
        MM.matmul_stacked(torch.zeros(2, 3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="matmul takes"):
        MM.matmul_stacked(torch.zeros(2, 3), torch.zeros(2, 4, 5))


@pytest.mark.parametrize("offset,shape,ok", [(0, (8, 16), True),
                                             (1, (8, 16), False),
                                             (8, (8, 16), True),
                                             (0, (8, 12), False)])
def test_tma_operand_check_raises_before_a_launch(offset, shape, ok):
    """A view whose base, rows or row length is not 16-byte aligned is
    refused by the wrappers' check before any launch (TMA would fault)."""
    buf = torch.zeros(256, dtype=torch.bfloat16)
    base = buf.data_ptr() % 16 // 2            # elements to a 16-byte edge
    start = (8 - base) % 8 + offset
    t = buf[start:start + shape[0] * shape[1]].view(shape)
    if ok:
        MM.check_tma_operand(t, "x")
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            MM.check_tma_operand(t, "x")
    with pytest.raises(ValueError, match="bf16"):
        MM.check_tma_operand(t.float(), "x")


def test_ag_matmul_uses_the_gather_plan():
    """B5's wrapper is on the mainloop: its module plans with
    ``count_all``."""
    assert CM.plan is MM.plan
    p = MM.plan(1024, 2816, 2048, 16, count_all=True)
    assert (p.block_m, p.block_n) == (128, 256)


@pytest.mark.parametrize("m,n,k,r", REDUCE)
def test_plan_reduce_at_every_b4_b6_shape(m, n, k, r):
    """The reduce plan of GEMM×AR / GEMM×RS: the regime and tile from m,
    every source rank's tiles counted for the wave fill, the persistent
    grid within the card, TMA boxes and shared memory within the
    hardware's limits, and the scratch the wrapper allocates for the plan's
    tile what the launcher needs (``need`` in csrc/collective_matmul.cu: an
    arrival count and R part claims per 16-row strip of each output tile;
    R landing slots of (R, m/R, n) f32)."""
    p = MM.plan(m, n, k, r, count_all=True)
    if m <= 64:
        assert (p.regime, p.cfg, p.block_m, p.block_n) == \
            ("bytes", 0, 64, 64)
    else:
        assert p.regime == "compute" and p.cfg in (1, 2)
        # every source rank's tiles fill the waves
        assert p.cfg == min((2, 1), key=lambda c: _cdiv(
            r * _cdiv(m, 128) * _cdiv(n, MM.CONFIGS[c]["block_n"]),
            MM.H100_SMS) * MM.CONFIGS[c]["block_n"])
    assert p.tiles == _cdiv(m, p.block_m) * _cdiv(n, p.block_n)
    assert p.blocks == r * p.tiles
    per_sm = MM.CONFIGS[p.cfg]["per_sm"]
    assert 1 <= p.grid == min(p.blocks, per_sm * MM.H100_SMS)
    assert p.a_box == (MM.BLOCK_K, min(p.block_m, _cdiv(m, 8) * 8))
    assert p.b_box == (64, MM.BLOCK_K)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    if r * m * n * 4 <= 64 * 2 ** 20:    # the wrapper's own allocation
        landing, flags = CM._scratch(torch.device("cpu"), 0, r, m, n, p)
        CM._SCRATCH.clear()
        assert landing.shape == (r, r, m // r, n)
        assert landing.dtype == torch.float32
        need = (r + 1) * _cdiv(m, p.block_m) * _cdiv(n, p.block_n) \
            * (p.block_m // 16)
        assert flags.dtype == torch.int32 and flags.numel() == need


@pytest.mark.parametrize("m,n,k,r", REDUCE)
def test_plan_reduce_is_one_plan_for_rs_and_ar(m, n, k, r):
    """RS and AR of one shape run one plan, whatever ``n_chunks`` (which
    the plan does not take) and the card (only the grid follows it), so
    RS's output is AR's owner rows bit for bit."""
    p = MM.plan(m, n, k, r, count_all=True)
    for q in (MM.plan(m, n, k, r, count_all=True),
              MM.plan(m, n, k, r, sms=114, count_all=True),
              MM.plan(m, n, k, r, sms=78, count_all=True)):
        assert (q.cfg, q.block_m, q.block_n, q.tiles, q.a_box, q.b_box) == \
            (p.cfg, p.block_m, p.block_n, p.tiles, p.a_box, p.b_box)
    assert "n_chunks" not in inspect.signature(MM.plan).parameters


def test_plan_reduce_picks_the_wide_tile_at_the_tp_pair():
    """B6 at the TP pair: 1,024 blocks of 128 x 256 fill 8 waves (2,048
    columns), 1,408 of 128 x 192 would fill 11 (2,112)."""
    p = MM.plan(4096, 2048, 1408, 4, count_all=True)
    assert (p.block_m, p.block_n, p.blocks, p.grid) == (128, 256, 1024, 132)


@pytest.mark.parametrize("g,c,k,n", GROUPED)
def test_grouped_plan_at_every_moe_shape(g, c, k, n):
    """B9's plan: C <= 64 (decode, the 128 bucket) bytes-bound on 64 x 64
    tiles, C = 240 the compute regime; one tile per row and column block
    of every group, a persistent grid over all of them, 3-D TMA boxes one
    group deep, shared memory within the card's."""
    p = GM.plan(g, c, n, k)
    if c <= 64:
        assert (p.regime, p.cfg, p.block_m, p.block_n, p.stages) == \
            ("bytes", 0, 64, 64, 6)
    else:
        assert (p.regime, p.cfg, p.block_m, p.block_n, p.stages) == \
            ("compute", 1, 128, 192, 5)
    assert p.tiles == _cdiv(c, p.block_m) * _cdiv(n, p.block_n)
    assert p.blocks == g * p.tiles
    per_sm = MM.CONFIGS[p.cfg]["per_sm"]
    assert p.grid == min(p.blocks, per_sm * MM.H100_SMS)
    assert p.a_box == (64, min(p.block_m, _cdiv(c, 8) * 8), 1)
    assert p.b_box == (64, 64, 1)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    assert p.threads == (p.block_m // 64 + 1) * 128


@pytest.mark.parametrize("g,c,k,n", GROUPED)
def test_grouped_plan_tile_does_not_depend_on_groups(g, c, k, n):
    """The tile is one group's (never counted over the groups), so a
    group's bits are the same launched alone, among 16 or among 64; only
    the grid follows the group count and the card."""
    one = GM.plan(1, c, n, k)
    for q in (GM.plan(g, c, n, k), GM.plan(16, c, n, k),
              GM.plan(g, c, n, k, sms=114)):
        assert (q.cfg, q.block_m, q.block_n, q.tiles, q.a_box, q.b_box) == \
            (one.cfg, one.block_m, one.block_n, one.tiles, one.a_box,
             one.b_box)


def _view(shape, strides, offset=0):
    """A bf16 view ``offset`` elements past a 16-byte edge."""
    need = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    buf = torch.zeros(need + 16, dtype=torch.bfloat16)
    start = (8 - buf.data_ptr() % 16 // 2) % 8 + offset
    return buf.as_strided(shape, strides, start)


@pytest.mark.parametrize("x,w,match", [
    (_view((4, 3, 16), (48, 16, 1), offset=1), _view((4, 16, 8), (128, 8, 1)),
     "16-byte aligned"),
    (_view((4, 3, 16), (48, 16, 1)), _view((4, 16, 8), (128, 8, 1), offset=4),
     "16-byte aligned"),
    (_view((4, 3, 16), (60, 20, 1)), _view((4, 16, 8), (128, 8, 1)),
     "16-byte aligned"),
    (_view((4, 3, 16), (48, 16, 1)), _view((4, 16, 8), (160, 10, 1)),
     "16-byte aligned"),
    (_view((4, 3, 16), (52, 16, 1)), _view((4, 16, 8), (128, 8, 1)),
     "group stride"),
    (_view((4, 3, 16), (48, 16, 1)), _view((4, 16, 8), (132, 8, 1)),
     "group stride"),
    (_view((4, 3, 16), (48, 16, 1)), _view((4, 16, 12), (192, 12, 1)),
     "N % 8"),
    (_view((4, 3, 16), (48, 16, 1)).float(),
     _view((4, 16, 8), (128, 8, 1)), "bf16"),
])
def test_grouped_operand_check_raises_before_a_launch(x, w, match,
                                                      monkeypatch):
    """A misaligned base, a row or group stride that is not a multiple of
    8 elements, N % 8 != 0 or another dtype is refused before the library
    is built or a kernel launched (TMA would fault or read wrong rows)."""
    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(GM._build, "library", no_launch)
    before = GM.grouped_matmul.launches
    with pytest.raises(ValueError, match=match):
        GM.check_operands(x, w, torch.float32)
    with pytest.raises(ValueError, match=match):
        GM._launch(x, w, torch.float32)
    assert GM.grouped_matmul.launches == before


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_grouped_operand_check_accepts_a_group_stride_of_zero(out_dtype):
    """x broadcast to every group (the dense MoE oracle's input) and
    aligned strided groups are what the kernel takes; another output
    dtype is refused."""
    x = _view((3, 16), (16, 1)).expand(4, 3, 16)
    assert x.stride(0) == 0
    w = _view((2, 2, 16, 8), (256, 128, 8, 1)).reshape(4, 16, 8)
    GM.check_operands(x, w, out_dtype)
    GM.check_operands(_view((4, 3, 16), (64, 16, 1)),
                      _view((4, 16, 8), (0, 8, 1)), out_dtype)
    with pytest.raises(ValueError, match="f32 or bf16"):
        GM.check_operands(x, w, torch.float16)
