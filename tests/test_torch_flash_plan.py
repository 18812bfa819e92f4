"""The flash attention kernel's plan and block schedule, on the CPU.

``kernels/flash_attention.py::flash_plan`` is the launch of the TMA +
``wgmma`` kernel (``csrc/flash_attention.cu``): the persistent grid and the
strides of the three 4-D tensor maps, which the wrapper passes to the
launcher, beside the tiles, stages and shared memory the card tests hold
against the built kernel; ``kv_blocks`` is the Python twin of
the device's block list (``kv_range``), which the producer and the
consumers both walk. They are pure Python, so their promises are checked
here at every shape the model paths and ``chip_smoke.py`` give the kernel:
the prefill buckets at tinyllama, moonshot and h2o-danube widths, the
training microbatch, the four hops of the sequence-parallel path,
whisper's encoder and cross-attention (non-causal, Sq != Skv), the card
tests' ragged shapes, head_dim 16/64/120/128 (padded to 64 or 128),
causal, windowed and neither. Every visible (row, key) pair of the plain
version's mask lies in a scheduled block, no scheduled block is wholly
masked for its query tile, rank 0 schedules nothing at hops >= 1, the
shared memory fits a block, and strides that TMA refuses raise before any
launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402

SMEM_PER_BLOCK = 232448         # an H100 block's shared memory limit

# (B, Hq, Hkv, S, head_dim, causal, window) as the paths launch them: the
# prefill buckets (128, 512) at tinyllama-1.1b (32 q heads, 4 KV heads of
# 64), moonshot-v1-16b-a3b (16 of 128, MHA) and h2o-danube-3-4b (32 and 8
# of 120, window 4096); the training microbatch; the card tests' ragged
# lengths, GQA ratios and windows
FORWARD = [(4, 32, 4, 512, 64, True, None), (4, 32, 4, 128, 64, True, None),
           (4, 16, 16, 512, 128, True, None),
           (4, 16, 16, 128, 128, True, None),
           (4, 32, 8, 512, 120, True, 4096), (4, 32, 8, 128, 120, True, 4096),
           (2, 32, 8, 512, 120, True, 4096), (1, 4, 2, 100, 64, True, None),
           (2, 8, 2, 200, 128, True, 32), (1, 2, 2, 64, 64, False, None),
           (1, 4, 1, 130, 128, True, None), (2, 8, 2, 200, 16, True, 32),
           (1, 8, 8, 1, 64, True, None), (1, 8, 1, 60, 64, False, None),
           (2, 32, 4, 405, 128, True, 100), (1, 4, 4, 130, 64, False, 7)]
# (B, Hq, Hkv, Sq, Skv, head_dim) of non-causal attention with queries
# and keys of their own lengths: whisper-medium's encoder (16 heads of 64
# over 1500 frames), its cross-attention (the training run's 448 decoder
# tokens, the serving check's 4-token prompt, one decode token) over the
# 1500 frames, and the card tests' ragged pairs at both widths
CROSS = [(8, 16, 16, 1500, 1500, 64), (4, 16, 16, 448, 1500, 64),
         (8, 16, 16, 4, 1500, 64)] + [
    (2, 8, 2, sq, skv, hd) for sq, skv in ((448, 1500), (1, 1500), (60, 130),
                                           (130, 60))
    for hd in (64, 128)]
# (R, B, Hq, Hkv, S, head_dim, causal, window) of the hop: the SP path's
# ring (tinyllama at seq 8192 on 4 ranks), the card tests' shapes
HOPS = [(4, 1, 32, 4, 2048, 64, True, None), (4, 2, 8, 2, 96, 64, True, None),
        (4, 2, 8, 2, 96, 120, True, 24), (4, 2, 8, 2, 96, 16, False, None),
        (4, 2, 8, 2, 96, 128, True, 24), (2, 1, 4, 1, 60, 64, True, None),
        (4, 1, 4, 4, 130, 64, True, 200), (2, 1, 4, 2, 405, 128, True, None)]


def _width(hd: int) -> int:
    return next(w for w in FA.KERNEL_HEAD_DIMS if hd <= w)


def _visible(sq, skv, q_off, kv_off, causal, window) -> np.ndarray:
    """The plain version's mask at global offsets, (sq, skv) bools."""
    qi = q_off + np.arange(sq)[:, None]
    ki = kv_off + np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    return keep


def _check_schedule(sq, skv, q_off, kv_off, causal, window, bk) -> int:
    """Every visible pair in a scheduled block (of ``bk`` keys), no
    scheduled block wholly masked for its query tile; the number of
    scheduled blocks."""
    keep = _visible(sq, skv, q_off, kv_off, causal, window)
    n = 0
    for t in range(-(-sq // FA.BLOCK_Q)):
        rows = keep[t * FA.BLOCK_Q:(t + 1) * FA.BLOCK_Q]
        blocks = FA.kv_blocks(t, block_k=bk, sq=sq, skv=skv, causal=causal,
                              window=window, q_off=q_off, kv_off=kv_off)
        cols = np.zeros(skv, bool)
        for kb in blocks:
            part = rows[:, kb * bk:(kb + 1) * bk]
            assert part.shape[1] > 0, (t, kb)
            assert part.any(), f"tile {t} schedules block {kb}, all masked"
            cols[kb * bk:(kb + 1) * bk] = True
        assert not (rows & ~cols[None, :]).any(), \
            f"tile {t} leaves a visible pair out of {list(blocks)}"
        n += len(blocks)
    return n


@pytest.mark.parametrize("b,hq,hkv,s,hd,causal,window", FORWARD)
def test_forward_schedule_covers_the_mask_exactly(b, hq, hkv, s, hd, causal,
                                                  window):
    bk = FA.BLOCK_K[_width(hd)]
    n = _check_schedule(s, s, 0, 0, causal, window, bk)
    if causal and window is None:     # tile t reads the keys up to its end
        tiles = -(-s // FA.BLOCK_Q)
        assert n == sum(-(-min((t + 1) * FA.BLOCK_Q, s) // bk)
                        for t in range(tiles))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,hd", CROSS)
def test_cross_schedule_reads_every_key_block(b, hq, hkv, sq, skv, hd):
    """Non-causal with Sq != Skv: every query tile schedules every key
    block, the ragged last one included, and its plan takes the
    projections' head-transposed views as they are."""
    bk = FA.BLOCK_K[_width(hd)]
    n = _check_schedule(sq, skv, 0, 0, False, None, bk)
    assert n == -(-sq // FA.BLOCK_Q) * -(-skv // bk)
    q = torch.empty(b, sq, hq, _width(hd)).transpose(1, 2)
    k = torch.empty(b, skv, hkv, _width(hd)).transpose(1, 2)
    p = FA.flash_plan(q.shape, q.stride(), k.shape, k.stride(), k.stride())
    assert p.tiles == -(-sq // FA.BLOCK_Q) * b * hq
    for i, t in enumerate((q, k, k)):
        for dim, x in zip((0, 1, 2), p.strides[3 * i:3 * i + 3]):
            if t.shape[dim] > 1:
                assert x == t.stride(dim)


@pytest.mark.parametrize("r,b,hq,hkv,s,hd,causal,window", HOPS)
def test_hop_schedule_at_global_offsets(r, b, hq, hkv, s, hd, causal, window):
    """Each rank's blocks at each hop cover its visible pairs exactly; a
    causal rank whose keys come from a later rank (src > rank, so rank 0 at
    every hop >= 1) schedules nothing, and its rows see no key."""
    for hop in range(r):
        q_off, kv_off = FA._hop_offsets(r * b, r, hop, s, s)
        for rank in range(r):
            qo, ko = int(q_off[rank * b]), int(kv_off[rank * b])
            n = _check_schedule(s, s, qo, ko, causal, window,
                                FA.BLOCK_K[_width(hd)])
            src = (rank - hop) % r
            if causal and src > rank:
                assert n == 0
                assert not _visible(s, s, qo, ko, causal, window).any()
            if causal and rank == 0 and hop >= 1:
                assert n == 0


@pytest.mark.parametrize("b,hq,hkv,s,hd,causal,window", FORWARD)
@pytest.mark.parametrize("strided", [False, True])
def test_plan_at_the_paths_shapes(b, hq, hkv, s, hd, causal, window,
                                  strided):
    """The plan of the padded width: tiles, a persistent grid of one block
    an SM at most on the card it is given, shared memory within a block's
    limit, map strides TMA takes (multiples of 16 bytes below 2^40 bytes),
    the strides of prefill's head-transposed views taken as they are."""
    w = _width(hd)
    if strided:           # (B, S, H, D) projections viewed as (B, H, S, D)
        q = torch.empty(b, s, hq, w).transpose(1, 2)
        k = torch.empty(b, s, hkv, w).transpose(1, 2)
    else:
        q, k = torch.empty(b, hq, s, w), torch.empty(b, hkv, s, w)
    p = FA.flash_plan(q.shape, q.stride(), k.shape, k.stride(), k.stride())
    bk, stages = {64: (128, 3), 128: (64, 3)}[w]
    assert (p.block_q, p.block_k, p.stages, p.threads) == (128, bk, stages,
                                                           384)
    n_qt = -(-s // 128)
    assert p.tiles == n_qt * b * hq and p.grid == min(p.tiles, 132)
    small = FA.flash_plan(q.shape, q.stride(), k.shape, k.stride(),
                          k.stride(), sms=7)
    assert small.grid == min(p.tiles, 7)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert p.smem_bytes == (128 * w * 2 + stages * 2 * bk * w * 2 + 1024
                            + 8 * (6 + 3 * stages) + 8)
    for i, t in enumerate((q, k, k)):         # q's, k's, v's (b, h, s)
        st = p.strides[3 * i:3 * i + 3]
        assert all(x * 2 % 16 == 0 and 0 < x * 2 < 2 ** 40 for x in st)
        for dim, x in zip((0, 1, 2), st):
            if t.shape[dim] > 1:
                assert x == t.stride(dim)


def test_plan_shared_memory_at_both_widths():
    assert FA.smem_bytes(64) == 16384 + 3 * 32768 + 1024 + 128
    assert FA.smem_bytes(128) == 32768 + 3 * 32768 + 1024 + 128
    assert all(FA.smem_bytes(w) <= SMEM_PER_BLOCK
               for w in FA.KERNEL_HEAD_DIMS)


def test_plan_normalises_unit_dims():
    """A dimension of extent 1 is read at coordinate 0 only: its stride,
    whatever the view says (here 3 elements, which TMA would refuse), is
    replaced by a contiguous one."""
    q = torch.empty(1, 4, 1, 64)
    p = FA.flash_plan((1, 4, 1, 64), (3, 64, 3, 1), (1, 4, 1, 64),
                      q.stride(), q.stride())
    assert p.strides[:3] == (256, 64, 64)
    assert p.strides[3:] == (256, 64, 64) * 2


@pytest.mark.parametrize("bad,match", [
    (dict(q=(512 * 64, 64, 65, 1)), "multiples of 16 bytes"),
    (dict(k=(2 ** 39, 64, 64, 1)), "below 2\\^40"),
    (dict(v=(4 * 512 * 64, 512 * 64, 64, 2)), "unit head_dim"),
    (dict(q=(4 * 512 * 64, 4, 64, 1)), "multiples of 16 bytes"),
])
def test_plan_refuses_what_tma_refuses(bad, match):
    """Strides TMA refuses — not a multiple of 16 bytes, 2^40 bytes or more,
    a head_dim stride other than 1 — raise before any launch."""
    b, hq, hkv, s, d = 2, 4, 4, 512, 64
    st = dict(q=(hq * s * d, s * d, d, 1), k=(hkv * s * d, s * d, d, 1),
              v=(hkv * s * d, s * d, d, 1))
    st.update(bad)
    with pytest.raises(ValueError, match=match):
        FA.flash_plan((b, hq, s, d), st["q"], (b, hkv, s, d), st["k"],
                      st["v"])


def test_plan_refuses_uninstantiated_widths():
    with pytest.raises(ValueError, match="head_dim"):
        st = (1920, 960, 120, 1)
        FA.flash_plan((1, 2, 8, 120), st, (1, 2, 8, 120), st, st)
