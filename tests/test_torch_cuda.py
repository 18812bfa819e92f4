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


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (65, 40, 72), (130, 264, 136),
                                   (8, 2048, 8000), (2048, 2048, 1408)])
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
