// Fused GEMM x collective kernels over the ranks of a PGL (paper Fig. 7-9).
// Ports of repro/kernels/collective_matmul.py::ag_matmul_fused,
// ::matmul_rs_fused and ::matmul_ar_fused; the design note is in
// kernels/collective_matmul.py.
//
// AG x GEMM: x: R slabs of (M x K) bf16 row shards, w: R slabs of (K x N)
// bf16; out: R slabs of (R*M x N) bf16, rows s*M.. of out[d] = x[s] @ w[d].
// It runs on the Hopper mainloop of hopper_gemm.cuh (TMA, mbarrier stages,
// wgmma); no block depends on another. GEMM x RS / AR keep the mma.sync
// tile of mm_tile.cuh.
//
// GEMM x RS / AR: x: R slabs of (M x K) bf16, w: R slabs of (K x N) bf16
// (K is each rank's shard of the reduction dim). landing: R owner slots of
// (R x M/R x N) f32; out: R slabs of (M/R x N) f32 (RS) or (M x N) f32
// (AR). flags: one int per (m tile, n tile), zeroed on the stream before
// every launch, so a launch that aborted part-way cannot leave a count
// behind for the next.
//
// Why neither can deadlock: no block ever waits for another. Each RS/AR
// block publishes its partial tile and counts itself in; only the block
// that finds all R partials published goes on to reduce them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"
#include "mm_tile.cuh"
#include "pk.cuh"

// GEMM x RS (kGather false) and GEMM x AR (true): store-and-count.
template <bool kGather>
__global__ void __launch_bounds__(MT_THREADS)
    pk_matmul_reduce_kernel(pk::PtrTable xs, pk::PtrTable ws,
                            pk::PtrTable lands, pk::PtrTable outs,
                            int* __restrict__ flags, int R, int M, int N,
                            int K) {
  __shared__ MmTileSmem sm;
  __shared__ int s_last;
  const int nt = blockIdx.x, mt = blockIdx.y, r = blockIdx.z;
  const int m0 = mt * MT_BM, n0 = nt * MT_BN;
  const int m_blk = M / R;

  // 1. this source rank's partial tile, f32
  float acc[2][4][4];
  mm_tile((const __nv_bfloat16*)xs.p[r], K, (const __nv_bfloat16*)ws.p[r],
          N, M, N, K, m0, n0, sm, acc);

  // 2. store_async into the owner rank's landing slot for source r
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        const int col = n0 + wn + j * 8 + t4 * 2;
        if (row >= M || col >= N) continue;
        const int o = row / m_blk, lr = row - o * m_blk;
        float* dst = (float*)lands.p[o] + ((long)r * m_blk + lr) * N + col;
        pk::store_async(reinterpret_cast<float2*>(dst),
                        make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]));
      }

  // 3. signal arrival; the last of the R source blocks reduces
  __threadfence();
  __syncthreads();
  int* flag = flags + mt * gridDim.x + nt;
  if (threadIdx.x == 0) {
    const int old = pk::signal(flag, 1);
    s_last = (old == R - 1);
    if (s_last) pk::wait(flag);  // acquire: every partial is visible now
  }
  __syncthreads();
  if (!s_last) return;

  // 4. sum the R partials in rank order; store to the owner (RS) or to
  //    every rank (AR: the all-gather half)
  for (int c = threadIdx.x; c < MT_BM * (MT_BN / 4); c += MT_THREADS) {
    const int row = m0 + c / (MT_BN / 4);
    const int col = n0 + (c % (MT_BN / 4)) * 4;
    if (row >= M || col >= N) continue;
    const int o = row / m_blk, lr = row - o * m_blk;
    const float* src = (const float*)lands.p[o] + (long)lr * N + col;
    const long slot = (long)m_blk * N;
    float4 s = __ldcg(reinterpret_cast<const float4*>(src));
    for (int rr = 1; rr < R; ++rr) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + rr * slot));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (kGather) {
      for (int d = 0; d < R; ++d)
        pk::store_async(reinterpret_cast<float4*>((float*)outs.p[d] +
                                                  (long)row * N + col),
                        s);
    } else {
      pk::store_async(
          reinterpret_cast<float4*>((float*)outs.p[o] + (long)lr * N + col),
          s);
    }
  }
}

namespace {

template <bool kGather>
int launch_reduce(const unsigned long long* x_ptrs,
                  const unsigned long long* w_ptrs,
                  const unsigned long long* landing_ptrs,
                  const unsigned long long* out_ptrs, void* flags, int R,
                  int M, int N, int K, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || M % R != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM, R);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * grid.x * grid.y, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  pk_matmul_reduce_kernel<kGather>
      <<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
          pk::table(x_ptrs, R), pk::table(w_ptrs, R),
          pk::table(landing_ptrs, R), pk::table(out_ptrs, R), (int*)flags,
          R, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// AG x GEMM on the Hopper mainloop: problem d * R + i is hop i of
// destination rank d; its A is the tensor map of source s = (d - i) mod R's
// x slab (the peer read is the gather), its B rank d's w, its rows s*M.. of
// out[d]. cfg and grid come from the plan (kernels/matmul.py::plan).
extern "C" int pk_ag_matmul_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* out_ptrs, int R,
                                 int M, int N, int K, int cfg, int grid,
                                 void* stream) {
  if (R < 1 || R > PK_MAX_RANKS) return (int)cudaErrorInvalidValue;
  const hg::Args g{R * R, R, 1, M, N, K};
  return hg::launch(x_ptrs, R, K, w_ptrs, R, N, out_ptrs, R, g, cfg, grid,
                    (cudaStream_t)stream);
}

extern "C" int pk_matmul_rs_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* landing_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, int R, int M, int N, int K,
                                 void* stream) {
  return launch_reduce<false>(x_ptrs, w_ptrs, landing_ptrs, out_ptrs, flags,
                              R, M, N, K, stream);
}

extern "C" int pk_matmul_ar_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* landing_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, int R, int M, int N, int K,
                                 void* stream) {
  return launch_reduce<true>(x_ptrs, w_ptrs, landing_ptrs, out_ptrs, flags,
                             R, M, N, K, stream);
}
