// Fused GEMM x all-reduce over the ranks of a PGL (paper Fig. 9). Port of
// repro/kernels/collective_matmul.py::matmul_ar_fused; the design note is
// in kernels/collective_matmul.py.
//
// x: R slabs of (M x K) bf16, w: R slabs of (K x N) bf16 (K is each rank's
// shard of the reduction dim). landing: R owner slots of (R x M/R x N) f32;
// out: R slabs of (M x N) f32. flags: one int per (m tile, n tile), zeroed
// on the stream before every launch, so a launch that aborted part-way
// cannot leave a count behind for the next.
//
// Why it cannot deadlock: no block ever waits for another. Each block
// publishes its partial tile and counts itself in; only the block that
// finds all R partials published goes on to reduce them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mm_tile.cuh"
#include "pk.cuh"

__global__ void __launch_bounds__(MT_THREADS)
    pk_matmul_ar_kernel(pk::PtrTable xs, pk::PtrTable ws, pk::PtrTable lands,
                        pk::PtrTable outs, int* __restrict__ flags, int R,
                        int M, int N, int K) {
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

  // 4. sum the R partials in rank order; store to every rank (all-gather)
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
    for (int d = 0; d < R; ++d)
      pk::store_async(
          reinterpret_cast<float4*>((float*)outs.p[d] + (long)row * N + col),
          s);
  }
}

extern "C" int pk_matmul_ar_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* landing_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, int R, int M, int N, int K,
                                 void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || M % R != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  pk::PtrTable xs{}, ws{}, ls{}, os{};
  for (int i = 0; i < R; ++i) {
    xs.p[i] = x_ptrs[i];
    ws.p[i] = w_ptrs[i];
    ls.p[i] = landing_ptrs[i];
    os.p[i] = out_ptrs[i];
  }
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM, R);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * grid.x * grid.y, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  pk_matmul_ar_kernel<<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
      xs, ws, ls, os, (int*)flags, R, M, N, K);
  return (int)cudaGetLastError();
}
