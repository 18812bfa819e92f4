// The mma.sync GEMM-tile kernels (mm_tile.cuh) that B1 (matmul), B5
// (AG x GEMM), B6 (GEMM x RS), B4 (GEMM x AR) and B9 (the grouped GEMM) ran
// on before the Hopper mainloop (hopper_gemm.cuh) took their place. No
// wrapper launches them:
// chip_smoke.py times them beside the kernels that replaced them, on the
// same inputs in the same run, as the before-column of the kernels table.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mm_tile.cuh"
#include "pk.cuh"

// out (M x N, bf16) = x (M x K) @ w (K x N), one 64 x 64 tile a block
__global__ void __launch_bounds__(MT_THREADS)
    pk_mm_tile_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             __nv_bfloat16* __restrict__ out, int M, int N,
                             int K, long ldx, long ldw, long ldo) {
  __shared__ MmTileSmem sm;
  float acc[2][4][4];
  const int m0 = blockIdx.y * MT_BM, n0 = blockIdx.x * MT_BN;
  mm_tile(x, ldx, w, ldw, M, N, K, m0, n0, sm, acc);

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
        if (row >= M) continue;
        __nv_bfloat16* dst = out + (long)row * ldo + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (col + 1 < N && (ldo % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) dst[0] = __float2bfloat16(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
}

// AG x GEMM: grid (n tile, m tile, d * R + i); hop i of the right-going
// ring brings rank d the shard of rank s = (d - i) mod R.
__global__ void __launch_bounds__(MT_THREADS)
    pk_mm_tile_ag_matmul_kernel(pk::PtrTable xs, pk::PtrTable ws,
                                pk::PtrTable outs, int R, int M, int N,
                                int K) {
  __shared__ MmTileSmem sm;
  const int nt = blockIdx.x, mt = blockIdx.y;
  const int d = blockIdx.z / R, i = blockIdx.z - d * R;
  const int s = (d - i + R) % R;
  const int m0 = mt * MT_BM, n0 = nt * MT_BN;

  float acc[2][4][4];
  mm_tile((const __nv_bfloat16*)xs.p[s], K, (const __nv_bfloat16*)ws.p[d],
          N, M, N, K, m0, n0, sm, acc);

  __nv_bfloat16* out = (__nv_bfloat16*)outs.p[d] + (long)s * M * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + a * 16 + g + h * 8;
        const int col = n0 + wn + j * 8 + t4 * 2;  // N even: col + 1 < N
        if (row >= M || col >= N) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long)row * N + col) =
            __floats2bfloat162_rn(acc[a][j][2 * h], acc[a][j][2 * h + 1]);
      }
}

extern "C" int pk_mm_tile_matmul_bf16(const void* x, const void* w, void* out,
                                      int M, int N, int K, long long ldx,
                                      long long ldw, long long ldo,
                                      void* stream) {
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM);
  pk_mm_tile_matmul_kernel<<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out,
      M, N, K, (long)ldx, (long)ldw, (long)ldo);
  return (int)cudaGetLastError();
}

extern "C" int pk_mm_tile_ag_matmul_bf16(const unsigned long long* x_ptrs,
                                         const unsigned long long* w_ptrs,
                                         const unsigned long long* out_ptrs,
                                         int R, int M, int N, int K,
                                         void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || N % 2 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM, R * R);
  pk_mm_tile_ag_matmul_kernel<<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
      pk::table(x_ptrs, R), pk::table(w_ptrs, R), pk::table(out_ptrs, R), R,
      M, N, K);
  return (int)cudaGetLastError();
}

// GEMM x RS (kGather false) and GEMM x AR (true), store-and-count: grid (n
// tile, m tile, source rank r); the block stores its partial tile into the
// owners' landing slots, counts in on the tile's flag, and the last of the
// R source blocks sums the partials in rank order.
template <bool kGather>
__global__ void __launch_bounds__(MT_THREADS)
    pk_mm_tile_matmul_reduce_kernel(pk::PtrTable xs, pk::PtrTable ws,
                                    pk::PtrTable lands, pk::PtrTable outs,
                                    int* __restrict__ flags, int R, int M,
                                    int N, int K) {
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

// landing: R owner slots of (R x M/R x N) f32; flags: one int per 64 x 64
// output tile, zeroed here before the launch
template <bool kGather>
int launch_mm_tile_reduce(const unsigned long long* x_ptrs,
                          const unsigned long long* w_ptrs,
                          const unsigned long long* landing_ptrs,
                          const unsigned long long* out_ptrs, void* flags,
                          int R, int M, int N, int K, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || M % R != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM, R);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * grid.x * grid.y, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  pk_mm_tile_matmul_reduce_kernel<kGather>
      <<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
          pk::table(x_ptrs, R), pk::table(w_ptrs, R),
          pk::table(landing_ptrs, R), pk::table(out_ptrs, R), (int*)flags,
          R, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pk_mm_tile_matmul_rs_bf16(const unsigned long long* x_ptrs,
                                         const unsigned long long* w_ptrs,
                                         const unsigned long long* landing_ptrs,
                                         const unsigned long long* out_ptrs,
                                         void* flags, int R, int M, int N,
                                         int K, void* stream) {
  return launch_mm_tile_reduce<false>(x_ptrs, w_ptrs, landing_ptrs, out_ptrs,
                                      flags, R, M, N, K, stream);
}

extern "C" int pk_mm_tile_matmul_ar_bf16(const unsigned long long* x_ptrs,
                                         const unsigned long long* w_ptrs,
                                         const unsigned long long* landing_ptrs,
                                         const unsigned long long* out_ptrs,
                                         void* flags, int R, int M, int N,
                                         int K, void* stream) {
  return launch_mm_tile_reduce<true>(x_ptrs, w_ptrs, landing_ptrs, out_ptrs,
                                     flags, R, M, N, K, stream);
}

__device__ __forceinline__ void gm_store2(float* dst, float v0, float v1,
                                          bool has1) {
  if (has1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
  }
}

__device__ __forceinline__ void gm_store2(__nv_bfloat16* dst, float v0,
                                          float v1, bool has1) {
  if (has1) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
  }
}

// The grouped GEMM: grid (ceil(N / 64), ceil(C / 64), G), the group on
// blockIdx.z; each operand addressed by a group stride and a row stride (a
// stride-0 group broadcasts x to every group); ragged C, N and K masked.
template <typename OutT>
__global__ void __launch_bounds__(MT_THREADS)
    pk_mm_tile_grouped_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ w,
                                     OutT* __restrict__ out, int C, int N,
                                     int K, long sxg, long ldx, long swg,
                                     long ldw, long sog, long ldo) {
  __shared__ MmTileSmem sm;
  float acc[2][4][4];
  const long gi = blockIdx.z;
  const int m0 = blockIdx.y * MT_BM, n0 = blockIdx.x * MT_BN;
  mm_tile(x + gi * sxg, ldx, w + gi * swg, ldw, C, N, K, m0, n0, sm, acc);

  OutT* o = out + gi * sog;
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
        if (row >= C || col >= N) continue;
        // N, ldo and sog are even (the caller requires N % 8 == 0), so a
        // pair of columns starting at an even col is aligned
        gm_store2(o + (long)row * ldo + col, acc[i][j][2 * h],
                  acc[i][j][2 * h + 1], col + 1 < N);
      }
}

// out_f32: 1 for an f32 output, 0 for bf16. Strides in elements.
extern "C" int pk_mm_tile_grouped_matmul_bf16(
    const void* x, const void* w, void* out, int G, int C, int N, int K,
    long long sxg, long long ldx, long long swg, long long ldw,
    long long sog, long long ldo, int out_f32, void* stream) {
  dim3 grid((N + MT_BN - 1) / MT_BN, (C + MT_BM - 1) / MT_BM, G);
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const __nv_bfloat16* wp = (const __nv_bfloat16*)w;
  if (out_f32) {
    pk_mm_tile_grouped_matmul_kernel<float>
        <<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
            xp, wp, (float*)out, C, N, K, (long)sxg, (long)ldx, (long)swg,
            (long)ldw, (long)sog, (long)ldo);
  } else {
    pk_mm_tile_grouped_matmul_kernel<__nv_bfloat16>
        <<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
            xp, wp, (__nv_bfloat16*)out, C, N, K, (long)sxg, (long)ldx,
            (long)swg, (long)ldw, (long)sog, (long)ldo);
  }
  return (int)cudaGetLastError();
}
