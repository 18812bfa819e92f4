// Grouped bf16 GEMM: out[g] (C x N) = x[g] (C x K) @ w[g] (K x N) for every
// group g in one launch, f32 accumulation, f32 or bf16 output. Port of
// repro/kernels/grouped_matmul.py::grouped_matmul; see
// kernels/grouped_matmul.py for the design note and mm_tile.cuh for the
// tile. Grid (ceil(N / 64), ceil(C / 64), G): the group rides blockIdx.z,
// as the expert axis is a parallel grid axis of the Pallas kernel. Each
// operand is addressed by a group stride and a row stride (a stride-0
// group broadcasts x to every group); ragged C, N and K are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mm_tile.cuh"

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

template <typename OutT>
__global__ void __launch_bounds__(MT_THREADS)
    pk_grouped_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             OutT* __restrict__ out, int C, int N, int K,
                             long sxg, long ldx, long swg, long ldw,
                             long sog, long ldo) {
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
        // N, ldo and sog are even (the wrapper requires N % 8 == 0), so a
        // pair of columns starting at an even col is aligned
        gm_store2(o + (long)row * ldo + col, acc[i][j][2 * h],
                  acc[i][j][2 * h + 1], col + 1 < N);
      }
}

// out_f32: 1 for an f32 output, 0 for bf16. Strides in elements.
extern "C" int pk_grouped_matmul_bf16(const void* x, const void* w, void* out,
                                      int G, int C, int N, int K,
                                      long long sxg, long long ldx,
                                      long long swg, long long ldw,
                                      long long sog, long long ldo,
                                      int out_f32, void* stream) {
  dim3 grid((N + MT_BN - 1) / MT_BN, (C + MT_BM - 1) / MT_BM, G);
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const __nv_bfloat16* wp = (const __nv_bfloat16*)w;
  if (out_f32) {
    pk_grouped_matmul_kernel<float><<<grid, MT_THREADS, 0,
                                      (cudaStream_t)stream>>>(
        xp, wp, (float*)out, C, N, K, (long)sxg, (long)ldx, (long)swg,
        (long)ldw, (long)sog, (long)ldo);
  } else {
    pk_grouped_matmul_kernel<__nv_bfloat16><<<grid, MT_THREADS, 0,
                                              (cudaStream_t)stream>>>(
        xp, wp, (__nv_bfloat16*)out, C, N, K, (long)sxg, (long)ldx,
        (long)swg, (long)ldw, (long)sog, (long)ldo);
  }
  return (int)cudaGetLastError();
}
