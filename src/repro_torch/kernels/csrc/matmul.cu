// Tiled bf16 GEMM: out (M x N, bf16) = x (M x K) @ w (K x N), f32
// accumulation. Port of repro/kernels/matmul.py::matmul; see
// kernels/matmul.py for the design note and mm_tile.cuh for the tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mm_tile.cuh"

__global__ void __launch_bounds__(MT_THREADS)
    pk_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     long ldx, long ldw, long ldo) {
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

extern "C" int pk_matmul_bf16(const void* x, const void* w, void* out, int M,
                              int N, int K, long long ldx, long long ldw,
                              long long ldo, void* stream) {
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM);
  pk_matmul_kernel<<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out,
      M, N, K, (long)ldx, (long)ldw, (long)ldo);
  return (int)cudaGetLastError();
}
