// The mma.sync GEMM-tile kernels (mm_tile.cuh) that B1 (matmul) and B5
// (AG x GEMM) ran on before the Hopper mainloop (hopper_gemm.cuh) took their
// place. No wrapper launches them: chip_smoke.py times them beside the
// kernels that replaced them, on the same inputs in the same run, as the
// before-column of the kernels table.
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
