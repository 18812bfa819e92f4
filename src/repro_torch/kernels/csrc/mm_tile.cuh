// The mma.sync bf16 GEMM tile of the yardstick kernels: those that B1, B4,
// B5, B6 and B9 ran on before the Hopper mainloop (mm_tile_yardstick.cu),
// and the flash attention kernel that B7 ran on before its TMA + wgmma
// design (flash_mma_yardstick.cu, which uses the fragment helpers). No
// wrapper launches either; chip_smoke.py times them as the before-column.
// It began as the port of repro/kernels/matmul.py::_mm_kernel, the tile
// the Pallas fused kernels build on.
//
// One CTA of MT_THREADS = 128 threads (4 warps, 2 x 2) computes a
// MT_BM x MT_BN = 64 x 64 output tile of A (M x K, row-major) @ B (K x N,
// row-major), each warp a 32 x 32 sub-tile of 2 x 4 mma.sync m16n8k16
// tiles (bf16 in, f32 accumulate). K is streamed in MT_BK = 32 slices
// through shared memory: A as [m][k], B transposed to [n][k] so every
// mma fragment is a 32-bit load of two neighbouring k values. Ragged M, N
// and K edges are zero-filled. Rows of A and B must be 16-byte aligned
// (leading dimensions multiple of 8 elements).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#define MT_BM 64
#define MT_BN 64
#define MT_BK 32
#define MT_THREADS 128
// row stride of a shared slice in bf16: 80 bytes keeps the fragment loads
// of the 8 rows of a quad group on distinct banks
#define MT_LDS (MT_BK + 8)

struct alignas(16) MmTileSmem {
  __nv_bfloat16 a[MT_BM * MT_LDS];
  // [n][k], with 8 elements of padding after every 8 rows of n so the
  // transposing stores of one warp spread over the banks too
  __nv_bfloat16 b[MT_BN * MT_LDS + (MT_BN / 8) * 8];
};

__device__ __forceinline__ int mt_bidx(int n, int k) {
  return n * MT_LDS + (n >> 3) * 8 + k;
}

__device__ __forceinline__ uint32_t mt_ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b for one m16n8k16 tile; fragment layouts as in the PTX ISA
// (a: rows g / g+8, k pairs 2*t4 and 2*t4+8; b: k pairs, column g;
// d: rows g / g+8, columns 2*t4, 2*t4+1 where g = lane/4, t4 = lane%4).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j][e]: warp sub-tile i (m16) x j (n8); element e at
//   row = m0 + warp_m + 16 i + g + 8 (e >= 2),
//   col = n0 + warp_n + 8 j + 2 t4 + (e & 1),
// with warp_m = 32 (warp / 2), warp_n = 32 (warp % 2).
__device__ __forceinline__ void mm_tile(
    const __nv_bfloat16* __restrict__ A, long lda,
    const __nv_bfloat16* __restrict__ B, long ldb, int M, int N, int K,
    int m0, int n0, MmTileSmem& sm, float (&acc)[2][4][4]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = lane & 3;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MT_BK) {
    // A slice: MT_BM rows x MT_BK columns, 8 columns (16 bytes) a thread
    for (int c = tid; c < MT_BM * (MT_BK / 8); c += MT_THREADS) {
      const int row = c / (MT_BK / 8), col = (c % (MT_BK / 8)) * 8;
      const int gr = m0 + row, gc = k0 + col;
      alignas(16) __nv_bfloat16 v[8];
      if (gr < M && gc + 8 <= K) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(A + (long)gr * lda + gc);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (gr < M && gc + e < K) ? A[(long)gr * lda + gc + e]
                                        : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(&sm.a[row * MT_LDS + col]) =
          *reinterpret_cast<const uint4*>(v);
    }
    // B slice: MT_BK rows x MT_BN columns, read 8 columns a thread and
    // stored transposed
    for (int c = tid; c < MT_BK * (MT_BN / 8); c += MT_THREADS) {
      const int kr = c / (MT_BN / 8), nc = (c % (MT_BN / 8)) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
      alignas(16) __nv_bfloat16 v[8];
      if (gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(B + (long)gk * ldb + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (gk < K && gn + e < N) ? B[(long)gk * ldb + gn + e]
                                        : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.b[mt_bidx(nc + e, kr)] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MT_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = mt_ld32(&sm.a[r * MT_LDS + kk + t4 * 2]);
        af[i][1] = mt_ld32(&sm.a[(r + 8) * MT_LDS + kk + t4 * 2]);
        af[i][2] = mt_ld32(&sm.a[r * MT_LDS + kk + 8 + t4 * 2]);
        af[i][3] = mt_ld32(&sm.a[(r + 8) * MT_LDS + kk + 8 + t4 * 2]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        const uint32_t b0 = mt_ld32(&sm.b[mt_bidx(n, kk + t4 * 2)]);
        const uint32_t b1 = mt_ld32(&sm.b[mt_bidx(n, kk + 8 + t4 * 2)]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }
}
