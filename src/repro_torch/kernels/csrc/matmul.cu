// B1: out (M x N, bf16) = x (M x K) @ w (K x N), f32 accumulation, for one
// w or a stack of Z vocab shards in one launch (out slab z = x @ w[z]).
// Port of repro/kernels/matmul.py::matmul on the Hopper mainloop of
// hopper_gemm.cuh (TMA, mbarrier stages, wgmma); kernels/matmul.py holds
// the plan that picks the regime, the tile and the grid.
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

// x: one (M x K) operand, rows ldx apart; w_ptrs: Z slabs of (K x N), rows
// ldw apart; out_ptrs: Z slabs of (M x N) bf16, rows ldo apart; cfg and
// grid from the plan. N need not be a multiple of 8 (a vocab shard of
// 12967 columns): ldw and ldo are, and ldo's padding takes the last chunk.
extern "C" int pk_matmul_bf16(const void* x, long long ldx,
                              const unsigned long long* w_ptrs, int Z,
                              long long ldw,
                              const unsigned long long* out_ptrs,
                              long long ldo, int M, int N, int K, int cfg,
                              int grid, void* stream) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(x);
  const hg::Args g{Z, 1, hg::kStacked, M, N, K};
  return hg::launch_bf16(&a, 1, ldx, w_ptrs, Z, ldw, out_ptrs, Z, ldo, g,
                         cfg, grid, static_cast<cudaStream_t>(stream));
}
