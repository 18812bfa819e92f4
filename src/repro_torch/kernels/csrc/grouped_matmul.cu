// B9: out[z] (C x N) = x[z] (C x K) @ w[z] (K x N) for every group z in one
// launch, f32 accumulation, f32 or bf16 output. Port of
// repro/kernels/grouped_matmul.py::grouped_matmul on the Hopper mainloop of
// hopper_gemm.cuh (kGrouped: 3-D tensor maps, the group the outermost
// coordinate; the StoreGrouped epilogue); kernels/grouped_matmul.py holds
// the design note and the plan that picks the regime, the tile and the
// grid.
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

// x, w: bf16, strides in elements (a group stride of 0 broadcasts the
// operand to every group); out: (G x C x N) f32 (out_f32 1) or bf16 at
// group stride sog and row stride ldo; cfg and grid from the plan.
extern "C" int pk_grouped_matmul_bf16(const void* x, const void* w, void* out,
                                      int G, int C, int N, int K,
                                      long long sxg, long long ldx,
                                      long long swg, long long ldw,
                                      long long sog, long long ldo,
                                      int out_f32, int cfg, int grid,
                                      void* stream) {
  const hg::Args g{G, 1, hg::kGrouped, C, N, K};
  const auto xp = reinterpret_cast<unsigned long long>(x);
  const auto wp = reinterpret_cast<unsigned long long>(w);
  const auto op = reinterpret_cast<unsigned long long>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return hg::launch_grouped(xp, sxg, ldx, wp, swg, ldw,
                              hg::StoreGrouped<float>{op, sog, ldo}, g, cfg,
                              grid, s);
  return hg::launch_grouped(xp, sxg, ldx, wp, swg, ldw,
                            hg::StoreGrouped<__nv_bfloat16>{op, sog, ldo}, g,
                            cfg, grid, s);
}
