// The Hopper GEMM mainloop shared by kernels/matmul.py (the port of
// repro/kernels/matmul.py::matmul), the three GEMM x collective kernels
// of kernels/collective_matmul.py (the ports of
// repro/kernels/collective_matmul.py::ag_matmul_fused, ::matmul_rs_fused
// and ::matmul_ar_fused) and the grouped expert GEMM of
// kernels/grouped_matmul.py (the port of
// repro/kernels/grouped_matmul.py::grouped_matmul).
//
// A (M x K, bf16, row-major) @ B (K x N, bf16, row-major), f32
// accumulation, for Z problems in one launch. Problem z reads A and B
// through tensor maps of a MapTable (HgProblem below): the stacked form of
// B1 (one x, R vocab shards of w), B5 (block (d, i) reads source s = (d -
// i) mod R's x slab), the reduce of B4/B6 (problem r is source rank r's
// partial product x[r] @ w[r]) and the groups of B9 (problem z is group
// z, read from 3-D maps at group coordinate z) are four decodings of z.
// What a finished tile's accumulator becomes is the kernel's epilogue, a
// template parameter: StoreBf16 below stores it in bf16 (B1, B5),
// StoreGrouped in f32 or bf16 at a group's strides (B9); the
// store-and-count epilogue of collective_matmul.cu reduces the R ranks'
// partials (B4, B6). The flash attention kernel (B7, flash_attention.cu)
// builds on the same device pieces: mbarriers, TMA (4-D maps), shared-memory
// descriptors and the quad-transposed stores.
//
// What bounds it on an H100 SXM, and what the design does about it:
//
// * compute-bound (M >= 65: prefill, the loss, the MLP GEMMs of B5):
//   2*M*N*K operations over 989 TFLOP/s. Only wgmma reaches that rate, and
//   only when its operands arrive in shared memory ahead of it. A block of
//   three warpgroups computes 128 x 256 (or 128 x 192) output tiles: one
//   producer thread issues TMA loads of 128 x 64 A and 64 x 256 B tiles
//   into a ring of 4 stages (5 at 192; 128-byte swizzle, 48 KB a stage),
//   two consumer warpgroups each run wgmma m64n256k16 on their 64 rows
//   (the accumulator is 128 of a thread's 168 registers; no spills). Each
//   stage has a full mbarrier (the producer's expect_tx; TMA completes the
//   bytes) and an empty one (every consumer warp arrives once the wgmma
//   that read the stage has retired: wait_group 1 keeps one K step of
//   wgmma in flight). The grid is persistent, one block an SM walking the
//   tiles, so the ring does not drain between tiles and the next tile's
//   loads overlap this tile's epilogue. Wide tiles matter: each block
//   re-reads its A and B tiles from L2, 48 KB per 4.2 MFLOP at 128 x 256
//   against 32 KB per 2.1 MFLOP at 128 x 128, which measured slower.
//   Multicasting B to the two blocks of a 2-block cluster (a third less L2
//   traffic) measured no faster, so L2 is not what bounds the wide tile;
//   the time outside the mainloop is (the epilogue below, the last wave).
//   The plan takes 192 columns where that fills more SMs in the last wave.
// * bytes-bound (M <= 64: the decode logits, a few tokens against a 33 to
//   168 MB weight): B's bytes over 3.35 TB/s. The tensor-core work of a
//   64-row wgmma with 8 real rows is noise next to streaming w, so the same
//   mainloop runs with one consumer warpgroup, 64 x 64 tiles and 6 stages
//   (16 KB each, 48 KB of w in flight a block, two blocks an SM), and x's
//   box shrinks to M rounded up to 8 rows. The serving path multiplies the
//   tokens by all R vocab shards in one launch (R x 125 tiles at tinyllama,
//   R x 254 at falcon-mamba), which fills the card. K is never split: even
//   at one rank's shard alone (125 tiles), splitting K in two and summing
//   the f32 partials in a second kernel measured slower than one block a
//   tile. Swapping A and B (w as the 64-row operand) would waste less
//   tensor-core work but needs an MN-major A; the waste is not what bounds
//   this regime.
//
// Ragged M, N and K edges come from TMA's zero fill (a box counts its full
// bytes toward complete_tx even where it fills zeros); rows and columns
// past M and N are masked at the store. TMA needs 16-byte-aligned bases
// and row strides: the wrappers check both and raise before a launch.
//
// Grouped (B9: 64 groups on the MoE path, more than a MapTable holds):
// x is one 3-D map (K, M, groups) and w one (N, K, groups), the group
// outermost, boxes one group deep. TMA zero-fills per dimension, so the
// box at a group's K or M edge reads zeros, never the next group's rows
// (which may hold anything, inf included: 0 * inf is NaN). An operand with
// a group stride of 0 (x broadcast to every group) is a map of one group,
// read at group 0.
//
// The shared-memory matrix descriptors (PTX ISA, wgmma "matrix
// descriptor"): start address >> 4; for A, K-major 128B swizzle, the
// stride between 8-row groups (SBO) is 1024 bytes and a k16 step advances
// the start address by 32 bytes inside the swizzle atom; for B, MN-major
// 128B swizzle (the transpose-b immediate), each TMA box is one 64-column
// atom of 64 K rows, the stride between atoms (LBO) is 8192 bytes, between
// 8-row K groups (SBO) 1024 bytes, and a k16 step advances 2048 bytes.
// Every stage starts on a 1024-byte boundary, as the swizzle requires.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links the runtime only,
// and are passed as __grid_constant__ kernel parameters. The mbarrier, TMA
// and encode helpers are in tma.cuh.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

#define HG_MAX_MAPS 8
#define HG_BK 64                // K a stage: 64 bf16 = one 128-byte row
#define HG_ATOM_BYTES 8192      // one 64 x 64 bf16 swizzled box
#define HG_SLOTS 2              // tiles in flight from consumers to drainers
#define HG_DRAIN_WARPS 3        // warps 1-3 of the producer warpgroup

namespace hg {

struct MapTable {
  CUtensorMap m[HG_MAX_MAPS];
};

struct OutTable {
  unsigned long long p[HG_MAX_MAPS];
};

// How a launch's problem index z decodes (Args::mode)
enum Mode { kStacked = 0, kGather = 1, kReduce = 2, kGrouped = 3 };

// problem z of a launch: A map a, B map b, output slab o, first row row0
struct HgProblem {
  int a, b, o, row0;
};

// kStacked: problem z multiplies A map 0 by B map z into slab z (matmul
// and its stacked form); kGather: z = d * R + i is hop i of destination
// rank d, source s = (d - i) mod R: A map s, B map d, rows s*M.. of slab d;
// kReduce: z is source rank r: A map r, B map r, no output slab (the
// epilogue stores the partial into the owners' landing slots); kGrouped: z
// is group z of A map 0 and B map 0 (3-D), output group z.
__device__ __forceinline__ HgProblem problem(int z, int R, int M, int mode) {
  if (mode == kStacked) return {0, z, z, 0};
  if (mode == kReduce) return {z, z, -1, 0};
  if (mode == kGrouped) return {0, 0, z, 0};
  const int d = z / R, i = z - d * R;
  const int s = (d - i + R) % R;
  return {s, d, d, s * M};
}

// a 128B-swizzled shared-memory matrix descriptor (lbo, sbo in bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a @ b for one m64n64k16 step: a K-major, b MN-major (trans-b),
// both through 128B-swizzled shared-memory descriptors; scale_d 0 drops d.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same for m64n192k16
__device__ __forceinline__ void wgmma_m64n192(float (&d)[96], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same for m64n256k16
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// v[i] for a runtime i, without indexing a register array at run time
template <class U>
__device__ __forceinline__ U pick4(const U (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// The quad transpose of the stores: lane t4 of each quad holds unit t4 (two
// neighbouring columns) of 4 chunks, mine[c] of chunk c; after it, got[i]
// is unit i of chunk t4, so a lane holds one chunk's columns in order.
template <class U>
__device__ __forceinline__ void quad_transpose(const U (&mine)[4],
                                               U (&got)[4], int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // send my share of chunk (t4 - r), receive lane (t4 + r)'s share of
    // chunk t4
    const int src = (t4 + r) & 3;
    const U v =
        __shfl_sync(0xffffffffu, pick4(mine, (t4 - r) & 3), (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) got[i] = src == i ? v : got[i];
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64(d, da, db, scale_d);
  else if constexpr (BN == 192)
    wgmma_m64n192(d, da, db, scale_d);
  else
    wgmma_m64n256(d, da, db, scale_d);
}

// A launch: Z problems of M x N x K.
struct Args {
  int Z, R, mode, M, N, K;
  int a_rows;  // rows of x's TMA box: min(block rows, M rounded up to 8)
  // kGrouped: the group coordinate of A's and B's map is z * step (0 for
  // an operand that serves every group)
  int a_gstep, b_gstep;
};

// one output tile of one problem: its problem, z, row and column tile
struct Tile {
  HgProblem p;
  int z, mt, nt, n_tiles;
};

// tile t of a launch. kReduce takes z fastest, so that the R source
// blocks of one output tile run in the same wave and the last of them
// finds the others' partials still in L2; the others take the row tile
// fastest. Every output element is one block's K loop whatever the order.
__device__ __forceinline__ Tile tile_of(int t, int m_tiles, int n_tiles,
                                        const Args& g) {
  int z, mt, nt;
  if (g.mode == kReduce) {
    z = t % g.Z;
    mt = t / g.Z % m_tiles;
    nt = t / g.Z / m_tiles;
  } else {
    mt = t % m_tiles;
    nt = t / m_tiles % n_tiles;
    z = t / m_tiles / n_tiles;
  }
  return {problem(z, g.R, g.M, g.mode), z, mt, nt, n_tiles};
}

// The bf16 epilogue of B1 and B5: rows p.row0 + ... of output slab p.o.
// The accumulator fragment of m64nBN — element 4 j + e at row 16 warp +
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of the
// warpgroup's 64 rows. The four threads of a quad hold 8 neighbouring
// columns of a row per 8-column chunk: transpose 4 chunks across the quad
// so that each thread stores one chunk as 16 bytes (4-byte stores, each
// half a sector, held the consumers long enough to show in every tile's
// time).
struct StoreBf16 {
  static constexpr bool kDrain = false;
  OutTable outs;

  template <int BM, int BN>
  __device__ __forceinline__ void store(float (&acc)[BN / 2], const Tile& t,
                                        const Args& g) const {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_base = t.mt * BM + wg * 64 + warp * 16 + lane / 4;
    const int t4 = lane % 4;
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(outs.p[t.p.o]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        uint32_t mine[4], got[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mine[c] = pack_bf16x2(acc[4 * (4 * q + c) + 2 * h],
                                acc[4 * (4 * q + c) + 2 * h + 1]);
        quad_transpose(mine, got, lane);
        const int col = t.nt * BN + 8 * (4 * q + t4);
        if (row < g.M && col < g.N)  // N % 8 == 0: the whole chunk fits
          *reinterpret_cast<uint4*>(out + (long)(t.p.row0 + row) * g.N +
                                    col) =
              make_uint4(got[0], got[1], got[2], got[3]);
      }
    }
  }
};

// The epilogue of B9: group t.z of a grouped output at base `out`, rows
// ldo and groups sog elements apart, in f32 or bf16 (OutT), rows past M and
// columns past N masked. The quad transpose of StoreBf16 with a unit of
// two columns: 4 bytes in bf16, one 16-byte store a lane a chunk; 8 bytes
// in f32, two 16-byte stores of one 32-byte sector. Stores are streaming
// (evict first): nothing in the launch reads the output back, and the w
// tile that the row tile beside this one still reads keeps its L2 lines.
template <class OutT>
struct StoreGrouped {
  static constexpr bool kDrain = false;
  unsigned long long out;
  long long sog, ldo;

  template <int BM, int BN>
  __device__ __forceinline__ void store(float (&acc)[BN / 2], const Tile& t,
                                        const Args& g) const {
    constexpr bool kF32 = std::is_same_v<OutT, float>;
    using U = std::conditional_t<kF32, unsigned long long, uint32_t>;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_base = t.mt * BM + wg * 64 + warp * 16 + lane / 4;
    const int t4 = lane % 4;
    OutT* o = reinterpret_cast<OutT*>(out) + t.z * sog;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        U mine[4], got[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float lo = acc[4 * (4 * q + c) + 2 * h];
          const float hi = acc[4 * (4 * q + c) + 2 * h + 1];
          if constexpr (kF32)
            mine[c] = (unsigned long long)__float_as_uint(hi) << 32 |
                      __float_as_uint(lo);
          else
            mine[c] = pack_bf16x2(lo, hi);
        }
        quad_transpose(mine, got, lane);
        const int col = t.nt * BN + 8 * (4 * q + t4);
        if (row >= g.M || col >= g.N) continue;  // N % 8 == 0: chunks fit
        uint4* dst = reinterpret_cast<uint4*>(o + row * ldo + col);
        if constexpr (kF32) {
          __stcs(dst, make_uint4((uint32_t)got[0], (uint32_t)(got[0] >> 32),
                                 (uint32_t)got[1], (uint32_t)(got[1] >> 32)));
          __stcs(dst + 1,
                 make_uint4((uint32_t)got[2], (uint32_t)(got[2] >> 32),
                            (uint32_t)got[3], (uint32_t)(got[3] >> 32)));
        } else {
          __stcs(dst, make_uint4(got[0], got[1], got[2], got[3]));
        }
      }
    }
  }
};

// whether a launch with epilogue Epi reads 3-D (grouped) tensor maps
template <class Epi>
inline constexpr bool kGroupedMaps = false;
template <class OutT>
inline constexpr bool kGroupedMaps<StoreGrouped<OutT>> = true;

// NC consumer warpgroups (block rows 64 * NC), BN columns, STAGES stages;
// warpgroups 0..NC-1 consume, warpgroup NC produces. Epi turns each
// finished tile's accumulator into output: Epi::store runs on the
// consumers. Where Epi::kDrain, the consumers then hand the tile to the
// three idle warps of the producer warpgroup ("drain warps") through a
// ring of HG_SLOTS mbarrier pairs (full: every consumer warp arrives once
// its part is stored; empty: every drain warp arrives once it has counted
// the tile in, Epi::count_in), and go on to the next tile while the drain
// warps finish the tile (Epi::settle); once their own tiles are done, the
// consumers help settle them too. Nothing in an epilogue uses
// __syncthreads() (the producer thread runs on).
template <int NC, int BN, int STAGES, class Epi>
__global__ void __launch_bounds__((NC + 1) * 128, NC == 1 ? 2 : 1)
    hg_gemm_kernel(const __grid_constant__ MapTable amaps,
                   const __grid_constant__ MapTable bmaps,
                   const __grid_constant__ Epi epi, Args g) {
  constexpr int BM = NC * 64;
  constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;  // full, then empty
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  // the hand-off ring, after the stages' barriers
  auto slot_full = [&](int j) { return bars + 8 * (2 * STAGES + j); };
  auto slot_empty = [&](int j) {
    return bars + 8 * (2 * STAGES + HG_SLOTS + j);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NC * 4);
    }
    if constexpr (Epi::kDrain) {
      for (int j = 0; j < HG_SLOTS; ++j) {
        mbar_init(slot_full(j), NC * 4);
        mbar_init(slot_empty(j), HG_DRAIN_WARPS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (g.M + BM - 1) / BM, n_tiles = (g.N + BN - 1) / BN;
  const int k_blocks = (g.K + HG_BK - 1) / HG_BK;
  const int total = g.Z * m_tiles * n_tiles;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (wg == NC) {
    if constexpr (Epi::kDrain) {
      // drain warps (1-3 of the warpgroup): this block's tile `it` from
      // hand-off slot it % HG_SLOTS; once it is handed on, what the
      // previous tile leaves to this block (Epi::settle), and at the end
      // what any of the block's tiles still leave
      const int dw = threadIdx.x / 32 - NC * 4 - 1;
      if (dw >= 0) {
        int it = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x, ++it) {
          const int j = it % HG_SLOTS;
          mbar_wait(slot_full(j), (it / HG_SLOTS) & 1);
          epi.template count_in<BM, BN>(tile_of(t, m_tiles, n_tiles, g), g,
                                        dw);
          __syncwarp();
          if (lane == 0) mbar_arrive(slot_empty(j));
          if (it > 0)
            epi.template settle<BM, BN>(
                tile_of(t - gridDim.x, m_tiles, n_tiles, g), g, dw,
                HG_DRAIN_WARPS, false);
        }
        for (int t = blockIdx.x; t < total; t += gridDim.x)
          epi.template settle<BM, BN>(tile_of(t, m_tiles, n_tiles, g), g, dw,
                                      HG_DRAIN_WARPS, true);
        return;
      }
    }
    // producer: one thread keeps the ring full across all of this block's
    // tiles
    if (threadIdx.x != NC * 128) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_of(t, m_tiles, n_tiles, g);
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), g.a_rows * 128 + B_BYTES);
        const uint32_t sa = base + stage * STAGE_BYTES;
        if constexpr (kGroupedMaps<Epi>) {
          // the same boxes, one group deep, at group coordinate z
          tma_load3(sa, &amaps.m[tl.p.a], kb * HG_BK, tl.mt * BM,
                    tl.z * g.a_gstep, full(stage));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load3(sa + A_BYTES + j * HG_ATOM_BYTES, &bmaps.m[tl.p.b],
                      tl.nt * BN + j * 64, kb * HG_BK, tl.z * g.b_gstep,
                      full(stage));
        } else {
          tma_load(sa, &amaps.m[tl.p.a], kb * HG_BK, tl.mt * BM, full(stage));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sa + A_BYTES + j * HG_ATOM_BYTES, &bmaps.m[tl.p.b],
                     tl.nt * BN + j * 64, kb * HG_BK, full(stage));
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64*wg.. of each tile
  int stage = 0;
  uint32_t phase = 0;
  int it = 0;  // this block's tile count
  for (int t = blockIdx.x; t < total; t += gridDim.x, ++it) {
    // a fresh accumulator each tile (the first wgmma drops it: scale_d 0),
    // so the last tile's is dead once its epilogue has read it
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    fence_acc(acc);
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(full(stage), phase);
      const uint32_t sa = base + stage * STAGE_BYTES + wg * 64 * 128;
      const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk)
        wgmma_step<BN>(acc, desc(sa + kk * 32, 16, 1024),
                       desc(sb + kk * 2048, HG_ATOM_BYTES, 1024),
                       (kb > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      // the K step before this one has retired: release its stage
      wgmma_wait<1>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));

    epi.template store<BM, BN>(acc, tile_of(t, m_tiles, n_tiles, g), g);
    if constexpr (Epi::kDrain) {
      // hand the tile over: the slot's last use must be drained first; the
      // arrive releases this warp's stores to the drain warps
      const int j = it % HG_SLOTS;
      mbar_wait(slot_empty(j), ((it / HG_SLOTS) & 1) ^ 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(slot_full(j));
    }
  }
  if constexpr (Epi::kDrain) {
    // the consumers' tiles are done: help with what the block's tiles still
    // leave, each warp its own strip
    for (int t = blockIdx.x; t < total; t += gridDim.x)
      epi.template settle<BM, BN>(tile_of(t, m_tiles, n_tiles, g), g,
                                  wg * 4 + threadIdx.x / 32 % 4, BM / 16, true);
  }
}

// ---- host side ------------------------------------------------------------

// A bf16 tensor map of `rank` (2 to 5) dimensions with 128-byte swizzle:
// dims innermost first, strides (bytes) of the outer ones, one box.
// Returns 0, or minus the CUresult of a refused encode.
inline int encode_tiled(CUtensorMap* map, unsigned long long ptr, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        reinterpret_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A 2-D map: `outer` rows of `inner` elements, rows `row_bytes` apart,
// boxes of box_inner x box_outer.
inline int encode(CUtensorMap* map, unsigned long long ptr, uint64_t inner,
                  uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                  uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode_tiled(map, ptr, 2, dims, strides, box);
}

// A 3-D map: `groups` slabs of `outer` rows of `inner` elements, rows
// `row_bytes` and slabs `group_bytes` apart, boxes of box_inner x
// box_outer x 1.
inline int encode3(CUtensorMap* map, unsigned long long ptr, uint64_t inner,
                   uint64_t outer, uint64_t groups, uint64_t row_bytes,
                   uint64_t group_bytes, uint32_t box_inner,
                   uint32_t box_outer) {
  const cuuint64_t dims[3] = {inner, outer, groups};
  const cuuint64_t strides[2] = {row_bytes, group_bytes};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  return encode_tiled(map, ptr, 3, dims, strides, box);
}

// block rows and columns of the launcher's configurations (CONFIGS in
// kernels/matmul.py)
inline int cfg_block_m(int cfg) { return cfg == 0 ? 64 : 128; }
inline int cfg_block_n(int cfg) { return cfg == 0 ? 64 : cfg == 1 ? 192 : 256; }

// maps(am, bm, a_rows) encodes the launch's tensor maps, x's box a_rows
// deep: 0, or minus the CUresult of a refused encode
template <int NC, int BN, int STAGES, class Epi, class Maps>
int launch_cfg(const Maps& maps, const Epi& epi, Args g, int grid,
               cudaStream_t stream) {
  constexpr int BM = NC * 64;
  constexpr int SMEM =
      STAGES * (BM + BN) * 128 + 1024 + 16 * (STAGES + HG_SLOTS);
  MapTable am{}, bm{};
  g.a_rows = (g.M + 7) / 8 * 8 < BM ? (g.M + 7) / 8 * 8 : BM;
  if (const int e = maps(am, bm, g.a_rows)) return e;
  auto kern = hg_gemm_kernel<NC, BN, STAGES, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, (NC + 1) * 128, SMEM, stream>>>(am, bm, epi, g);
  return (int)cudaGetLastError();
}

// cfg 0: the bytes-bound regime (one consumer warpgroup, 64 x 64 tiles, 6
// stages); cfg 1 and 2: the compute-bound regime (two consumer warpgroups,
// 128 x 192 tiles and 5 stages, 128 x 256 tiles and 4 stages). The plan
// (kernels/matmul.py::plan) chooses cfg and grid.
template <class Epi, class Maps>
int launch_maps(const Maps& maps, const Epi& epi, const Args& g, int cfg,
                int grid, cudaStream_t stream) {
  if (cfg == 0) return launch_cfg<1, 64, 6>(maps, epi, g, grid, stream);
  if (cfg == 1) return launch_cfg<2, 192, 5>(maps, epi, g, grid, stream);
  if (cfg == 2) return launch_cfg<2, 256, 4>(maps, epi, g, grid, stream);
  return (int)cudaErrorInvalidValue;
}

// The launcher of B1, B4, B5 and B6: Z problems decoded by g.mode from
// 2-D maps of the n_a A and n_b B slabs, each tile finished by epi.
template <class Epi>
int launch(const unsigned long long* a_ptrs, int n_a, long long lda,
           const unsigned long long* b_ptrs, int n_b, long long ldb,
           const Epi& epi, Args g, int cfg, int grid, cudaStream_t stream) {
  if (n_a < 1 || n_a > HG_MAX_MAPS || n_b < 1 || n_b > HG_MAX_MAPS ||
      g.N % 8 != 0 || lda % 8 != 0 || ldb % 8 != 0 || grid < 1 || g.M < 1 ||
      g.K < 1 || g.R < 1 || g.Z < 1)
    return (int)cudaErrorInvalidValue;
  const bool ok =
      g.mode == kStacked ? g.Z <= n_b
      : g.mode == kGather
          ? g.Z == g.R * g.R && n_a >= g.R && n_b >= g.R
      : g.mode == kReduce
          ? g.Z == g.R && n_a >= g.R && n_b >= g.R && g.M % g.R == 0
          : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  auto maps = [&](MapTable& am, MapTable& bm, int a_rows) {
    for (int i = 0; i < n_a; ++i)
      if (const int e =
              encode(&am.m[i], a_ptrs[i], g.K, g.M, lda * 2, HG_BK, a_rows))
        return e;
    for (int i = 0; i < n_b; ++i)
      if (const int e =
              encode(&bm.m[i], b_ptrs[i], g.N, g.K, ldb * 2, 64, HG_BK))
        return e;
    return 0;
  };
  return launch_maps(maps, epi, g, cfg, grid, stream);
}

// The grouped launcher of B9 (kGrouped): out[z] = x[z] @ w[z] for the g.Z
// groups, x (Z x M x K) and w (Z x K x N) bf16 through one 3-D map each,
// group strides sxg and swg and row strides ldx and ldw in elements; a
// group stride of 0 makes the operand one group that serves every group.
template <class OutT>
int launch_grouped(unsigned long long x, long long sxg, long long ldx,
                   unsigned long long w, long long swg, long long ldw,
                   const StoreGrouped<OutT>& epi, Args g, int cfg, int grid,
                   cudaStream_t stream) {
  if (g.mode != kGrouped || g.Z < 1 || g.M < 1 || g.K < 1 || g.N < 1 ||
      g.N % 8 != 0 || ldx % 8 != 0 || ldw % 8 != 0 || sxg % 8 != 0 ||
      swg % 8 != 0 || sxg < 0 || swg < 0 || epi.ldo % 8 != 0 ||
      epi.sog % 8 != 0 || epi.out % 16 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  g.a_gstep = sxg != 0;
  g.b_gstep = swg != 0;
  auto maps = [&](MapTable& am, MapTable& bm, int a_rows) {
    const int e = encode3(&am.m[0], x, g.K, g.M, sxg ? g.Z : 1, ldx * 2,
                          (sxg ? sxg : ldx * g.M) * 2, HG_BK, a_rows);
    return e ? e
             : encode3(&bm.m[0], w, g.N, g.K, swg ? g.Z : 1, ldw * 2,
                       (swg ? swg : ldw * g.K) * 2, 64, HG_BK);
  };
  return launch_maps(maps, epi, g, cfg, grid, stream);
}

// The bf16 launcher of B1 (kStacked: slab z of out_ptrs) and B5 (kGather:
// slab d).
inline int launch_bf16(const unsigned long long* a_ptrs, int n_a,
                       long long lda, const unsigned long long* b_ptrs,
                       int n_b, long long ldb,
                       const unsigned long long* out_ptrs, int n_out, Args g,
                       int cfg, int grid, cudaStream_t stream) {
  if (n_out < 1 || n_out > HG_MAX_MAPS || g.mode == kReduce ||
      n_out < (g.mode == kGather ? g.R : g.Z))
    return (int)cudaErrorInvalidValue;
  StoreBf16 epi{};
  for (int i = 0; i < n_out; ++i) epi.outs.p[i] = out_ptrs[i];
  return launch(a_ptrs, n_a, lda, b_ptrs, n_b, ldb, epi, g, cfg, grid,
                stream);
}

}  // namespace hg
