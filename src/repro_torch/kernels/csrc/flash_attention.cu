// B7: FlashAttention forward and one ring-attention hop on Hopper, bf16 in,
// f32 online softmax. Port of repro/kernels/flash_attention.py::
// flash_attention; kernels/flash_attention.py holds the wrapper, the plan
// (flash_plan, kv_blocks) and the design note.
//
// What bounds it on an H100 SXM: at prefill and at the hop, the tensor
// cores (4 * Sq * Skv * D operations a head where every key is visible,
// half that under the causal mask) and, beside them, the exponentials of
// the softmax (one a visible (row, key) pair, 16 an SM a clock). Only
// wgmma reaches the tensor cores' rate, and only when its operands are in
// shared memory ahead of it. The design, after FlashAttention-3's forward,
// on the pieces of hopper_gemm.cuh (mbarriers, TMA, descriptors, the quad
// transpose):
//
// * A block of three warpgroups computes 128-row query tiles of one
//   (batch, head) at a time: warpgroups 0 and 1 consume, 64 rows each; one
//   thread of warpgroup 2 produces. setmaxnreg hands the producer's
//   registers to the consumers (24 and 240).
// * Q, K and V are read through 4-D tensor maps over (D, S, H, B) at the
//   strides the caller passes, so the head-transposed views of prefill
//   need no copy, and the KV head h / (Hq / Hkv) is a map coordinate, so
//   GQA needs no repeat. The Q tile is loaded once; K and V blocks (Cfg:
//   128 keys at D = 64, 64 at D = 128) stream through a ring of 3 stages,
//   each with a full barrier for K, one for V (the producer's expect_tx;
//   TMA completes the bytes) and an empty barrier (every consumer warp
//   arrives once its products have read the stage). With 2 stages the
//   producer could not load block j before the later warpgroup had
//   finished block j - 2, and the other waited; a fourth stage measured no
//   faster. 128-byte swizzle: a row of 64 columns is one box, so D = 128
//   is two boxes a tile, one atom apart.
// * S = Q K^T is wgmma m64nBKk16 with both operands in shared memory and
//   K-major (trans-b 0): SBO 1024, a k16 step 32 bytes inside the 128-byte
//   atom, steps 4-7 in the second atom at D = 128.
// * O += P V is wgmma m64nDk16 with P from registers: the f32 S accumulator
//   of n8 tiles 2c and 2c+1, rounded to bf16 (as the Pallas kernel rounds P
//   to v's dtype), is the A fragment of key chunk c. V is the MN-major B
//   (trans-b 1) of hopper_gemm's layout: SBO 1024, LBO the BK * 128 bytes
//   between 64-column atoms, a k16 step 2048 bytes.
// * The online softmax stays in registers: each accumulator row is spread
//   over a quad of lanes, reduced with two shuffles; the row maximum is
//   taken of the raw scores (the scale is positive) and the scale folded
//   into one FMA before exp2 (log2 e). A row with nothing visible yet keeps
//   m = -inf and exponentiates against 0. Only a block that some row does
//   not wholly see (the diagonal, the window's edge, the ragged end) takes
//   the element mask.
// * Two overlaps after FlashAttention-3: within a warpgroup, block j's S
//   is issued before block j-1's P V and its softmax runs while that
//   product is in flight; between the two warpgroups, named barriers make
//   them take turns to issue their products, so that one's softmax (the
//   exponentials, 16 an SM a clock, take about as long as the products at
//   D = 64) runs while the other's products hold the tensor cores.
// * Key blocks are scheduled by kv_range below, the Pallas kernel's
//   predicate (flash_attention.py:37-41) taken at the tile's real rows and
//   keys: the blocks [lo, hi) hold every visible (row, key) pair and none
//   is wholly masked. Producer and consumers both call it, so they walk the
//   same blocks and the barriers' phases agree. TMA zero-fills a box past S
//   inside its own head (per-dimension bounds), and zero keys are masked,
//   since they give s = 0, not -inf.
// * A persistent grid, one block an SM (the wrapper's plan sizes it). The
//   producer takes tiles from the launch's own counter as it needs them
//   (an atomic; tile_of orders them heaviest causal query tile first) and
//   hands each to the consumers through one of two tile slots, so the
//   blocks stay balanced whatever a tile costs: at a hop, whole ranks see
//   nothing, and a fixed assignment of tiles to blocks (i, i + grid, ...)
//   left some blocks twice the others' work. The producer loads the next
//   tile's Q (once the consumers release the last one, a q-empty barrier)
//   and K/V while the consumers store the current tile, and the ring runs
//   on across tiles; a block a tile paid its set-up and its stores on every
//   tile.
//
// HOP = true is one ring-attention hop (the JAX _block_update of
// core/ring_attention.py from the zero state): the batch is R ranks x
// rank_batch rows, rank r = b / rank_batch holds queries at global rows
// r * Sq + i and, at hop `hop`, the keys of rank (r - hop) mod R at global
// columns ((r - hop) mod R) * Skv + j. The schedule and the mask are taken
// at those global positions, so a rank whose block lies wholly in the
// future loads nothing. It writes the f32 unnormalized O, the row max m
// (-1e30 where no key is visible) and the row sum l, never dividing; the
// caller merges hops. The forward divides by l (0 gives 0) and stores bf16.
// Both stores are hopper_gemm's quad-transposed 16-byte stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper_gemm.cuh"

#define FA_BQ 128      // query rows a block: two consumer warpgroups of 64
#define FA_STAGES 3    // ring stages (see the top)
#define FA_THREADS 384

namespace fa {

// Keys a stage at head_dim D. At D = 64 a block of 128 keys
// keeps S (64 of a thread's f32) beside O (32) and P (32); at D = 128 O
// takes 64, and with a 128-key S ptxas spilled and serialized the products
// (the overlap below keeps S, P and O live at once), so blocks are 64 keys.
template <int D>
struct Cfg {
  static constexpr int BK = D == 64 ? 128 : 64;
};

struct Maps {
  CUtensorMap q, k, v;
};

// Where the hop's outputs go (HOP only): f32 O (B, Hq, Sq, D), m and l
// (B, Hq, Sq), all contiguous; the rank layout of the batch and the hop.
struct Hop {
  float* o;
  float* m;
  float* l;
  int rank_batch, n_ranks, hop;
};

struct Args {
  int B, Hq, Hkv, Sq, Skv, causal, window;
  float scale_log2;  // the softmax scale times log2(e)
};

// the key blocks [lo, hi) that query tile q_lo.. schedules
struct KvRange {
  int lo, hi;
};

// The block list of one query tile, at global positions (q_off, kv_off):
// a key block is scheduled iff it holds a (row, key) pair visible to a real
// row (< Sq) at a real key (< Skv). The visible keys of rows r0..r1 form
// one interval, [r0 - window + 1, r1] (causal) or from r0 - window + 1 on,
// so the blocks are one range. kernels/flash_attention.py::kv_blocks is
// its twin.
template <int BK>
__device__ __forceinline__ KvRange kv_range(int q_lo, int q_off, int kv_off,
                                            const Args& a) {
  const int n_kb = (a.Skv + BK - 1) / BK;
  const int r0 = q_off + q_lo;
  const int r1 = q_off + min(q_lo + FA_BQ, a.Sq) - 1;
  int lo = 0, hi = n_kb;
  if (a.causal) {  // the first key of the block at most r1
    const int d = r1 - kv_off;
    hi = d < 0 ? 0 : min(n_kb, d / BK + 1);
  }
  if (a.window > 0) {  // the last real key of the block above r0 - window
    const int t = r0 - a.window + 1 - kv_off;  // first visible local key
    lo = t <= 0 ? 0 : t >= a.Skv ? n_kb : t / BK;
  }
  return {lo, hi};
}

// The launch's tile counter (next: the next tile to take; done: blocks
// that have taken their last): zero before the launch and reset by its last
// block. The caller passes a counter of its own to each stream, so launches
// on one stream reuse it in turn and launches on two never share one.
struct Sched {
  unsigned int next, done;
};

// Tile t of a launch: (batch b, head h, query rows q_lo..) at the ranks'
// global offsets, and its key blocks. The heaviest query tiles (the last,
// under the causal mask) come first, every head of one before the next,
// so the last tiles a block takes are the lightest.
struct Tile {
  int b, h, bh, q_lo, q_off, kv_off;
  KvRange kr;
};

template <int BK, bool HOP>
__device__ __forceinline__ Tile tile_of(int t, const Args& a, const Hop& hp) {
  const int bhs = a.B * a.Hq, n_qt = (a.Sq + FA_BQ - 1) / FA_BQ;
  Tile tl;
  tl.bh = t % bhs;
  tl.b = tl.bh / a.Hq;
  tl.h = tl.bh - tl.b * a.Hq;
  tl.q_lo = (n_qt - 1 - t / bhs) * FA_BQ;
  tl.q_off = tl.kv_off = 0;
  if (HOP) {
    const int r = tl.b / hp.rank_batch;
    tl.q_off = r * a.Sq;
    tl.kv_off =
        ((r - hp.hop) % hp.n_ranks + hp.n_ranks) % hp.n_ranks * a.Skv;
  }
  tl.kr = kv_range<BK>(tl.q_lo, tl.q_off, tl.kv_off, a);
  return tl;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = a @ b for one m64n128k16 step, a and b both K-major (trans-b 0),
// through 128B-swizzled shared-memory descriptors; scale_d 0 drops s.
__device__ __forceinline__ void wgmma_ss_m64n128_kmajor(float (&d)[64],
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same for m64n64k16
__device__ __forceinline__ void wgmma_ss_m64n64_kmajor(float (&d)[32],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

// d (+)= a @ b for one m64n64k16 step, a from registers (the bf16x2 A
// fragment), b MN-major (trans-b 1) through a 128B-swizzled descriptor;
// scale_d 0 drops d.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (+)= a @ b for one m64n128k16 step, a from registers (the bf16x2 A
// fragment), b MN-major (trans-b 1) through a 128B-swizzled descriptor;
// scale_d 0 drops d.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64)
    wgmma_ss_m64n64_kmajor(d, da, db, scale_d);
  else
    wgmma_ss_m64n128_kmajor(d, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_m64n64(d, a, db, 1);
  else
    wgmma_rs_m64n128(d, a, db, 1);
}

// keeps the compiler from moving writes of A-fragment registers past the
// wgmma fence (as hg::fence_acc does for accumulators)
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Shared memory from a 1024-byte boundary (the swizzle's): the Q tile, the
// stages (K, then V), the barriers (q full, q empty, tile full and empty
// of 2 tile slots; k full, v full and empty a stage), the 2 tile slots;
// 1 KB of slack for the alignment.
template <int D>
struct Smem {
  static constexpr int BK = Cfg<D>::BK, STAGES = FA_STAGES;
  static constexpr int ATOMS = D / 64;  // 64-column boxes a row
  static constexpr int Q_BYTES = FA_BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // K or V of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BARS = 6 + 3 * STAGES;
  static constexpr int BYTES =
      Q_BYTES + STAGES * STAGE_BYTES + 1024 + 8 * BARS + 8;
};

template <int D, bool HOP>
__global__ void __launch_bounds__(FA_THREADS, 1)
    flash_kernel(const __grid_constant__ Maps maps, const Args a,
                 const Hop hp, Sched* __restrict__ sched,
                 __nv_bfloat16* __restrict__ o) {
  using SM = Smem<D>;
  constexpr int BK = Cfg<D>::BK, STAGES = FA_STAGES;
  extern __shared__ uint8_t fa_smem[];
  const uint32_t base = (hg::smem_addr(fa_smem) + 1023) & ~1023u;
  const uint32_t bars = base + SM::Q_BYTES + STAGES * SM::STAGE_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto t_full = [&](int j) { return bars + 8 * (2 + j); };
  auto t_empty = [&](int j) { return bars + 8 * (4 + j); };
  auto k_full = [&](int s) { return bars + 8 * (6 + s); };
  auto v_full = [&](int s) { return bars + 8 * (6 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (6 + 2 * STAGES + s); };
  // the tile slots: the producer hands each tile it takes to the consumers
  volatile int* slot = reinterpret_cast<volatile int*>(
      fa_smem + (bars + 8 * SM::BARS - hg::smem_addr(fa_smem)));
  auto k_tile = [&](int s) {
    return base + SM::Q_BYTES + s * SM::STAGE_BYTES;
  };

  // a persistent grid: the producer takes the next tile from the launch's
  // counter and hands it to the consumers through a tile slot; both walk
  // the same tiles and, in each, the same blocks, and count the ring's
  // stages (it), the Q loads (nq) and the tiles (j) across tiles
  const int n_tiles = (a.Sq + FA_BQ - 1) / FA_BQ * a.B * a.Hq;
  const int kv_group = a.Hq / a.Hkv;  // GQA: the KV head, a map coordinate

  if (threadIdx.x == 0) {
    hg::mbar_init(q_full, 1);
    hg::mbar_init(q_empty, 8);  // the consumers' 8 warps
    for (int j = 0; j < 2; ++j) {
      hg::mbar_init(t_full(j), 1);
      hg::mbar_init(t_empty(j), 8);
    }
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(k_full(s), 1);
      hg::mbar_init(v_full(s), 1);
      hg::mbar_init(empty(s), 8);  // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer warpgroup: one thread takes the tiles; of each, it loads
    // the Q tile once, then K and V of every scheduled block into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int it = 0, nq = 0;
    for (int j = 0;; ++j) {
      const int t = (int)atomicAdd(&sched->next, 1u);
      hg::mbar_wait(t_empty(j & 1), ((j >> 1) & 1) ^ 1);
      slot[j & 1] = t;
      hg::mbar_arrive(t_full(j & 1));  // releases the slot's write
      if (t >= n_tiles) break;
      const Tile tl = tile_of<BK, HOP>(t, a, hp);
      if (tl.kr.lo >= tl.kr.hi) continue;
      const int b = tl.b, hk = tl.h / kv_group;
      // the Q tile once the consumers are done with the last one
      hg::mbar_wait(q_empty, (nq++ & 1) ^ 1);
      hg::mbar_expect_tx(q_full, SM::Q_BYTES);
#pragma unroll
      for (int at = 0; at < SM::ATOMS; ++at)
        hg::tma_load4(base + at * FA_BQ * 128, &maps.q, at * 64, tl.q_lo,
                      tl.h, b, q_full);
      for (int kb = tl.kr.lo; kb < tl.kr.hi; ++kb, ++it) {
        const int s = it % STAGES;
        hg::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const uint32_t sk = k_tile(s), sv = sk + SM::KV_BYTES;
        hg::mbar_expect_tx(k_full(s), SM::KV_BYTES);
#pragma unroll
        for (int at = 0; at < SM::ATOMS; ++at)
          hg::tma_load4(sk + at * BK * 128, &maps.k, at * 64, kb * BK,
                        hk, b, k_full(s));
        hg::mbar_expect_tx(v_full(s), SM::KV_BYTES);
#pragma unroll
        for (int at = 0; at < SM::ATOMS; ++at)
          hg::tma_load4(sv + at * BK * 128, &maps.v, at * 64, kb * BK,
                        hk, b, v_full(s));
      }
    }
    // the last block to take its final ticket resets the counter for the
    // stream's next launch
    if (atomicAdd(&sched->done, 1u) == gridDim.x - 1) {
      sched->next = 0;
      sched->done = 0;
      __threadfence();
    }
  } else {
    // the consumer warpgroups: warpgroup wg owns rows 64 wg.. of the tile;
    // each thread rows a = .. + lane / 4 and b = a + 8 of its warp's 16
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, t4 = lane % 4;
    const uint32_t qa = base + wg * 64 * 128;  // this warpgroup's Q rows
    int it = 0, nq = 0;
    for (int j = 0;; ++j) {
      hg::mbar_wait(t_full(j & 1), (j >> 1) & 1);
      const int t = slot[j & 1];
      __syncwarp();
      if (lane == 0) hg::mbar_arrive(t_empty(j & 1));
      if (t >= n_tiles) break;
      const Tile tl = tile_of<BK, HOP>(t, a, hp);
      const KvRange kr = tl.kr;
      const int bh = tl.bh, q_lo = tl.q_lo, q_off = tl.q_off;
      const int kv_off = tl.kv_off;
      const int row_a = q_lo + wg * 64 + warp * 16 + lane / 4;
      const int row_b = row_a + 8;
      // m in log2 units (the scale folded in), l and O in f32
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float oacc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

      if (kr.lo < kr.hi) {
        // each row's visible global key columns [lo, hi]: the ragged key
        // edge, the causal bound, the window (keys > row - window)
        const int last = kv_off + a.Skv - 1;
        const int gra = q_off + row_a, grb = q_off + row_b;
        const int hi_a = a.causal ? min(gra, last) : last;
        const int hi_b = a.causal ? min(grb, last) : last;
        const int lo_a = a.window > 0 ? gra - a.window + 1 : INT_MIN;
        const int lo_b = a.window > 0 ? grb - a.window + 1 : INT_MIN;
        // the tile's real global rows: a block every one of whose keys each
        // of them sees needs no element mask (rows past Sq read zero q and
        // are never stored)
        const int r0 = q_off + q_lo, r1 = q_off + min(q_lo + FA_BQ, a.Sq) - 1;

        // S = Q K^T of the block in stage s: 64 rows x 128 keys, D / 16 k16
        // steps, issued and committed, not waited for
        auto issue_s = [&](float(&sacc)[BK / 2], int s) {
          const uint32_t sk = k_tile(s);
          hg::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_qk<BK>(
                sacc,
                hg::desc(qa + (kk / 4) * FA_BQ * 128 + (kk % 4) * 32, 16, 1024),
                hg::desc(sk + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
                kk > 0 ? 1 : 0);
          hg::wgmma_commit();
        };
        // O += P V of the block in stage s: 128 keys in 8 k16 chunks,
        // issued and committed (pa and oacc fenced before the S product
        // ahead of it, so that nothing defines them while wgmma runs)
        auto issue_pv = [&](uint32_t(&pa)[BK / 16][4], int s) {
          const uint32_t sv = k_tile(s) + SM::KV_BYTES;
#pragma unroll
          for (int c = 0; c < BK / 16; ++c)
            wgmma_pv<D>(oacc, pa[c],
                        hg::desc(sv + c * 2048, BK * 128, 1024));
          hg::wgmma_commit();
        };
        // the online softmax of block kb's S: the row maxima over the quad
        // (of raw s: the scale is positive), m and l updated, S replaced by
        // P = exp2(s * scale_log2 - m); returns O's rescale factors.
        // Element 4 j + e of S is row a (e < 2) or b, key 8 j + 2 t4 + e % 2.
        auto softmax = [&](float(&sacc)[BK / 2], int kb) -> float2 {
          const int k0 = kv_off + kb * BK;
          const bool full = (kb + 1) * BK <= a.Skv &&
                            (!a.causal || k0 + BK - 1 <= r0) &&
                            (a.window <= 0 || k0 >= r1 - a.window + 1);
          if (!full) {
            const int col0 = k0 + 2 * t4;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = col0 + 8 * j + (e & 1);
                const bool keep = e < 2 ? (col >= lo_a) & (col <= hi_a)
                                        : (col >= lo_b) & (col <= hi_b);
                if (!keep) sacc[4 * j + e] = -INFINITY;
              }
          }
          float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
            mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
          }
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
          }
          const float mn_a = fmaxf(m_a, mx_a * a.scale_log2);
          const float mn_b = fmaxf(m_b, mx_b * a.scale_log2);
          // a row with nothing visible yet keeps m = -inf: exponentiate
          // against 0
          const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
          const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
          const float2 alpha = make_float2(exp2_approx(m_a - base_a),
                                           exp2_approx(m_b - base_b));
          float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sacc[4 * j + e] = exp2_approx(
                  fmaf(sacc[4 * j + e], a.scale_log2,
                       e < 2 ? -base_a : -base_b));
            ps_a += sacc[4 * j] + sacc[4 * j + 1];
            ps_b += sacc[4 * j + 2] + sacc[4 * j + 3];
          }
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            ps_a += __shfl_xor_sync(0xffffffffu, ps_a, off);
            ps_b += __shfl_xor_sync(0xffffffffu, ps_b, off);
          }
          l_a = l_a * alpha.x + ps_a;
          l_b = l_b * alpha.y + ps_b;
          m_a = mn_a;
          m_b = mn_b;
          return alpha;
        };
        // P rounded to bf16: n8 tiles 2c and 2c + 1 of S are the A fragment
        // of key chunk c
        auto pack = [&](const float(&sacc)[BK / 2],
                        uint32_t(&pa)[BK / 16][4]) {
#pragma unroll
          for (int c = 0; c < BK / 16; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pa[c][i] = hg::pack_bf16x2(sacc[8 * c + 2 * i],
                                         sacc[8 * c + 2 * i + 1]);
        };
        auto release = [&](int s) {  // the stage's K and V are read
          __syncwarp();
          if (lane == 0) hg::mbar_arrive(empty(s));
        };
        // Ping-pong (FlashAttention-3's): the two consumer warpgroups take
        // turns to issue their products — named barrier 1 + wg is this
        // warpgroup's turn, passed on once its products are issued — so that
        // one's softmax runs while the other's products hold the tensor
        // cores. Warpgroup 0 goes first; both take n + 1 turns for n blocks,
        // and warpgroup 1 does not pass its last.
        auto turn_wait = [&] {
          asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
        };
        auto turn_pass = [&] {
          asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
        };
        if (wg == 1) turn_pass();

        // Intra-warpgroup overlap (FlashAttention-3's): block kb's S = Q K^T
        // is issued before the previous block's O += P V, and its softmax
        // runs while that product is in flight; once it has landed, O is
        // rescaled and S becomes the next P in the same registers.
        uint32_t pa[BK / 16][4];
        {
          float sacc[BK / 2];
          hg::mbar_wait(q_full, nq & 1);
          hg::mbar_wait(k_full(it % STAGES), (it / STAGES) & 1);
          turn_wait();
          issue_s(sacc, it % STAGES);
          turn_pass();
          hg::wgmma_wait<0>();
          hg::fence_acc(sacc);
          softmax(sacc, kr.lo);  // O is still 0: no rescale
          pack(sacc, pa);
        }
        ++it;
        for (int kb = kr.lo + 1; kb < kr.hi; ++kb, ++it) {
          const int s = it % STAGES, sp = (it - 1) % STAGES;
          float sacc[BK / 2];
          fence_frag(pa);  // P and O as the P V product reads them
          hg::fence_acc(oacc);
          hg::mbar_wait(k_full(s), (it / STAGES) & 1);
          hg::mbar_wait(v_full(sp), ((it - 1) / STAGES) & 1);
          turn_wait();
          issue_s(sacc, s);
          issue_pv(pa, sp);
          turn_pass();
          hg::wgmma_wait<1>();  // S has landed; P V may still run
          hg::fence_acc(sacc);
          const float2 alpha = softmax(sacc, kb);
          hg::wgmma_wait<0>();  // P V has landed: pa, O and the stage free
          hg::fence_acc(oacc);
          fence_frag(pa);
          release(sp);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            oacc[4 * j] *= alpha.x;
            oacc[4 * j + 1] *= alpha.x;
            oacc[4 * j + 2] *= alpha.y;
            oacc[4 * j + 3] *= alpha.y;
          }
          pack(sacc, pa);
        }
        const int sl = (it - 1) % STAGES;
        fence_frag(pa);
        hg::fence_acc(oacc);
        hg::mbar_wait(v_full(sl), ((it - 1) / STAGES) & 1);
        turn_wait();
        hg::wgmma_fence();
        issue_pv(pa, sl);
        if (wg == 0) turn_pass();
        hg::wgmma_wait<0>();
        hg::fence_acc(oacc);
        fence_frag(pa);
        release(sl);
        if (lane == 0) hg::mbar_arrive(q_empty);  // the tile's Q is read
        ++nq;
      }

      // the accumulator of n8 tile j: element 4 j + e at row a (e < 2) or b,
      // column 8 j + 2 t4 + e % 2; the quad transpose gives each lane one
      // 8-column chunk of a row in order, stored as 16 bytes
      if (HOP) {  // unnormalized O, row max and row sum, for the merge
        float* oh = hp.o + ((long)bh * a.Sq) * D;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = hh ? row_b : row_a;
#pragma unroll
          for (int q = 0; q < D / 32; ++q) {
            unsigned long long mine[4], got[4] = {0, 0, 0, 0};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              mine[c] = (unsigned long long)__float_as_uint(
                            oacc[4 * (4 * q + c) + 2 * hh + 1])
                            << 32 |
                        __float_as_uint(oacc[4 * (4 * q + c) + 2 * hh]);
            hg::quad_transpose(mine, got, lane);
            if (row >= a.Sq) continue;
            uint4* dst =
                reinterpret_cast<uint4*>(oh + (long)row * D + 8 * (4 * q + t4));
            dst[0] = make_uint4((uint32_t)got[0], (uint32_t)(got[0] >> 32),
                                (uint32_t)got[1], (uint32_t)(got[1] >> 32));
            dst[1] = make_uint4((uint32_t)got[2], (uint32_t)(got[2] >> 32),
                                (uint32_t)got[3], (uint32_t)(got[3] >> 32));
          }
        }
        if (t4 == 0) {  // the quad's four lanes hold the same m and l
          const long rb = (long)bh * a.Sq;
          const float ln2 = 0.69314718055994531f;  // m back to natural units
          if (row_a < a.Sq) {
            hp.m[rb + row_a] = m_a == -INFINITY ? -1e30f : m_a * ln2;
            hp.l[rb + row_a] = l_a;
          }
          if (row_b < a.Sq) {
            hp.m[rb + row_b] = m_b == -INFINITY ? -1e30f : m_b * ln2;
            hp.l[rb + row_b] = l_b;
          }
        }
      } else {
        const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
        const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
        __nv_bfloat16* oh = o + ((long)bh * a.Sq) * D;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = hh ? row_b : row_a;
          const float inv = hh ? inv_b : inv_a;
#pragma unroll
          for (int q = 0; q < D / 32; ++q) {
            uint32_t mine[4], got[4] = {0, 0, 0, 0};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              mine[c] =
                  hg::pack_bf16x2(oacc[4 * (4 * q + c) + 2 * hh] * inv,
                                  oacc[4 * (4 * q + c) + 2 * hh + 1] * inv);
            hg::quad_transpose(mine, got, lane);
            if (row < a.Sq)
              *reinterpret_cast<uint4*>(oh + (long)row * D + 8 * (4 * q + t4)) =
                  make_uint4(got[0], got[1], got[2], got[3]);
          }
        }
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

// The 4-D maps of q, k and v over (D, S, H, B) at the strides st (elements:
// q's b, h, s, then k's, then v's), boxes of 64 columns x `rows` x 1 x 1:
// 0, or minus the CUresult of a refused encode.
template <int D>
int encode_maps(Maps& m, const void* q, const void* k, const void* v, int B,
                int Hq, int Hkv, int Sq, int Skv, const long long* st) {
  auto enc = [&](CUtensorMap* map, const void* p, int S, int H,
                 const long long* s3, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)s3[2] * 2,
                                   (cuuint64_t)s3[1] * 2,
                                   (cuuint64_t)s3[0] * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
    return hg::encode_tiled(map, reinterpret_cast<unsigned long long>(p), 4,
                            dims, strides, box);
  };
  if (const int e = enc(&m.q, q, Sq, Hq, st, FA_BQ)) return e;
  if (const int e = enc(&m.k, k, Skv, Hkv, st + 3, Cfg<D>::BK)) return e;
  return enc(&m.v, v, Skv, Hkv, st + 6, Cfg<D>::BK);
}

template <int D, bool HOP>
int launch(const void* q, const void* k, const void* v, void* o, Hop hp,
           int B, int Hq, int Hkv, int Sq, int Skv, const long long* st,
           int causal, int window, float scale, int grid, void* sched,
           cudaStream_t stream) {
  Maps maps;
  if (const int e = encode_maps<D>(maps, q, k, v, B, Hq, Hkv, Sq, Skv, st))
    return e;
  const Args a{B, Hq, Hkv, Sq, Skv, causal, window,
               scale * 1.4426950408889634f};
  auto kern = flash_kernel<D, HOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, FA_THREADS, Smem<D>::BYTES, stream>>>(
      maps, a, hp, static_cast<Sched*>(sched),
      static_cast<__nv_bfloat16*>(o));
  return (int)cudaGetLastError();
}

template <bool HOP>
int dispatch(const void* q, const void* k, const void* v, void* o, Hop hp,
             int B, int Hq, int Hkv, int Sq, int Skv, int D,
             const long long* st, int causal, int window, float scale,
             int grid, void* sched, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || grid < 1 ||
      sched == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, HOP>(q, k, v, o, hp, B, Hq, Hkv, Sq, Skv, st, causal,
                           window, scale, grid, sched, s);
  if (D == 128)
    return launch<128, HOP>(q, k, v, o, hp, B, Hq, Hkv, Sq, Skv, st, causal,
                            window, scale, grid, sched, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fa

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) bf16 at strides in elements
// (b, h, s; unit along D); o (B, Hq, Sq, D) bf16, contiguous; grid the
// persistent blocks (the plan's); sched the stream's tile counter, two
// unsigned ints, zero between launches.
extern "C" int pk_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, int window,
    float scale, int grid, void* sched, void* stream) {
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const fa::Hop none{nullptr, nullptr, nullptr, 1, 1, 0};
  return fa::dispatch<false>(q, k, v, o, none, B, Hq, Hkv, Sq, Skv, D, st,
                             causal, window, scale, grid, sched, stream);
}

// One ring-attention hop over B = n_ranks x rank_batch rows (see the top):
// o (B, Hq, Sq, D), m and l (B, Hq, Sq), f32, contiguous.
extern "C" int pk_flash_attention_hop_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs,
    int n_ranks, int hop, int causal, int window, float scale, int grid,
    void* sched, void* stream) {
  if (n_ranks < 1 || B % n_ranks != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const fa::Hop hp{(float*)o, (float*)m, (float*)l, B / n_ranks, n_ranks,
                   hop};
  return fa::dispatch<true>(q, k, v, nullptr, hp, B, Hq, Hkv, Sq, Skv, D, st,
                            causal, window, scale, grid, sched, stream);
}

// The launch configuration of head_dim D, as kernels/flash_attention.py::
// flash_plan computes it: out = {query rows a block, keys a stage, stages,
// threads, dynamic shared memory bytes}. 0, or cudaErrorInvalidValue for a
// D the kernel is not instantiated for.
extern "C" int pk_flash_attention_config(int D, int* out) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  out[0] = FA_BQ;
  out[1] = D == 64 ? fa::Cfg<64>::BK : fa::Cfg<128>::BK;
  out[2] = FA_STAGES;
  out[3] = FA_THREADS;
  out[4] = D == 64 ? fa::Smem<64>::BYTES : fa::Smem<128>::BYTES;
  return 0;
}
