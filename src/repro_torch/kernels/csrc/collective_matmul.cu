// Fused GEMM x collective kernels over the ranks of a PGL (paper Fig. 7-9).
// Ports of repro/kernels/collective_matmul.py::ag_matmul_fused,
// ::matmul_rs_fused and ::matmul_ar_fused; the design note is in
// kernels/collective_matmul.py. All three run on the Hopper mainloop of
// hopper_gemm.cuh (TMA, mbarrier stages, wgmma, a persistent grid); the
// plan (kernels/matmul.py::plan) gives cfg and grid.
//
// AG x GEMM: x: R slabs of (M x K) bf16 row shards, w: R slabs of (K x N)
// bf16; out: R slabs of (R*M x N) bf16, rows s*M.. of out[d] = x[s] @ w[d].
//
// GEMM x RS / AR: x: R slabs of (M x K) bf16, w: R slabs of (K x N) bf16
// (K is each rank's shard of the reduction dim). Problem r is source rank
// r's partial product x[r] @ w[r] (mode kReduce): its block reads only
// x[r] and w[r]. Tiles are taken with r fastest, so that the R partials of
// one output tile are computed in the same wave and stay in L2 until they
// are summed. landing: R owner slots of (R x M/R x N) f32; out: R slabs of
// (M/R x N) f32 (RS) or (M x N) f32 (AR). The store-and-count epilogue
// (StoreAndCount below): each consumer warp stores its 16 rows (a strip)
// of the partial into the owners' landing slots and hands the tile to the
// producer warpgroup's three idle warps, which count each strip in on its
// flag while the consumers already run the next tile's wgmma. Once a
// strip's count is R, its R partials are summed in rank order and stored,
// in R parts of its rows, each source rank's block taking its own part
// (settle). flags ((R + 1) ints per strip of the plan's tiles, sized by
// kernels/collective_matmul.py::_scratch): a count per strip and a claim
// per part, zeroed on the stream before every launch, so a launch that
// aborted part-way cannot leave a count behind for the next.
//
// Why none can deadlock: no block ever waits for another. AG x GEMM blocks
// depend on nothing; an RS/AR strip is published and counted in, and a
// part is reduced only by a warp that finds all R partials published (the
// block that completes a count always finds it so). Inside a block the
// consumers wait for the drain warps only to reuse a hand-off slot, and
// the drain warps wait only for their own block's consumers; no epilogue
// uses __syncthreads().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"
#include "pk.cuh"

namespace cm {

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The epilogue of GEMM x RS (gather 0) and GEMM x AR (gather 1). A strip
// is the 16 rows of a tile one consumer warp holds; strip s of output tile
// (mt, nt) counts its arrivals in flags[(mt * n_tiles + nt) * BM / 16 + s].
struct StoreAndCount {
  static constexpr bool kDrain = true;
  pk::PtrTable lands, outs;
  int* flags;
  int gather;

  // On the consumers: the partial into landing[o][r], r the source rank, o
  // = row / (M / R) the rank that owns the row (a tile may span owners: at
  // decode M / R is 2). A thread's accumulator holds, for column pair j (8
  // j + 2 (lane % 4)) and row half h (lane / 4 + 8 h of the warp's strip),
  // acc[4 j + 2 h] and acc[4 j + 2 h + 1]: a float2 per (row, pair), so
  // each quad writes one full 32-byte sector of a row. No fence here: the
  // hand-off barrier releases the stores to the drain warps, which count.
  template <int BM, int BN>
  __device__ __forceinline__ void store(float (&acc)[BN / 2],
                                        const hg::Tile& t,
                                        const hg::Args& g) const {
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int strip = t.mt * BM + wg * 64 + warp * 16;
    if (strip >= g.M) return;  // every source's block skips this strip
    const int m_blk = g.M / g.R;
    const int row_lo = strip + lane / 4, col_lo = t.nt * BN + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row >= g.M) continue;
      const int o = row / m_blk;
      float* dst = reinterpret_cast<float*>(lands.p[o]) +
                   ((long)t.z * m_blk + row - o * m_blk) * g.N + col_lo;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (col_lo + 8 * j < g.N)  // N % 8 == 0: the pair fits
          pk::store_async(reinterpret_cast<float2*>(dst + 8 * j),
                          make_float2(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]));
    }
  }

  // flags[0, n) count each strip's arrivals; flags[n + R f + p] claims
  // part p of strip f.
  template <int BM, int BN>
  __device__ __forceinline__ int strips(const hg::Args& g) const {
    return (g.M + BM - 1) / BM * ((g.N + BN - 1) / BN) * (BM / 16);
  }

  // strips of a tile one drain warp counts: s = dw, dw + 3, ...
  template <int BM>
  static constexpr int kMine = (BM / 16 + HG_DRAIN_WARPS - 1) / HG_DRAIN_WARPS;

  // On drain warp `dw` of HG_DRAIN_WARPS, once every consumer warp has
  // stored its strip of the tile: count each of its strips in, a lane a
  // strip.
  template <int BM, int BN>
  __device__ __forceinline__ void count_in(const hg::Tile& t,
                                           const hg::Args& g, int dw) const {
    // The consumers' partials happen before the signal: their stores, the
    // hand-off barrier's arrive (release) and wait (acquire), then the
    // signal's release at GPU scope, which is cumulative. (A full fence
    // here measured slower on every tile.)
    const int lane = threadIdx.x % 32, s = dw + HG_DRAIN_WARPS * lane;
    if (lane < kMine<BM> && s < BM / 16 && t.mt * BM + 16 * s < g.M)
      pk::signal(flags + (t.mt * t.n_tiles + t.nt) * (BM / 16) + s, 1);
  }

  // On one warp, for strips s0, s0 + ds, ... (at most 3) of tile t whose
  // R partials have all arrived: claim and reduce part t.z of the strip
  // (its rows [p·⌈16/R⌉, ...) for p = t.z: each source rank's block
  // reduces its own share), or every part still unclaimed (`sweep`). The
  // drain warps settle a tile's own parts once the next tile is handed on;
  // at the end every warp of the block sweeps the block's tiles (the drain
  // warps after their last count): an incomplete strip is left to the
  // block that completes it, whose drain warps sweep after their count.
  // So every part is reduced exactly once (the claim is a
  // compare-and-swap), the reduction is spread over the R source blocks
  // instead of piling onto whichever block runs late, and nothing waits
  // for another block. A lane a (strip, part): one round trip checks and
  // claims them all.
  template <int BM, int BN>
  __device__ __forceinline__ void settle(const hg::Tile& t, const hg::Args& g,
                                         int s0, int ds, bool sweep) const {
    const int lane = threadIdx.x % 32, R = g.R;
    const int n = strips<BM, BN>(g), rows = (16 + R - 1) / R;
    const int per = sweep ? R : 1, i = lane / per;
    const int p = sweep ? lane % per : t.z;
    const int s = s0 + ds * i, strip = t.mt * BM + 16 * s;
    const int f0 = (t.mt * t.n_tiles + t.nt) * (BM / 16);
    bool won = false;
    if (i < kMine<BM> && s < BM / 16 && strip + p * rows < g.M &&
        p * rows < 16 && pk::wait(flags + f0 + s) == R)
      won = atomicCAS(flags + n + R * (f0 + s) + p, 0, 1) == 0;
    for (unsigned todo = __ballot_sync(0xffffffffu, won); todo;
         todo &= todo - 1) {
      const int w = __ffs(todo) - 1, ws = s0 + ds * (w / per);
      const int wp = sweep ? w % per : t.z;
      pk::wait(flags + f0 + ws);  // acquire: every partial is visible now
      reduce<BN>(g, t.nt, t.mt * BM + 16 * ws + wp * rows,
                 min(rows, 16 - wp * rows));
    }
  }

  // Rows [row0, row0 + nrows) of a tile column block, nrows <= 16: the R
  // partials read back, summed in rank order, stored to the owner (RS) or
  // to every rank (AR: the all-gather half). As float4s, lanes along a row
  // (a warp reads and writes whole runs of a row), RB load instructions of
  // K float4s a lane for each of two ranks in flight. Each row's landing
  // and output addresses are computed once per batch of rows, outside the
  // rank loop: computed per element (the owner is a runtime division), they
  // made the reduce bound by instructions. Partials are read once, as last
  // use (evict first; the acquire before this call invalidated L1), and
  // the result is stored streaming, so the partials still to be summed
  // keep L2.
  template <int BN>
  __device__ __forceinline__ void reduce(const hg::Args& g, int nt, int row0,
                                         int nrows) const {
    constexpr int V = BN / 4;                       // float4s in a tile row
    constexpr int RPI = V >= 32 ? 1 : 32 / V;       // rows an instruction
    constexpr int LPR = 32 / RPI;                   // lanes a row
    constexpr int K = V >= 32 ? (V + 31) / 32 : 1;  // float4s a lane a row
    constexpr int RB = BN == 64 ? 4 : 8 / K;        // row instructions a batch
    const int lane = threadIdx.x % 32, c4 = lane % LPR;
    const int R = g.R, m_blk = g.M / R;
    const long slot = (long)m_blk * g.N;  // one source's rows in a landing
    const int col = nt * BN + 4 * c4;
    bool col_ok[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      col_ok[k] = c4 + 32 * k < V && col + 128 * k < g.N;
    for (int b = 0; b < nrows; b += RB * RPI) {
      const float* src[RB];  // the row in landing[o], source 0
      long off[RB];          // the row in out[o] (RS) or in every out (AR)
      int own[RB];           // o
      bool row_ok[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r_in = b + i * RPI + lane / LPR;
        const int row = row0 + r_in;
        const int o = min(row / m_blk, R - 1);
        const long lr = (long)(row - o * m_blk) * g.N + col;
        row_ok[i] = r_in < nrows && row < g.M;
        src[i] = reinterpret_cast<const float*>(lands.p[o]) + lr;
        off[i] = gather ? (long)row * g.N + col : lr;
        own[i] = o;
      }
      float4 sum[RB][K];
      for (int rr = 0; rr < R; rr += 2) {
        float4 v[2][RB][K];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int k = 0; k < K; ++k)
              v[h][i][k] = rr + h < R && row_ok[i] && col_ok[k]
                               ? __ldlu(reinterpret_cast<const float4*>(
                                     src[i] + (rr + h) * slot + 128 * k))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (rr == 0) sum[i][k] = v[0][i][k];
            else add4(sum[i][k], v[0][i][k]);
            if (rr + 1 < R) add4(sum[i][k], v[1][i][k]);
          }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!row_ok[i] || !col_ok[k]) continue;
          const int d0 = gather ? 0 : own[i], d1 = gather ? R : own[i] + 1;
          for (int d = d0; d < d1; ++d)
            __stcs(
                reinterpret_cast<float4*>(reinterpret_cast<float*>(outs.p[d]) +
                                          off[i] + 128 * k),
                sum[i][k]);
        }
    }
  }
};

inline int launch_reduce(const unsigned long long* x_ptrs,
                         const unsigned long long* w_ptrs,
                         const unsigned long long* landing_ptrs,
                         const unsigned long long* out_ptrs, void* flags,
                         long long n_flags, int R, int M, int N, int K,
                         int gather, int cfg, int grid, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || M < 1 || M % R != 0 || cfg < 0 ||
      cfg > 2 || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  const int bm = hg::cfg_block_m(cfg), bn = hg::cfg_block_n(cfg);
  // a count per strip, a claim per part of a strip
  const long long need = (long long)(R + 1) * ((M + bm - 1) / bm) *
                         ((N + bn - 1) / bn) * (bm / 16);
  if (n_flags < need) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * need,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  StoreAndCount epi{pk::table(landing_ptrs, R), pk::table(out_ptrs, R),
                    (int*)flags, gather};
  const hg::Args g{R, R, hg::kReduce, M, N, K};
  return hg::launch(x_ptrs, R, K, w_ptrs, R, N, epi, g, cfg, grid,
                    (cudaStream_t)stream);
}

}  // namespace cm

// AG x GEMM on the Hopper mainloop: problem d * R + i is hop i of
// destination rank d; its A is the tensor map of source s = (d - i) mod R's
// x slab (the peer read is the gather), its B rank d's w, its rows s*M.. of
// out[d].
extern "C" int pk_ag_matmul_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* out_ptrs, int R,
                                 int M, int N, int K, int cfg, int grid,
                                 void* stream) {
  if (R < 1 || R > PK_MAX_RANKS) return (int)cudaErrorInvalidValue;
  const hg::Args g{R * R, R, hg::kGather, M, N, K};
  return hg::launch_bf16(x_ptrs, R, K, w_ptrs, R, N, out_ptrs, R, N, g,
                         cfg, grid, (cudaStream_t)stream);
}

// GEMM x RS and GEMM x AR: the store-and-count epilogue on the mainloop;
// n_flags is the flags buffer's length in ints (at least (R + 1) per strip).
extern "C" int pk_matmul_rs_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* landing_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, long long n_flags, int R, int M,
                                 int N, int K, int cfg, int grid,
                                 void* stream) {
  return cm::launch_reduce(x_ptrs, w_ptrs, landing_ptrs, out_ptrs, flags,
                       n_flags, R, M, N, K, 0, cfg, grid, stream);
}

extern "C" int pk_matmul_ar_bf16(const unsigned long long* x_ptrs,
                                 const unsigned long long* w_ptrs,
                                 const unsigned long long* landing_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, long long n_flags, int R, int M,
                                 int N, int K, int cfg, int grid,
                                 void* stream) {
  return cm::launch_reduce(x_ptrs, w_ptrs, landing_ptrs, out_ptrs, flags,
                       n_flags, R, M, N, K, 1, cfg, grid, stream);
}
