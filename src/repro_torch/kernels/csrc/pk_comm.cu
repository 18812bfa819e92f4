// Ring all-gather, ring reduce-scatter, the one-hop p2p ring shift and the
// all-to-all over the ranks of a PGL. Port of
// repro/kernels/pk_comm.py::ring_all_gather, ::ring_reduce_scatter and
// ::p2p_ring_shift; the all-to-all replaces no Pallas kernel (JAX's chunked
// all-to-all is lax.all_to_all, the TPU's native collective). The design
// note is in kernels/pk_comm.py.
//
// all-gather:     TMA staged. A persistent grid walks the (source s, tile)
//                 items of the plan (kernels/pk_comm.py ag_plan); a tile is
//                 one box of a tensor map over the input that carries the
//                 strides of the view it was given. One producer thread
//                 TMA-loads the tile into a ring of shared-memory stages
//                 (an mbarrier each) and writes it into slot s of every
//                 rank's output by R TMA bulk tensor stores from the stage,
//                 through a second map over the output laid out as the
//                 gathered tensor (R, *gathered); a stage is refilled once
//                 its stores have read it (wait_group.read). One read and R
//                 stores a tile; no block waits on another. Shapes a tensor
//                 map cannot take run a word kernel over the same strided
//                 description.
// reduce-scatter: pull and sum. A persistent grid walks the (owner o,
//                 tile) items; for each, one producer thread issues R TMA
//                 bulk copies (cp.async.bulk, completing on the stage's
//                 full mbarrier) of the tile of in[s] slot o, s = 0..R-1,
//                 into a ring of shared-memory stages; eight consumer warps
//                 sum the R tiles in f32 in rank order, round once and
//                 store 16-byte words into out[o], then free the stage
//                 (its empty mbarrier). R^2 blk read and R blk written, the
//                 bytes of the bound: no landing slot, no flag, no second
//                 pass. No block waits on another. Shapes that bulk copies
//                 cannot take (a chunk not a multiple of 16 bytes, an
//                 address not 16-byte aligned) run an element-wise pull
//                 kernel with the same sums in the same order. A rank's
//                 block is blk elements, split into n_chunks chunks of
//                 chunk elements; tiles never cross a chunk.
// p2p ring shift: a persistent grid walks the (source s, tile) items; each
//                 item stores its tile of in[s] into out[(s + 1) % R] and
//                 counts itself in on the destination's flag (signal,
//                 release) once its stores are visible. The flags are never
//                 reset: every launch adds its tiles, and the wrapper keeps
//                 the count they must reach. The TPU kernel opens with a
//                 neighbour barrier so that no chip writes into a buffer
//                 its neighbour still reads; on one card, inside one
//                 launch, a block that spin-waited on another rank's flag
//                 could wait on a block not yet resident and deadlock. The
//                 hop needs no wait: its output is a fresh buffer and the
//                 stream orders it after the producer of the input.
// all-to-all:     a persistent grid walks the (source s, destination d,
//                 tile) items of the plan (kernels/pk_comm.py a2a_plan);
//                 block d of in[s]'s split dim goes to slot s of out[d]'s
//                 concat dim. A block is rows of contiguous bytes under up
//                 to four strided dims; a tile is a run of rows times a
//                 piece of a row. Threads move the widest word every row
//                 start allows, four loads in flight, and a row's tail
//                 past its whole words byte by byte. No flag, no wait:
//                 the items are independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pk.cuh"
#include "tma.cuh"

namespace {

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

// -- all-gather: TMA staged, one read and R stores a tile --

constexpr int AG_THREADS = 32;  // one warp: its first thread does the work
constexpr int AG_MAX_STAGES = 8;
constexpr int AG_WORD_THREADS = 256;
constexpr int AG_WORD_DIMS = 6;

// one box of a 5-D map at (c0 innermost, ..., c4) from shared `src`, a TMA
// bulk tensor store committed to the thread's current bulk group
__device__ __forceinline__ void tma_store5(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

struct AgArgs {
  CUtensorMap in_map;   // (e0, e1, e2, source): the input view's strides
  CUtensorMap out_map;  // (e0, e1, e2, slot, rank): the gathered layout
  int R, items, t0, t1, t2;    // ranks; (source, tile) items; tiles a dim
  int b0, b1, b2, stages;      // the box (a tile), the ring's stages
  int box_bytes, stage_bytes;  // a box; a stage: the box to 128 bytes
};

// The persistent TMA kernel, one thread: block b takes items b, b + grid,
// ... Item i is source s = i / tiles, then tile (k0 fastest, k1, k2) at
// c = k * box. Loads run stages - 1 items ahead; the stage of item j - 1
// is refilled once its R stores have read it (all but the newest group).
__global__ void __launch_bounds__(AG_THREADS)
    pk_ag_tma_kernel(const __grid_constant__ AgArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  const uint32_t ring = hg::smem_addr(smem);
  const uint32_t full0 = ring + p.stages * p.stage_bytes;
  for (int s = 0; s < p.stages; ++s) hg::mbar_init(full0 + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const int tiles = p.t0 * p.t1 * p.t2;
  const int n = (int)blockIdx.x < p.items
                    ? (p.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                    : 0;
  // item j of this block: its source and the box's first coordinates
  auto at = [&](int j, int& s, int& c0, int& c1, int& c2) {
    const int i = (int)blockIdx.x + j * (int)gridDim.x;
    s = i / tiles;
    int t = i - s * tiles;
    c0 = (t % p.t0) * p.b0;
    t /= p.t0;
    c1 = (t % p.t1) * p.b1;
    c2 = (t / p.t1) * p.b2;
  };
  auto load = [&](int j) {
    const int stage = j % p.stages;
    int s, c0, c1, c2;
    at(j, s, c0, c1, c2);
    hg::mbar_expect_tx(full0 + 8 * stage, (uint32_t)p.box_bytes);
    hg::tma_load4(ring + stage * p.stage_bytes, &p.in_map, c0, c1, c2, s,
                  full0 + 8 * stage);
  };
  const int ahead = n < p.stages - 1 ? n : p.stages - 1;
  for (int j = 0; j < ahead; ++j) load(j);
  for (int j = 0; j < n; ++j) {
    const int stage = j % p.stages;
    hg::mbar_wait(full0 + 8 * stage, (j / p.stages) & 1);
    // the stores read what the async proxy wrote: order them after it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    int s, c0, c1, c2;
    at(j, s, c0, c1, c2);
    for (int d = 0; d < p.R; ++d)
      tma_store5(&p.out_map, ring + stage * p.stage_bytes, c0, c1, c2, s, d);
    hg::bulk_commit();
    if (j + p.stages - 1 < n) {
      hg::bulk_wait_read<1>();
      load(j + p.stages - 1);
    }
  }
  hg::bulk_wait_read<0>();  // the stores have read the ring before it goes
}

// The copy's description in words for the word kernel: dims inner first,
// input and output strides in bytes.
struct WordDims {
  long long ext[AG_WORD_DIMS], in[AG_WORD_DIMS], out[AG_WORD_DIMS];
};

// Word by word, for shapes a tensor map cannot take: element e of a source
// is split into its coordinates dim by dim.
template <typename U>
__global__ void __launch_bounds__(AG_WORD_THREADS)
    pk_ag_word_kernel(const unsigned char* __restrict__ in,
                      unsigned char* __restrict__ out, int R, int nd,
                      const WordDims w, long long per_src, long long src,
                      long long slot, long long rank) {
  const long long total = (long long)R * per_src;
  for (long long e = (long long)blockIdx.x * AG_WORD_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * AG_WORD_THREADS) {
    const long long s = e / per_src;
    long long rest = e - s * per_src, io = s * src, oo = s * slot;
    for (int k = 0; k < nd; ++k) {
      const long long q = rest / w.ext[k];
      const long long i = rest - q * w.ext[k];
      io += i * w.in[k];
      oo += i * w.out[k];
      rest = q;
    }
    const U v = *reinterpret_cast<const U*>(in + io);
    for (int d = 0; d < R; ++d)
      *reinterpret_cast<U*>(out + d * rank + oo) = v;
  }
}

// A map of 8-byte elements (no swizzle, no interleave), strides in bytes;
// 0, or minus the CUresult of a refused encode.
inline int encode_u64(CUtensorMap* map, unsigned long long ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  hg::EncodeTiledFn fn = hg::encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, rank,
                        reinterpret_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// A stage of the TMA kernel's ring: a box, rounded up to the 128-byte
// alignment of a TMA copy's shared-memory address.
inline int ag_stage_bytes(int box_bytes) {
  return (box_bytes + 127) / 128 * 128;
}

// The TMA kernel's dynamic shared memory: the ring and its mbarriers.
inline size_t ag_smem(int box_bytes, int stages) {
  return (size_t)stages * ag_stage_bytes(box_bytes) +
         stages * sizeof(uint64_t);
}

// -- reduce-scatter: pull and sum, f32 in rank order --

template <typename T>
struct Vec;  // VEC elements of T moved as one 16-byte word
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using W = float4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using W = uint4;
};

__device__ __forceinline__ void acc_set(float* a, float4 w) {
  a[0] = w.x;
  a[1] = w.y;
  a[2] = w.z;
  a[3] = w.w;
}
__device__ __forceinline__ void acc_set(float* a, uint4 w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void acc_add(float* a, float4 w) {
  a[0] += w.x;
  a[1] += w.y;
  a[2] += w.z;
  a[3] += w.w;
}
__device__ __forceinline__ void acc_add(float* a, uint4 w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    a[2 * i] += f.x;
    a[2 * i + 1] += f.y;
  }
}
__device__ __forceinline__ float4 pack(const float* a, float4*) {
  return make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ uint4 pack(const float* a, uint4*) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
  return w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int RS_CONSUMERS = 256;              // 8 warps sum and store
constexpr int RS_THREADS = RS_CONSUMERS + 32;  // + the producer warp
constexpr int RS_MAX_STAGES = 8;
constexpr int RS_ELEM_THREADS = 256;

struct RsArgs {
  pk::PtrTable src, dst;
  long blk, chunk, items;  // items: R owners x n_chunks x tiles a chunk
  int R, tile, tiles_per_chunk, stages;
};

// The persistent pull-and-sum kernel: block b takes items b, b + grid, ...
// (the same number of tiles each, give or take one). Item i is owner o =
// i / (items / R), then chunk c and tile t of that owner's block. Stage j
// of the ring holds R tiles of `tile` elements, source s at s * tile.
template <typename T>
__global__ void __launch_bounds__(RS_THREADS)
    pk_rs_pull_kernel(const __grid_constant__ RsArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using W = typename Vec<T>::W;
  constexpr int V = Vec<T>::N;
  const long stage_elems = (long)p.R * p.tile;
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (size_t)p.stages * stage_elems * sizeof(T));
  const uint32_t full0 = hg::smem_addr(bars);
  const uint32_t empty0 = hg::smem_addr(bars + p.stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, RS_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool producer = threadIdx.x >= RS_CONSUMERS;
  if (producer && threadIdx.x != RS_CONSUMERS) return;
  const long per_owner = p.items / p.R;
  int j = 0;
  for (long i = blockIdx.x; i < p.items; i += gridDim.x, ++j) {
    const int stage = j % p.stages;
    const uint32_t phase = (j / p.stages) & 1;
    const int o = (int)(i / per_owner);
    const long rest = i - o * per_owner;
    const long c = rest / p.tiles_per_chunk;
    const long begin = c * p.chunk + (rest - c * p.tiles_per_chunk) * p.tile;
    const int len = (int)lmin(p.tile, (c + 1) * p.chunk - begin);
    T* st = ring + stage * stage_elems;
    if (producer) {
      hg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t bytes = (uint32_t)len * sizeof(T);
      hg::mbar_expect_tx(full0 + 8 * stage, (uint32_t)p.R * bytes);
      for (int s = 0; s < p.R; ++s)
        hg::bulk_load(hg::smem_addr(st + (long)s * p.tile),
                  reinterpret_cast<const T*>(p.src.p[s]) +
                      (long)o * p.blk + begin,
                  bytes, full0 + 8 * stage);
    } else {
      hg::mbar_wait(full0 + 8 * stage, phase);
      T* out = reinterpret_cast<T*>(p.dst.p[o]) + begin;
      for (int v = threadIdx.x; v < len / V; v += RS_CONSUMERS) {
        float a[V];
        acc_set(a, reinterpret_cast<const W*>(st)[v]);
        for (int s = 1; s < p.R; ++s)
          acc_add(a, reinterpret_cast<const W*>(st + (long)s * p.tile)[v]);
        reinterpret_cast<W*>(out)[v] = pack(a, (W*)nullptr);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) hg::mbar_arrive(empty0 + 8 * stage);
    }
  }
}

// Element by element, for shapes the bulk copies cannot take: the same f32
// sums in rank order, rounded once.
template <typename T>
__global__ void __launch_bounds__(RS_ELEM_THREADS)
    pk_rs_pull_elem_kernel(pk::PtrTable src, pk::PtrTable dst, int R,
                           long blk) {
  const long total = (long)R * blk;
  for (long e = (long)blockIdx.x * RS_ELEM_THREADS + threadIdx.x; e < total;
       e += (long)gridDim.x * RS_ELEM_THREADS) {
    const int o = (int)(e / blk);  // slot o of every source is at e
    float a = to_f32(reinterpret_cast<const T*>(src.p[0])[e]);
    for (int s = 1; s < R; ++s)
      a += to_f32(reinterpret_cast<const T*>(src.p[s])[e]);
    from_f32(reinterpret_cast<T*>(dst.p[o]) + (e - (long)o * blk), a);
  }
}

// -- p2p ring shift: one hop to the right, persistent, monotonic flags --

constexpr int P2P_THREADS = 256;
constexpr int P2P_UNROLL = 4;  // words in flight a thread

// Item i is source s = i / tiles, tile t; the block copies its tile
// of in[s] into out[(s + 1) % R], P2P_UNROLL loads in flight a thread, then
// fences and counts the tile in on the destination's flag.
template <typename U>
__global__ void __launch_bounds__(P2P_THREADS)
    pk_p2p_kernel(const __grid_constant__ pk::PtrTable src,
                  const __grid_constant__ pk::PtrTable dst,
                  int* __restrict__ flags, int R, long units,
                  long tile_units, int tiles) {
  const int items = R * tiles;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int s = i / tiles, d = (s + 1) % R;
    const long begin = (long)(i - s * tiles) * tile_units;
    const long end = lmin(begin + tile_units, units);
    const U* in = reinterpret_cast<const U*>(src.p[s]);
    U* out = reinterpret_cast<U*>(dst.p[d]);
    for (long b = begin + threadIdx.x; b < end;
         b += (long)P2P_THREADS * P2P_UNROLL) {
      U v[P2P_UNROLL];
#pragma unroll
      for (int k = 0; k < P2P_UNROLL; ++k) {
        const long e = b + (long)k * P2P_THREADS;
        if (e < end) v[k] = __ldg(in + e);
      }
#pragma unroll
      for (int k = 0; k < P2P_UNROLL; ++k) {
        const long e = b + (long)k * P2P_THREADS;
        if (e < end) pk::store_async(out + e, v[k]);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) pk::signal(flags + d, 1);
  }
}

// -- all-to-all: a strided copy of R x R blocks, persistent, no flags --

constexpr int A2A_THREADS = 512;
constexpr int A2A_UNROLL = 4;  // words in flight a thread
constexpr int A2A_DIMS = 4;

// The strided dims above a row, inner first: extents, input and output
// strides in bytes.
struct A2aDims {
  int ext[A2A_DIMS];
  long long in[A2A_DIMS], out[A2A_DIMS];
};

// Row `row` of a block: its input and output byte offsets.
__device__ __forceinline__ void a2a_row(const A2aDims& w, int nd, int row,
                                        long long& io, long long& oo) {
  io = 0;
  oo = 0;
#pragma unroll
  for (int k = 0; k < A2A_DIMS; ++k) {
    if (k < nd) {
      const int q = row / w.ext[k];
      const int i = row - q * w.ext[k];
      io += i * w.in[k];
      oo += i * w.out[k];
      row = q;
    }
  }
}

// Item i is pair (s, d) = divmod(i / tiles, R), tile t = i % tiles: rows
// [row0, row0 + rows_per_tile) of the block, words [w0, w0 + piece) of each
// row, and the row's tail with its last piece.
template <typename U>
__global__ void __launch_bounds__(A2A_THREADS)
    pk_a2a_kernel(const __grid_constant__ pk::PtrTable src,
                  const __grid_constant__ pk::PtrTable dst,
                  const __grid_constant__ A2aDims w, int nd, int R,
                  long long dst_in, long long src_out, int rows,
                  int row_words, int tail, int piece, int pieces,
                  int rows_per_tile, int tiles) {
  const int items = R * R * tiles;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int pair = i / tiles, t = i - pair * tiles;
    const int s = pair / R, d = pair - s * R;
    const int rt = t / pieces, pc = t - rt * pieces;
    const int row0 = rt * rows_per_tile;
    const int nrows = min(rows_per_tile, rows - row0);
    const int w0 = pc * piece;
    const int nw = min(piece, row_words - w0);
    const unsigned char* in =
        reinterpret_cast<const unsigned char*>(src.p[s]) + d * dst_in;
    unsigned char* out = reinterpret_cast<unsigned char*>(dst.p[d]) +
                         s * src_out;
    const int n = nw > 0 ? nrows * nw : 0;
    for (int f = threadIdx.x; f < n; f += A2A_THREADS * A2A_UNROLL) {
      U v[A2A_UNROLL];
      long long to[A2A_UNROLL];
#pragma unroll
      for (int k = 0; k < A2A_UNROLL; ++k) {
        const int e = f + k * A2A_THREADS;
        if (e < n) {
          const int row = row0 + e / nw;
          const long long col = (long long)(w0 + e % nw) * sizeof(U);
          long long io, oo;
          a2a_row(w, nd, row, io, oo);
          v[k] = __ldg(reinterpret_cast<const U*>(in + io + col));
          to[k] = oo + col;
        }
      }
#pragma unroll
      for (int k = 0; k < A2A_UNROLL; ++k) {
        const int e = f + k * A2A_THREADS;
        if (e < n) *reinterpret_cast<U*>(out + to[k]) = v[k];
      }
    }
    if (tail > 0 && pc == pieces - 1) {
      const long long lo = (long long)row_words * sizeof(U);
      for (int f = threadIdx.x; f < nrows * tail; f += A2A_THREADS) {
        const int row = row0 + f / tail;
        long long io, oo;
        a2a_row(w, nd, row, io, oo);
        out[oo + lo + f % tail] = in[io + lo + f % tail];
      }
    }
  }
}

bool aligned16(const unsigned long long* ptrs, int R) {
  for (int i = 0; i < R; ++i)
    if (ptrs[i] % 16) return false;
  return true;
}

// The bulk kernel's dynamic shared memory: the ring and its mbarriers.
template <typename T>
size_t rs_smem(int R, int tile, int stages) {
  return (size_t)stages * R * tile * sizeof(T) + 2 * stages * sizeof(uint64_t);
}

template <typename T>
int launch_rs(const unsigned long long* in, const unsigned long long* out,
              int R, long blk, long chunk, int tile, int grid, int stages,
              long smem_bytes, cudaStream_t stream) {
  pk::PtrTable s = pk::table(in, R), d = pk::table(out, R);
  if (tile == 0) {  // element by element
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    pk_rs_pull_elem_kernel<T>
        <<<grid, RS_ELEM_THREADS, 0, stream>>>(s, d, R, blk);
    return (int)cudaGetLastError();
  }
  // bulk copies: 16-byte addresses and sizes, a tile inside a chunk
  const long es = sizeof(T);
  if (tile < 0 || (tile * es) % 16 || (chunk * es) % 16 ||
      !aligned16(in, R) || !aligned16(out, R) || stages < 1 ||
      stages > RS_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rs_smem<T>(R, tile, stages);
  if ((long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  static size_t granted = 0;  // the attribute this instantiation was given
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        pk_rs_pull_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const int tpc = (int)((chunk + tile - 1) / tile);
  RsArgs a{s, d, blk, chunk, (long)R * (blk / chunk) * tpc, R, tile, tpc,
           stages};
  pk_rs_pull_kernel<T><<<grid, RS_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: the input view's and the (R, *gathered) output's base
// addresses. The copy is the plan's (kernels/pk_comm.py ag_plan): nd dims,
// inner first, extents `ext` (units of `unit` bytes) and input and output
// strides `in_st`, `out_st` in bytes (the inner dim's are the unit: it is
// contiguous in both), source s at s * src bytes of the input and slot s *
// slot of a rank's output, rank d at d * rank. route 1: the TMA kernel
// (unit 8, nd 3, tiles of box[0..2], the persistent grid, stages, shared
// memory a block: a launch whose ag_smem differs is refused); route 0: the
// word kernel (nd <= 6, the unit a word of 1-16 bytes, grid blocks).
extern "C" int pk_all_gather(const void* in, void* out, int R, int route,
                             int unit, int nd, const long long* ext,
                             const long long* in_st, const long long* out_st,
                             long long src, long long slot, long long rank,
                             const int* box, int grid, int stages,
                             long long smem_bytes, void* stream) {
  if (R < 1 || grid < 1 || nd < 1 || nd > AG_WORD_DIMS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  long long per_src = 1;
  for (int k = 0; k < nd; ++k) per_src *= ext[k];
  if (per_src == 0) return 0;
  if (route == 0) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    WordDims w{};
    for (int k = 0; k < nd; ++k) {
      w.ext[k] = ext[k];
      w.in[k] = in_st[k];
      w.out[k] = out_st[k];
    }
    const unsigned char* i = static_cast<const unsigned char*>(in);
    unsigned char* o = static_cast<unsigned char*>(out);
    auto go = [&](auto word) {
      pk_ag_word_kernel<decltype(word)><<<grid, AG_WORD_THREADS, 0, st>>>(
          i, o, R, nd, w, per_src, src, slot, rank);
      return (int)cudaGetLastError();
    };
    switch (unit) {
      case 16: return go(uint4{});
      case 8: return go(uint2{});
      case 4: return go(0u);
      case 2: return go((unsigned short)0);
      case 1: return go((unsigned char)0);
    }
    return (int)cudaErrorInvalidValue;
  }
  // the TMA route: 8-byte units, three dims, the inner one contiguous, a
  // box row a multiple of 16 bytes, every address and stride 16-byte aligned
  if (route != 1 || unit != 8 || nd != 3 || in_st[0] != 8 ||
      out_st[0] != 8 || (reinterpret_cast<uintptr_t>(in) | 
      reinterpret_cast<uintptr_t>(out)) % 16 || stages < 2 ||
      stages > AG_MAX_STAGES || box[0] % 2)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (box[k] < 1 || box[k] > 256) return (int)cudaErrorInvalidValue;
  const int box_bytes = 8 * box[0] * box[1] * box[2];
  const size_t smem = ag_smem(box_bytes, stages);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  AgArgs a{};
  const cuuint64_t idims[4] = {(cuuint64_t)ext[0], (cuuint64_t)ext[1],
                               (cuuint64_t)ext[2], (cuuint64_t)R};
  const cuuint64_t istr[3] = {(cuuint64_t)in_st[1], (cuuint64_t)in_st[2],
                              (cuuint64_t)src};
  const cuuint32_t ibox[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2], 1};
  if (const int e = encode_u64(&a.in_map, reinterpret_cast<uintptr_t>(in),
                               4, idims, istr, ibox))
    return e;
  const cuuint64_t odims[5] = {(cuuint64_t)ext[0], (cuuint64_t)ext[1],
                               (cuuint64_t)ext[2], (cuuint64_t)R,
                               (cuuint64_t)R};
  const cuuint64_t ostr[4] = {(cuuint64_t)out_st[1], (cuuint64_t)out_st[2],
                              (cuuint64_t)slot, (cuuint64_t)rank};
  const cuuint32_t obox[5] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2], 1, 1};
  if (const int e = encode_u64(&a.out_map, reinterpret_cast<uintptr_t>(out),
                               5, odims, ostr, obox))
    return e;
  a.R = R;
  a.b0 = box[0];
  a.b1 = box[1];
  a.b2 = box[2];
  a.t0 = (int)((ext[0] + box[0] - 1) / box[0]);
  a.t1 = (int)((ext[1] + box[1] - 1) / box[1]);
  a.t2 = (int)((ext[2] + box[2] - 1) / box[2]);
  a.items = R * a.t0 * a.t1 * a.t2;
  a.stages = stages;
  a.box_bytes = box_bytes;
  a.stage_bytes = ag_stage_bytes(box_bytes);
  static size_t granted = 0;  // the attribute the kernel was given
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        pk_ag_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  pk_ag_tma_kernel<<<grid, AG_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// in: R rank tables of R slots of blk elements (slot o = the partial for
// owner o); out: R ranks of blk elements. dtype: 0 = float32, 1 =
// bfloat16. The launch is the plan's (kernels/pk_comm.py rs_plan): tile
// elements a source a stage (0: the element-wise kernel), the persistent
// grid, the ring's stages and its shared memory a block: a launch whose
// rs_smem differs (0 for the element-wise kernel) is refused.
extern "C" int pk_reduce_scatter(const unsigned long long* in_ptrs,
                                 const unsigned long long* out_ptrs, int R,
                                 long blk_elems, long chunk_elems, int dtype,
                                 int tile, int grid, int stages,
                                 long long smem_bytes, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || chunk_elems <= 0 ||
      blk_elems % chunk_elems != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (blk_elems == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rs<float>(in_ptrs, out_ptrs, R, blk_elems, chunk_elems,
                            tile, grid, stages, (long)smem_bytes, st);
  if (dtype == 1)
    return launch_rs<__nv_bfloat16>(in_ptrs, out_ptrs, R, blk_elems,
                                    chunk_elems, tile, grid, stages,
                                    (long)smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// in/out: host tables of R rank addresses of blk_bytes each; flags: R ints
// that this launch adds its tiles to, never reset (flags[d] counts the
// tiles that ever arrived in rank d's output on this stream). The launch is
// the plan's (kernels/pk_comm.py p2p_plan): tiles of tile_bytes (a multiple
// of 16), the persistent grid; words are the widest (16 down to 1 bytes)
// that divide blk_bytes and every address.
extern "C" int pk_p2p_ring_shift(const unsigned long long* in_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, int R, long blk_bytes,
                                 long tile_bytes, int grid, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || blk_bytes < 0 || tile_bytes < 16 ||
      tile_bytes % 16 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (blk_bytes == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)((blk_bytes + tile_bytes - 1) / tile_bytes);
  pk::PtrTable s = pk::table(in_ptrs, R), d = pk::table(out_ptrs, R);
  unsigned long long bits = (unsigned long long)blk_bytes;
  for (int i = 0; i < R; ++i) bits |= in_ptrs[i] | out_ptrs[i];
  return pk::with_word(bits, [&](auto word) {
    using U = decltype(word);
    pk_p2p_kernel<U><<<grid, P2P_THREADS, 0, st>>>(
        s, d, (int*)flags, R, blk_bytes / (long)sizeof(U),
        tile_bytes / (long)sizeof(U), tiles);
    return (int)cudaGetLastError();
  });
}

// in/out: host tables of R rank addresses: rank s's input (its local
// tensor, any strides) and rank d's output (its local tensor after the
// all-to-all). The launch is the plan's (kernels/pk_comm.py a2a_plan): the
// word of `unit` bytes, nd <= 4 strided dims above a row (extents, input
// and output strides in bytes), block (s, d) at in[s] + d * dst_in and
// out[d] + s * src_out, rows of row_words words and tail bytes, items of
// rows_per_tile rows times a piece of piece words (pieces a row), the
// persistent grid. A unit that does not divide every address and stride
// is refused.
extern "C" int pk_all_to_all(const unsigned long long* in_ptrs,
                             const unsigned long long* out_ptrs, int R,
                             int unit, int nd, const long long* ext,
                             const long long* in_st, const long long* out_st,
                             long long dst_in, long long src_out, int rows,
                             int row_words, int tail, int piece, int pieces,
                             int rows_per_tile, int grid, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || nd < 0 || nd > A2A_DIMS || grid < 1 ||
      rows < 0 || row_words < 0 || tail < 0 || tail >= unit || piece < 1 ||
      pieces < 1 || rows_per_tile < 1 ||
      (unit != 16 && unit != 8 && unit != 4 && unit != 2 && unit != 1))
    return (int)cudaErrorInvalidValue;
  unsigned long long bits = (unsigned long long)(dst_in | src_out);
  long long n_rows = 1;
  A2aDims w{};
  for (int k = 0; k < nd; ++k) {
    if (ext[k] < 1) return (int)cudaErrorInvalidValue;
    w.ext[k] = (int)ext[k];
    w.in[k] = in_st[k];
    w.out[k] = out_st[k];
    bits |= (unsigned long long)(in_st[k] | out_st[k]);
    n_rows *= ext[k];
  }
  for (int i = 0; i < R; ++i) bits |= in_ptrs[i] | out_ptrs[i];
  const long long tiles =
      (rows + (long long)rows_per_tile - 1) / rows_per_tile * pieces;
  if (bits % unit || n_rows != rows || (long long)R * R * tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || (row_words == 0 && tail == 0)) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const pk::PtrTable s = pk::table(in_ptrs, R), d = pk::table(out_ptrs, R);
  auto go = [&](auto word) {
    pk_a2a_kernel<decltype(word)><<<grid, A2A_THREADS, 0, st>>>(
        s, d, w, nd, R, dst_in, src_out, rows, row_words, tail, piece,
        pieces, rows_per_tile, (int)tiles);
    return (int)cudaGetLastError();
  };
  switch (unit) {
    case 16: return go(uint4{});
    case 8: return go(uint2{});
    case 4: return go(0u);
    case 2: return go((unsigned short)0);
    default: return go((unsigned char)0);
  }
}
