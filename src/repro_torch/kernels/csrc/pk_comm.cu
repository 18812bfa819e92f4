// Ring all-gather, ring reduce-scatter and the one-hop p2p ring shift over
// the ranks of a PGL. Port of repro/kernels/pk_comm.py::ring_all_gather,
// ::ring_reduce_scatter and ::p2p_ring_shift; the design note is in
// kernels/pk_comm.py.
//
// A rank's block is blk_elems elements (its rows, flattened), split into
// n_chunks row chunks of chunk_elems each; tiles never cross a chunk.
//
// all-gather:     grid (tile, source s): the block reads its tile of in[s]
//                 once and stores it into slot s of every rank's output.
//                 No block waits: a copy depends on nothing but its source.
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
//                 kernel with the same sums in the same order.
// p2p ring shift: grid (tile, source s): the block stores its tile of in[s]
//                 into out[(s + 1) % R] (store_async), fences and counts
//                 itself in on the destination's flag (signal, release).
//                 The TPU kernel opens with a neighbour barrier so that no
//                 chip writes into a buffer its neighbour still reads; on
//                 one card, inside one launch, a block that spin-waited on
//                 another rank's flag could wait on a block not yet resident
//                 and deadlock. The hop needs no wait: its output is a fresh
//                 buffer and the stream orders it after the producer of the
//                 input. So no block waits; the flags count each rank's
//                 arrived tiles (R ints, zeroed before the launch), which a
//                 later consumer or a test can read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pk.cuh"
#include "tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_VECS = 4 * THREADS;  // vectors a block moves

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

// -- all-gather: a byte copy, in 16-byte vectors when everything aligns --

template <typename U>
__global__ void __launch_bounds__(THREADS)
    pk_all_gather_kernel(pk::PtrTable src, pk::PtrTable dst, int R,
                         long blk_units, long chunk_units,
                         int tiles_per_chunk) {
  const int s = blockIdx.y;
  const int c = blockIdx.x / tiles_per_chunk;
  const int t = blockIdx.x - c * tiles_per_chunk;
  const long begin = (long)c * chunk_units + (long)t * TILE_VECS;
  const long end = lmin(begin + TILE_VECS, (long)(c + 1) * chunk_units);
  const U* in = reinterpret_cast<const U*>(src.p[s]);
  const long slot = (long)s * blk_units;
  for (long i = begin + threadIdx.x; i < end; i += THREADS) {
    const U v = __ldg(in + i);
    for (int d = 0; d < R; ++d)  // store_async into rank d's slot s
      reinterpret_cast<U*>(dst.p[d])[slot + i] = v;
  }
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

// one TMA bulk copy of `bytes` (a multiple of 16) from global `src` into
// shared `dst`, both 16-byte aligned, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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
        bulk_load(hg::smem_addr(st + (long)s * p.tile),
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

// -- p2p ring shift: one hop to the right, store-and-count, no wait --

template <typename U>
__global__ void __launch_bounds__(THREADS)
    pk_p2p_kernel(pk::PtrTable src, pk::PtrTable dst, int* __restrict__ flags,
                  int R, long units) {
  const int s = blockIdx.y, d = (s + 1) % R;
  const long begin = (long)blockIdx.x * TILE_VECS;
  const long end = lmin(begin + TILE_VECS, units);
  const U* in = reinterpret_cast<const U*>(src.p[s]);
  U* out = reinterpret_cast<U*>(dst.p[d]);
  for (long i = begin + threadIdx.x; i < end; i += THREADS)
    pk::store_async(out + i, __ldg(in + i));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) pk::signal(flags + d, 1);
}

template <typename U>
int launch_p2p(pk::PtrTable s, pk::PtrTable d, int* flags, int R,
               long blk_bytes, cudaStream_t st) {
  const long units = blk_bytes / (long)sizeof(U);
  const int tiles = (int)((units + TILE_VECS - 1) / TILE_VECS);
  pk_p2p_kernel<U><<<dim3(tiles, R), THREADS, 0, st>>>(s, d, flags, R, units);
  return (int)cudaGetLastError();
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

// in/out: host tables of R rank addresses. Rank r's input is blk_bytes
// bytes; its output holds R slots of blk_bytes. chunk_bytes divides
// blk_bytes.
extern "C" int pk_all_gather(const unsigned long long* in_ptrs,
                             const unsigned long long* out_ptrs, int R,
                             long blk_bytes, long chunk_bytes, void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || chunk_bytes <= 0 ||
      blk_bytes % chunk_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if (blk_bytes == 0) return 0;
  pk::PtrTable s = pk::table(in_ptrs, R), d = pk::table(out_ptrs, R);
  const int n_chunks = (int)(blk_bytes / chunk_bytes);
  const cudaStream_t st = (cudaStream_t)stream;
  if (chunk_bytes % 16 == 0 && aligned16(in_ptrs, R) &&
      aligned16(out_ptrs, R)) {
    const long cu = chunk_bytes / 16;
    const int tiles = (int)((cu + TILE_VECS - 1) / TILE_VECS);
    pk_all_gather_kernel<uint4><<<dim3(n_chunks * tiles, R), THREADS, 0,
                                  st>>>(s, d, R, blk_bytes / 16, cu, tiles);
  } else if (chunk_bytes % 2 == 0) {
    const long cu = chunk_bytes / 2;
    const int tiles = (int)((cu + TILE_VECS - 1) / TILE_VECS);
    pk_all_gather_kernel<unsigned short>
        <<<dim3(n_chunks * tiles, R), THREADS, 0, st>>>(
            s, d, R, blk_bytes / 2, cu, tiles);
  } else {
    const int tiles = (int)((chunk_bytes + TILE_VECS - 1) / TILE_VECS);
    pk_all_gather_kernel<unsigned char>
        <<<dim3(n_chunks * tiles, R), THREADS, 0, st>>>(
            s, d, R, blk_bytes, chunk_bytes, tiles);
  }
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

// in/out: host tables of R rank addresses of blk_bytes each; flags: R ints,
// zeroed here on the stream, flags[d] counts the tiles that arrived in
// rank d's output. Moves 16-, 8-, 4-, 2- or 1-byte words: the widest that
// divides blk_bytes and every address.
extern "C" int pk_p2p_ring_shift(const unsigned long long* in_ptrs,
                                 const unsigned long long* out_ptrs,
                                 void* flags, int R, long blk_bytes,
                                 void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || blk_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * R, st);
  if (err != cudaSuccess) return (int)err;
  if (blk_bytes == 0) return 0;
  unsigned long long bits = (unsigned long long)blk_bytes;
  for (int i = 0; i < R; ++i) bits |= in_ptrs[i] | out_ptrs[i];
  pk::PtrTable s = pk::table(in_ptrs, R), d = pk::table(out_ptrs, R);
  return pk::with_word(bits, [&](auto word) {
    return launch_p2p<decltype(word)>(s, d, (int*)flags, R, blk_bytes, st);
  });
}
