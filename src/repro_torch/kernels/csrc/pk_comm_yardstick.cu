// The kernels B3 and B8 ran on before their redesigns (csrc/pk_comm.cu),
// kept as timing yardsticks: no wrapper of the port calls them;
// chip_smoke.py and the probes (scripts/scan_rs_probe.py,
// scripts/ag_p2p_probe.py) time them beside the kernels that replaced them
// (the ``ms_mm_tile`` column).
//
// reduce-scatter, store-and-count. Grid (tile, source s, owner o): the
// block stores tile of in[s] slot o into landing[o] slot s, fences and
// counts itself in on the tile's flag;
// the last of the R arrivals acquires, sums the R partials in rank order in
// f32 and stores the reduced tile into out[o]. No block waits. It moves
// R^2 blk read, R^2 blk written to the landing slots and read again, and R
// blk written, and zeroes the flags on the stream before every launch.
//
// all-gather, word copy. Grid (tile, source s): each block reads its tile
// of in[s] (contiguous) with one 16-byte __ldg a thread in flight and
// stores it R times, into slot s of every rank's (R, R, blk) output.
//
// p2p ring shift, store-and-count. Grid (tile, source s): the block stores
// its tile of in[s] into out[(s + 1) % R], fences and counts itself in on
// the destination's flag, after a memset of the flags on the stream before
// every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pk.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_VECS = 4 * THREADS;  // vectors a block moves

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

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

// VEC: 1 (element by element) or Vec<T>::N (16-byte words).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    rs_store_and_count_kernel(pk::PtrTable src, pk::PtrTable dst,
                              pk::PtrTable land, int* __restrict__ flags,
                              int R, long blk_elems, long chunk_elems,
                              int tiles_per_chunk) {
  __shared__ int s_last;
  const int s = blockIdx.y, o = blockIdx.z;
  const int c = blockIdx.x / tiles_per_chunk;
  const int t = blockIdx.x - c * tiles_per_chunk;
  const long begin = (long)c * chunk_elems + (long)t * TILE_VECS * VEC;
  const long end = lmin(begin + (long)TILE_VECS * VEC,
                        (long)(c + 1) * chunk_elems);
  using W = typename Vec<T>::W;

  // 1. store_async: my partial for owner o into o's landing slot s
  const T* part = reinterpret_cast<const T*>(src.p[s]) + (long)o * blk_elems;
  T* slot = reinterpret_cast<T*>(land.p[o]) + (long)s * blk_elems;
  for (long i = begin + (long)threadIdx.x * VEC; i < end;
       i += (long)THREADS * VEC) {
    if constexpr (VEC == 1) {
      slot[i] = part[i];
    } else {
      *reinterpret_cast<W*>(slot + i) =
          __ldg(reinterpret_cast<const W*>(part + i));
    }
  }

  // 2. signal arrival on the tile's flag; the last of R arrivals reduces
  __threadfence();
  __syncthreads();
  int* flag = flags + ((long)o * gridDim.x + blockIdx.x);
  if (threadIdx.x == 0) {
    const int old = pk::signal(flag, 1);
    s_last = (old == R - 1);
    if (s_last) pk::wait(flag);  // acquire: all R slots are visible now
  }
  __syncthreads();
  if (!s_last) return;

  // 3. sum the R landing slots in rank order (f32), round once, store
  const T* base = reinterpret_cast<const T*>(land.p[o]);
  T* out = reinterpret_cast<T*>(dst.p[o]);
  for (long i = begin + (long)threadIdx.x * VEC; i < end;
       i += (long)THREADS * VEC) {
    if constexpr (VEC == 1) {
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += to_f32(base[(long)r * blk_elems + i]);
      from_f32(out + i, a);
    } else {
      float a[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = 0.f;
      for (int r = 0; r < R; ++r)
        acc_add(a, __ldcg(reinterpret_cast<const W*>(
                       base + (long)r * blk_elems + i)));
      *reinterpret_cast<W*>(out + i) = pack(a, (W*)nullptr);
    }
  }
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
    ag_word_kernel(pk::PtrTable src, pk::PtrTable dst, int R, long blk_units,
                   long chunk_units, int tiles_per_chunk) {
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

template <typename U>
__global__ void __launch_bounds__(THREADS)
    p2p_count_kernel(pk::PtrTable src, pk::PtrTable dst,
                     int* __restrict__ flags, int R, long units) {
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

bool aligned16(const unsigned long long* ptrs, int R) {
  for (int i = 0; i < R; ++i)
    if (ptrs[i] % 16) return false;
  return true;
}

template <typename T>
int launch_rs(const unsigned long long* in, const unsigned long long* out,
              const unsigned long long* landing, void* flags, int R,
              long blk, long chunk, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const bool vec = chunk % V == 0 && blk % V == 0 && aligned16(in, R) &&
                   aligned16(out, R) && aligned16(landing, R);
  const int per_tile = TILE_VECS * (vec ? V : 1);
  const int tiles = (int)((chunk + per_tile - 1) / per_tile);
  const int n_chunks = (int)(blk / chunk);
  dim3 grid(n_chunks * tiles, R, R);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, sizeof(int) * grid.x * R, stream);
  if (err != cudaSuccess) return (int)err;
  pk::PtrTable s = pk::table(in, R), d = pk::table(out, R),
               l = pk::table(landing, R);
  if (vec)
    rs_store_and_count_kernel<T, V><<<grid, THREADS, 0, stream>>>(
        s, d, l, (int*)flags, R, blk, chunk, tiles);
  else
    rs_store_and_count_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        s, d, l, (int*)flags, R, blk, chunk, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// in: R rank tables of R slots of blk elements (slot o = the partial for
// owner o); out: R ranks of blk elements; landing: R owner slots of R x blk
// elements; flags: one int per (owner, tile), R * n_chunks *
// ceil(chunk / 1024) of them at most, zeroed here on the stream. dtype:
// 0 = float32, 1 = bfloat16.
extern "C" int pk_mm_tile_reduce_scatter(const unsigned long long* in_ptrs,
                                         const unsigned long long* out_ptrs,
                                         const unsigned long long* landing,
                                         void* flags, int R, long blk_elems,
                                         long chunk_elems, int dtype,
                                         void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || chunk_elems <= 0 ||
      blk_elems % chunk_elems != 0)
    return (int)cudaErrorInvalidValue;
  if (blk_elems == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_rs<float>(in_ptrs, out_ptrs, landing, flags, R, blk_elems,
                            chunk_elems, st);
  if (dtype == 1)
    return launch_rs<__nv_bfloat16>(in_ptrs, out_ptrs, landing, flags, R,
                                    blk_elems, chunk_elems, st);
  return (int)cudaErrorInvalidValue;
}

// in/out: host tables of R rank addresses. Rank r's input is blk_bytes
// bytes; its output holds R slots of blk_bytes. chunk_bytes divides
// blk_bytes.
extern "C" int pk_mm_tile_all_gather(const unsigned long long* in_ptrs,
                                     const unsigned long long* out_ptrs,
                                     int R, long blk_bytes, long chunk_bytes,
                                     void* stream) {
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
    ag_word_kernel<uint4><<<dim3(n_chunks * tiles, R), THREADS, 0, st>>>(
        s, d, R, blk_bytes / 16, cu, tiles);
  } else if (chunk_bytes % 2 == 0) {
    const long cu = chunk_bytes / 2;
    const int tiles = (int)((cu + TILE_VECS - 1) / TILE_VECS);
    ag_word_kernel<unsigned short>
        <<<dim3(n_chunks * tiles, R), THREADS, 0, st>>>(
            s, d, R, blk_bytes / 2, cu, tiles);
  } else {
    const int tiles = (int)((chunk_bytes + TILE_VECS - 1) / TILE_VECS);
    ag_word_kernel<unsigned char>
        <<<dim3(n_chunks * tiles, R), THREADS, 0, st>>>(
            s, d, R, blk_bytes, chunk_bytes, tiles);
  }
  return (int)cudaGetLastError();
}

// in/out: host tables of R rank addresses of blk_bytes each; flags: R ints,
// zeroed here on the stream, flags[d] counts the tiles that arrived in
// rank d's output. Moves the widest words that divide blk_bytes and every
// address.
extern "C" int pk_mm_tile_p2p_ring_shift(const unsigned long long* in_ptrs,
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
    using U = decltype(word);
    const long units = blk_bytes / (long)sizeof(U);
    const int tiles = (int)((units + TILE_VECS - 1) / TILE_VECS);
    p2p_count_kernel<U><<<dim3(tiles, R), THREADS, 0, st>>>(s, d, (int*)flags,
                                                            R, units);
    return (int)cudaGetLastError();
  });
}
