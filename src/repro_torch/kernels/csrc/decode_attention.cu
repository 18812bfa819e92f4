// One-token decode attention over the stacked, sequence-sharded slab cache,
// in one pass: rank r holds the global positions r * s_loc + j of a (R, B,
// Hkv, s_loc, hd) K and V. It replaces no Pallas kernel: the JAX package's
// decode island (repro/models/layers.py::decode_island) writes the new token
// with a dynamic_update_slice and leaves the mix to XLA. See
// kernels/decode_attention.py for the design note.
//
// A block takes one (rank, slot, kv head) and, where the plan splits the
// keys, one of `splits` equal parts of the rank's visible keys (grid
// (R*B*Hkv, splits)):
//
// 1. The block whose part holds the slot's position `pos` (the rank's last
//    visible key, where the rank holds it) writes k_new and v_new there, in
//    place; a position that no rank holds (>= s_max) writes nothing. The
//    block reads that row back below, so the write is fenced and the block
//    synchronised before any load.
// 2. Only the visible keys [max(kvl - window, r * s_loc), kvl) of the rank,
//    kvl = pos + 1, cut to the block's part, are read: tiles of DA_KT keys
//    of K and V, staged in shared memory by 16-byte cp.async copies in a
//    ring of DA_STAGES.
// 3. The g = Hq / Hkv query heads of the group are read once, into
//    registers as f32. A key row is split over `lanes` lanes (a power of
//    two), D elements a lane; each group of lanes takes a key of the tile,
//    so every lane group keeps its own running max, sum and output for each
//    head, all in f32: the score is the lanes' partial dot products summed
//    by an xor butterfly (the same bits on every lane of the group), and P
//    stays f32 (no rounding to bf16, which a tensor-core product would
//    need; with one query row the kernel is bound by bytes anyway). The
//    softmax runs in base 2 (scores times log2 e, ex2.approx: one MUFU
//    instruction an exponential) and m leaves in natural units.
// 4. The lane groups' (m, l, o) are merged through shared memory, reusing
//    the stage ring, and the block writes the unnormalized o (hd f32) with
//    m and l for each of its heads: the rank's partial of the log-sum-exp
//    merge the island finishes across ranks. With split keys each split
//    writes its own partial and da_combine merges them in split order.
//
// A rank with no visible key writes m = -1e30, l = 0 and o = 0.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DA_THREADS = 128;
constexpr int DA_KT = 32;       // keys a tile
constexpr int DA_STAGES = 3;
constexpr float DA_NEG_INF = -1e30f;
constexpr float DA_LOG2E = 1.4426950408889634f;
constexpr float DA_LN2 = 0.6931471805599453f;
constexpr int DA_SMEM_LIMIT = 232448;

struct DaArgs {
  const void* q;    // (R, B, Hq, [1,] hd): strides (rank, slot, head)
  const void* kn;   // (R, B, Hkv, [1,] hd) new K and V, in the cache's type
  const void* vn;
  void* k;          // (R, B, Hkv, s_loc, hd) cache, rows of 16 bytes
  void* v;
  const void* pos;  // (B,) int32 or int64, or null: pos_scalar
  long long pos_scalar, pos_stride;
  int pos64;
  float* o;         // (R, B, Hq, splits, hd) f32
  float* m;         // (R, B, Hq, splits) f32
  float* l;
  int B, Hkv, g, s_loc, hd, window, splits, lanes;
  float scale;      // of the scores, hd^-0.5
  long long qr, qb, qh, knr, knb, knh, vnr, vnb, vnh;
  long long kr, kb, kh, ks, vr, vb, vh, vs;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D elements of T (8 or 16 bytes) from shared memory, widened to f32
template <typename T, int D>
__device__ __forceinline__ void load_frag(const T* p, float (&out)[D]) {
  static_assert(D == 4 || D == 8, "a lane holds 4 or 8 elements");
  if constexpr (D == 8) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = to_f32(e[i]);
  } else {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = to_f32(e[i]);
  }
}

// G: query heads a group at most (the group's g <= G); D: elements a lane
template <typename T, int G, int D>
__global__ void __launch_bounds__(DA_THREADS)
    da_kernel(const DaArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int kvh = blockIdx.x % p.Hkv;
  const int b = (blockIdx.x / p.Hkv) % p.B;
  const int r = blockIdx.x / (p.Hkv * p.B);
  const int split = blockIdx.y;
  const int hd = p.hd;

  const long long pos =
      p.pos == nullptr ? p.pos_scalar
      : p.pos64 ? reinterpret_cast<const long long*>(p.pos)[b * p.pos_stride]
                : (long long)reinterpret_cast<const int*>(p.pos)[b * p.pos_stride];
  const long long off = (long long)r * p.s_loc;
  const long long kvl = pos + 1;
  const long long lo = p.window > 0 ? max(0LL, kvl - p.window) : 0LL;
  const long long va = max(lo, off) - off;              // the rank's visible
  const long long ve = min(kvl, off + p.s_loc) - off;   // keys [va, ve)
  const long long part = ve > va ? (ve - va + p.splits - 1) / p.splits : 0;
  const long long a = va + split * part;
  const long long e = min(ve, a + part);
  const int n = e > a ? (int)(e - a) : 0;

  T* kbase = reinterpret_cast<T*>(p.k) + r * p.kr + b * p.kb + kvh * p.kh;
  T* vbase = reinterpret_cast<T*>(p.v) + r * p.vr + b * p.vb + kvh * p.vh;

  // 1. the new token, where this block's part holds its position
  const long long lp = pos - off;
  if (lp >= a && lp < e) {
    const T* kn = reinterpret_cast<const T*>(p.kn) + r * p.knr + b * p.knb +
                  kvh * p.knh;
    const T* vn = reinterpret_cast<const T*>(p.vn) + r * p.vnr + b * p.vnb +
                  kvh * p.vnh;
    for (int i = tid; i < 2 * hd; i += DA_THREADS) {
      if (i < hd)
        kbase[lp * p.ks + i] = kn[i];
      else
        vbase[lp * p.vs + i - hd] = vn[i - hd];
    }
    __threadfence();
  }
  __syncthreads();

  // 3. the group's query heads, D elements of each a lane
  const int L = p.lanes;
  const int grp = tid / L, li = tid % L, ngrp = DA_THREADS / L;
  const int d0 = li * D;
  const bool active = d0 < hd;
  float qf[G][D];
  {
    const T* qb = reinterpret_cast<const T*>(p.q) + r * p.qr + b * p.qb +
                  (long long)kvh * p.g * p.qh;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int i = 0; i < D; ++i)
        qf[h][i] = (h < p.g && active) ? to_f32(qb[h * p.qh + d0 + i]) : 0.f;
  }
  float mr[G], lr[G], acc[G][D];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    mr[h] = DA_NEG_INF;
    lr[h] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[h][i] = 0.f;
  }

  // 2. the visible keys, tile by tile through the stage ring
  T* ring = reinterpret_cast<T*>(smem);
  const int stage_elems = 2 * DA_KT * hd;  // K rows, then V rows
  const int chunks = hd / 8;               // 16-byte copies a row
  const int ntiles = (n + DA_KT - 1) / DA_KT;
  auto load = [&](int t) {
    const long long k0 = a + (long long)t * DA_KT;
    const int nk = min(DA_KT, n - t * DA_KT);
    T* sk = ring + (t % DA_STAGES) * stage_elems;
    T* sv = sk + DA_KT * hd;
    const int per = nk * chunks;
    for (int i = tid; i < 2 * per; i += DA_THREADS) {
      const int j = i < per ? i : i - per;
      const int key = j / chunks, c = j - key * chunks;
      if (i < per)
        cp_async16(sk + key * hd + c * 8, kbase + (k0 + key) * p.ks + c * 8);
      else
        cp_async16(sv + key * hd + c * 8, vbase + (k0 + key) * p.vs + c * 8);
    }
  };
#pragma unroll
  for (int s = 0; s < DA_STAGES - 1; ++s) {
    if (s < ntiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DA_STAGES - 2>();
    __syncthreads();  // tile t has landed; tile t - 1's stage is free
    if (t + DA_STAGES - 1 < ntiles) load(t + DA_STAGES - 1);
    cp_async_commit();
    const T* sk = ring + (t % DA_STAGES) * stage_elems;
    const T* sv = sk + DA_KT * hd;
    const int nk = min(DA_KT, n - t * DA_KT);
    // every lane runs every round, so the butterfly's shuffles see the
    // whole warp; a lane group past the tile's last key keeps its state
    for (int k0 = 0; k0 < nk; k0 += ngrp) {
      const int key = k0 + grp;
      const bool valid = key < nk;
      float kf[D], vf[D];
      if (valid && active) {
        load_frag<T, D>(sk + key * hd + d0, kf);
        load_frag<T, D>(sv + key * hd + d0, vf);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= p.g) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) s = fmaf(qf[h][i], kf[i], s);
        for (int w = L >> 1; w > 0; w >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, w);
        if (!valid) continue;
        s *= p.scale * DA_LOG2E;
        const float mn = fmaxf(mr[h], s);
        const float c = ex2(mr[h] - mn), pr = ex2(s - mn);
        lr[h] = lr[h] * c + pr;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[h][i] = fmaf(pr, vf[i], acc[h][i] * c);
        mr[h] = mn;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it holds the merge from here

  // 4. merge the lane groups
  float* ms = reinterpret_cast<float*>(smem);  // [ngrp][G]
  float* ls = ms + ngrp * G;                   // [ngrp][G]
  float* os = ls + ngrp * G;                   // [ngrp][G][hd]
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (li == 0) {
      ms[grp * G + h] = mr[h];
      ls[grp * G + h] = lr[h];
    }
    if (active)
#pragma unroll
      for (int i = 0; i < D; ++i) os[(grp * G + h) * hd + d0 + i] = acc[h][i];
  }
  __syncthreads();
  const long long row0 =
      ((long long)(r * p.B + b) * p.Hkv + kvh) * p.g;  // first head's row
  for (int idx = tid; idx < p.g * hd; idx += DA_THREADS) {
    const int h = idx / hd, d = idx - h * hd;
    float mx = DA_NEG_INF;
    for (int gi = 0; gi < ngrp; ++gi) mx = fmaxf(mx, ms[gi * G + h]);
    float sum = 0.f, o = 0.f;
    for (int gi = 0; gi < ngrp; ++gi) {
      const float w = ex2(ms[gi * G + h] - mx);
      sum = fmaf(ls[gi * G + h], w, sum);
      o = fmaf(os[(gi * G + h) * hd + d], w, o);
    }
    const long long out = (row0 + h) * p.splits + split;
    p.o[out * hd + d] = o;
    if (d == 0) {
      p.m[out] = mx == DA_NEG_INF ? DA_NEG_INF : mx * DA_LN2;
      p.l[out] = sum;
    }
  }
}

// the splits' partials (rows, splits, hd) -> (rows, hd), in split order
__global__ void da_combine(const float* po, const float* pm, const float* pl,
                           float* o, float* m, float* l, int splits, int hd) {
  const long long row = blockIdx.x;
  float mx = DA_NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pm[row * splits + s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float sum = 0.f, acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(pm[row * splits + s] - mx);
      sum = fmaf(pl[row * splits + s], w, sum);
      acc = fmaf(po[(row * splits + s) * hd + d], w, acc);
    }
    o[row * hd + d] = acc;
    if (d == 0) {
      m[row] = mx;
      l[row] = sum;
    }
  }
}

template <typename T, int G, int D>
int da_launch(const DaArgs& p, int blocks, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      da_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  da_kernel<T, G, D><<<dim3(blocks, p.splits), DA_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int da_dispatch(const DaArgs& p, int G, int D, int blocks, int smem,
                cudaStream_t s) {
  if (G == 1 && D == 8) return da_launch<T, 1, 8>(p, blocks, smem, s);
  if (G == 2 && D == 8) return da_launch<T, 2, 8>(p, blocks, smem, s);
  if (G == 4 && D == 8) return da_launch<T, 4, 8>(p, blocks, smem, s);
  if (G == 8 && D == 4) return da_launch<T, 8, 4>(p, blocks, smem, s);
  if (G == 12 && D == 4) return da_launch<T, 12, 4>(p, blocks, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan's values (kernels/decode_attention.py decode_plan): heads a
// group at most G, elements a lane D, lanes a key row, parts of each
// rank's visible keys, shared memory a block. With splits > 1, o, m and l are
// the (R, B, Hq, splits, ...) partials and da_combine writes the merged
// (R, B, Hq, ...) into out_o, out_m, out_l. Returns cudaGetLastError().
extern "C" int pk_decode_attention(
    const void* q, const void* kn, const void* vn, void* k, void* v,
    const void* pos, long long pos_scalar, long long pos_stride, int pos64,
    void* o, void* m, void* l, void* out_o, void* out_m, void* out_l, int R,
    int B, int Hkv, int g, int s_loc, int hd, int window, float scale,
    long long qr, long long qb, long long qh, long long knr, long long knb,
    long long knh, long long vnr, long long vnb, long long vnh,
    long long kr, long long kb, long long kh, long long ks, long long vr,
    long long vb, long long vh, long long vs, int G, int D, int lanes,
    int splits, int smem, int bf16, void* stream) {
  if (hd % 8 || hd / D > lanes || lanes > 32 || (lanes & (lanes - 1)) ||
      g < 1 || g > G || splits < 1 || smem > DA_SMEM_LIMIT ||
      smem < DA_STAGES * 2 * DA_KT * hd * 2 ||
      smem < (DA_THREADS / lanes) * G * (hd + 2) * 4)
    return (int)cudaErrorInvalidValue;
  const int blocks = R * B * Hkv;
  if (blocks == 0) return 0;
  DaArgs p{q, kn, vn, k, v, pos, pos_scalar, pos_stride, pos64,
           (float*)o, (float*)m, (float*)l, B, Hkv, g, s_loc, hd, window,
           splits, lanes, scale, qr, qb, qh, knr, knb, knh, vnr,
           vnb, vnh, kr, kb, kh, ks, vr, vb, vh, vs};
  cudaStream_t s = (cudaStream_t)stream;
  int err = bf16 ? da_dispatch<__nv_bfloat16>(p, G, D, blocks, smem, s)
                 : da_dispatch<__half>(p, G, D, blocks, smem, s);
  if (err != 0 || splits == 1) return err;
  da_combine<<<blocks * g, hd < 128 ? hd : 128, 0, s>>>(
      (const float*)o, (const float*)m, (const float*)l, (float*)out_o,
      (float*)out_m, (float*)out_l, splits, hd);
  return (int)cudaGetLastError();
}
