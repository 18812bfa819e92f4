// The mma.sync flash attention kernel that B7 (kernels/flash_attention.py:
// flash_attention and flash_attention_hop) ran on before its TMA + wgmma
// design (flash_attention.cu) took its place, kept unchanged as a timing
// yardstick. No wrapper launches it: chip_smoke.py times it beside the
// kernel that replaced it, on the same inputs in the same run, as the
// before-column (ms_mm_tile) of the kernels table.
//
// FlashAttention forward, bf16 in/out, f32 online softmax. Grid
// (ceil(Sq / 64), B * Hq), 128 threads. Warp w owns query rows
// [16 w, 16 w + 16) of the block. Per 64-key block: S = Q K^T and O += P V
// with mma.sync m16n8k16; m, l and O stay in f32 registers.
//
// HOP = true is one ring-attention hop (the JAX _block_update of
// core/ring_attention.py from the zero state): the batch is R ranks x
// rank_batch rows, rank r = b / rank_batch holds queries at global rows
// r * Sq + i and, at hop `hop`, the keys of rank (r - hop) mod R at
// global columns ((r - hop) mod R) * Skv + j. The causal / window skip and
// the element mask are taken at those global positions, so a rank whose
// block lies wholly in the future exits at once. It writes the f32
// unnormalized O, the row max m (-1e30 where no key is visible) and the
// row sum l, never dividing; the caller merges hops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mm_tile.cuh"  // mma_bf16_16816, mt_ld32

namespace {

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 128

template <int D>
struct FaSmem {
  static constexpr int QS = D + 8;        // q / k row stride (bf16)
  static constexpr int VS = FA_BK + 8;    // transposed v row stride
  static constexpr int Q_ELEMS = FA_BQ * QS;
  static constexpr int K_ELEMS = FA_BK * QS;
  // v^T as [d][key], 8 elements of padding after every 8 rows of d
  static constexpr int V_ELEMS = D * VS + (D / 8) * 8;
  static constexpr int BYTES = (Q_ELEMS + K_ELEMS + V_ELEMS) * 2;
  __device__ static int vidx(int d, int key) {
    return d * VS + (d >> 3) * 8 + key;
  }
};

__device__ __forceinline__ uint32_t fa_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Load rows [r0, r0 + 64) of a (S x D) head slab with row stride `rs` into
// shared memory as [row][d] (stride D + 8), zero past row S.
template <int D>
__device__ __forceinline__ void fa_load_rows(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long rs, int r0, int S) {
  for (int c = threadIdx.x; c < 64 * (D / 8); c += FA_THREADS) {
    const int row = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < S)
      v = *reinterpret_cast<const uint4*>(src + (long)(r0 + row) * rs + col);
    *reinterpret_cast<uint4*>(dst + row * (D + 8) + col) = v;
  }
}

// Where the hop's outputs go (HOP only): f32 O (B, Hq, Sq, D), m and l
// (B, Hq, Sq), all contiguous; the rank layout of the batch and the hop.
struct FaHop {
  float* o;
  float* m;
  float* l;
  int rank_batch, n_ranks, hop;
};

template <int D, bool HOP>
__global__ void __launch_bounds__(FA_THREADS)
    pk_flash_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, FaHop hp, int Hq, int Hkv,
                    int Sq, int Skv, long sqb, long sqh, long sqs, long skb,
                    long skh, long sks, long svb, long svh, long svs,
                    int causal, int window, float scale) {
  using SM = FaSmem<D>;
  extern __shared__ __align__(16) unsigned char fa_smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem_raw);
  __nv_bfloat16* Ks = Qs + SM::Q_ELEMS;
  __nv_bfloat16* Vt = Ks + SM::K_ELEMS;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);  // GQA: read the KV head in place
  const int q_lo = blockIdx.x * FA_BQ;
  // global positions of this rank's rows and of the held key block
  int q_off = 0, kv_off = 0;
  if (HOP) {
    const int r = b / hp.rank_batch;
    q_off = r * Sq;
    kv_off = ((r - hp.hop) % hp.n_ranks + hp.n_ranks) % hp.n_ranks * Skv;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qh = q + b * sqb + h * sqh;
  const __nv_bfloat16* kh = k + b * skb + hk * skh;
  const __nv_bfloat16* vh = v + b * svb + hk * svh;

  fa_load_rows<D>(Qs, qh, sqs, q_lo, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = warp * 16 + g, c = kk * 16 + t4 * 2;
    qf[kk][0] = mt_ld32(&Qs[r * SM::QS + c]);
    qf[kk][1] = mt_ld32(&Qs[(r + 8) * SM::QS + c]);
    qf[kk][2] = mt_ld32(&Qs[r * SM::QS + c + 8]);
    qf[kk][3] = mt_ld32(&Qs[(r + 8) * SM::QS + c + 8]);
  }

  const int row_a = q_lo + warp * 16 + g, row_b = row_a + 8;
  // each row's visible global key columns [lo, hi]: the ragged key edge,
  // the causal bound, the window (keys > row - window)
  const int last = kv_off + Skv - 1;
  const int hi_a = causal ? min(q_off + row_a, last) : last;
  const int hi_b = causal ? min(q_off + row_b, last) : last;
  const int lo_a = window > 0 ? q_off + row_a - window + 1 : INT_MIN;
  const int lo_b = window > 0 ? q_off + row_b - window + 1 : INT_MIN;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  const int n_kb = (Skv + FA_BK - 1) / FA_BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_lo = kb * FA_BK;
    // block-level schedule of flash_attention.py:37-41, at global
    // positions: skip blocks with no visible entry for any row of this
    // query block
    const int gk = kv_off + k_lo, gq = q_off + q_lo;
    if (causal && gk > gq + FA_BQ - 1) break;
    if (window > 0 && !(gk + FA_BK - 1 > gq - window)) continue;

    __syncthreads();  // the previous block's K / V^T reads are done
    fa_load_rows<D>(Ks, kh, sks, k_lo, Skv);
    for (int c = threadIdx.x; c < FA_BK * (D / 8); c += FA_THREADS) {
      const int key = c / (D / 8), d0 = (c % (D / 8)) * 8;
      alignas(16) __nv_bfloat16 t[8];
      *reinterpret_cast<uint4*>(t) = make_uint4(0u, 0u, 0u, 0u);
      if (k_lo + key < Skv)
        *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(
            vh + (long)(k_lo + key) * svs + d0);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[SM::vidx(d0 + e, key)] = t[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[FA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * SM::QS + kk * 16 + t4 * 2];
        mma_bf16_16816(s[j], qf[kk], mt_ld32(kr), mt_ld32(kr + 8));
      }
    }

    // scale, mask, row maxima (each row is spread over a quad of lanes)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv_off + k_lo + j * 8 + t4 * 2 + (e & 1);
        const bool keep = e < 2 ? (col >= lo_a) & (col <= hi_a)
                                : (col >= lo_b) & (col <= hi_b);
        const float x = keep ? s[j][e] * scale : -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with nothing visible yet keeps m = -inf: exponentiate against 0
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = __expf(m_a - base_a), alpha_b = __expf(m_b - base_b);
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
      s[j][0] = __expf(s[j][0] - base_a);
      s[j][1] = __expf(s[j][1] - base_a);
      s[j][2] = __expf(s[j][2] - base_b);
      s[j][3] = __expf(s[j][3] - base_b);
      ps_a += s[j][0] + s[j][1];
      ps_b += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ps_a += __shfl_xor_sync(0xffffffffu, ps_a, off);
      ps_b += __shfl_xor_sync(0xffffffffu, ps_b, off);
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= alpha_a;
      oacc[j][1] *= alpha_a;
      oacc[j][2] *= alpha_b;
      oacc[j][3] *= alpha_b;
    }

    // O += P V: the S accumulator of two n8 tiles is the A fragment of
    // one k16 step (P rounded to bf16, as the Pallas kernel rounds it)
#pragma unroll
    for (int kc = 0; kc < FA_BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = fa_pack(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = fa_pack(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = fa_pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = fa_pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + g, key = kc * 16 + t4 * 2;
        mma_bf16_16816(oacc[j], pa, mt_ld32(&Vt[SM::vidx(d, key)]),
                       mt_ld32(&Vt[SM::vidx(d, key + 8)]));
      }
    }
  }

  if (HOP) {  // unnormalized O, row max and row sum, for the merge
    float* oh = hp.o + ((long)bh * Sq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (row_a < Sq)
        *reinterpret_cast<float2*>(oh + (long)row_a * D + col) =
            make_float2(oacc[j][0], oacc[j][1]);
      if (row_b < Sq)
        *reinterpret_cast<float2*>(oh + (long)row_b * D + col) =
            make_float2(oacc[j][2], oacc[j][3]);
    }
    if (t4 == 0) {  // the quad's four lanes hold the same m and l
      const long rb = (long)bh * Sq;
      if (row_a < Sq) {
        hp.m[rb + row_a] = m_a == -INFINITY ? -1e30f : m_a;
        hp.l[rb + row_a] = l_a;
      }
      if (row_b < Sq) {
        hp.m[rb + row_b] = m_b == -INFINITY ? -1e30f : m_b;
        hp.l[rb + row_b] = l_b;
      }
    }
    return;
  }
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  __nv_bfloat16* oh = o + ((long)bh * Sq) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (long)row_a * D + col) =
          __floats2bfloat162_rn(oacc[j][0] * inv_a, oacc[j][1] * inv_a);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (long)row_b * D + col) =
          __floats2bfloat162_rn(oacc[j][2] * inv_b, oacc[j][3] * inv_b);
  }
}

template <int D, bool HOP>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     FaHop hp, int B, int Hq, int Hkv, int Sq, int Skv,
                     const long long* st, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int bytes = FaSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      pk_flash_kernel<D, HOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * Hq);
  pk_flash_kernel<D, HOP><<<grid, FA_THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, hp, Hq, Hkv, Sq, Skv,
      (long)st[0], (long)st[1], (long)st[2], (long)st[3], (long)st[4],
      (long)st[5], (long)st[6], (long)st[7], (long)st[8], causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <bool HOP>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o,
                       FaHop hp, int B, int Hq, int Hkv, int Sq, int Skv,
                       int D, const long long* st, int causal, int window,
                       float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return fa_launch<64, HOP>(q, k, v, o, hp, B, Hq, Hkv, Sq, Skv, st,
                              causal, window, scale, (cudaStream_t)stream);
  if (D == 128)
    return fa_launch<128, HOP>(q, k, v, o, hp, B, Hq, Hkv, Sq, Skv, st,
                               causal, window, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pk_mm_tile_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, int window,
    float scale, void* stream) {
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const FaHop none{nullptr, nullptr, nullptr, 1, 1, 0};
  return fa_dispatch<false>(q, k, v, o, none, B, Hq, Hkv, Sq, Skv, D, st,
                            causal, window, scale, stream);
}

// One ring-attention hop over B = n_ranks x rank_batch rows (see the top):
// o (B, Hq, Sq, D), m and l (B, Hq, Sq), f32, contiguous.
extern "C" int pk_mm_tile_flash_attention_hop_bf16(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh,
    long long sks, long long svb, long long svh, long long svs,
    int n_ranks, int hop, int causal, int window, float scale,
    void* stream) {
  if (n_ranks < 1 || B % n_ranks != 0) return (int)cudaErrorInvalidValue;
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const FaHop hp{(float*)o, (float*)m, (float*)l, B / n_ranks, n_ranks, hop};
  return fa_dispatch<true>(q, k, v, nullptr, hp, B, Hq, Hkv, Sq, Skv, D, st,
                           causal, window, scale, stream);
}
