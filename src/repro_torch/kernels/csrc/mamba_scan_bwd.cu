// Backward of the Mamba-1 selective scan (csrc/mamba_scan.cu's forward,
// no D skip): for every (batch, channel d, state n), with
//   h_t = abar_t * h_{t-1} + (dt_t x_t) b_t,  abar_t = exp(dt_t a),
//   y_t = sum_n h_t c_t,
// and the cotangent dy (B, S, D) f32, the reverse recurrence
//   g_t = dy_t c_t + abar_{t+1} g_{t+1}   (g_S = 0)
// gives
//   dx_t  = dt_t sum_n g_t b_t
//   ddt_t = x_t sum_n g_t b_t + sum_n g_t a abar_t h_{t-1}
//   db_t  = sum_d g_t dt_t x_t,   dc_t = sum_d dy_t h_t
//   da    = sum_{b,t} g_t dt_t abar_t h_{t-1}.
// The Pallas package has no counterpart: JAX differentiates its XLA
// associative scan. See kernels/mamba_scan.py for the design note.
//
// A lane holds K = min(4, N) states of one channel in registers, L = N / K
// lanes make a channel, and a block of 256 lanes covers CH = 256 / L
// channels of one batch row (grid: channel tiles x B), as the forward
// kernel lays them out. The sequence runs in segments of `seg` steps. For
// each segment the block first stages dt, x, dy (seg x CH) and b, c (seg x
// N) in shared memory, widened to f32, with coalesced loads, so the steps
// read shared memory only.
//
// 1. Forward, segment by segment: the recurrence from h0, the state at
//    each segment's start stored (ckpt, (B, S/seg, D, N) f32).
// 2. Backward, last segment first: re-run the segment's forward from its
//    stored start, keeping every h_{t-1} (and the segment's last h) in
//    shared memory; walk it backward with g in registers, keeping every
//    g_t in shared memory. The sums over n (dx, ddt) are each lane's K
//    terms in order, then an xor butterfly over the channel's L lanes; da
//    gathers in registers over t. After the walk the block sums db and dc
//    over its CH channels in channel order, one (step, state) a thread,
//    from the stored g and h, into one partial a block (B, S, D-tiles,
//    N), and writes the segment's dx and ddt rows coalesced.
// 3. A second kernel sums the partials in index order: db and dc over the
//    channel tiles, da over the batch rows (one partial a row).
//
// No float atomics: every sum has one order, fixed by N alone, so the
// result is the same bits run to run and for every `seg` (the states are
// the one sequential recurrence whatever the segments). The exponential
// is ex2.approx.ftz of dt * (a scaled by log2(e)), as in the forward
// kernel; every operation is rounded explicitly (__fmul_rn, __fmaf_rn,
// __fadd_rn).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SB_THREADS = 256;
constexpr int SB_SEG_MAX = 8;
// pad of a row of per-thread states in shared memory: the channel sums
// read two steps' rows a warp, 16 banks apart
constexpr int SB_PAD = 16;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int k_states(int n) { return n < 4 ? n : 4; }

struct SbArgs {
  const float* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* a;   // (D, N) contiguous
  const float* h0;  // (B, D, N) contiguous
  const float* dy;
  float* ckpt;      // (B, nseg, D, N)
  float* ddt;       // (B, S, D) contiguous
  void* dx;         // (B, S, D) contiguous, x's type
  float* part_db;   // (B, S, nblk, N)
  float* part_dc;   // (B, S, nblk, N)
  float* part_da;   // (B, D, N)
  int S, D, seg, nseg, nblk;
  long sdb, sds, sxb, sxs, sbb, sbs, scb, scs, syb, sys;  // (batch, step)
};

// the shared memory of a block, in floats: h_{t-1} of every step of a
// segment and the segment's last h ((seg + 1) rows), g of every step (seg
// rows), the staged dt, x, dy and the dx, ddt rows (seg x CH each), the
// staged b and c (seg x N each)
__host__ __device__ inline int sb_smem_floats(int n, int seg) {
  const int row = SB_THREADS * k_states(n) + SB_PAD;
  const int ch = SB_THREADS / (n / k_states(n));
  return (2 * seg + 1) * row + 5 * seg * ch + 2 * seg * n;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K consecutive f32 values, aligned to K elements
template <int K>
__device__ __forceinline__ void ld_k(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else if constexpr (K == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x, v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

template <int K>
__device__ __forceinline__ void st_k(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Stage steps [t0, t0 + len) of dt and x (and dy, b or c where given) for
// the block's channels [d0, d0 + CH) in shared memory as f32, zero past D.
template <typename T, int N, int CH>
__device__ __forceinline__ void stage(const SbArgs& p, long bi, int d0,
                                      int t0, int len, float* s_dt,
                                      float* s_x, float* s_dy, float* s_b,
                                      float* s_c) {
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  for (int e = threadIdx.x; e < len * CH; e += SB_THREADS) {
    const int i = e / CH, d = d0 + (e - i * CH);
    const long t = t0 + i;
    float vd = 0.f, vx = 0.f, vy = 0.f;
    if (d < p.D) {
      vd = ld(p.dt + bi * p.sdb + t * p.sds + d);
      vx = ld(x + bi * p.sxb + t * p.sxs + d);
      if (s_dy) vy = ld(p.dy + bi * p.syb + t * p.sys + d);
    }
    s_dt[e] = vd;
    s_x[e] = vx;
    if (s_dy) s_dy[e] = vy;
  }
  for (int e = threadIdx.x; e < len * N; e += SB_THREADS) {
    const int i = e / N, n = e - i * N;
    const long t = t0 + i;
    s_b[e] = ld(bm + bi * p.sbb + t * p.sbs + n);
    if (s_c) s_c[e] = ld(cm + bi * p.scb + t * p.scs + n);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(SB_THREADS)
    pk_scan_bwd_kernel(const SbArgs p) {
  constexpr int K = k_states(N), L = N / K, CH = SB_THREADS / L;
  constexpr int ROW = SB_THREADS * K + SB_PAD;
  extern __shared__ __align__(16) float smem[];
  const int seg = p.seg;
  float* s_h = smem;                     // [seg + 1][ROW]
  float* s_g = s_h + (seg + 1) * ROW;    // [seg][ROW]
  float* s_dt = s_g + seg * ROW;         // [seg][CH]
  float* s_x = s_dt + seg * CH;
  float* s_dy = s_x + seg * CH;
  float* s_ddt = s_dy + seg * CH;
  float* s_dxo = s_ddt + seg * CH;
  float* s_b = s_dxo + seg * CH;         // [seg][N]
  float* s_c = s_b + seg * N;

  const int tid = threadIdx.x;
  const int ch = tid / L, j = tid - ch * L;
  const int blk = blockIdx.x;
  const int d0 = blk * CH;
  const int d = d0 + ch;
  const bool live = d < p.D;
  const long bi = blockIdx.y;
  const int S = p.S, D = p.D;

  float av[K], a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) av[k] = a2[k] = h[k] = 0.f;
  if (live) {
    ld_k<K>(p.a + (long)d * N + j * K, av);
    ld_k<K>(p.h0 + (bi * D + d) * (long)N + j * K, h);
#pragma unroll
    for (int k = 0; k < K; ++k) a2[k] = __fmul_rn(av[k], kLog2e);
  }
  float* ck = p.ckpt + (bi * p.nseg * D + d) * (long)N + j * K;
  const long ck_step = (long)D * N;

  // 1. the forward recurrence, segment by segment; each segment's start
  for (int kseg = 0; kseg < p.nseg; ++kseg) {
    if (live) st_k<K>(ck + kseg * ck_step, h);
    if (kseg == p.nseg - 1) break;
    const int t0 = kseg * seg;
    __syncthreads();  // the last segment's staged values are read
    stage<T, N, CH>(p, bi, d0, t0, seg, s_dt, s_x, nullptr, s_b, nullptr);
    __syncthreads();
    for (int i = 0; i < seg; ++i) {
      const float dtv = s_dt[i * CH + ch];
      const float u = __fmul_rn(dtv, s_x[i * CH + ch]);
      float bv[K];
      ld_k<K>(s_b + i * N + j * K, bv);
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k] = __fmaf_rn(exp2_approx(__fmul_rn(dtv, a2[k])), h[k],
                         __fmul_rn(u, bv[k]));
    }
  }

  // 2. the segments last to first
  float g[K], anext[K], da[K];
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = anext[k] = da[k] = 0.f;
  for (int kseg = p.nseg - 1; kseg >= 0; --kseg) {
    const int t0 = kseg * seg;
    const int len = min(seg, S - t0);
    __syncthreads();  // the last segment's sums have read shared memory
    stage<T, N, CH>(p, bi, d0, t0, len, s_dt, s_x, s_dy, s_b, s_c);
    float hh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) hh[k] = 0.f;
    if (live) ld_k<K>(ck + kseg * ck_step, hh);
    __syncthreads();
    for (int i = 0; i < len; ++i) {  // h_{t-1} of every step
      st_k<K>(s_h + i * ROW + tid * K, hh);
      const float dtv = s_dt[i * CH + ch];
      const float u = __fmul_rn(dtv, s_x[i * CH + ch]);
      float bv[K];
      ld_k<K>(s_b + i * N + j * K, bv);
#pragma unroll
      for (int k = 0; k < K; ++k)
        hh[k] = __fmaf_rn(exp2_approx(__fmul_rn(dtv, a2[k])), hh[k],
                          __fmul_rn(u, bv[k]));
    }
    st_k<K>(s_h + len * ROW + tid * K, hh);  // the segment's last h
    for (int i = len - 1; i >= 0; --i) {
      const float dtv = s_dt[i * CH + ch];
      const float xv = s_x[i * CH + ch];
      const float dyv = s_dy[i * CH + ch];
      float bv[K], cv[K], hp[K];
      ld_k<K>(s_b + i * N + j * K, bv);
      ld_k<K>(s_c + i * N + j * K, cv);
      ld_k<K>(s_h + i * ROW + tid * K, hp);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float abar = exp2_approx(__fmul_rn(dtv, a2[k]));
        g[k] = __fmaf_rn(anext[k], g[k], __fmul_rn(dyv, cv[k]));
        anext[k] = abar;
        const float gh = __fmul_rn(g[k], hp[k]);
        s1 = __fadd_rn(s1, __fmul_rn(g[k], bv[k]));
        s2 = __fadd_rn(s2, __fmul_rn(__fmul_rn(gh, av[k]), abar));
        da[k] = __fadd_rn(da[k], __fmul_rn(__fmul_rn(gh, dtv), abar));
      }
      st_k<K>(s_g + i * ROW + tid * K, g);
#pragma unroll
      for (int off = L >> 1; off > 0; off >>= 1) {
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off, L));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, off, L));
      }
      if (j == 0) {
        s_ddt[i * CH + ch] = __fadd_rn(__fmul_rn(xv, s1), s2);
        s_dxo[i * CH + ch] = __fmul_rn(dtv, s1);
      }
    }
    __syncthreads();
    // db, dc of each (step, state): the block's channels in order
    for (int e = tid; e < len * N; e += SB_THREADS) {
      const int i = e / N, n = e - i * N;
      const float* gi = s_g + i * ROW + n;
      const float* hi = s_h + (i + 1) * ROW + n;
      float sb = 0.f, sc = 0.f;
      for (int c = 0; c < CH; ++c) {
        const float u = __fmul_rn(s_dt[i * CH + c], s_x[i * CH + c]);
        sb = __fadd_rn(sb, __fmul_rn(gi[c * N], u));
        sc = __fadd_rn(sc, __fmul_rn(s_dy[i * CH + c], hi[c * N]));
      }
      const long o = ((bi * S + t0 + i) * p.nblk + blk) * (long)N + n;
      p.part_db[o] = sb;
      p.part_dc[o] = sc;
    }
    for (int e = tid; e < len * CH; e += SB_THREADS) {
      const int i = e / CH, dd = d0 + (e - i * CH);
      if (dd < D) {
        const long o = (bi * S + t0 + i) * (long)D + dd;
        p.ddt[o] = s_ddt[e];
        st(static_cast<T*>(p.dx) + o, s_dxo[e]);
      }
    }
  }
  if (live) st_k<K>(p.part_da + (bi * D + d) * (long)N + j * K, da);
}

// out[i, q] = sum_m in[i, m, q] in order of m, for i < P, q < Q
template <typename T>
__global__ void pk_sum_mid_kernel(const float* in, T* out, long P, int M,
                                  long Q) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= P * Q) return;
  const long i = e / Q, q = e - i * Q;
  const float* src = in + i * M * Q + q;
  float s = 0.f;
  for (int m = 0; m < M; ++m) s = __fadd_rn(s, src[m * Q]);
  st(out + e, s);
}

template <typename T>
cudaError_t sum_mid(const float* in, void* out, long P, int M, long Q,
                    cudaStream_t stream) {
  const long total = P * Q;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  pk_sum_mid_kernel<T><<<(unsigned)((total + threads - 1) / threads),
                         threads, 0, stream>>>(in, static_cast<T*>(out), P,
                                               M, Q);
  return cudaGetLastError();
}

template <typename T, int N>
int sb_launch(const SbArgs& p, int B, void* db, void* dc, float* da,
              int smem_bytes, cudaStream_t stream) {
  constexpr int CH = SB_THREADS / (N / k_states(N));
  const int smem = sb_smem_floats(N, p.seg) * (int)sizeof(float);
  if (p.nblk != (p.D + CH - 1) / CH || smem != smem_bytes)
    return (int)cudaErrorInvalidValue;
  static int granted = 0;  // the attribute this instantiation was given
  if (smem > 48 * 1024 && smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        pk_scan_bwd_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const dim3 grid(p.nblk, B);
  pk_scan_bwd_kernel<T, N><<<grid, SB_THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = sum_mid<T>(p.part_db, db, (long)B * p.S, p.nblk, N, stream);
  if (err == cudaSuccess)
    err = sum_mid<T>(p.part_dc, dc, (long)B * p.S, p.nblk, N, stream);
  if (err == cudaSuccess)
    err = sum_mid<float>(p.part_da, da, 1, B, (long)p.D * N, stream);
  return (int)err;
}

template <typename T>
int sb_dispatch(const SbArgs& p, int B, int N, void* db, void* dc, float* da,
                int smem, cudaStream_t s) {
  switch (N) {
    case 1: return sb_launch<T, 1>(p, B, db, dc, da, smem, s);
    case 2: return sb_launch<T, 2>(p, B, db, dc, da, smem, s);
    case 4: return sb_launch<T, 4>(p, B, db, dc, da, smem, s);
    case 8: return sb_launch<T, 8>(p, B, db, dc, da, smem, s);
    case 16: return sb_launch<T, 16>(p, B, db, dc, da, smem, s);
    case 32: return sb_launch<T, 32>(p, B, db, dc, da, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dt and dy are f32; x, b and c are bf16 when x_bf16 is 1, f32 when 0, and
// dx, db and dc take x's type; ddt and da are f32. Strides in elements
// (batch, step) for dt, x, b, c and dy, whose last dim is contiguous; h0
// (B, D, N), ddt and dx (B, S, D), db and dc (B, S, N) and da (D, N) are
// contiguous. Scratch: ckpt (B, ceil(S / seg), D, N), part_db and part_dc
// (B, S, nblk, N) with nblk = ceil(D / CH), CH = 256 / (N / min(4, N))
// channels a block, part_da (B, D, N), all f32. seg (1..8) is the
// segment a block stages and re-runs; it never changes the result.
// smem_bytes is the plan's shared memory a block: a launch whose layout
// differs is refused. One scan kernel, then three launches of the in-order
// sum.
extern "C" int pk_mamba_scan_bwd(
    const void* dt, const void* x, const void* b, const void* c,
    const void* a, const void* h0, const void* dy, void* ckpt, void* ddt,
    void* dx, void* db, void* dc, void* da, void* part_db, void* part_dc,
    void* part_da, int B, int S, int D, int N, int x_bf16, int seg,
    int smem_bytes, long long sdb, long long sds, long long sxb,
    long long sxs, long long sbb, long long sbs, long long scb,
    long long scs, long long syb, long long sys, void* stream) {
  if (N < 1 || N > 32 || (N & (N - 1)) || seg < 1 || seg > SB_SEG_MAX ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const int nseg = (S + seg - 1) / seg;
  const int ch = SB_THREADS / (N / k_states(N));
  const int nblk = (D + ch - 1) / ch;
  SbArgs p{(const float*)dt, x, b, c, (const float*)a, (const float*)h0,
           (const float*)dy, (float*)ckpt, (float*)ddt, dx,
           (float*)part_db, (float*)part_dc, (float*)part_da, S, D, seg,
           nseg, nblk, (long)sdb, (long)sds, (long)sxb, (long)sxs,
           (long)sbb, (long)sbs, (long)scb, (long)scs, (long)syb,
           (long)sys};
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? sb_dispatch<__nv_bfloat16>(p, B, N, db, dc, (float*)da,
                                             smem_bytes, s)
                : sb_dispatch<float>(p, B, N, db, dc, (float*)da,
                                     smem_bytes, s);
}
