// The selective-scan kernel that mamba_scan ran on before its staged,
// pipelined design (csrc/mamba_scan.cu), kept as a timing yardstick: no
// wrapper of the port calls it; chip_smoke.py and scripts/scan_rs_probe.py
// time it beside the kernel that replaced it (the ``ms_mm_tile`` column).
//
// Mamba-1 selective scan, no D skip: for every (batch, channel d, state n)
//   h = exp(dt_t[d] * a[d, n]) * h + (dt_t[d] * x_t[d]) * b_t[n]
//   y_t[d] = sum_n h[n] * c_t[n]
// One thread per (channel, state): N lanes (a power of two <= 32) hold one
// channel's N states in registers for the whole sequence, and y_t is their
// sum by an xor butterfly of warp shuffles inside the N-lane group. A block
// of 256 threads covers 256 / N channels of one batch row (grid: channel
// blocks x B). The sequence runs through the block in runs of `run` steps:
// dt and x for the block's channels and b, c for the row are staged, as
// f32, through shared memory, the run is scanned from shared memory, and y
// is staged back and written coalesced; no load overlaps the scan. The
// state is addressed through strides (the stacked per-rank layout (R, B,
// D/R, N) in place).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MS_THREADS = 256;
constexpr int MS_MAX_RUN = 128;
constexpr int MS_SMEM_LIMIT = 48 * 1024;   // static-launch shared memory

struct MtArgs {
  const void* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* a;      // (D, N) contiguous
  const float* h0;
  float* y;            // (B, S, D) contiguous
  float* h_out;
  int S, D, N, run, dl;
  long sdb, sds, sxb, sxs, sbb, sbs, scb, scs;   // (batch, step) strides
  long h0r, h0b, hor, hob;                       // state (rank, batch)
};

__device__ __forceinline__ float mt_ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float mt_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// dt is f32; x, b and c are all T (f32 or bf16)
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
    mm_tile_mamba_scan_kernel(const MtArgs p) {
  extern __shared__ float smem[];
  const int N = p.N, D = p.D, S = p.S, run = p.run;
  const int cpb = MS_THREADS / N;            // channels per block
  float* s_dt = smem;                        // [run][cpb]
  float* s_x = s_dt + run * cpb;             // [run][cpb]
  float* s_y = s_x + run * cpb;              // [run][cpb]
  float* s_b = s_y + run * cpb;              // [run][N]
  float* s_c = s_b + run * N;                // [run][N]
  const float* dt = static_cast<const float*>(p.dt);
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);

  const int tid = threadIdx.x;
  const int ch = tid / N, n = tid - ch * N;
  const long bi = blockIdx.y;
  const int d0 = blockIdx.x * cpb;
  const int d = d0 + ch;
  const bool live = d < D;
  long h0_off = 0, ho_off = 0;
  float av = 0.f, h = 0.f;
  if (live) {
    const int r = d / p.dl, j = d - r * p.dl;
    h0_off = r * p.h0r + bi * p.h0b + (long)j * N + n;
    ho_off = r * p.hor + bi * p.hob + (long)j * N + n;
    av = p.a[(long)d * N + n];
    h = p.h0[h0_off];
  }
  // lanes of a dead channel (the ragged last block) still run the loop:
  // the shuffles need every lane of the warp
  for (int t0 = 0; t0 < S; t0 += run) {
    const int len = min(run, S - t0);
    __syncthreads();                         // the last run's y is stored
    for (int e = tid; e < len * cpb; e += MS_THREADS) {
      const int t = e / cpb, dd = d0 + (e - t * cpb);
      float vd = 0.f, vx = 0.f;
      if (dd < D) {
        vd = mt_ld(dt + bi * p.sdb + (long)(t0 + t) * p.sds + dd);
        vx = mt_ld(x + bi * p.sxb + (long)(t0 + t) * p.sxs + dd);
      }
      s_dt[e] = vd;
      s_x[e] = vx;
    }
    for (int e = tid; e < len * N; e += MS_THREADS) {
      const int t = e / N, nn = e - t * N;
      s_b[e] = mt_ld(bm + bi * p.sbb + (long)(t0 + t) * p.sbs + nn);
      s_c[e] = mt_ld(cm + bi * p.scb + (long)(t0 + t) * p.scs + nn);
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float dtv = s_dt[t * cpb + ch];
      const float abar = expf(__fmul_rn(dtv, av));
      const float bx = __fmul_rn(__fmul_rn(dtv, s_x[t * cpb + ch]),
                                 s_b[t * N + n]);
      h = __fmaf_rn(abar, h, bx);
      float yv = __fmul_rn(h, s_c[t * N + n]);
      for (int off = N >> 1; off > 0; off >>= 1)
        yv = __fadd_rn(yv, __shfl_xor_sync(0xffffffffu, yv, off, N));
      if (n == 0) s_y[t * cpb + ch] = yv;
    }
    __syncthreads();
    for (int e = tid; e < len * cpb; e += MS_THREADS) {
      const int t = e / cpb, dd = d0 + (e - t * cpb);
      if (dd < D) p.y[(bi * S + t0 + t) * (long)D + dd] = s_y[e];
    }
  }
  if (live) p.h_out[ho_off] = h;
}

template <typename T>
cudaError_t mt_launch(const MtArgs& p, int B, cudaStream_t stream) {
  const int cpb = MS_THREADS / p.N;
  const size_t smem = (size_t)p.run * (3 * cpb + 2 * p.N) * sizeof(float);
  dim3 grid((p.D + cpb - 1) / cpb, B);
  mm_tile_mamba_scan_kernel<T><<<grid, MS_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dt is f32; x, b and c are bf16 when x_bf16 is 1, f32 when 0. Strides in
// elements; the last dim of dt, x, b, c and the state is contiguous. The
// state of channel d = r * dl + j sits at r * h0r + batch * h0b + j * N.
// `chunk` is the run of steps staged through shared memory at once (capped
// at 128 and by 48 KB of shared memory); it never changes the result.
// The arguments of the old pk_mamba_scan.
extern "C" int pk_mm_tile_mamba_scan(
    const void* dt, const void* x, const void* b, const void* c,
    const void* a, const void* h0, void* y, void* h_out, int B, int S, int D,
    int N, int chunk, int x_bf16, long long sdb, long long sds,
    long long sxb, long long sxs, long long sbb, long long sbs,
    long long scb, long long scs, int dl, long long h0r, long long h0b,
    long long hor, long long hob, void* stream) {
  if (N < 1 || N > 32 || (N & (N - 1)) || dl < 1 || D % dl || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int cpb = MS_THREADS / N;
  const int per_step = (3 * cpb + 2 * N) * (int)sizeof(float);
  int run = chunk < MS_MAX_RUN ? chunk : MS_MAX_RUN;
  if (run > MS_SMEM_LIMIT / per_step) run = MS_SMEM_LIMIT / per_step;
  if (S > 0 && run > S) run = S;
  MtArgs p{dt, x, b, c, (const float*)a, (const float*)h0, (float*)y,
           (float*)h_out, S, D, N, run, dl, (long)sdb, (long)sds,
           (long)sxb, (long)sxs, (long)sbb, (long)sbs, (long)scb,
           (long)scs, (long)h0r, (long)h0b, (long)hor, (long)hob};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(x_bf16 ? mt_launch<__nv_bfloat16>(p, B, s)
                      : mt_launch<float>(p, B, s));
}
