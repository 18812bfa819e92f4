// Mamba-1 selective scan, no D skip: for every (batch, channel d, state n)
//   h = exp(dt_t[d] * a[d, n]) * h + (dt_t[d] * x_t[d]) * b_t[n]
//   y_t[d] = sum_n h[n] * c_t[n]
// from h0 over t = 0..S-1; y (B, S, D) f32 and the last state (B, D, N) f32.
// Port of repro/kernels/mamba_scan.py::mamba_scan; see
// kernels/mamba_scan.py for the design note.
//
// The recurrence stays sequential in t for every state. A lane holds K =
// min(4, N) states of one channel in registers (K independent FMA chains),
// L = N / K lanes make a channel, and y_t is the lane's K products summed
// in order then an xor butterfly of log2 L shuffles, so every lane of the
// channel ends with the same bits. A block covers `ch` channels (64 or 128,
// the plan's) of one batch row: grid (channel tiles, B).
//
// Two kernels run that same step (scan_step), so they give the same bits:
//
// * staged (prefill): a producer warp's elected thread loads, for each run
//   of `run` steps, the tiles dt [run x ch], x [run x ch], b and c [run x
//   N] by TMA (3-D maps over (inner, step, batch), zero-filled past S and
//   D) into a ring of `stages` shared-memory stages with full and empty
//   mbarriers, so the next run loads while this one is scanned. The
//   consumer lanes scan the stage, write y_t into a double-buffered [run x
//   ch] tile and free the stage; then they wait for the next run's stage,
//   widen its bf16 b and c to f32 together (every channel reads each value,
//   so each lane widening its own would cost 8 of a step's ~40
//   instructions), meet at one named barrier and store the y tile's rows
//   as 16-byte words.
// * direct (decode, S = 1, or operands a tensor map cannot take): no
//   staging and no block barrier; each lane reads its dt, x, b, c, a and
//   state from global memory, steps and writes y and the state.
//
// The exponential is ex2.approx.ftz of dt * (a scaled by log2(e) once):
// one FMUL and one MUFU.EX2 a state a step, where the accurate expf took
// eight instructions (16 MUFU an SM a clock is the floor PERF.md records);
// against the f32 plain version the error stays near 1e-7 at the path's
// shapes.
//
// Every operation is rounded explicitly (__fmul_rn, __fmaf_rn, __fadd_rn:
// no contraction left to the compiler) and y's sum over n has one order, so
// a channel runs the same operations in the same order whatever the run
// length, the stage boundaries or the kernel: a scan over S + k steps
// equals a scan over S steps followed by k scans of one step chained
// through h0, bit for bit. The state is addressed through strides, so the
// stacked per-rank layout of the serving cache, (R, B, D/R, N), is read
// and written in place: channel d lives at rank d / dl, local channel d %
// dl.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int SC_MAX_CONSUMERS = 512;
constexpr int SC_MAX_STAGES = 4;
constexpr int SC_SMEM_LIMIT = 232448;

struct ScArgs {
  const void* dt;
  const void* x;
  const void* b;
  const void* c;
  const float* a;  // (D, N) contiguous
  const float* h0;
  float* y;        // (B, S, D) contiguous
  float* h_out;
  int S, D, dl, ch, run, stages;
  long sdb, sds, sxb, sxs, sbb, sbs, scb, scs;  // (batch, step) strides
  long h0r, h0b, hor, hob;                      // state (rank, batch)
};

__host__ __device__ constexpr int k_states(int n) { return n < 4 ? n : 4; }

__host__ __device__ inline int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// the staged kernel's shared memory: `stages` stages of dt, x, b, c tiles,
// then the two y tiles, then (bf16 inputs) two runs of b and c widened to
// f32, then the mbarriers
struct ScLayout {
  int o_x, o_b, o_c, stage, o_y, o_bc, o_bars, total;
  __host__ __device__ ScLayout(int ch, int run, int n, int es, int stages) {
    o_x = align128(run * ch * 4);
    o_b = o_x + align128(run * ch * es);
    o_c = o_b + align128(run * n * es);
    stage = o_c + align128(run * n * es);
    o_y = stages * stage;
    o_bc = o_y + 2 * run * ch * 4;
    o_bars = o_bc + (es == 2 ? 2 * 2 * run * n * 4 : 0);
    total = o_bars + 2 * stages * 8;
  }
};

__device__ __forceinline__ float ld_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K consecutive f32 values from shared memory, aligned to K elements
template <int K>
__device__ __forceinline__ void lds_k(const float* p, float (&v)[K]) {
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

// exp(v) as ex2.approx.ftz of v * log2(e); a is scaled by log2(e) once,
// when a lane loads it
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One step of the K states of one channel that this lane holds; returns
// the channel's y_t, the same bits in each of its L = N / K lanes.
template <int N>
__device__ __forceinline__ float scan_step(float (&h)[k_states(N)],
                                           const float (&av)[k_states(N)],
                                           float dtv, float xv,
                                           const float (&bv)[k_states(N)],
                                           const float (&cv)[k_states(N)]) {
  constexpr int K = k_states(N), L = N / K;
  const float dtx = __fmul_rn(dtv, xv);
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float abar = exp2_approx(__fmul_rn(dtv, av[j]));
    h[j] = __fmaf_rn(abar, h[j], __fmul_rn(dtx, bv[j]));
    y = j == 0 ? __fmul_rn(h[j], cv[j]) : __fmaf_rn(h[j], cv[j], y);
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1)
    y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, off, L));
  return y;
}

// The lane's channel, first state, state offsets, a and h0.
template <int N>
struct ScLane {
  static constexpr int K = k_states(N), L = N / K;
  int ch, n0, d;
  bool live;
  long ho;
  float h[K], av[K];
  __device__ __forceinline__ ScLane(const ScArgs& p, int tid, long bi) {
    ch = tid / L;
    n0 = (tid - ch * L) * K;
    d = blockIdx.x * p.ch + ch;
    live = d < p.D;
    ho = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = av[j] = 0.f;
    if (live) {
      const int r = d / p.dl, jj = d - r * p.dl;
      const long h0_off = r * p.h0r + bi * p.h0b + (long)jj * N + n0;
      ho = r * p.hor + bi * p.hob + (long)jj * N + n0;
      const float* a = p.a + (long)d * N + n0;
      if (K == 4 && aligned16(a) && aligned16(p.h0 + h0_off)) {
        const float4 va = __ldg(reinterpret_cast<const float4*>(a));
        const float4 vh = *reinterpret_cast<const float4*>(p.h0 + h0_off);
        av[0] = va.x, av[1 % K] = va.y, av[2 % K] = va.z, av[3 % K] = va.w;
        h[0] = vh.x, h[1 % K] = vh.y, h[2 % K] = vh.z, h[3 % K] = vh.w;
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          av[j] = __ldg(a + j);
          h[j] = p.h0[h0_off + j];
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) av[j] = __fmul_rn(av[j], kLog2e);
    }
  }
  __device__ __forceinline__ void store_state(const ScArgs& p) const {
    if (!live) return;
    if (K == 4 && aligned16(p.h_out + ho)) {
      *reinterpret_cast<float4*>(p.h_out + ho) =
          make_float4(h[0], h[1 % K], h[2 % K], h[3 % K]);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) p.h_out[ho + j] = h[j];
    }
  }
  static __device__ __forceinline__ bool aligned16(const float* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  }
};

// dt is f32; x, b and c are all T (f32 or bf16)
template <typename T, int N>
__global__ void __launch_bounds__(SC_MAX_CONSUMERS)
    pk_scan_direct_kernel(const ScArgs p) {
  constexpr int K = k_states(N);
  const long bi = blockIdx.y;
  ScLane<N> ln(p, threadIdx.x, bi);
  const float* dt = static_cast<const float*>(p.dt) + bi * p.sdb;
  const T* x = static_cast<const T*>(p.x) + bi * p.sxb;
  const T* bm = static_cast<const T*>(p.b) + bi * p.sbb + ln.n0;
  const T* cm = static_cast<const T*>(p.c) + bi * p.scb + ln.n0;
  // lanes of a dead channel (the ragged last tile) still step: the
  // shuffles need every lane of the warp
  for (int t = 0; t < p.S; ++t) {
    float dtv = 0.f, xv = 0.f, bv[K], cv[K];
    if (ln.live) {
      dtv = ld_f32(dt + t * p.sds + ln.d);
      xv = ld_f32(x + t * p.sxs + ln.d);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bv[j] = ld_f32(bm + t * p.sbs + j);
      cv[j] = ld_f32(cm + t * p.scs + j);
    }
    const float yv = scan_step<N>(ln.h, ln.av, dtv, xv, bv, cv);
    if (ln.live && ln.n0 == 0) p.y[(bi * p.S + t) * (long)p.D + ln.d] = yv;
  }
  ln.store_state(p);
}

template <typename T, int N>
__global__ void __launch_bounds__(SC_MAX_CONSUMERS + 32)
    pk_scan_staged_kernel(const __grid_constant__ ScArgs p,
                       const __grid_constant__ CUtensorMap m_dt,
                       const __grid_constant__ CUtensorMap m_x,
                       const __grid_constant__ CUtensorMap m_b,
                       const __grid_constant__ CUtensorMap m_c) {
  constexpr int K = k_states(N), L = N / K;
  extern __shared__ __align__(128) unsigned char smem[];
  const int CH = p.ch, RUN = p.run, consumers = CH * L;
  const ScLayout lay(CH, RUN, N, sizeof(T), p.stages);
  const uint32_t full0 = hg::smem_addr(smem + lay.o_bars);
  const uint32_t empty0 = full0 + 8 * p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long bi = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int n_runs = (p.S + RUN - 1) / RUN;

  if (threadIdx.x >= consumers) {  // the producer warp
    if (threadIdx.x == consumers) {
      const uint32_t bytes =
          RUN * CH * (4 + sizeof(T)) + 2 * RUN * N * sizeof(T);
      for (int j = 0; j < n_runs; ++j) {
        const int stage = j % p.stages;
        const uint32_t full = full0 + 8 * stage;
        hg::mbar_wait(empty0 + 8 * stage, ((j / p.stages) & 1) ^ 1);
        hg::mbar_expect_tx(full, bytes);
        const uint32_t base = hg::smem_addr(smem + stage * lay.stage);
        hg::tma_load3(base, &m_dt, d0, j * RUN, (int)bi, full);
        hg::tma_load3(base + lay.o_x, &m_x, d0, j * RUN, (int)bi, full);
        hg::tma_load3(base + lay.o_b, &m_b, 0, j * RUN, (int)bi, full);
        hg::tma_load3(base + lay.o_c, &m_c, 0, j * RUN, (int)bi, full);
      }
    }
    return;
  }

  ScLane<N> ln(p, threadIdx.x, bi);
  float* const y_tiles = reinterpret_cast<float*>(smem + lay.o_y);
  // b and c of run j in f32: bf16 is widened once a run, by all the
  // consumers together, into widened[j & 1] (b, then c); f32 is read from
  // the stage
  constexpr bool kWiden = sizeof(T) == 2;
  float* const widened = reinterpret_cast<float*>(smem + lay.o_bc);
  auto widen = [&](int j) {
    if constexpr (kWiden) {
      const unsigned char* st = smem + (j % p.stages) * lay.stage;
      const int pairs = RUN * N / 2;
      const __nv_bfloat162* b2 =
          reinterpret_cast<const __nv_bfloat162*>(st + lay.o_b);
      const __nv_bfloat162* c2 =
          reinterpret_cast<const __nv_bfloat162*>(st + lay.o_c);
      float2* w = reinterpret_cast<float2*>(widened + (j & 1) * 2 * RUN * N);
      for (int e = threadIdx.x; e < pairs; e += consumers) {
        w[e] = __bfloat1622float2(b2[e]);
        w[pairs + e] = __bfloat1622float2(c2[e]);
      }
    }
  };
  auto bar_consumers = [consumers] {
    asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
  };
  hg::mbar_wait(full0, 0);
  widen(0);
  bar_consumers();
  for (int j = 0; j < n_runs; ++j) {
    const int stage = j % p.stages;
    const int t0 = j * RUN, len = min(RUN, p.S - t0);
    // run j's stage is full (waited for before the last barrier); this
    // lane's column of its tiles, walked a step at a time
    const unsigned char* st = smem + stage * lay.stage;
    const float* s_dt = reinterpret_cast<const float*>(st) + ln.ch;
    const T* s_x = reinterpret_cast<const T*>(st + lay.o_x) + ln.ch;
    const float* s_b;
    if constexpr (kWiden)
      s_b = widened + (j & 1) * 2 * RUN * N + ln.n0;
    else
      s_b = reinterpret_cast<const float*>(st + lay.o_b) + ln.n0;
    const float* s_c = s_b + (kWiden ? RUN * N : (lay.o_c - lay.o_b) / 4);
    float* yt = y_tiles + (j & 1) * RUN * CH;
    float* s_y = yt + ln.ch;
    for (int t = 0; t < len; ++t) {
      float bv[K], cv[K];
      lds_k<K>(s_b, bv);
      lds_k<K>(s_c, cv);
      const float yv = scan_step<N>(ln.h, ln.av, *s_dt, to_f32(*s_x), bv, cv);
      if (ln.n0 == 0) *s_y = yv;
      s_dt += CH, s_x += CH, s_b += N, s_c += N, s_y += CH;
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hg::mbar_arrive(empty0 + 8 * stage);
    if (j + 1 < n_runs) {
      hg::mbar_wait(full0 + 8 * ((j + 1) % p.stages),
                    ((j + 1) / p.stages) & 1);
      widen(j + 1);
    }
    // run j's y tile and run j + 1's widened b, c are whole once every
    // consumer is here; the tiles written before (y of run j - 1, b and c
    // of run j - 1) are no longer read, as each consumer passed the last
    // barrier after reading them
    bar_consumers();
    const int row4 = CH / 4;
    for (int v = threadIdx.x; v < len * row4; v += consumers) {
      const int t = v / row4, c4 = (v - t * row4) * 4;
      if (d0 + c4 < p.D)
        *reinterpret_cast<float4*>(p.y + (bi * p.S + t0 + t) * (long)p.D +
                                   d0 + c4) =
            *reinterpret_cast<const float4*>(yt + t * CH + c4);
    }
  }
  ln.store_state(p);
}

// A 3-D map over (inner, step, batch) of f32 or bf16 elements, strides in
// elements, boxes of box_inner x run x 1, no swizzle, zero fill.
int encode_scan_map(CUtensorMap* map, const void* ptr, bool bf16, long inner,
                    long steps, long batch, long s_step, long s_batch,
                    int box_inner, int run) {
  hg::EncodeTiledFn fn = hg::encode_fn();
  if (fn == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const long es = bf16 ? 2 : 4;
  // a batch of one is never stepped over: give it a stride TMA takes
  if (batch == 1) s_batch = steps * s_step;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)steps,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(s_step * es),
                                 (cuuint64_t)(s_batch * es)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)run, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <typename T, int N>
int sc_launch(const ScArgs& p, int B, bool staged, int smem_bytes,
              cudaStream_t stream) {
  constexpr int L = N / k_states(N);
  const int consumers = p.ch * L;
  if (consumers % 32 || consumers > SC_MAX_CONSUMERS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.D + p.ch - 1) / p.ch, B);
  if (!staged) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    pk_scan_direct_kernel<T, N><<<grid, consumers, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  const bool bf16 = sizeof(T) == 2;
  const ScLayout lay(p.ch, p.run, N, sizeof(T), p.stages);
  if (p.S < 1 || p.D % 4 || p.run < 1 || p.run > 256 || p.stages < 1 ||
      p.stages > SC_MAX_STAGES || lay.total > SC_SMEM_LIMIT ||
      lay.total != smem_bytes)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_dt, m_x, m_b, m_c;
  int e = encode_scan_map(&m_dt, p.dt, false, p.D, p.S, B, p.sds, p.sdb,
                          p.ch, p.run);
  if (!e) e = encode_scan_map(&m_x, p.x, bf16, p.D, p.S, B, p.sxs, p.sxb,
                              p.ch, p.run);
  if (!e) e = encode_scan_map(&m_b, p.b, bf16, N, p.S, B, p.sbs, p.sbb, N,
                              p.run);
  if (!e) e = encode_scan_map(&m_c, p.c, bf16, N, p.S, B, p.scs, p.scb, N,
                              p.run);
  if (e) return e;
  static int granted = 0;  // the attribute this instantiation was given
  if (lay.total > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        pk_scan_staged_kernel<T, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return (int)err;
    granted = lay.total;
  }
  pk_scan_staged_kernel<T, N><<<grid, consumers + 32, lay.total, stream>>>(
      p, m_dt, m_x, m_b, m_c);
  return (int)cudaGetLastError();
}

template <typename T>
int sc_dispatch(const ScArgs& p, int B, int N, bool staged, int smem,
                cudaStream_t s) {
  switch (N) {
    case 1: return sc_launch<T, 1>(p, B, staged, smem, s);
    case 2: return sc_launch<T, 2>(p, B, staged, smem, s);
    case 4: return sc_launch<T, 4>(p, B, staged, smem, s);
    case 8: return sc_launch<T, 8>(p, B, staged, smem, s);
    case 16: return sc_launch<T, 16>(p, B, staged, smem, s);
    case 32: return sc_launch<T, 32>(p, B, staged, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dt is f32; x, b and c are bf16 when x_bf16 is 1, f32 when 0. Strides in
// elements; the last dim of dt, x, b, c and the state is contiguous. The
// state of channel d = r * dl + j sits at r * h0r + batch * h0b + j * N.
// The launch is the plan's (kernels/mamba_scan.py scan_plan): `channels` a
// block, and for the staged kernel (staged = 1) the steps a stage (`run`)
// and the stages; neither changes the result. smem_bytes is the plan's
// shared memory a block: a launch whose ScLayout differs (0 for the direct
// kernel) is refused.
extern "C" int pk_mamba_scan(const void* dt, const void* x, const void* b,
                             const void* c, const void* a, const void* h0,
                             void* y, void* h_out, int B, int S, int D,
                             int N, int x_bf16, long long sdb, long long sds,
                             long long sxb, long long sxs, long long sbb,
                             long long sbs, long long scb, long long scs,
                             int dl, long long h0r, long long h0b,
                             long long hor, long long hob, int channels,
                             int run, int stages, int staged,
                             int smem_bytes, void* stream) {
  if (N < 1 || N > 32 || (N & (N - 1)) || dl < 1 || D % dl || channels < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  ScArgs p{dt, x, b, c, (const float*)a, (const float*)h0, (float*)y,
           (float*)h_out, S, D, dl, channels, run, stages, (long)sdb,
           (long)sds, (long)sxb, (long)sxs, (long)sbb, (long)sbs, (long)scb,
           (long)scs, (long)h0r, (long)h0b, (long)hor, (long)hob};
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? sc_dispatch<__nv_bfloat16>(p, B, N, staged, smem_bytes, s)
                : sc_dispatch<float>(p, B, N, staged, smem_bytes, s);
}
