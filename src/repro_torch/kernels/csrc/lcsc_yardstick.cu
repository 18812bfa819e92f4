// The kernel B11's ring all-gather ran on before its redesign (csrc/lcsc.cu
// on the item walk of csrc/lcsc.cuh), kept as a timing yardstick: no wrapper
// of the port calls it; chip_smoke.py and scripts/ag_p2p_probe.py time it
// beside the kernel that replaced it (the ``ms_mm_tile`` column).
//
// The template it is written on, lcsc_steps::run, walks the ring step by
// step: a persistent grid of R ranks x P parts; the prologue copies rank
// d's shard into slot d of its own output, then at each step every block
// copies its part of a slot into the right neighbour's output word by word
// through registers, fences, signals the neighbour's (step, part) flag
// (release), waits on its own (acquire) and meets the rest of the block at
// a __syncthreads. The flags are zeroed on the stream before every launch,
// and the launch is cooperative (parts from the occupancy calculator), so
// every block that waits is resident. It moves 2 R^2 blk: the prologue's
// copy is read back at step 0.
#include <cuda_runtime.h>

#include "pk.cuh"

namespace lcsc_steps {

// Launch geometry every LCSC kernel takes as its first argument: R ranks of
// `parts` blocks each, `n_steps` ring steps, and the arrival flags, one int
// per (rank, step, part), zero at the start of the launch.
struct Grid {
  int R;
  int parts;
  int n_steps;
  int* flags;
};

// What a worker may use at step `step` (the TPU form's LCSCCtx).
struct Ctx {
  int R, rank, left, right, part, parts, step, n_steps;
  int* flags;
  __device__ int* flag(int at_rank, int at_step) const {
    return flags + ((long)at_rank * n_steps + at_step) * parts + part;
  }
};

// A wait longer than this many SM clock cycles (over a second at the
// card's clocks) is a bug.
constexpr long long kSpinCycles = 1ll << 32;

__device__ __forceinline__ void wait_at_least(const int* flag, int v) {
  const long long t0 = clock64();
  while (pk::wait(flag) < v)
    if (clock64() - t0 > kSpinCycles) __trap();
}

// The worker that does nothing (a slot the kernel leaves empty).
struct Nothing {
  __device__ void operator()(const Ctx&) const {}
};

template <class Prologue, class Communicator, class Loader, class Consumer,
          class Storer>
__device__ void run(const Grid& g, Prologue prologue,
                    Communicator communicator, Loader loader,
                    Consumer consumer, Storer storer) {
  Ctx c;
  c.R = g.R;
  c.parts = g.parts;
  c.n_steps = g.n_steps;
  c.flags = g.flags;
  c.rank = blockIdx.x / g.parts;
  c.part = blockIdx.x - c.rank * g.parts;
  c.left = (c.rank + g.R - 1) % g.R;
  c.right = (c.rank + 1) % g.R;
  c.step = 0;
  prologue(c);
  __syncthreads();
  for (c.step = 0; c.step < c.n_steps; ++c.step) {
    communicator(c);  // the hop goes out first
    loader(c);
    consumer(c);
    storer(c);
    __threadfence();  // the hop's stores before its signal
    __syncthreads();
    if (threadIdx.x == 0) {
      pk::signal(c.flag(c.right, c.step), 1);
      wait_at_least(c.flag(c.rank, c.step), 1);  // the left hop arrived
    }
    __syncthreads();
  }
}

template <typename... KA>
cudaError_t launch_args(void (*kernel)(Grid, KA...), Grid g, dim3 grid,
                        int threads, cudaStream_t stream, KA... a) {
  void* argv[] = {&g, &a...};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel, grid, dim3(threads), argv, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// Launch `kernel` over R ranks and n_steps steps with as many parts per
// rank as stay resident, at most max_parts and at most what flag_capacity
// ints of flags can count.
template <typename... KA, typename... A>
cudaError_t launch(void (*kernel)(Grid, KA...), int R, int n_steps,
                   long max_parts, int threads, int* flags,
                   long flag_capacity, cudaStream_t stream, A... args) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  long parts = (long)per_sm * sms / R;
  if (max_parts < parts) parts = max_parts;
  if (n_steps > 0 && flag_capacity / ((long)R * n_steps) < parts)
    parts = flag_capacity / ((long)R * n_steps);
  if (parts < 1) return cudaErrorCooperativeLaunchTooLarge;
  Grid g{R, (int)parts, n_steps, flags};
  err = cudaMemsetAsync(flags, 0, sizeof(int) * R * n_steps * parts, stream);
  if (err != cudaSuccess) return err;
  return launch_args<KA...>(kernel, g, dim3(R * parts), threads, stream,
                            static_cast<KA>(args)...);
}

}  // namespace lcsc_steps

namespace {

constexpr int THREADS = 256;
constexpr long TILE_VECS = 4 * THREADS;  // words a part moves at least

template <typename U>
__global__ void __launch_bounds__(THREADS)
    pk_lcsc_steps_all_gather_kernel(lcsc_steps::Grid g, pk::PtrTable src,
                                    pk::PtrTable dst, long units) {
  // this block's part of a slot, from `from` into `to`
  auto copy = [units](const lcsc_steps::Ctx& c, const U* from, U* to) {
    const long per = (units + c.parts - 1) / c.parts;
    const long begin = per * c.part;
    const long end = begin + per < units ? begin + per : units;
    for (long k = begin + threadIdx.x; k < end; k += THREADS)
      pk::store_async(to + k, __ldcg(from + k));
  };
  auto slot = [dst, units](int rank, int s) {
    return reinterpret_cast<U*>(dst.p[rank]) + (long)s * units;
  };
  lcsc_steps::run(
      g,
      [&](const lcsc_steps::Ctx& c) {  // prologue: my shard into my own slot
        copy(c, reinterpret_cast<const U*>(src.p[c.rank]),
             slot(c.rank, c.rank));
      },
      [&](const lcsc_steps::Ctx& c) {  // communicator: forward the shard
                                       // that arrived `step` hops ago
        const int s = (c.rank - c.step + c.R) % c.R;
        copy(c, slot(c.rank, s), slot(c.right, s));
      },
      lcsc_steps::Nothing{}, lcsc_steps::Nothing{}, lcsc_steps::Nothing{});
}

template <typename U>
int launch_ag(const unsigned long long* in, const unsigned long long* out,
              int* flags, long flag_capacity, int R, long blk_bytes,
              cudaStream_t st) {
  const long units = blk_bytes / (long)sizeof(U);
  const long want = (units + TILE_VECS - 1) / TILE_VECS;
  return (int)lcsc_steps::launch(pk_lcsc_steps_all_gather_kernel<U>, R,
                                 R - 1, want, THREADS, flags, flag_capacity,
                                 st, pk::table(in, R), pk::table(out, R),
                                 units);
}

}  // namespace

// flags: flag_capacity ints of scratch, zeroed here on the stream.
extern "C" int pk_mm_tile_lcsc_all_gather(const unsigned long long* in_ptrs,
                                          const unsigned long long* out_ptrs,
                                          void* flags, long flag_capacity,
                                          int R, long blk_bytes,
                                          void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || blk_bytes < 0)
    return (int)cudaErrorInvalidValue;
  if (blk_bytes == 0) return 0;
  unsigned long long bits = (unsigned long long)blk_bytes;
  for (int i = 0; i < R; ++i) bits |= in_ptrs[i] | out_ptrs[i];
  return pk::with_word(bits, [&](auto word) {
    return launch_ag<decltype(word)>(in_ptrs, out_ptrs, (int*)flags,
                                     flag_capacity, R, blk_bytes,
                                     (cudaStream_t)stream);
  });
}
