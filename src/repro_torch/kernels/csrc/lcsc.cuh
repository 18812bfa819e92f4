// The LCSC program template (paper §3.2.3): loader / consumer / storer /
// communicator workers around a ring of steps. Port of
// repro/kernels/lcsc.py::lcsc_kernel; the design note is in
// kernels/lcsc.py.
//
// Device side: lcsc::run(grid, prologue, communicator, loader, consumer,
// storer) runs the prologue, then for each step the communicator first
// (its stores go into the right neighbour's PGL slots), then loader,
// consumer and storer, and closes the hop on that step's flags: fence,
// signal the right neighbour's (step, part) flag (release), wait on this
// block's own (step, part) flag (acquire) — the left neighbour's hop has
// arrived. Each worker is a callable taking the step's lcsc::Ctx.
//
// Unlike the store-and-count kernels, blocks here wait on other blocks. The
// wait is safe by construction: the grid is persistent, R ranks x P parts,
// P chosen from the occupancy calculator so that every block is resident,
// and the launch is cooperative, which CUDA refuses rather than run a grid
// that cannot be co-resident. A block waits only on its counterpart
// (left rank, same part) at the same step, which signals before it waits.
// The spin is bounded: a block that waits longer than kSpinCycles traps,
// so a bug fails the launch instead of hanging the card.
//
// Host side: lcsc::launch picks P, zeroes the flags on the stream and
// makes the cooperative launch; any refusal comes back as its error code.
#pragma once

#include <cuda_runtime.h>

#include "pk.cuh"

namespace lcsc {

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

}  // namespace lcsc
