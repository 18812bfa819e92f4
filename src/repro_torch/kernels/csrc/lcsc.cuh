// The LCSC program template (paper §3.2.3): prologue / communicator /
// loader / consumer / storer workers around a ring of steps. Port of
// repro/kernels/lcsc.py::lcsc_kernel; the design note is in
// kernels/lcsc.py.
//
// The work unit is an item: (step i, rank d, tile t), t a byte range of a
// rank's block. The ring has n_steps = R - 1 hops; the walk covers
// max(n_steps, 1) steps, so that a ring of one rank still runs its prologue.
// A persistent grid walks the items in step-major order (item k = (i R + d)
// tiles + t), block b taking k = b, b + grid, ... Item (i >= 1, d, t) reads
// what item (i - 1, left of d, t) stored, so it waits on that item's flag
// and on nothing else: tile t can be at hop 3 while tile t + 40 is at hop 1.
//
// For each item the workers name where its tile comes from (Hop::load) and
// where it goes (Hop::store), relative to the tile's first byte: the
// prologue at step 0, the communicator at each hop (the right neighbour's
// slot, and past step 0 the origin: what arrived from the left), the loader
// and the storer any other origin or destination; the consumer sees the
// staged tile between its arrival and its stores. Workers are callables
// taking (const Ctx&, Hop&) — the consumer (const Ctx&) — and are called
// once an item, when its load is issued.
//
// TMA route (Staged): one thread a block. It TMA-loads each item's tile
// (cp.async.bulk) into a ring of shared-memory stages, one mbarrier each,
// and writes it by bulk stores from the stage; a stage is refilled once the
// stores of the item before have completed. Word route (Word, a word type):
// the block's warp copies the tile in words through registers, for
// shapes bulk copies cannot take (a block or an address not a multiple of
// 16 bytes).
//
// Flags that are never reset: one int an item, flags[k]. A launch carries
// an epoch, one more than the last launch's on its stream; an item stamps
// its flag with it (release) once its stores are complete, and an item
// waits until (int)(flag - epoch) >= 0 (acquire). A flag an earlier launch
// stamped, of whatever shape, holds an earlier epoch and satisfies no wait
// (the wrapper zeroes the flags once every 2^30 launches, so the difference
// never wraps). No memset: a launch is one device op. The epoch is a launch
// argument, so a CUDA graph would replay one epoch and a replay's waits
// would be met by the replay before's stamps: the wrapper refuses capture.
//
// Memory order across proxies: a tile is written by bulk stores (the async
// proxy), signalled by a flag store (the generic proxy) and read by another
// block's TMA load (the async proxy). The producer waits for its bulk
// groups to complete (cp.async.bulk.wait_group 0, not .read), fences
// (fence.proxy.async.global) and stores the flag with release semantics;
// the waiter acquires the flag and fences (fence.proxy.async.global)
// before its load.
//
// Progress: the item waited on always comes earlier in the walk. Loads run
// ahead only for items whose wait has already arrived; a block blocks on a
// wait only at that item's turn, after stamping every item of its own
// before it. So the earliest unstamped item's block is never blocked, and
// by induction every item is stamped — as long as every block is resident.
// The launch is cooperative: CUDA refuses a grid that cannot be
// co-resident, and the refusal comes back as the launcher's error. A spin
// that outlasts kSpinCycles traps, so a bug fails the launch instead of
// hanging the card.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "pk.cuh"
#include "tma.cuh"

namespace lcsc {

constexpr int kThreads = 32;    // a block: one warp
constexpr int kMaxStores = 2;   // destinations of an item's tile
constexpr int kMaxStages = 8;

// The plan's launch (kernels/lcsc.py lcsc_plan).
struct Grid {
  int R, n_steps, tiles;    // ranks; ring hops (R - 1); tiles a block
  long long blk, tile;      // bytes: a rank's block; a tile (the last short)
  int stages, stage_bytes;  // TMA route: the ring; a stage (128-aligned)
  int* flags;               // one int an item
  int epoch;                // this launch's stamp
};

// One item: step `step` of rank `rank`, bytes [begin, begin + bytes) of a
// block (tile `tile`), and its staged copy in shared memory (TMA route).
struct Ctx {
  int R, rank, left, right, step, n_steps, tile, tiles;
  long long begin;
  int bytes;
  uint32_t stage;
};

// Where an item's tile comes from and goes, as block base addresses.
struct Hop {
  const unsigned char* from;
  unsigned char* to[kMaxStores];
  int n_to;
  __device__ void load(const void* p) {
    from = static_cast<const unsigned char*>(p);
  }
  __device__ void store(void* p) {  // at most kMaxStores; constant indices
    (n_to == 0 ? to[0] : to[1]) = static_cast<unsigned char*>(p);
    ++n_to;
  }
};
static_assert(sizeof(Hop) == 32, "kernels/lcsc.py counts 32 bytes a Hop");

// The route of lcsc::run that stages tiles through TMA.
struct Staged {};

// The worker that does nothing (a slot the kernel leaves empty).
struct Nothing {
  template <class... A>
  __device__ void operator()(const A&...) const {}
};

// A wait longer than this many SM clock cycles (over a second at the
// card's clocks) is a bug.
constexpr long long kSpinCycles = 1ll << 32;

__device__ __forceinline__ bool arrived(const int* flag, int epoch) {
  return (int)((unsigned)pk::wait(flag) - (unsigned)epoch) >= 0;
}

// Spin (acquire) until the item of `flag` has stamped this launch's epoch.
__device__ __forceinline__ void wait_arrived(const int* flag, int epoch) {
  const long long t0 = clock64();
  while (!arrived(flag, epoch))
    if (clock64() - t0 > kSpinCycles) __trap();
}

// Order the async proxy's global accesses after the generic proxy's
// before them, and the other way round.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void stamp(int* flag, int epoch) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag),
               "r"(epoch)
               : "memory");
}

__device__ __forceinline__ int walk_items(const Grid& g) {
  return (g.n_steps > 1 ? g.n_steps : 1) * g.R * g.tiles;
}

__device__ __forceinline__ Ctx item(const Grid& g, int k) {
  Ctx c;
  const int per_step = g.R * g.tiles;
  c.R = g.R;
  c.n_steps = g.n_steps;
  c.tiles = g.tiles;
  c.step = k / per_step;
  c.rank = (k - c.step * per_step) / g.tiles;
  c.tile = k - c.step * per_step - c.rank * g.tiles;
  c.left = (c.rank + g.R - 1) % g.R;
  c.right = (c.rank + 1) % g.R;
  c.begin = (long long)c.tile * g.tile;
  c.bytes = (int)(g.blk - c.begin < g.tile ? g.blk - c.begin : g.tile);
  c.stage = 0;
  return c;
}

// The item whose stores item c reads (the left rank's, one step earlier,
// same tile), or -1 at step 0.
__device__ __forceinline__ int waits_on(const Grid& g, const Ctx& c) {
  return c.step == 0 ? -1 : ((c.step - 1) * g.R + c.left) * g.tiles + c.tile;
}

template <class P, class C, class L, class S>
__device__ __forceinline__ Hop plan_hop(const Ctx& c, P& pro, C& com, L& ld,
                                        S& st) {
  Hop h{};
  if (c.step == 0) pro(c, h);
  if (c.step < c.n_steps) com(c, h);
  ld(c, h);
  st(c, h);
  return h;
}

// The dynamic shared memory of the TMA route: the stages, their mbarriers,
// their Hops.
inline size_t smem(int stage_bytes, int stages) {
  return (size_t)stages * (stage_bytes + sizeof(uint64_t) + sizeof(Hop));
}

template <class Word, class P, class C, class L, class U, class S>
__device__ void run(const Grid& g, P pro, C com, L ld, U con, S st) {
  const int items = walk_items(g);
  if constexpr (std::is_same_v<Word, Staged>) {
    extern __shared__ __align__(128) unsigned char smem_[];
    if (threadIdx.x != 0) return;
    const uint32_t ring = hg::smem_addr(smem_);
    const uint32_t full0 = ring + g.stages * g.stage_bytes;
    Hop* hops = reinterpret_cast<Hop*>(smem_ + g.stages * g.stage_bytes +
                                       g.stages * sizeof(uint64_t));
    for (int s = 0; s < g.stages; ++s) hg::mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int n = (int)blockIdx.x < items
                      ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                      : 0;
    auto k_of = [&](int j) { return (int)blockIdx.x + j * (int)gridDim.x; };
    int issued = 0, stamped = 0;
    // signal this block's items before `end`, whose stores are complete
    auto stamp_to = [&](int end) {
      fence_async_global();
      for (; stamped < end; ++stamped) stamp(g.flags + k_of(stamped), g.epoch);
    };
    // issue item j's load once its wait has arrived; `block`: spin for it,
    // after completing and stamping every earlier item of this block
    auto issue = [&](int j, bool block) {
      const Ctx c = item(g, k_of(j));
      const int w = waits_on(g, c);
      if (w >= 0) {
        if (!arrived(g.flags + w, g.epoch)) {
          if (!block) return false;
          hg::bulk_wait<0>();
          stamp_to(j);
          wait_arrived(g.flags + w, g.epoch);
        }
        fence_async_global();
      }
      const int s = j % g.stages;
      hops[s] = plan_hop(c, pro, com, ld, st);
      hg::mbar_expect_tx(full0 + 8 * s, (uint32_t)c.bytes);
      hg::bulk_load(ring + s * g.stage_bytes, hops[s].from + c.begin,
                    (uint32_t)c.bytes, full0 + 8 * s);
      issued = j + 1;
      return true;
    };
    for (int j = 0; j < n; ++j) {
      if (issued == j) issue(j, true);
      const int s = j % g.stages;
      hg::mbar_wait(full0 + 8 * s, (j / g.stages) & 1);
      // the stores read what the async proxy wrote: order them after it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      Ctx c = item(g, k_of(j));
      c.stage = ring + s * g.stage_bytes;
      con(c);
      for (int q = 0; q < hops[s].n_to; ++q)
        hg::bulk_store(hops[s].to[q] + c.begin, c.stage, (uint32_t)c.bytes);
      hg::bulk_commit();
      hg::bulk_wait<1>();  // the items before j are complete, their
      stamp_to(j);         // stages free: signal them
      while (issued < n && issued < j + g.stages && issue(issued, false)) {
      }
    }
    hg::bulk_wait<0>();
    stamp_to(n);
  } else {
    const int lane = threadIdx.x;
    for (int k = blockIdx.x; k < items; k += gridDim.x) {
      const Ctx c = item(g, k);
      const int w = waits_on(g, c);
      if (w >= 0) {
        if (lane == 0) wait_arrived(g.flags + w, g.epoch);
        __syncwarp();
      }
      const Hop h = plan_hop(c, pro, com, ld, st);
      con(c);
      const Word* from = reinterpret_cast<const Word*>(h.from + c.begin);
      for (int e = lane; e < c.bytes / (int)sizeof(Word); e += kThreads) {
        const Word v = __ldcg(from + e);  // L2: another SM wrote it
#pragma unroll
        for (int q = 0; q < kMaxStores; ++q)
          if (q < h.n_to) reinterpret_cast<Word*>(h.to[q] + c.begin)[e] = v;
      }
      __threadfence();  // every lane's stores before the stamp
      __syncwarp();
      if (lane == 0) stamp(g.flags + k, g.epoch);
    }
  }
}

// Launch `kernel` at the plan's grid of kThreads-thread blocks and `smem`
// bytes of dynamic shared memory, cooperatively: CUDA refuses a grid that
// cannot be co-resident, and the refusal is returned.
template <typename... KA>
cudaError_t launch(void (*kernel)(Grid, KA...), const Grid& g, int grid,
                   size_t smem_bytes, cudaStream_t stream, KA... a) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  Grid gv = g;
  void* argv[] = {&gv, &a...};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), argv, smem_bytes, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace lcsc
