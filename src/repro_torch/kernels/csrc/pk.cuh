// ParallelKittens communication primitives as CUDA device functions.
//
// Counterparts of the Pallas primitives in repro/kernels/pk_comm.py
// (pk_store_async :48, pk_signal :83, pk_wait :96). On a TPU they are
// remote DMAs and semaphores between chips; on Hopper they are plain
// stores into another rank's PGL slot (a peer pointer on a multi-GPU node,
// a slice of the same allocation on virtual ranks) ordered by
// release/acquire operations on flags in device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PK_MAX_RANKS 8

namespace pk {

// Per-rank base addresses of one PGL buffer, passed to a kernel by value.
struct PtrTable {
  unsigned long long p[PK_MAX_RANKS];
};

// A pointer table from a host array of R rank addresses.
inline PtrTable table(const unsigned long long* ptrs, int R) {
  PtrTable t{};
  for (int i = 0; i < R; ++i) t.p[i] = ptrs[i];
  return t;
}

// Calls f(U{}) for the widest word type U — 16, 8, 4, 2 or 1 bytes — that
// divides `bits` (a size or'ed with every address a copy touches) and
// returns its result.
template <class F>
int with_word(unsigned long long bits, F f) {
  if (bits % 16 == 0) return f(uint4{});
  if (bits % 8 == 0) return f(uint2{});
  if (bits % 4 == 0) return f(0u);
  if (bits % 2 == 0) return f((unsigned short)0);
  return f((unsigned char)0);
}

// store_async: one vector store (up to 16 bytes) into a (possibly remote)
// slot. Ordering against the flag is the caller's fence + signal.
template <typename U>
__device__ __forceinline__ void store_async(U* dst, U v) {
  *dst = v;
}

// signal: add to a flag with release semantics at GPU scope; returns the
// flag's value before the add.
__device__ __forceinline__ int signal(int* flag, int v) {
  int old;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(flag), "r"(v)
               : "memory");
  return old;
}

// wait: read a flag with acquire semantics at GPU scope. Stores released
// before the signals this read observes are visible after it.
__device__ __forceinline__ int wait(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

}  // namespace pk
