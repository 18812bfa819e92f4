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
