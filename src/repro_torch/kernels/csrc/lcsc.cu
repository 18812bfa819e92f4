// The ring all-gather written on the LCSC template. Port of
// repro/kernels/lcsc.py::lcsc_ring_all_gather; the design note is in
// kernels/lcsc.py.
//
// in: R rank addresses of blk_bytes each; out: R ranks of R slots of
// blk_bytes. The prologue stages rank d's shard into slot d of its own
// output; at step i the communicator forwards slot (d - i) mod R — staged
// at step 0, arrived from the left neighbour at step i - 1 after — into
// the same slot of the right neighbour's output. Each block moves its part
// of a slot, in the widest words (16 down to 1 byte) that divide blk_bytes
// and every address.
#include <cuda_runtime.h>

#include "lcsc.cuh"
#include "pk.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long TILE_VECS = 4 * THREADS;  // words a part moves at least

template <typename U>
__global__ void __launch_bounds__(THREADS)
    pk_lcsc_all_gather_kernel(lcsc::Grid g, pk::PtrTable src,
                              pk::PtrTable dst, long units) {
  // this block's part of a slot, from `from` into `to`
  auto copy = [units](const lcsc::Ctx& c, const U* from, U* to) {
    const long per = (units + c.parts - 1) / c.parts;
    const long begin = per * c.part;
    const long end = begin + per < units ? begin + per : units;
    for (long k = begin + threadIdx.x; k < end; k += THREADS)
      pk::store_async(to + k, __ldcg(from + k));
  };
  auto slot = [dst, units](int rank, int s) {
    return reinterpret_cast<U*>(dst.p[rank]) + (long)s * units;
  };
  lcsc::run(
      g,
      [&](const lcsc::Ctx& c) {  // prologue: my shard into my own slot
        copy(c, reinterpret_cast<const U*>(src.p[c.rank]),
             slot(c.rank, c.rank));
      },
      [&](const lcsc::Ctx& c) {  // communicator: forward the shard that
                                 // arrived `step` hops ago
        const int s = (c.rank - c.step + c.R) % c.R;
        copy(c, slot(c.rank, s), slot(c.right, s));
      },
      lcsc::Nothing{}, lcsc::Nothing{}, lcsc::Nothing{});
}

template <typename U>
int launch_ag(const unsigned long long* in, const unsigned long long* out,
              int* flags, long flag_capacity, int R, long blk_bytes,
              cudaStream_t st) {
  const long units = blk_bytes / (long)sizeof(U);
  const long want = (units + TILE_VECS - 1) / TILE_VECS;
  return (int)lcsc::launch(pk_lcsc_all_gather_kernel<U>, R, R - 1, want,
                           THREADS, flags, flag_capacity, st, pk::table(in, R),
                           pk::table(out, R), units);
}

}  // namespace

// flags: flag_capacity ints of scratch, zeroed here on the stream.
extern "C" int pk_lcsc_all_gather(const unsigned long long* in_ptrs,
                                  const unsigned long long* out_ptrs,
                                  void* flags, long flag_capacity, int R,
                                  long blk_bytes, void* stream) {
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
