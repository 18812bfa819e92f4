// The ring all-gather written on the LCSC template. Port of
// repro/kernels/lcsc.py::lcsc_ring_all_gather; the design note is in
// kernels/lcsc.py.
//
// in: R rank addresses of blk bytes each; out: R ranks of R slots of blk
// bytes. Step 0 is the prologue fused with the first hop: rank d's tile of
// its shard is loaded once and stored into slot d of its own output and of
// its right neighbour's. At step i >= 1 the communicator forwards slot
// (d - i) mod R — arrived from the left neighbour at step i - 1 — into the
// same slot of the right neighbour's output. R (R - 1) blk read, R^2 blk
// written.
#include <cuda_runtime.h>

#include "lcsc.cuh"
#include "pk.cuh"

namespace {

template <class Word>
__global__ void __launch_bounds__(lcsc::kThreads)
    pk_lcsc_all_gather_kernel(const __grid_constant__ lcsc::Grid g,
                              const __grid_constant__ pk::PtrTable src,
                              const __grid_constant__ pk::PtrTable dst) {
  auto slot = [&](int rank, int s) {
    return reinterpret_cast<unsigned char*>(dst.p[rank]) + s * g.blk;
  };
  lcsc::run<Word>(
      g,
      [&](const lcsc::Ctx& c, lcsc::Hop& h) {  // prologue: my shard, into
        h.load(reinterpret_cast<const void*>(src.p[c.rank]));  // my slot
        h.store(slot(c.rank, c.rank));
      },
      [&](const lcsc::Ctx& c, lcsc::Hop& h) {  // communicator: forward the
        const int s = (c.rank - c.step + c.R) % c.R;  // shard that arrived
        if (c.step > 0) h.load(slot(c.rank, s));      // `step` hops ago
        h.store(slot(c.right, s));
      },
      lcsc::Nothing{}, lcsc::Nothing{}, lcsc::Nothing{});
}

template <class Word>
int launch_ag(const lcsc::Grid& g, int grid, size_t smem,
              const unsigned long long* in, const unsigned long long* out,
              cudaStream_t st) {
  static size_t granted = 0;  // the attribute this instantiation was given
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        pk_lcsc_all_gather_kernel<Word>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  return (int)lcsc::launch(pk_lcsc_all_gather_kernel<Word>, g, grid, smem,
                           st, pk::table(in, g.R), pk::table(out, g.R));
}

}  // namespace

// in_ptrs, out_ptrs: host tables of R rank addresses (rank r's shard of
// blk_bytes; rank r's R slots of blk_bytes). The launch is the plan's
// (kernels/lcsc.py lcsc_plan): tiles of tile_bytes; route 1, TMA: blk and
// tile multiples of 16 bytes, every address 16-byte aligned, `stages`
// stages and smem_bytes of shared memory a block (a launch whose
// lcsc::smem differs is refused), unit 0; route 0, words of `unit`
// bytes. grid blocks, co-resident (a cooperative launch). flags: flag_ints
// ints that this launch's items stamp with `epoch` (item k, flags[k]); a
// plan of more items is refused.
extern "C" int pk_lcsc_all_gather(const unsigned long long* in_ptrs,
                                  const unsigned long long* out_ptrs,
                                  void* flags, long long flag_ints, int R,
                                  long long blk_bytes, int route, int unit,
                                  long long tile_bytes, int grid, int stages,
                                  long long smem_bytes, int epoch,
                                  void* stream) {
  if (R < 1 || R > PK_MAX_RANKS || blk_bytes < 0 || grid < 1 ||
      tile_bytes < 1 || tile_bytes >= (1 << 20) || flag_ints > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (blk_bytes == 0) return 0;
  const long long tiles = (blk_bytes + tile_bytes - 1) / tile_bytes;
  if ((R > 1 ? R - 1 : 1) * R * tiles > flag_ints)
    return (int)cudaErrorInvalidValue;
  unsigned long long bits = (unsigned long long)(blk_bytes | tile_bytes);
  for (int i = 0; i < R; ++i) bits |= in_ptrs[i] | out_ptrs[i];
  lcsc::Grid g{R, R - 1, (int)tiles, blk_bytes, tile_bytes, stages, 0,
               (int*)flags, epoch};
  const cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    if (smem_bytes != 0 || unit < 1 || unit > 16 || (unit & (unit - 1)) ||
        bits % unit)
      return (int)cudaErrorInvalidValue;
    switch (unit) {
      case 16: return launch_ag<uint4>(g, grid, 0, in_ptrs, out_ptrs, st);
      case 8: return launch_ag<uint2>(g, grid, 0, in_ptrs, out_ptrs, st);
      case 4: return launch_ag<unsigned>(g, grid, 0, in_ptrs, out_ptrs, st);
      case 2:
        return launch_ag<unsigned short>(g, grid, 0, in_ptrs, out_ptrs, st);
      default:
        return launch_ag<unsigned char>(g, grid, 0, in_ptrs, out_ptrs, st);
    }
  }
  g.stage_bytes = (int)((tile_bytes + 127) / 128 * 128);
  const size_t smem = lcsc::smem(g.stage_bytes, stages);
  if (route != 1 || unit != 0 || bits % 16 || stages < 2 ||
      stages > lcsc::kMaxStages ||
      (long long)smem != smem_bytes)
    return (int)cudaErrorInvalidValue;
  return launch_ag<lcsc::Staged>(g, grid, smem, in_ptrs, out_ptrs, st);
}
