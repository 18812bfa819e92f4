"""Build and load the hand-written CUDA kernels (``kernels/csrc``).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object,
all sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
keyed by a hash of the sources and the flags, built at first use into
``build/repro_torch/`` under the repository root, and reused while the
sources are unchanged. Nothing but the repository's sources and the CUDA
toolkit goes into it. A failed build raises with nvcc's output.

Each C launcher returns ``cudaGetLastError()`` after its launch (or minus
the ``CUresult`` with which ``cuTensorMapEncodeTiled`` refused a tensor
map); the Python wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

from repro_torch import compat

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

#: C symbol -> argtypes (restype is int: the cudaError_t of the launch)
SIGNATURES = {
    # x, ldx, w slab ptrs, Z (slabs), ldw, out slab ptrs, ldo, M, N, K,
    # cfg, grid (the plan's), stream
    "pk_matmul_bf16": [_P, _L, ctypes.POINTER(ctypes.c_uint64), _I, _L,
                       ctypes.POINTER(ctypes.c_uint64), _L, _I, _I, _I, _I,
                       _I, _P],
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, q strides (b, h, s),
    # k strides, v strides, causal, window, scale, grid (the plan's), the
    # stream's tile counter, stream
    "pk_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _I, _I, ctypes.c_float, _I, _P, _P],
    # x ptrs, w ptrs, landing ptrs, out ptrs (host tables of R addresses),
    # flags, flag count (ints), R, M, N, K, cfg, grid (the plan's), stream
    "pk_matmul_ar_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 4
                         + [_P, _L] + [_I] * 6 + [_P],
    "pk_matmul_rs_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 4
                         + [_P, _L] + [_I] * 6 + [_P],
    # x ptrs, w ptrs, out ptrs, R, M (rows a rank), N, K, cfg, grid (the
    # plan's), stream
    "pk_ag_matmul_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 3
                         + [_I] * 6 + [_P],
    # the mma.sync kernels B1, B5, B6, B4 and B9 ran on before the Hopper
    # mainloop, a timing yardstick (csrc/mm_tile_yardstick.cu): x, w, out,
    # M, N, K, ldx, ldw, ldo, stream; x ptrs, w ptrs, out ptrs, R, M, N, K,
    # stream; x ptrs, w ptrs, landing ptrs, out ptrs, flags (one int a
    # 64 x 64 tile), R, M, N, K, stream; and B9's arguments without cfg
    # and grid
    "pk_mm_tile_matmul_bf16": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _P],
    "pk_mm_tile_ag_matmul_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 3
                                 + [_I, _I, _I, _I, _P],
    "pk_mm_tile_matmul_rs_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 4
                                 + [_P, _I, _I, _I, _I, _P],
    "pk_mm_tile_matmul_ar_bf16": [ctypes.POINTER(ctypes.c_uint64)] * 4
                                 + [_P, _I, _I, _I, _I, _P],
    "pk_mm_tile_grouped_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I, _L, _L,
                                       _L, _L, _L, _L, _I, _P],
    # the launch configuration of a head_dim: D, int[5] out (query rows,
    # keys a stage, stages, threads, shared memory bytes)
    "pk_flash_attention_config": [_I, ctypes.POINTER(ctypes.c_int)],
    # the mma.sync kernel flash and its hop ran on before the TMA + wgmma
    # design, a timing yardstick (csrc/flash_mma_yardstick.cu): the
    # arguments of pk_flash_attention_bf16 and pk_flash_attention_hop_bf16
    # without grid and tile counter
    "pk_mm_tile_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _L, _L, _L, _L, _L, _L, _L, _L,
                                        _L, _I, _I, ctypes.c_float, _P],
    "pk_mm_tile_flash_attention_hop_bf16": [_P] * 6 + [_I] * 6 + [_L] * 9
                                           + [_I] * 4 + [ctypes.c_float, _P],
    # in ptrs, out ptrs, flags, flag ints, R, blk bytes, route (1 TMA, 0
    # words), unit, tile bytes, grid, stages, shared memory a block (the
    # plan's), epoch, stream
    "pk_lcsc_all_gather": [ctypes.POINTER(ctypes.c_uint64)] * 2
                          + [_P, _L, _I, _L, _I, _I, _L, _I, _I, _L, _I, _P],
    # the kernel B11 ran on before, a timing yardstick
    # (csrc/lcsc_yardstick.cu): in ptrs, out ptrs, flags, flag capacity
    # (ints, zeroed by the launch), R, blk bytes, stream
    "pk_mm_tile_lcsc_all_gather": [ctypes.POINTER(ctypes.c_uint64)] * 2
                                  + [_P, _L, _I, _L, _P],
    # x, w, out, G, C, N, K, x strides (group, row), w strides, out
    # strides, out_f32, cfg, grid (the plan's), stream
    "pk_grouped_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                               _L, _L, _I, _I, _I, _P],
    # in, out, R, route (1 TMA, 0 words), unit, dims, extents, input and
    # output strides (int64[dims]), source, slot and rank strides, box
    # (int[3]), grid, stages, shared memory a block (the plan's), stream
    "pk_all_gather": [_P, _P, _I, _I, _I, _I]
                     + [ctypes.POINTER(ctypes.c_int64)] * 3 + [_L] * 3
                     + [ctypes.POINTER(ctypes.c_int), _I, _I, _L, _P],
    # the kernel B3's all-gather ran on before, a timing yardstick
    # (csrc/pk_comm_yardstick.cu): in ptrs, out ptrs, R, blk bytes, chunk
    # bytes, stream
    "pk_mm_tile_all_gather": [ctypes.POINTER(ctypes.c_uint64)] * 2
                             + [_I, _L, _L, _P],
    # in ptrs, out ptrs, R, blk elems, chunk elems, dtype (0 f32, 1 bf16),
    # tile (elements a source a stage; 0: element-wise), grid, stages,
    # shared memory a block (the plan's), stream
    "pk_reduce_scatter": [ctypes.POINTER(ctypes.c_uint64)] * 2
                         + [_I, _L, _L, _I, _I, _I, _I, _L, _P],
    # the store-and-count kernel the reduce-scatter ran on before, a timing
    # yardstick (csrc/pk_comm_yardstick.cu): in ptrs, out ptrs, landing
    # ptrs, flags, R, blk elems, chunk elems, dtype, stream
    "pk_mm_tile_reduce_scatter": [ctypes.POINTER(ctypes.c_uint64)] * 3
                                 + [_P, _I, _L, _L, _I, _P],
    # in ptrs, out ptrs, flags, R, blk bytes, tile bytes, grid (the
    # plan's), stream
    "pk_p2p_ring_shift": [ctypes.POINTER(ctypes.c_uint64)] * 2
                         + [_P, _I, _L, _L, _I, _P],
    # in ptrs, out ptrs, R, unit, dims, extents, input and output strides
    # (int64[dims]), dst_in, src_out, rows, row words, tail, piece, pieces,
    # rows a tile, grid (the plan's), stream
    "pk_all_to_all": [ctypes.POINTER(ctypes.c_uint64)] * 2 + [_I, _I, _I]
                     + [ctypes.POINTER(ctypes.c_int64)] * 3 + [_L, _L]
                     + [_I] * 7 + [_P],
    # the kernel B8 ran on before, a timing yardstick
    # (csrc/pk_comm_yardstick.cu): in ptrs, out ptrs, flags, R, blk bytes,
    # stream
    "pk_mm_tile_p2p_ring_shift": [ctypes.POINTER(ctypes.c_uint64)] * 2
                                 + [_P, _I, _L, _P],
    # q, k, v, o, m, l, B, Hq, Hkv, Sq, Skv, D, q/k/v strides (b, h, s),
    # n_ranks, hop, causal, window, scale, grid (the plan's), the stream's
    # tile counter, stream
    "pk_flash_attention_hop_bf16": [_P] * 6 + [_I] * 6 + [_L] * 9
                                   + [_I] * 4 + [ctypes.c_float, _I, _P, _P],
    # dt, x, b, c, a, h0, y, h_out, B, S, D, N, x/b/c bf16 flag, dt, x,
    # b, c strides (batch, step), dl, h0 strides (rank, batch), h_out
    # strides (rank, batch), channels a block, run, stages, staged, shared
    # memory a block (the plan's), stream
    "pk_mamba_scan": [_P] * 8 + [_I] * 5 + [_L] * 8 + [_I] + [_L] * 4
                     + [_I] * 5 + [_P],
    # the scan's backward: dt, x, b, c, a, h0, dy, ckpt, ddt, dx, db, dc,
    # da, the partials of db, dc and da, B, S, D, N, x/b/c bf16 flag,
    # steps a segment and shared memory a block (the plan's), dt, x, b,
    # c, dy strides (batch, step), stream
    "pk_mamba_scan_bwd": [_P] * 16 + [_I] * 7 + [_L] * 10 + [_P],
    # q, k_new, v_new, cache k, cache v, pos (or null), pos scalar, pos
    # stride, pos int64 flag, o, m, l (the splits' partials), the merged
    # o, m, l, R, B, Hkv, g, s_loc, hd, window (-1: none), scale, q, k_new,
    # v_new strides (rank, slot, head), cache k, v strides (rank, slot,
    # head, position), heads a group, elements a lane, lanes, splits,
    # shared memory a block (the plan's), bf16 flag, stream
    "pk_decode_attention": [_P] * 6 + [_L, _L, _I] + [_P] * 6 + [_I] * 7
                           + [ctypes.c_float] + [_L] * 17 + [_I] * 6 + [_P],
    # the kernel the scan ran on before its staged design, a timing
    # yardstick (csrc/mamba_scan_yardstick.cu): dt, x, b, c, a, h0, y,
    # h_out, B, S, D, N, chunk, x/b/c bf16 flag, the strides as above,
    # stream
    "pk_mm_tile_mamba_scan": [_P] * 8 + [_I] * 6 + [_L] * 8 + [_I]
                             + [_L] * 4 + [_P],
}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    errors = []
    for c, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> pathlib.Path:
    """Compile the library if no build of these sources exists; its path."""
    lib = BUILD_DIR / f"libpk_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [os.path.join(tmp, p.stem + ".o") for p in cus]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p),
                   "-o", o] for p, o in zip(cus, objs)])
        part = os.path.join(tmp, lib.name)
        _run_all([[nvcc, "-shared", *NVCC_FLAGS, *objs, "-o", part]])
        os.replace(part, lib)      # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launcher reports an error: a cudaError_t (> 0), or minus
    the CUresult of a refused tensor-map encode (< 0)."""
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a tensor "
                           f"map with CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def host_table(addrs: list[int]):
    """A C array of device addresses (a pointer table) for a launcher."""
    return (ctypes.c_uint64 * len(addrs))(*addrs)
