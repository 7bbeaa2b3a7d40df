"""Wrapper of the K5 exact-parse kernel (csrc/encode_k5.cu): the
counterpart of csc_tpu/ops/encode_scan.py `run_parse` as csc_tpu's
pipeline drives it under CSC_ENCODE_PARSE=exact.

`parse_k5` checks its tensors, allocates the per-stream hash tables (int32
zeros: ht2 [B, 16384], ht3 [B, 65536], ht6 [B, hash_width << hash_bits]),
the tape, the counters and the block types, and launches the kernel on
the current CUDA stream, one warp (a block) a stream (two kernels, one
for the streams their dictionary covers and one for those longer than
it, each block of the other kind returning at once); a stream of at most
64 KB is staged in the block's shared memory (`smem_bytes`,
`blocks_per_sm`).  The tables take 64 KB + 256 KB + 4 * (hash_width <<
hash_bits) bytes a stream: 576 KB for a 16 KB stream at m1 (hash_bits 16,
width 1), so about 2.4 GB for the encode path's largest group of 16 KB
streams (64 MB, 4 096 streams); 8.3 MB for a 1 MB stream at m1 (hash_bits
21); 32.3 MB for a 32 MB one (hash_bits 23; at m2, width 8 and
hash_bits 21, 64.3 MB).  Indices into them stay within int32 (at most 8
<< 24 words a row), offsets between rows are int64.  For tensors on the CPU it
runs the plain PyTorch version (ops/exact_scan.py) instead; on any other
device it raises.  LAUNCHES counts the calls that launch K5 (both its
kernels a call).
"""
import ctypes

import torch

from . import exact_scan

LAUNCHES = 0


def launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, lazy, tables, tape, max_steps, out, btypes):
    """csc_k5_launch of library `lib` on the current CUDA stream, into the
    caller's tables (ht2, ht3, ht6, zeros), tape [B, T, 2], out [4, B]
    (tok_cnt, done, err, steps) and btypes [B, NB] (zeros); raises if the
    launch fails."""
    b, n = data.shape
    ht2, ht3, ht6 = tables
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.csc_k5_launch(
            data.data_ptr(), n, blocks.data_ptr(), blocks.shape[1],
            sizes.data_ptr(), dict_sizes.data_ptr(), int(hash_bits),
            int(hash_width), int(good_len), 1 if lazy else 0,
            ht2.data_ptr(), ht3.data_ptr(), ht6.data_ptr(), tape.data_ptr(),
            tape.shape[1], int(max_steps), out.data_ptr(),
            btypes.data_ptr(), b, stream)
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError_t {rc}")


def smem_bytes(n):
    """K5's dynamic shared memory a block for streams of n bytes (0 past
    the 64 KB staging cut)."""
    from .. import _build
    fn = _build.kernel_library("csc_k5").csc_k5_smem
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64]
    return int(fn(n))


def blocks_per_sm(n, ring=False):
    """K5's resident blocks (streams) per SM on the current card for
    streams of n bytes, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
    gives them: of the kernel for streams their dictionary covers, or
    (ring) of the one for streams longer than it."""
    from .. import _build
    fn = _build.kernel_library("csc_k5").csc_k5_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    rc = fn(n, int(ring), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K5 occupancy query failed: cudaError_t {rc}")
    return blocks.value


def new_tables(b, hash_bits, hash_width, device):
    """The zeroed int32 hash tables (ht2, ht3, ht6) of b streams."""
    return tuple(torch.zeros((b, size), dtype=torch.int32, device=device)
                 for size in exact_scan.table_sizes(hash_bits, hash_width))


def parse_k5(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
             good_len, lazy, max_tokens, max_steps=None):
    """Parse B streams exactly.

    data: [B, N] u8 LZ input; blocks: [B, NB, 2] i32, the analyzer's block
    table (each block's cumulative end and info word,
    encode_host.plan_stream(..., exact=True); exact_scan.lz_blocks makes
    one of LZ runs); sizes, dict_sizes: [B] i32; hash_bits, hash_width,
    good_len: the preset's finder; lazy: the lazy second probe (lz_mode
    2); max_steps: the lockstep step budget (exact_scan.max_steps_for(N)
    by default).  Returns (tape [B, max_tokens, 2] i32 of (kind | wire_len
    << 3, dist_code), tok_cnt, done, err, steps [B] i32, btypes [B, NB]
    i32), on data's device; err is ERR_OVERFLOW (the tape filled) or
    ERR_STEPS (the budget ran out); steps counts each stream's lockstep
    micro-ops up to its end (the budget when cut; 2^31 - 1 past int32's
    range, which K5 counts past in int64); btypes holds each
    block's final type, after the duplicate-block probe (0 for a block
    the parse did not reach).
    """
    global LAUNCHES
    exact_scan.check_inputs(data, blocks, sizes, dict_sizes, hash_bits,
                            hash_width, good_len)
    for name, t in (("data", data), ("blocks", blocks),
                    ("sizes", sizes), ("dict_sizes", dict_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    if max_steps is None:
        max_steps = exact_scan.max_steps_for(data.shape[1])
    if not 0 <= max_steps <= exact_scan.MAX_BUDGET:
        raise ValueError(f"max_steps must be in [0, 2^62), got {max_steps}")
    dev, b = data.device, data.shape[0]
    if dev.type == "cpu":
        return exact_scan.exact_plain(
            data, blocks, sizes, dict_sizes, hash_bits, hash_width,
            good_len, lazy, max_tokens, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")

    from .. import _build
    lib = _build.kernel_library("csc_k5")
    tables = new_tables(b, hash_bits, hash_width, dev)
    tape = torch.zeros((b, max_tokens, 2), dtype=torch.int32, device=dev)
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, lazy, tables, tape, max_steps, out, btypes)
    LAUNCHES += 1
    return tape, out[0], out[1], out[2], out[3], btypes
