"""Wrapper of the K6 kernel (csrc/encode_k6.cu), the exact optimal parse
of m3 / m4 priced by the live model: on the card, what csc_tpu's
pipeline hands its golden encoder at m3 / m4 (CSC_ENCODE_PARSE=exact,
and streams over its 1 MB device cap).

`parse_k6` checks its tensors, allocates the per-stream hash tables
(int32 zeros, as K5's: ht2 [B, 16384], ht3 [B, 65536], ht6 [B,
hash_width << hash_bits]), the model's p_lit (uint16 [B, 65536], 128 KB a
stream) and the stretch's cells (int32 [B, NFIELD * CELLS], 74 KB a
stream), which the kernel sets up, the tape, the counters and the block
types, and launches the kernel on the current CUDA stream, one warp (a
block) a stream; a stream of at most 64 KB is staged in the block's
shared memory (`smem_bytes`, `blocks_per_sm`).  For tensors on the CPU
it runs the plain version (ops/exact_ap_scan.py) instead; on any other
device it raises.  LAUNCHES counts the calls that launch K6.
"""
import ctypes

import numpy as np
import torch

from . import exact_ap_scan, exact_kernel, prices

LAUNCHES = 0
NLIT = 256 * 256


def p2b_table(device):
    """The p_2_bits price table (prices.P_2_BITS) as K6 reads it: [512]
    uint16 (as int16) on `device`."""
    return torch.from_numpy(np.array(prices.P_2_BITS, np.uint16).view(
        np.int16)).to(device)


def _lib_fn(name, restype, argtypes):
    from .. import _build
    fn = getattr(_build.kernel_library("csc_k6"), name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def cell_words():
    """The int32 words of a stream's cells (the kernel's NFIELD *
    CELLS)."""
    return int(_lib_fn("csc_k6_cell_words", ctypes.c_int64, [])())


def smem_bytes(n):
    """K6's dynamic shared memory a block for streams of n bytes (the
    staged words up to 64 KB, then the model's 2 216 bytes)."""
    return int(_lib_fn("csc_k6_smem", ctypes.c_int64, [ctypes.c_int64])(n))


def blocks_per_sm(n):
    """K6's resident blocks (streams) per SM on the current card for
    streams of n bytes, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
    gives them."""
    fn = _lib_fn("csc_k6_blocks_per_sm", ctypes.c_int,
                 [ctypes.c_int64, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    rc = fn(n, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K6 occupancy query failed: cudaError_t {rc}")
    return blocks.value


def new_scratch(b, hash_bits, hash_width, device):
    """(tables, lit, cells) of b streams: the zeroed hash tables (ht2,
    ht3, ht6), p_lit and the cells (set up by the kernel)."""
    tables = exact_kernel.new_tables(b, hash_bits, hash_width, device)
    lit = torch.empty((b, NLIT), dtype=torch.int16, device=device)
    cells = torch.empty((b, cell_words()), dtype=torch.int32, device=device)
    return tables, lit, cells


def launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, p2b, scratch, tape, out, btypes):
    """csc_k6_launch of library `lib` on the current CUDA stream, into the
    caller's scratch (new_scratch's; the tables zeros), tape [B, T, 2],
    out [3, B] (tok_cnt, done, err) and btypes [B, NB] (zeros); raises if
    the launch fails."""
    b, n = data.shape
    (ht2, ht3, ht6), lit, cells = scratch
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.csc_k6_launch(
            data.data_ptr(), n, blocks.data_ptr(), blocks.shape[1],
            sizes.data_ptr(), dict_sizes.data_ptr(), int(hash_bits),
            int(hash_width), int(good_len), p2b.data_ptr(), ht2.data_ptr(),
            ht3.data_ptr(), ht6.data_ptr(), lit.data_ptr(),
            cells.data_ptr(), tape.data_ptr(), tape.shape[1],
            out.data_ptr(), btypes.data_ptr(), b, stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError_t {rc}")


def parse_k6(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
             good_len, max_tokens):
    """Parse B streams (m3 / m4, each at most its dictionary) with golden's
    optimal parse.

    data: [B, N] u8 LZ input; blocks: [B, NB, 2] i32, the analyzer's block
    table (encode_host.plan_stream(..., exact=True)); sizes, dict_sizes:
    [B] i32; hash_bits, hash_width, good_len: the preset's finder.
    Returns (tape [B, max_tokens, 2] i32 of (kind | wire_len << 3,
    dist_code), tok_cnt, done, err [B] i32, btypes [B, NB] i32), on data's
    device; err is ERR_OVERFLOW when a token did not fit the tape, which
    ends the stream's parse (done 0); btypes holds each block's final
    type, after the duplicate-block probe (0 for a block the parse did not
    reach).
    """
    global LAUNCHES
    dev, b = data.device, data.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K6 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")
    exact_ap_scan.check_inputs(data, blocks, sizes, dict_sizes, hash_bits,
                               hash_width, good_len)
    for name, t in (("data", data), ("blocks", blocks),
                    ("sizes", sizes), ("dict_sizes", dict_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    if dev.type == "cpu":
        return exact_ap_scan.exact_ap_plain(
            data, blocks, sizes, dict_sizes, hash_bits, hash_width,
            good_len, max_tokens)

    from .. import _build
    lib = _build.kernel_library("csc_k6")
    scratch = new_scratch(b, hash_bits, hash_width, dev)
    tape = torch.zeros((b, max_tokens, 2), dtype=torch.int32, device=dev)
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, p2b_table(dev), scratch, tape, out, btypes)
    LAUNCHES += 1
    return tape, out[0], out[1], out[2], btypes
