"""Wrapper of the K6 kernel (csrc/encode_k6.cu), the exact optimal parse
of m3-m5 priced by the live model: on the card, what csc_tpu's
pipeline hands its golden encoder at m3-m5 (CSC_ENCODE_PARSE=exact,
and streams over its 1 MB device cap).

`parse_k6` checks its tensors, allocates the per-stream hash tables
(int32 zeros, as K5's: ht2 [B, 16384], ht3 [B, 65536], ht6 [B,
hash_width << hash_bits]; at m5, for the tree's kernel
(csc_k6_bt_launch), the binary tree's head [B, 1 << bt_bits] and links
[B, 2 * min(bt_size, N + 1)] in ht6's place, int32 zeros), the model's
p_lit (uint16 [B, 65536], 128 KB a stream) and the stretch's cells
(int32 [B, NFIELD * CELLS], 74 KB a stream), which the kernel sets up,
the tape, the counters and the block types, and launches the kernel on
the current CUDA stream, one warp (a block) a stream: two kernels, the
streams their dictionary covers and those longer than it (golden's ring
window), each block of the other kind returning at once; a stream of at
most 64 KB is staged in the block's shared memory (`smem_bytes`,
`blocks_per_sm`).  For tensors on the CPU
it runs the plain version (ops/exact_ap_scan.py) instead; on any other
device it raises.  LAUNCHES counts the calls that launch K6, TREE_LAUNCHES
those of them that launch its binary-tree kernels (m5), RING_LAUNCHES
those of them whose ring kernel has a stream to parse (one longer than its
dictionary: every launch starts the ring kernel, whose blocks return at
once where it has none) and TREE_RING_LAUNCHES those of them at m5.
"""
import ctypes

import numpy as np
import torch

from . import exact_ap_scan, exact_kernel, prices

LAUNCHES = 0
TREE_LAUNCHES = 0
RING_LAUNCHES = 0
TREE_RING_LAUNCHES = 0
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


def tree_bytes(b, n, bt, bt_sizes):
    """The device bytes of the binary tree of b streams n bytes wide
    (head and links, `new_scratch`'s), 0 without one."""
    if bt is None or not bt.size:
        return 0
    return 4 * b * ((1 << bt.bits) + _stride(n, bt_sizes))


def _stride(n, bt_sizes):
    return 2 * min(int(bt_sizes.max()), n + 1)


def smem_bytes(n):
    """K6's dynamic shared memory a block for streams of n bytes (the
    staged words up to 64 KB, then the model's 2 216 bytes)."""
    return int(_lib_fn("csc_k6_smem", ctypes.c_int64, [ctypes.c_int64])(n))


def blocks_per_sm(n, tree=False, ring=False):
    """K6's resident blocks (streams) per SM on the current card for
    streams of n bytes (tree: m5's kernels; ring: the kernel of streams
    longer than their dictionary), as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them."""
    fn = _lib_fn("csc_k6_bt_blocks_per_sm" if tree else
                 "csc_k6_blocks_per_sm", ctypes.c_int,
                 [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p])
    blocks = ctypes.c_int(0)
    rc = fn(n, int(ring), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K6 occupancy query failed: cudaError_t {rc}")
    return blocks.value


def new_scratch(b, hash_bits, hash_width, device, bt=None, n=0,
                bt_sizes=None):
    """(tables, lit, cells, tree) of b streams: the zeroed hash tables
    (ht2, ht3, ht6), p_lit and the cells (set up by the kernel), and with
    a binary tree bt (exact_ap_scan.BT) for streams n bytes wide of sizes
    bt_sizes, (head, links) zeroed, else None."""
    tree = None
    if bt is not None and bt.size:
        hash_width = 0
        tree = (torch.zeros((b, 1 << bt.bits), dtype=torch.int32,
                            device=device),
                torch.zeros((b, _stride(n, bt_sizes)), dtype=torch.int32,
                            device=device))
    tables = exact_kernel.new_tables(b, hash_bits, hash_width, device)
    lit = torch.empty((b, NLIT), dtype=torch.int16, device=device)
    cells = torch.empty((b, cell_words()), dtype=torch.int32, device=device)
    return tables, lit, cells, tree


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
BT_ARGTYPES = [_P, _I64, _P, _I32, _P, _P, _I32, _I32, _P, _I32, _P, _P, _P,
               _P, _P, _I64, _P, _P, _P, _I64, _P, _P, _I32, _P]


def launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, p2b, scratch, tape, out, btypes, bt=None,
           bt_sizes=None):
    """csc_k6_launch of library `lib` on the current CUDA stream, into the
    caller's scratch (new_scratch's; the tables zeros), tape [B, T, 2],
    out [3, B] (tok_cnt, done, err) and btypes [B, NB] (zeros); with the
    scratch's tree, csc_k6_bt_launch of bt's bits and cycles and the
    streams' bt_sizes ([B] i32 on the card).  Raises if the launch
    fails."""
    b, n = data.shape
    (ht2, ht3, ht6), lit, cells, tree = scratch
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        if tree is None:
            rc = lib.csc_k6_launch(
                data.data_ptr(), n, blocks.data_ptr(), blocks.shape[1],
                sizes.data_ptr(), dict_sizes.data_ptr(), int(hash_bits),
                int(hash_width), int(good_len), p2b.data_ptr(),
                ht2.data_ptr(), ht3.data_ptr(), ht6.data_ptr(),
                lit.data_ptr(), cells.data_ptr(), tape.data_ptr(),
                tape.shape[1], out.data_ptr(), btypes.data_ptr(), b, stream)
        else:
            fn = lib.csc_k6_bt_launch
            fn.restype, fn.argtypes = ctypes.c_int, BT_ARGTYPES
            head, nodes = tree
            rc = fn(data.data_ptr(), n, blocks.data_ptr(), blocks.shape[1],
                    sizes.data_ptr(), dict_sizes.data_ptr(), bt.bits,
                    bt.cyc, bt_sizes.data_ptr(), int(good_len),
                    p2b.data_ptr(), ht2.data_ptr(), ht3.data_ptr(),
                    head.data_ptr(), nodes.data_ptr(), nodes.shape[1],
                    lit.data_ptr(), cells.data_ptr(), tape.data_ptr(),
                    tape.shape[1], out.data_ptr(), btypes.data_ptr(), b,
                    stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError_t {rc}")


def parse_k6(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
             good_len, max_tokens, bt=None, bt_sizes=None, ring=None):
    """Parse B streams (m3-m5; a stream longer than its dictionary
    follows golden's ring window) with golden's optimal parse.

    data: [B, N] u8 LZ input; blocks: [B, NB, 2] i32, the analyzer's block
    table (encode_host.plan_stream(..., exact=True)); sizes, dict_sizes:
    [B] i32; hash_bits, hash_width, good_len: the preset's finder; bt (m5,
    exact_ap_scan.BT): the binary tree's bits and cycles, and its size
    unless bt_sizes ([B] i32) gives each stream's; ring: whether a stream
    is longer than its dictionary, as the caller's host-side sizes say
    (None: read from sizes and dict_sizes before the launch), for
    RING_LAUNCHES alone.
    Returns (tape [B, max_tokens, 2] i32 of (kind | wire_len << 3,
    dist_code), tok_cnt, done, err [B] i32, btypes [B, NB] i32), on data's
    device; err is ERR_OVERFLOW when a token did not fit the tape, or
    ERR_BT where golden's tree faults (a link index past 2 * bt_size),
    either of which ends the stream's parse (done 0); btypes holds each
    block's final type, after the duplicate-block probe (0 for a block
    the parse did not reach).
    """
    global LAUNCHES, TREE_LAUNCHES, RING_LAUNCHES, TREE_RING_LAUNCHES
    dev, b = data.device, data.shape[0]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K6 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")
    exact_ap_scan.check_inputs(data, blocks, sizes, dict_sizes, hash_bits,
                               hash_width, good_len, bt)
    if bt is not None and not bt.size:
        bt = None
    if bt is not None:
        if bt_sizes is None:
            bt_sizes = torch.full((b,), bt.size, dtype=torch.int32,
                                  device=dev)
        if (bt_sizes.dtype != torch.int32 or bt_sizes.shape != (b,)
                or bt_sizes.device != dev or bool((bt_sizes < 32).any())):
            raise ValueError("bt_sizes: want [B] int32 of at least 32 on "
                             "data's device")
    else:
        bt_sizes = None
    for name, t in (("data", data), ("blocks", blocks),
                    ("sizes", sizes), ("dict_sizes", dict_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    if dev.type == "cpu":
        return exact_ap_scan.exact_ap_plain(
            data, blocks, sizes, dict_sizes, hash_bits, hash_width,
            good_len, max_tokens, bt, bt_sizes)

    if ring is None:
        ring = bool((sizes > dict_sizes).any())
    from .. import _build
    lib = _build.kernel_library("csc_k6")
    scratch = new_scratch(b, hash_bits, hash_width, dev, bt, data.shape[1],
                          bt_sizes)
    tape = torch.zeros((b, max_tokens, 2), dtype=torch.int32, device=dev)
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    launch(lib, data, blocks, sizes, dict_sizes, hash_bits, hash_width,
           good_len, p2b_table(dev), scratch, tape, out, btypes, bt,
           bt_sizes)
    LAUNCHES += 1
    TREE_LAUNCHES += bt is not None
    RING_LAUNCHES += ring
    TREE_RING_LAUNCHES += ring and bt is not None
    return tape, out[0], out[1], out[2], btypes
