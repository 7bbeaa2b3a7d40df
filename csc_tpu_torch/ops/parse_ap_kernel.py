"""Wrapper of the K4 optimal-parse kernel (csrc/encode_k4.cu): the
counterpart of csc_tpu/ops/parse_ap.py `run_ap_parse` as csc_tpu's
pipeline drives it at m3-m5.

`parse_k4` checks its tensors, allocates the tape and the counters, and
launches the kernel on the current CUDA stream (one warp a stream; at
most MAX_CAND candidate rows and good_len <= MAX_GOOD_LEN, which every
preset meets: C = 4 or 10, good_len 16, 24 or 48).  The DP cells live in
each block's shared memory.  For tensors on the CPU it runs the plain
PyTorch version (ops/parse_ap_scan.py) instead; on any other device it
raises.  LAUNCHES counts kernel launches.

`launch` is the raw launch, whose `cells` argument may take a [B, 10, N]
int32 debug copy of the cells (`new_cells`; rows price, stamp, back,
ndist, nstate, nxt, nrep[4]) that every cell write updates: the card
tests hold it against the plain version's cells.  `smem_bytes` and
`blocks_per_sm` read a block's shared memory and the blocks an SM holds.
"""
import ctypes

import torch

from . import parse_ap_scan

LAUNCHES = 0
MAX_CAND = 12       # encode_k4.cuh
MAX_GOOD_LEN = 64
CELL_ROWS = 10      # price, stamp, back, ndist, nstate, nxt, nrep[4]


def new_cells(b, n, device):
    """A [B, 10, N] int32 cell array as the plain version starts it: zeros,
    the stamps at -1."""
    cells = torch.zeros((b, CELL_ROWS, n), dtype=torch.int32, device=device)
    cells[:, 1] = -1
    return cells


def launch(lib, data, candp, run_ends, run_skip, sizes, dict_sizes, prices,
           good_len, tape, max_steps, cells, out):
    """csc_k4_launch of library `lib` on the current CUDA stream, into the
    caller's tape [B, T, 2], out [4, B] (tok_cnt, done, err, finds) and
    cells (a [B, 10, N] tensor, or None for no copy); raises if the launch
    fails."""
    b, n = data.shape
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.csc_k4_launch(
            data.data_ptr(), candp.data_ptr(), n, candp.shape[1],
            run_ends.data_ptr(), run_skip.data_ptr(), run_ends.shape[1],
            sizes.data_ptr(), dict_sizes.data_ptr(), int(good_len),
            prices.data_ptr(), tape.data_ptr(), tape.shape[1],
            int(max_steps), None if cells is None else cells.data_ptr(),
            out.data_ptr(), b, stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError_t {rc}")


def smem_bytes(n):
    """K4's dynamic shared memory a block for streams of n bytes."""
    from .. import _build
    fn = _build.kernel_library("csc_k4").csc_k4_smem
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64]
    return int(fn(n))


def blocks_per_sm(n):
    """K4's resident blocks (streams) per SM on the current card for
    streams of n bytes, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
    gives them."""
    from .. import _build
    fn = _build.kernel_library("csc_k4").csc_k4_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    blocks = ctypes.c_int(0)
    rc = fn(n, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K4 occupancy query failed: cudaError_t {rc}")
    return blocks.value


def parse_k4(data, candp, run_ends, run_skip, sizes, dict_sizes, prices,
             good_len, max_tokens, max_steps=None):
    """Parse B streams.

    data: [B, N] u8 LZ input; candp: [B, C, N] i32 packed candidates
    (parse_pre.pack_candidates, C = 2 + hash_width or 10 at m5);
    run_ends / run_skip: [B, R] i32 cumulative run ends and 1 for runs
    with no parse; sizes, dict_sizes: [B] i32; prices: [736] i32
    (prices.pack_prices); max_steps: the lockstep step budget
    (parse_ap_scan.max_steps_for(N) by default).  Returns (tape [B,
    max_tokens, 2] i32 of (kind | wire_len << 3, dist_code), tok_cnt,
    done, err, finds [B] i32), on data's device; err is ERR_OVERFLOW (the
    tape filled) or ERR_STEPS (the budget ran out); finds counts the FIND
    positions at which the lanes ran, each reading its C candidate rows.
    """
    global LAUNCHES
    parse_ap_scan.check_inputs(data, candp, run_ends, run_skip, sizes,
                               dict_sizes, prices)
    for name, t in (("data", data), ("candp", candp), ("run_ends", run_ends),
                    ("run_skip", run_skip), ("sizes", sizes),
                    ("dict_sizes", dict_sizes), ("prices", prices)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    if not 2 <= good_len <= MAX_GOOD_LEN:
        raise ValueError(f"good_len must be in [2, {MAX_GOOD_LEN}], got "
                         f"{good_len}")
    if max_steps is None:
        max_steps = parse_ap_scan.max_steps_for(data.shape[1])
    dev, b = data.device, data.shape[0]
    if dev.type == "cpu":
        return parse_ap_scan.parse_ap_plain(
            data, candp, run_ends, run_skip, sizes, dict_sizes, prices,
            good_len, max_tokens, max_steps)
    if dev.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")
    if candp.shape[1] > MAX_CAND:
        raise ValueError(f"K4 takes at most {MAX_CAND} candidate rows, got "
                         f"{candp.shape[1]}")

    from .. import _build
    lib = _build.kernel_library("csc_k4")
    tape = torch.zeros((b, max_tokens, 2), dtype=torch.int32, device=dev)
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    launch(lib, data, candp, run_ends, run_skip, sizes, dict_sizes, prices,
           good_len, tape, max_steps, None, out)
    LAUNCHES += 1
    return tape, out[0], out[1], out[2], out[3]
