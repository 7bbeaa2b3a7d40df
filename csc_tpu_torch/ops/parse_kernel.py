"""Wrapper of the K2 lazy-parse kernel (csrc/encode_k2.cu): the
counterpart of csc_tpu/ops/pallas_parse.py `parse_batch_pallas` / `_run`.

`parse_k2` checks its tensors, allocates the tape and the counters, and
launches the kernel on the current CUDA stream (one warp a stream; at
most MAX_CAND candidate rows, and every preset has 2 + hash_width <= 10).
For tensors on the CPU it runs the plain PyTorch version
(ops/parse_scan.py) instead; on any other device it raises.  LAUNCHES
counts kernel launches.
"""
import torch

from . import parse_scan

LAUNCHES = 0
MAX_CAND = 12       # encode_k2.cuh: 16 lanes a probe, 4 of them reps


def parse_k2(data, candp, run_ends, run_skip, sizes, dict_sizes, good_len,
             max_tokens):
    """Parse B streams.

    data: [B, N] u8 LZ input; candp: [B, C, N] i32 packed candidates
    (parse_pre.pack_candidates); run_ends / run_skip: [B, R] i32
    cumulative run ends and 1 for runs with no parse; sizes, dict_sizes:
    [B] i32.  Returns (tape [B, max_tokens, 2] i32 of (kind | wire_len <<
    3, dist_code), tok_cnt, done, err [B] i32), on data's device.
    """
    global LAUNCHES
    parse_scan.check_inputs(data, candp, run_ends, run_skip, sizes,
                            dict_sizes)
    for name, t in (("data", data), ("candp", candp), ("run_ends", run_ends),
                    ("run_skip", run_skip), ("sizes", sizes),
                    ("dict_sizes", dict_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_tokens < 1:
        raise ValueError("max_tokens must be >= 1")
    dev, b = data.device, data.shape[0]
    if dev.type == "cpu":
        return parse_scan.parse_plain(data, candp, run_ends, run_skip,
                                      sizes, dict_sizes, good_len,
                                      max_tokens)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")

    if candp.shape[1] > MAX_CAND:
        raise ValueError(f"K2 takes at most {MAX_CAND} candidate rows (2 + "
                         f"hash_width), got {candp.shape[1]}")

    from .. import _build
    lib = _build.kernel_library("csc_k2")
    tape = torch.zeros((b, max_tokens, 2), dtype=torch.int32, device=dev)
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.csc_k2_launch(
            data.data_ptr(), candp.data_ptr(), data.shape[1],
            candp.shape[1], run_ends.data_ptr(), run_skip.data_ptr(),
            run_ends.shape[1], sizes.data_ptr(), dict_sizes.data_ptr(),
            int(good_len), tape.data_ptr(), max_tokens, out.data_ptr(), b,
            stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return tape, out[0], out[1], out[2]
