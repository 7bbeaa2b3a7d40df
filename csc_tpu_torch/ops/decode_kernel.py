"""Wrapper of the K1 decode kernel (csrc/decode_k1.cu): the counterpart of
csc_tpu/ops/pallas_decode.py `_run` / `_run_fused`.

`decode_k1` checks its tensors, allocates the outputs and scratch, and
launches the kernel on the current CUDA stream.  For tensors on the CPU
it runs the plain PyTorch version (ops/decode_scan.py) instead; on any
other device it raises.  LAUNCHES counts kernel launches.
"""
import torch

from ..constants import COPY_CHUNK, MAX_BLOCKS, NPROB, P_DELTA
from . import decode_scan

LAUNCHES = 0


def decode_k1(rc, bc, rc_ends, bc_ends, wnd_size, max_steps,
              max_blocks=MAX_BLOCKS):
    """Decode B demuxed streams.

    rc, bc: [B, L] u8 padded coder bytes; rc_ends, bc_ends: [B, NB] i32
    cumulative block ends padded with 0x7FFFFFFF.  Returns (wnd
    [B, wnd_size + 16] u8, blk_log [B, max_blocks, 2] i32, wnd_pos, done,
    err, blk_cnt [B] i32), on rc's device.
    """
    global LAUNCHES
    decode_scan.check_inputs(rc, bc, rc_ends, bc_ends)
    for name, t in (("rc", rc), ("bc", bc), ("rc_ends", rc_ends),
                    ("bc_ends", bc_ends)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_blocks < 1 or wnd_size < 1:
        raise ValueError("max_blocks and wnd_size must be >= 1")
    dev, b = rc.device, rc.shape[0]
    if dev.type == "cpu":
        return decode_scan.decode_plain(rc, bc, rc_ends, bc_ends, wnd_size,
                                        max_steps, max_blocks)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")

    from .. import _build
    lib = _build.kernel_library("csc_k1")
    stride = wnd_size + COPY_CHUNK
    wnd = torch.zeros((b, stride), dtype=torch.uint8, device=dev)
    blk_log = torch.zeros((b, max_blocks, 2), dtype=torch.int32, device=dev)
    # p_delta scratch: uint16_t in the kernel, 2048 fits int16
    pdelta = torch.full((b, NPROB - P_DELTA), 2048, dtype=torch.int16,
                        device=dev)
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_err = lib.csc_k1_launch(
            rc.data_ptr(), rc.shape[1], bc.data_ptr(), bc.shape[1],
            rc_ends.data_ptr(), rc_ends.shape[1],
            bc_ends.data_ptr(), bc_ends.shape[1],
            wnd.data_ptr(), stride, wnd_size, pdelta.data_ptr(),
            blk_log.data_ptr(), max_blocks, int(max_steps), out.data_ptr(),
            b, stream)
    if rc_err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc_err}")
    LAUNCHES += 1
    return wnd, blk_log, out[0], out[1], out[2], out[3]
