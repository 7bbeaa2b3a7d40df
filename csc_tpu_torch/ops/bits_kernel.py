"""Wrapper of the K3 phase-B coder kernel (csrc/encode_k3.cu): the
counterpart of csc_tpu/ops/pallas_encode.py `encode_bits_pallas` / `_run`.

`code_k3` checks its tensors, allocates the outputs and the p_delta
scratch, and launches the kernel on the current CUDA stream.  For tensors
on the CPU it runs the plain PyTorch version (ops/bits_scan.py) instead;
on any other device it raises.  LAUNCHES counts kernel launches.
"""
import torch

from ..constants import NPROB, P_DELTA
from . import bits_scan

LAUNCHES = 0


def code_k3(kind, a, b, c, max_rc, max_bc, nmap, nchunk, bsize):
    """Code B stitched tapes (four [B, T] int32 tensors, K_END filled).

    Returns (rc_out [B, max_rc] u8, bc_out [B, max_bc] u8, rc_blkmap and
    bc_blkmap [B, nmap] i32, chunk_log [B, nchunk, 2] i32, stats [5, B]
    i32 rows rc_cnt, bc_cnt, chunk_cnt, done, err), on the tapes' device.
    """
    global LAUNCHES
    bits_scan.check_inputs(kind, a, b, c)
    for name, t in (("kind", kind), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"tape {name} must be contiguous")
    if min(max_rc, max_bc, nmap, nchunk, bsize) < 1:
        raise ValueError("max_rc, max_bc, nmap, nchunk and bsize must be "
                         ">= 1")
    dev, bsz = kind.device, kind.shape[0]
    if dev.type == "cpu":
        return bits_scan.bits_plain(kind, a, b, c, max_rc, max_bc, nmap,
                                    nchunk, bsize)
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors (or the plain version "
                         f"on CPU ones), not on {dev}")

    from .. import _build
    lib = _build.kernel_library("csc_k3")
    rc_out = torch.zeros((bsz, max_rc), dtype=torch.uint8, device=dev)
    bc_out = torch.zeros((bsz, max_bc), dtype=torch.uint8, device=dev)
    rc_map = torch.zeros((bsz, nmap), dtype=torch.int32, device=dev)
    bc_map = torch.zeros((bsz, nmap), dtype=torch.int32, device=dev)
    clog = torch.zeros((bsz, nchunk, 2), dtype=torch.int32, device=dev)
    # p_delta scratch: uint16_t in the kernel, 2048 fits int16
    pdelta = torch.full((bsz, NPROB - P_DELTA), 2048, dtype=torch.int16,
                        device=dev)
    stats = torch.empty((5, bsz), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.csc_k3_launch(
            kind.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            kind.shape[1], rc_out.data_ptr(), max_rc, bc_out.data_ptr(),
            max_bc, rc_map.data_ptr(), bc_map.data_ptr(), nmap,
            clog.data_ptr(), nchunk, bsize, pdelta.data_ptr(),
            stats.data_ptr(), bsz, stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError_t {rc}")
    LAUNCHES += 1
    return rc_out, bc_out, rc_map, bc_map, clog, stats
