"""Batched stream decode: host demux -> upload -> K1 -> host inverse
filters.  The counterpart of csc_tpu/ops/pipeline.py `decode_batch` (and
the host side of pallas_decode.py `decode_batch_pallas`), with the device
named by the caller.
"""
import numpy as np
import torch

from csc_tpu import native
from csc_tpu.golden.decoder import DecodeError
from csc_tpu.ops import framing

from .. import constants
from ..constants import DT_EXE, DT_ENGTXT, SIG_EOF, ERR_CORRUPT, MAX_WINDOW
from .decode_kernel import decode_k1


def _bucket(n, lo=4096):
    """Round up to a power of two (>= lo), as csc_tpu's pipeline does."""
    b = lo
    while b < n:
        b *= 2
    return b


def _demux(props_list, blobs, positions):
    rcs, bcs, rce, bce = [], [], [], []
    for props, blob, pos in zip(props_list, blobs, positions):
        rc, bc, re_, be_ = framing.demux_stream(blob, pos,
                                                props.csc_blocksize)
        rcs.append(rc)
        bcs.append(bc)
        rce.append(re_)
        bce.append(be_)
    rc = framing.batch_pad(rcs, 0, np.uint8)
    bc = framing.batch_pad(bcs, 0, np.uint8)
    rc = np.pad(rc, ((0, 0), (0, _bucket(rc.shape[1] + 8) - rc.shape[1])))
    bc = np.pad(bc, ((0, 0), (0, _bucket(bc.shape[1] + 8) - bc.shape[1])))
    return rc, bc, framing.pad_ends(rce), framing.pad_ends(bce)


def _inverse_filters(raw, log, n, end):
    """Host post-pass: EXE / ENGTXT inverse per logged block (the DLT
    inverse is fused in the kernel)."""
    for k in range(n):
        btype, start = log[k]
        stop = log[k + 1][1] if k + 1 < n else end
        if btype == SIG_EOF:
            break
        if btype == DT_EXE:
            seg = bytearray(raw[start:stop])
            native.e89_inverse(seg)
            raw[start:stop] = seg
        elif btype == DT_ENGTXT:
            seg = bytearray(raw[start:stop])
            native.dict_inverse(seg)
            raw[start:stop] = seg


def decode_batch(props_list, blobs, positions=None, out_sizes=None,
                 max_steps=None, *, device):
    """Decode B independent csc streams on `device` (a torch.device).

    props_list: per-stream CSCProps; blobs: physical streams (bytes);
    positions: start offsets; out_sizes: decoded sizes when known.
    Returns list[bytes].  Streams decode in linear window coordinates:
    with out_sizes the window holds the whole output; without them it
    starts at the dictionary size and regrows when a stream outgrows it.
    Raises DecodeError on a corrupt stream, on one that did not finish
    within max_steps, or on a block-log overflow.
    """
    device = torch.device(device)
    b = len(blobs)
    if b == 0:
        raise ValueError("decode_batch needs at least one stream")
    if positions is None:
        positions = [0] * b
    rc, bc, rc_ends, bc_ends = _demux(props_list, blobs, positions)
    rc_t = torch.from_numpy(rc).to(device)
    bc_t = torch.from_numpy(bc).to(device)
    rce_t = torch.from_numpy(rc_ends).to(device)
    bce_t = torch.from_numpy(bc_ends).to(device)

    if out_sizes is not None:
        wnd_size = max(max(out_sizes), 1024)
    else:
        wnd_size = max(p.dict_size for p in props_list)
    wnd_size = _bucket(int(wnd_size))
    max_blocks = constants.MAX_BLOCKS

    while True:
        steps_cap = max_steps
        if steps_cap is None:
            # one step per coded bit, per <= 2 raw bytes, per <= 16 copied
            # bytes: 8*rc + bc + 2*window is generous
            steps_cap = 8 * rc.shape[1] + bc.shape[1] + 64 + 2 * wnd_size
        wnd, blk_log, wnd_pos, done, err, blk_cnt = decode_k1(
            rc_t, bc_t, rce_t, bce_t, wnd_size, steps_cap, max_blocks)
        out_pos = wnd_pos.cpu().numpy()
        if out_sizes is None and int(out_pos.max()) > wnd_size:
            # the output outgrew the dictionary-sized window (dict <
            # output without declared sizes): regrow and decode again
            if wnd_size >= MAX_WINDOW or int(out_pos.max()) > MAX_WINDOW:
                raise DecodeError("decoded output exceeds 1 GB window cap")
            wnd_size = min(_bucket(int(out_pos.max()) * 2), MAX_WINDOW)
            continue
        break

    done = done.cpu().numpy()
    err = err.cpu().numpy()
    blk_cnt = blk_cnt.cpu().numpy()
    bad = [i for i in range(b) if err[i] == ERR_CORRUPT or not done[i]]
    if bad:
        raise DecodeError(f"corrupt stream(s) in batch: {bad}")
    over = [i for i in range(b) if blk_cnt[i] > max_blocks]
    if over:
        raise DecodeError(f"block log overflow (> {max_blocks} typed "
                          f"blocks) in stream(s): {over}")
    used = max(int(out_pos.max()), 1)
    wnd_np = wnd[:, :used].cpu().numpy()
    log_np = blk_log[:, :max(int(blk_cnt.max()), 1)].cpu().numpy()
    outputs = []
    for i in range(b):
        raw = bytearray(wnd_np[i, :out_pos[i]].tobytes())
        _inverse_filters(raw, log_np[i], int(blk_cnt[i]), int(out_pos[i]))
        outputs.append(bytes(raw))
    return outputs


def decode_stream(props, blob, pos=0, *, device):
    """Single-stream decode through the batched path (B=1)."""
    return decode_batch([props], [blob], [pos], device=device)[0]
