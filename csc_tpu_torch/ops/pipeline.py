"""Batched stream pipelines on one device (a CUDA card unless the caller
names the CPU, where every kernel wrapper runs its plain version).

decode: host demux -> upload -> K1 -> host inverse filters.  The
counterpart of csc_tpu/ops/pipeline.py `decode_batch` (and the host side
of pallas_decode.py `decode_batch_pallas`).

encode (m1/m2): host plan (analyzer + forward filters) -> candidates
(parse_pre) -> K2 lazy parse -> stitch -> K3 phase-B coder -> host remux.
The counterpart of csc_tpu/ops/pipeline.py `encode_batch` on its fast
path (pipeline.py:335-389).  Where csc_tpu falls back to its host golden
encoder (a stream the planner rejects, one over the 1 MB device cap, the
m3-m5 levels, a K3 output overflow) this port raises EncodeError naming
the stream and the reason: it never encodes on the host.
"""
import numpy as np
import torch

from .. import constants, native
from ..constants import (DT_EXE, DT_ENGTXT, DT_NO_LZ, SIG_EOF, ERR_CORRUPT,
                         MAX_WINDOW, DECODE_ERROR)
from . import encode_host, framing, parse_pre, stitch
from .bits_kernel import code_k3
from .decode_kernel import decode_k1
from .parse_kernel import parse_k2
from .parse_scan import tape_capacity

CUDA = torch.device("cuda")
# LZ input bytes per device encode call: bounds the candidate arrays
# (20 int32 rows per position at m2) and the precompute's temporaries
ENCODE_GROUP_BYTES = 64 * 1024 * 1024


class DecodeError(Exception):
    """A corrupt or unfinished stream (csc_dec.cpp's DECODE_ERROR)."""
    code = DECODE_ERROR


class EncodeError(Exception):
    """A stream the device encode does not take, or a kernel that
    reported an error for it."""


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
                 max_steps=None, *, device=CUDA):
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


def decode_stream(props, blob, pos=0, *, device=CUDA):
    """Single-stream decode through the batched path (B=1)."""
    return decode_batch([props], [blob], [pos], device=device)[0]


# ================================================================= encode
def plan_streams(props_list, datas):
    """Per-stream (lz_input, run_table), or None for an empty stream;
    EncodeError for a stream the device path does not take."""
    plans = []
    for i, (props, data) in enumerate(zip(props_list, datas)):
        if props.lz_mode not in (1, 2) or props.bt_size:
            raise EncodeError(
                f"stream {i}: lz_mode {props.lz_mode} (levels m3-m5, the "
                f"optimal parse) is not ported yet (ROADMAP queue 1 item 5)")
        if len(data) > encode_host.MAX_ENCODE:
            raise EncodeError(
                f"stream {i}: {len(data)} bytes is over the "
                f"{encode_host.MAX_ENCODE}-byte device encode cap; split it")
        if len(data) > props.dict_size:
            # the candidates treat the stream as one window with no wrap
            # (csc_tpu parse_pre.py:6); past the dictionary the reference
            # decoder's ring rejects the matches that cross its end
            raise EncodeError(
                f"stream {i}: {len(data)} bytes is more than its "
                f"{props.dict_size}-byte dictionary; the fast parse needs "
                f"the dictionary to cover the stream")
        plans.append(encode_host.plan_stream(props, data) if data else None)
    return plans


def _groups(props_list, plans):
    """Stream indices grouped by preset (a device call runs one preset),
    each group cut into calls of at most ENCODE_GROUP_BYTES of input."""
    by_preset = {}
    for i, plan in enumerate(plans):
        if plan is not None:
            p = props_list[i]
            by_preset.setdefault((p.hash_bits, p.hash_width, p.good_len,
                                  p.lz_mode, p.csc_blocksize), []).append(i)
    groups = []
    for key in sorted(by_preset):
        cur, nbytes = [], 0
        for i in sorted(by_preset[key], key=lambda i: len(plans[i][0])):
            n = len(plans[i][0])
            if cur and nbytes + n > ENCODE_GROUP_BYTES:
                groups.append(cur)
                cur, nbytes = [], 0
            cur.append(i)
            nbytes += n
        groups.append(cur)
    return groups


def group_inputs(props_list, plans, idxs, device):
    """The device inputs of one group: data [B, N] u8, run_ends and
    run_skip [B, R] i32, sizes and dict_sizes [B] i32."""
    lz = [plans[i][0] for i in idxs]
    rts = [plans[i][1] for i in idxs]
    n = max(len(x) for x in lz)
    r = max(len(rt) for rt in rts)
    data = np.zeros((len(idxs), n), np.uint8)
    run_ends = np.zeros((len(idxs), r), np.int32)
    run_skip = np.zeros((len(idxs), r), np.int32)
    for j, (x, rt) in enumerate(zip(lz, rts)):
        data[j, :len(x)] = np.frombuffer(x, np.uint8)
        run_ends[j, :len(rt)] = np.cumsum([run[1] for run in rt])
        run_ends[j, len(rt):] = len(x)
        run_skip[j, :len(rt)] = [run[0] >= DT_NO_LZ for run in rt]
    sizes = np.array([len(x) for x in lz], np.int32)
    dicts = np.array([props_list[i].dict_size for i in idxs], np.int32)
    return [torch.from_numpy(a).to(device)
            for a in (data, run_ends, run_skip, sizes, dicts)]


def k3_shapes(props, n, run_tables):
    """K3's output sizes for a group of streams of at most n LZ input
    bytes: (max_rc, max_bc, nmap, nchunk, bsize); the buffers as csc_tpu
    sizes them (its pipeline.py:369-370), the crossing maps from the
    capacity over the block size, the chunk log from the run tables."""
    bsize = props.csc_blocksize
    max_rc, max_bc = 2 * n + 4096, n + 4096
    nchunk = max(1, max(sum(1 for run in rt if run[3]) for rt in run_tables))
    return max_rc, max_bc, max(max_rc, max_bc) // bsize + 1, nchunk, bsize


def remux_group(props, coded):
    """Host remux of K3's outputs into physical streams."""
    rc_out, bc_out, rc_map, bc_map, clog, stats = coded
    stats = stats.cpu().numpy()
    rc_cnt, bc_cnt, chunk_cnt = stats[0], stats[1], stats[2]
    rc_np = rc_out[:, :max(int(rc_cnt.max()), 1)].cpu().numpy()
    bc_np = bc_out[:, :max(int(bc_cnt.max()), 1)].cpu().numpy()
    rcm, bcm, cl = (t.cpu().numpy() for t in (rc_map, bc_map, clog))
    return [encode_host.remux_stream(
        props.csc_blocksize, rc_np[j, :rc_cnt[j]].tobytes(),
        bc_np[j, :bc_cnt[j]].tobytes(), rcm[j], bcm[j],
        chunk_ends=[tuple(int(v) for v in cl[j, k])
                    for k in range(chunk_cnt[j])])
        for j in range(len(rc_cnt))]


def encode_group(props_list, plans, idxs, device, on_stage=None):
    """Encode the streams `idxs` of a batch, all of one preset, on
    `device` from their encode_host.plan_stream plans: candidates, K2,
    stitch, K3, remux.  Returns their raw streams in `idxs` order.

    on_stage, when given, is called as on_stage(name, **values) after each
    stage, so a caller can time the stages and hold each kernel to its
    plain version on the inputs this path gives it:
      "precompute"  cand ([B, 2C, N] candidates), k2_args (K2's arguments)
      "k2"          k2_out (K2's outputs)
      "stitch"      stitch_args (the stitch's), k3_args (K3's arguments)
      "k3"          k3_out (K3's outputs)
      "remux"       outs (the raw streams)
    """
    note = on_stage or (lambda name, **values: None)
    p0 = props_list[idxs[0]]
    data, run_ends, run_skip, sizes, dicts = group_inputs(
        props_list, plans, idxs, device)
    cand = parse_pre.precompute_candidates(data, run_ends, p0.hash_bits,
                                           p0.hash_width)
    k2_args = (data, parse_pre.pack_candidates(cand), run_ends, run_skip,
               sizes, dicts, p0.good_len,
               tape_capacity(data.shape[1], run_ends.shape[1]))
    note("precompute", cand=cand, k2_args=k2_args)
    del cand
    k2_out = parse_k2(*k2_args)
    note("k2", k2_out=k2_out)
    tape, tok_cnt, done, err = k2_out
    tok_cnt, done, err = (t.cpu().numpy() for t in (tok_cnt, done, err))
    bad = [idxs[j] for j in range(len(idxs)) if err[j] or not done[j]]
    if bad:
        raise EncodeError(f"stream(s) {bad}: the parse did not finish")
    tape = tape[:, :int(tok_cnt.max())].contiguous()
    run_tables = [plans[i][1] for i in idxs]
    kk, aa, bb, cc, _ = stitch.stitch_tapes(tape, data, run_tables)
    k3_args = (kk, aa, bb, cc, *k3_shapes(p0, data.shape[1], run_tables))
    note("stitch", stitch_args=(tape, data, run_tables), k3_args=k3_args)
    coded = code_k3(*k3_args)
    note("k3", k3_out=coded)
    stats = coded[5].cpu().numpy()
    over = [idxs[j] for j in range(len(idxs)) if stats[4, j]]
    if over:
        raise EncodeError(f"stream(s) {over}: K3 output overflow "
                          f"(coded bytes past the output capacity)")
    unfinished = [idxs[j] for j in range(len(idxs)) if not stats[3, j]]
    if unfinished:
        raise EncodeError(f"stream(s) {unfinished}: K3 did not reach "
                          f"K_END")
    outs = remux_group(p0, coded)
    note("remux", outs=outs)
    return outs


def encode_batch(props_list, datas, *, device=CUDA, on_stage=None):
    """Encode B independent streams at m1/m2 on `device`.

    Returns list[bytes], the raw streams without the property header,
    byte-identical to csc_tpu's encode_batch on its fast path.  Streams
    are grouped by preset (one device call per preset and size group).
    An empty stream is the SIG_EOF chunk alone.  Raises EncodeError for
    a stream it cannot take (m3-m5, over MAX_ENCODE, longer than its
    dictionary) or that a kernel flags.  on_stage: as encode_group's,
    called once more as on_stage("plan", plans=...) after the host plan.
    """
    device = torch.device(device)
    if len(props_list) != len(datas):
        raise ValueError("one props per stream")
    plans = plan_streams(props_list, datas)
    if on_stage:
        on_stage("plan", plans=plans)
    outs = [None] * len(datas)
    for i, plan in enumerate(plans):
        if plan is None:
            outs[i] = encode_host.remux_stream(
                props_list[i].csc_blocksize, b"", b"", [], [],
                chunk_ends=[])
    for idxs in _groups(props_list, plans):
        for i, out in zip(idxs, encode_group(props_list, plans, idxs,
                                              device, on_stage)):
            outs[i] = out
    return outs


def encode_stream(props, data, *, device=CUDA):
    """Single-stream encode through the batched path (B=1)."""
    return encode_batch([props], [data], device=device)[0]
