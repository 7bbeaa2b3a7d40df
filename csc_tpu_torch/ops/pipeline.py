"""Batched stream pipelines on one device (a CUDA card unless the caller
names the CPU, where every kernel wrapper runs its plain version).

decode: host demux -> upload -> K1 -> host inverse filters.  The
counterpart of csc_tpu/ops/pipeline.py `decode_batch` (and the host side
of pallas_decode.py `decode_batch_pallas`).

encode: host plan (analyzer + forward filters) -> candidates (parse_pre)
-> K2 lazy parse (m1/m2) or K4 optimal parse (m3-m5) -> stitch -> K3
phase-B coder -> host remux.  The counterpart of csc_tpu/ops/pipeline.py
`encode_batch` on its fast path (pipeline.py:335-389 and, at m3-m5,
391-467).  With parse="exact" (csc_tpu's CSC_ENCODE_PARSE=exact, m1-m4):
host plan (the analyzer's 8 KB blocks) -> K5, the exact lazy parse of m1
/ m2 with live hash tables, or K6, the exact optimal parse of m3 / m4
priced by the live model, either of which also makes the duplicate-block
probe and merges the blocks into runs -> the run table rebuilt from the
parse's block types -> stitch -> K3 -> remux, byte-identical to the
reference encoder: csc_tpu's bytes under CSC_ENCODE_PARSE=exact, where
csc_tpu takes a stream with a BAD / ENTROPY / DLT run, one over its 1 MB
device cap or, at m3 / m4, every stream to its golden encoder, and the
port's exact parse writes golden's bytes on the card.  An m1-m4 stream
over MAX_ENCODE takes the exact parse under parse="fast" too, as csc_tpu
takes it to golden (pipeline.py:240-262), and so does an m1 / m2 one
longer than its dictionary, whose window wraps as a ring of the
dictionary's size (golden's bytes; csc_tpu's fast path writes a stream
golden rejects there).  Where csc_tpu still falls back to golden and the
port has no device path (m5 under the exact parse or over the cap, m3-m5
past its dictionary, a stream over 1 GB, a K3 output overflow) this port
raises EncodeError naming the stream and the reason: it never encodes on
the host.
"""
import numpy as np
import torch

from .. import constants, native
from ..constants import (DT_EXE, DT_ENGTXT, DT_NO_LZ, SIG_EOF, ERR_CORRUPT,
                         ERR_OVERFLOW, ERR_STEPS, MAX_WINDOW, DECODE_ERROR,
                         MIN_BLOCK_SIZE)
from . import encode_host, exact_scan, framing, parse_pre, prices, stitch
from .bits_kernel import code_k3
from .decode_kernel import decode_k1
from .exact_ap_kernel import parse_k6
from .exact_kernel import parse_k5
from .parse_ap_kernel import parse_k4
from .parse_ap_scan import max_steps_for
from .parse_kernel import parse_k2
from .parse_scan import tape_capacity

CUDA = torch.device("cuda")
# LZ input bytes per device encode call: bounds the candidate arrays
# (20 int32 rows per position at m2) and the precompute's temporaries,
# and under the exact parse the hash tables (576 KB a 16 KB stream at m1,
# 64 MB a 32 MB one at m2); a longer stream is a call of its own
ENCODE_GROUP_BYTES = 64 * 1024 * 1024
PARSES = ("fast", "exact")


class DecodeError(Exception):
    """A corrupt or unfinished stream (csc_dec.cpp's DECODE_ERROR)."""
    code = DECODE_ERROR


class EncodeError(Exception):
    """A stream the device encode does not take, or a kernel that
    reported an error for it; `streams` lists the indices in the batch
    of the streams at fault."""

    def __init__(self, message, streams=()):
        super().__init__(message)
        self.streams = list(streams)


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
    K1's log of typed blocks is sized alike: with out_sizes, an entry for
    each 8 KB block and each raw chunk of a stream, and 2 more (the most
    of any stream); without them MAX_BLOCKS, regrown when a stream logs
    more.  Raises
    DecodeError on a corrupt stream or on one that did not finish within
    max_steps.
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
    if out_sizes is not None:
        max_blocks = max(-(-n // MIN_BLOCK_SIZE) - (-n // p.raw_blocksize)
                         + 2 for n, p in zip(out_sizes, props_list))
    else:
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
        logged = int(blk_cnt.max())
        if out_sizes is None and logged > max_blocks:
            # more typed blocks than the log held: size it and decode again
            max_blocks = logged
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
def exact_refusal(props):
    """Why the exact parse does not take a stream of this preset, which
    csc_tpu encodes with its golden encoder (pipeline.py:229-262), or
    None: the exact parse is the lazy parse of m1 / m2 (K5) and the
    optimal parse of m3 / m4 (K6), whose finders are hash chains; m5's
    binary-tree finder (bt_size > 0) has none yet."""
    if props.bt_size:
        return (f"the exact parse has no binary-tree finder (m5, bt_size "
                f"{props.bt_size}): it takes m1-m4")
    return None


def plan_streams(props_list, datas, parse="fast"):
    """Per-stream plans, or None for an empty stream: an
    encode_host.FastPlan for the fast parse, an ExactPlan for the exact
    one (each says its parse).
    An m1-m4 stream over MAX_ENCODE, or an m1 / m2 one longer than its
    dictionary, takes the exact parse whatever `parse` says: csc_tpu
    hands the first to golden, and its fast path writes a stream golden
    rejects for the second (ROADMAP queue 3), where the exact parse
    writes golden's bytes.  EncodeError for a stream the device path does
    not take: over MAX_WINDOW (1 GB), at m5 under the exact parse or over
    the cap, or at m3-m5 past its dictionary."""
    if parse not in PARSES:
        raise ValueError(f"parse must be one of {PARSES}, got {parse!r}")
    plans = []
    for i, (props, data) in enumerate(zip(props_list, datas)):
        if props.lz_mode not in (1, 2, 3):
            raise EncodeError(f"stream {i}: lz_mode {props.lz_mode} has no "
                              f"device parse", [i])
        if len(data) > MAX_WINDOW:
            # K5 counts positions in int32 from vld_rge on
            raise EncodeError(f"stream {i}: {len(data)} bytes is more than "
                              f"the {MAX_WINDOW}-byte window limit", [i])
        big = len(data) > encode_host.MAX_ENCODE
        # a stream longer than its dictionary meets golden's ring window,
        # which only the exact parse follows (the fast parse treats the
        # stream as one window with no wrap, csc_tpu parse_pre.py:6)
        ring = len(data) > props.dict_size
        reason = exact_refusal(props)
        if ring and props.lz_mode == 3:
            # golden's ring window is followed by K5 alone (m1 / m2)
            raise EncodeError(
                f"stream {i}: {len(data)} bytes is more than its "
                f"{props.dict_size}-byte dictionary and the exact parse "
                f"of lz_mode 3 (m3-m5) does not follow golden's ring window "
                f"yet; only the exact parse of m1 / m2 follows the ring "
                f"window past the dictionary", [i])
        if big and reason:
            raise EncodeError(
                f"stream {i}: {len(data)} bytes is over the "
                f"{encode_host.MAX_ENCODE}-byte cap of the fast parse and "
                f"{reason}; split it", [i])
        if parse == "exact" and reason:
            raise EncodeError(f"stream {i}: {reason}; csc_tpu encodes it "
                              f"with its golden encoder", [i])
        plans.append(encode_host.plan_stream(
            props, data, exact=parse == "exact" or big or ring)
            if data else None)
    return plans


def _groups(props_list, plans):
    """(stream indices, width) of each device call: streams grouped by
    preset and parse (a call runs one), each group cut into calls of at
    most ENCODE_GROUP_BYTES of input (a longer stream alone).  At m3-m5 a
    preset's streams are first split by their power-of-two size bucket
    and the width is csc_tpu's for the bucket (`ap_width`); under the
    exact parse the width is csc_tpu's for the preset's streams, `ap_width`
    too (pipeline.py:307), streams over MAX_ENCODE split off by their
    bucket (csc_tpu codes them with golden; the exact parse's output does
    not depend on the width, so the bucket only spares a short stream a
    long one's width; a stream longer than its dictionary is grouped the
    same way, K5 choosing the ring's parse for it alone); at m1 / m2 on
    the fast parse it is the call's longest stream (None)."""
    by_preset = {}
    for i, plan in enumerate(plans):
        if plan is not None:
            p = props_list[i]
            key = (p.hash_bits, p.hash_width, p.good_len, p.lz_mode,
                   p.csc_blocksize, plan.parse == "exact")
            if p.lz_mode == 3:
                key += (_bucket(len(plan.lz)),)
            elif plan.parse == "exact":
                key += (_bucket(max(len(plan.lz), encode_host.MAX_ENCODE)),)
            by_preset.setdefault(key, []).append(i)
    groups = []
    for key in sorted(by_preset):
        idxs = sorted(by_preset[key], key=lambda i: len(plans[i].lz))
        width = (ap_width([plans[i] for i in idxs])
                 if key[5] or key[3] == 3 else None)
        cur, nbytes = [], 0
        for i in idxs:
            n = len(plans[i].lz)
            if cur and nbytes + n > ENCODE_GROUP_BYTES:
                groups.append((cur, width))
                cur, nbytes = [], 0
            cur.append(i)
            nbytes += n
        groups.append((cur, width))
    return groups


def ap_width(plans):
    """The cell width the optimal parse of these streams runs at: csc_tpu's
    group width for them (pipeline.py:266-276, 302-309), the smallest 2^k
    or 3 * 2^(k-1), at least 1024, that holds the longest
    (pallas_decode.py `_bucket15`).  The parse's output depends on it: a
    match into the last column of the cells is undone
    (ops/parse_ap_scan.py), which touches a stream only when it is exactly
    that long."""
    n = max(len(plan.lz) for plan in plans)
    b = 1024
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


def _data_inputs(props_list, plans, idxs, width):
    """data [B, N] u8 (N = width, or the longest stream), sizes and
    dict_sizes [B] i32 of one group, as numpy arrays."""
    lz = [plans[i].lz for i in idxs]
    n = max(len(x) for x in lz)
    if width is not None:
        if width < n:
            raise ValueError(f"width {width} < the longest stream, {n}")
        n = width
    data = np.zeros((len(idxs), n), np.uint8)
    for j, x in enumerate(lz):
        data[j, :len(x)] = np.frombuffer(x, np.uint8)
    sizes = np.array([len(x) for x in lz], np.int32)
    dicts = np.array([props_list[i].dict_size for i in idxs], np.int32)
    return data, sizes, dicts


def group_inputs(props_list, plans, idxs, device, width=None):
    """The device inputs of one group of fast plans: data [B, N] u8 (N =
    width, or the longest stream), run_ends and run_skip [B, R] i32,
    sizes and dict_sizes [B] i32."""
    data, sizes, dicts = _data_inputs(props_list, plans, idxs, width)
    rts = [plans[i].runs for i in idxs]
    r = max(len(rt) for rt in rts)
    run_ends = np.zeros((len(idxs), r), np.int32)
    run_skip = np.zeros((len(idxs), r), np.int32)
    for j, rt in enumerate(rts):
        run_ends[j, :len(rt)] = np.cumsum([run[1] for run in rt])
        run_ends[j, len(rt):] = sizes[j]
        run_skip[j, :len(rt)] = [run[0] >= DT_NO_LZ for run in rt]
    return [torch.from_numpy(a).to(device)
            for a in (data, run_ends, run_skip, sizes, dicts)]


def block_inputs(props_list, plans, idxs, device, width=None):
    """K5's inputs of one group of exact plans: data [B, N] u8 (N =
    width, or the longest stream), blocks [B, NB, 2] i32 (the plans'
    block tables; a shorter table padded with blocks that end at the
    stream's end, which the parse never reaches), sizes and dict_sizes [B]
    i32."""
    data, sizes, dicts = _data_inputs(props_list, plans, idxs, width)
    tables = [plans[i].blocks for i in idxs]
    blocks = np.zeros((len(idxs), max(len(t) for t in tables), 2), np.int32)
    for j, t in enumerate(tables):
        blocks[j, :len(t)] = t
        blocks[j, len(t):, 0] = sizes[j]
    return [torch.from_numpy(a).to(device)
            for a in (data, blocks, sizes, dicts)]


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


def encode_group(props_list, plans, idxs, device, on_stage=None,
                 width=None):
    """Encode the streams `idxs` of a batch, all of one preset and parse,
    on `device` from their plans (plan_streams'): candidates, K2 (m1 /
    m2) or K4 (m3-m5), stitch, K3, remux; for exact plans K5 (m1 / m2)
    or K6 (m3 / m4), with no candidates, in the parse's place, and the
    run tables rebuilt from its block types.  Returns their raw streams
    in `idxs` order.
    width: the data width (the longest stream by default; at m3-m5 and
    under the exact parse, `ap_width` of the streams).

    on_stage, when given, is called as on_stage(name, **values) after each
    stage, so a caller can time the stages and hold each kernel to its
    plain version on the inputs this path gives it:
      "precompute"  cand ([B, 2C, N] candidates), k2_args or k4_args (the
                    parse kernel's arguments)
      "k2" / "k4"   k2_out / k4_out (its outputs)
      "k5" / "k6"   under the exact parse, in place of the two above:
                    k5_args and k5_out (K5's arguments and outputs, m1 /
                    m2), or k6_args and k6_out (K6's, m3 / m4)
      "stitch"      stitch_args (the stitch's), k3_args (K3's arguments)
      "k3"          k3_out (K3's outputs)
      "remux"       outs (the raw streams)
    """
    note = on_stage or (lambda name, **values: None)
    p0 = props_list[idxs[0]]
    ap = p0.lz_mode == 3
    exact = plans[idxs[0]].parse == "exact"
    if exact:
        reason = exact_refusal(p0)
        if reason:
            raise EncodeError(f"stream(s) {list(idxs)}: {reason}", idxs)
    if (ap or exact) and width is None:
        width = ap_width([plans[i] for i in idxs])
    if exact:
        # the exact parse probes its own hash tables: no candidates
        data, blocks, sizes, dicts = block_inputs(props_list, plans, idxs,
                                                  device, width)
        n = data.shape[1]
        args = (data, blocks, sizes, dicts, p0.hash_bits, p0.hash_width,
                p0.good_len)
        if ap:
            args += (tape_capacity(n, blocks.shape[1]),)
            out = parse_k6(*args)
            note("k6", k6_args=args, k6_out=out)
        else:
            args += (p0.lz_mode == 2, tape_capacity(n, blocks.shape[1]),
                     exact_scan.max_steps_for(n))
            out = parse_k5(*args)
            note("k5", k5_args=args, k5_out=out)
    else:
        data, run_ends, run_skip, sizes, dicts = group_inputs(
            props_list, plans, idxs, device, width)
        n = data.shape[1]
        tcap = tape_capacity(n, run_ends.shape[1])
        # m5's binary-tree finder is stood in for by width-8 chains
        # (csc_tpu pipeline.py:391-399)
        hash_width = (p0.hash_width or 8) if ap else p0.hash_width
        cand = parse_pre.precompute_candidates(data, run_ends, p0.hash_bits,
                                               hash_width)
        args = (data, parse_pre.pack_candidates(cand), run_ends, run_skip,
                sizes, dicts)
        if ap:
            kernel = "k4"
            args += (torch.from_numpy(prices.pack_prices(
                prices.snapshot_prices())).to(device), p0.good_len, tcap,
                max_steps_for(n))
        else:
            kernel = "k2"
            args += (p0.good_len, tcap)
        note("precompute", cand=cand, **{kernel + "_args": args})
        del cand
        out = (parse_k4 if ap else parse_k2)(*args)
        note(kernel, **{kernel + "_out": out})
    tape, tok_cnt, done, err = out[:4]
    tok_cnt, done, err = (t.cpu().numpy() for t in (tok_cnt, done, err))
    bad = [idxs[j] for j in range(len(idxs)) if err[j] or not done[j]]
    if bad:
        raise EncodeError(f"stream(s) {bad}: the parse did not finish "
                          f"(err {sorted({int(e) for e in err})}: "
                          f"{ERR_OVERFLOW} a full tape, {ERR_STEPS} the "
                          f"step budget)", bad)
    tape = tape[:, :int(tok_cnt.max())].contiguous()
    if exact:
        btypes = out[-1].cpu().numpy()
        run_tables = [encode_host.exact_run_table(
            plans[i], btypes[j, :len(plans[i].blocks)])
            for j, i in enumerate(idxs)]
    else:
        run_tables = [plans[i].runs for i in idxs]
    kk, aa, bb, cc, _ = stitch.stitch_tapes(tape, data, run_tables)
    k3_args = (kk, aa, bb, cc, *k3_shapes(p0, data.shape[1], run_tables))
    note("stitch", stitch_args=(tape, data, run_tables), k3_args=k3_args)
    coded = code_k3(*k3_args)
    note("k3", k3_out=coded)
    stats = coded[5].cpu().numpy()
    over = [idxs[j] for j in range(len(idxs)) if stats[4, j]]
    if over:
        raise EncodeError(f"stream(s) {over}: K3 output overflow "
                          f"(coded bytes past the output capacity)", over)
    unfinished = [idxs[j] for j in range(len(idxs)) if not stats[3, j]]
    if unfinished:
        raise EncodeError(f"stream(s) {unfinished}: K3 did not reach "
                          f"K_END", unfinished)
    outs = remux_group(p0, coded)
    note("remux", outs=outs)
    return outs


def encode_batch(props_list, datas, *, device=CUDA, on_stage=None,
                 parse="fast"):
    """Encode B independent streams at m1-m5 on `device`.

    parse="fast" (the default) returns list[bytes], the raw streams
    without the property header, byte-identical to csc_tpu's encode_batch
    on its fast path; an m1-m4 stream over MAX_ENCODE (1 MB) takes the
    exact parse all the same, as csc_tpu codes it with its golden encoder,
    so its bytes are csc_tpu's and golden's; so does an m1 / m2 stream
    longer than its dictionary (up to 1 GB), whose window wraps as
    golden's ring: over 1 MB its bytes are csc_tpu's and golden's, at 1
    MB or less golden's, where csc_tpu's fast path writes a stream golden
    rejects (ROADMAP queue 3).  parse="exact" (m1-m4) returns the
    reference encoder's own bytes for every stream, as csc_tpu's under
    CSC_ENCODE_PARSE=exact: BAD / ENTROPY / DLT runs, the duplicate-block
    probe and several raw chunks included.  Streams are grouped by preset
    and parse (one device call per preset and size group).  An empty
    stream is the SIG_EOF chunk alone.  Raises EncodeError for a stream
    it cannot take (over 1 GB; m5 over MAX_ENCODE or under
    parse="exact"; m3-m5 longer than its dictionary) or that a kernel
    flags (a K3 output overflow).  on_stage: as encode_group's,
    called once more as on_stage("plan", plans=...) after the host plan.
    """
    device = torch.device(device)
    if len(props_list) != len(datas):
        raise ValueError("one props per stream")
    plans = plan_streams(props_list, datas, parse)
    if on_stage:
        on_stage("plan", plans=plans)
    outs = [None] * len(datas)
    for i, plan in enumerate(plans):
        if plan is None:
            outs[i] = encode_host.remux_stream(
                props_list[i].csc_blocksize, b"", b"", [], [],
                chunk_ends=[])
    for idxs, width in _groups(props_list, plans):
        for i, out in zip(idxs, encode_group(props_list, plans, idxs,
                                              device, on_stage, width)):
            outs[i] = out
    return outs


def encode_stream(props, data, *, device=CUDA, parse="fast"):
    """Single-stream encode through the batched path (B=1)."""
    return encode_batch([props], [data], device=device, parse=parse)[0]
