"""Host side of the batched encoder: stream planning (analyzer + forward
filters), the CompressRLE token skeleton of DT_DLT runs, and the MemIO
remux of the coded byte streams with persistent-buffer flush semantics.

A copy of csc_tpu/ops/encode_host.py (`plan_stream`, `remux_stream`,
`PersistentCoder`, `rle_tape`, `_dlt_bpb`) on this package's own native
runtime.  The device phases (candidates, K2, stitch, K3) produce, per
stream, the logical RC/BC byte sequences plus the 64 KB block-crossing
maps and the chunk log; this module turns them into the physical byte
stream exactly as the reference writes it: tagged MemIO blocks in
chronological write order (csc_memio.cpp:83-108), the Coder::Flush tail
with its stale skipped byte (csc_coder.cpp:40-74) and the trailing
SIG_EOF chunk (csc_enc.cpp:193-203).
"""
import math
from typing import NamedTuple

import numpy as np

from .. import native
from ..constants import (DT_NORMAL, DT_EXE, DT_ENGTXT, DT_FAST, DT_SKIP,
                         DT_NO_LZ, DT_DLT, MIN_BLOCK_SIZE, DLT_INDEX, MB,
                         K_DLIT, K_RLEN)

# largest stream the device encode takes (csc_tpu's default
# CSC_TPU_MAX_ENCODE, encode_host.py:270; the archiver's autosplit cap)
MAX_ENCODE = 1 * MB

# 100 * log2 table of the analyzer (csc_analyzer.cpp; a copy of
# csc_tpu/golden/analyzer.py:15-17)
_LOG_TABLE = [int(100.0 * math.log(i * 16 + 8) / math.log(2.0))
              for i in range(MIN_BLOCK_SIZE >> 4)]
_LOG_TABLE.append(int(100.0 * math.log(MIN_BLOCK_SIZE) / math.log(2.0)))


class PersistentCoder:
    """Reproduces the write-side coder buffers + MemIO framing for one
    stream, given the logical RC/BC byte sequences in chronological event
    order.  The 64 KB buffers persist across chunk flushes (the flush
    'skip' byte re-emits stale content)."""

    def __init__(self, bsize):
        self.bsize = bsize
        self.rc_buf = bytearray(bsize)
        self.bc_buf = bytearray(bsize)
        self.rc_size = 0
        self.bc_size = 0
        self.out = bytearray()

    def _write_block(self, data, rc1bc0):
        size = len(data)
        fb = (rc1bc0 << 7) | ((1 << 6) if size == self.bsize else 0)
        self.out.append(fb)
        if size != self.bsize:
            self.out += bytes([(size >> 16) & 0xFF, (size >> 8) & 0xFF,
                               size & 0xFF])
        self.out += data

    def put_rc(self, b):
        self.rc_buf[self.rc_size] = b
        self.rc_size += 1
        if self.rc_size == self.bsize:
            self._write_block(bytes(self.rc_buf), 1)
            self.rc_size = 0

    def put_bc(self, b):
        self.bc_buf[self.bc_size] = b
        self.bc_size += 1
        if self.bc_size == self.bsize:
            self._write_block(bytes(self.bc_buf), 0)
            self.bc_size = 0

    def put_rc_bulk(self, data):
        """Append many rc bytes (slice copies, not per-byte python)."""
        i, n = 0, len(data)
        while i < n:
            take = min(self.bsize - self.rc_size, n - i)
            self.rc_buf[self.rc_size:self.rc_size + take] = \
                data[i:i + take]
            self.rc_size += take
            i += take
            if self.rc_size == self.bsize:
                self._write_block(bytes(self.rc_buf), 1)
                self.rc_size = 0

    def put_bc_bulk(self, data):
        i, n = 0, len(data)
        while i < n:
            take = min(self.bsize - self.bc_size, n - i)
            self.bc_buf[self.bc_size:self.bc_size + take] = \
                data[i:i + take]
            self.bc_size += take
            i += take
            if self.bc_size == self.bsize:
                self._write_block(bytes(self.bc_buf), 0)
                self.bc_size = 0

    def flush_chunk(self, low, lowhi, cache, cachesize, bc_val, bc_bits):
        """Coder::Flush from the final registers of a chunk."""
        # 5 ShiftLows
        for _ in range(5):
            if (low & 0xFFFFFFFF) < 0xFF000000 or lowhi:
                temp = cache
                while True:
                    self.put_rc((temp + lowhi) & 0xFF)
                    temp = 0xFF
                    cachesize -= 1
                    if cachesize == 0:
                        break
                cache = (low >> 24) & 0xFF
            cachesize += 1
            low = (low << 8) & 0xFFFFFFFF
            lowhi = 0
        # skipped byte: stale buffer content is kept
        self.rc_size += 1
        # bc: partial byte + one zero pad
        self.put_bc((bc_val << (8 - bc_bits)) & 0xFF if bc_bits else 0)
        self.put_bc(0)
        self._write_block(bytes(self.rc_buf[:self.rc_size]), 1)
        self._write_block(bytes(self.bc_buf[:self.bc_size]), 0)
        self.rc_size = 0
        self.bc_size = 0


def remux_stream(bsize, rc_bytes, bc_bytes, rc_blkmap, bc_blkmap, regs=None,
                 chunk_ends=None):
    """Merge the RC/BC byte sequences into the physical stream.

    rc_blkmap[k] = bc_cnt at the moment rc byte (k+1)*bsize was emitted
    (i.e. when the k-th full RC block was written); bc_blkmap likewise.
    Block-write events are merged in chronological order via their
    (rc_cnt, bc_cnt) vector timestamps.

    Two flush conventions:
    * regs given (single chunk): remaining bytes feed Coder::Flush computed
      from the final registers.
    * chunk_ends given (multi-chunk): the coder already emitted each
      chunk's flush bytes (B_FLUSH); at each (rc_end, bc_end) boundary we
      add the skipped stale byte and write the partial blocks.
    The SIG_EOF chunk is appended either way (csc_enc.cpp:193-203).
    """
    pc = PersistentCoder(bsize)
    events = []
    nrc_full = len(rc_bytes) // bsize
    nbc_full = len(bc_bytes) // bsize
    for k in range(nrc_full):
        events.append(((k + 1) * bsize, int(rc_blkmap[k]), 0, k))
    for j in range(nbc_full):
        events.append((int(bc_blkmap[j]), (j + 1) * bsize, 1, j))
    if chunk_ends:
        for ci, (rce, bce) in enumerate(chunk_ends):
            events.append((rce, bce, 2, ci))
    events.sort(key=lambda e: (e[0], e[1]))
    rc_done = 0
    bc_done = 0
    for ev in events:
        if ev[2] == 0:
            pc.put_rc_bulk(rc_bytes[rc_done:(ev[3] + 1) * bsize])
            rc_done = (ev[3] + 1) * bsize
        elif ev[2] == 1:
            pc.put_bc_bulk(bc_bytes[bc_done:(ev[3] + 1) * bsize])
            bc_done = (ev[3] + 1) * bsize
        else:
            # chunk boundary: drain to (rce, bce), skip byte, write blocks
            pc.put_rc_bulk(rc_bytes[rc_done:ev[0]])
            rc_done = ev[0]
            pc.put_bc_bulk(bc_bytes[bc_done:ev[1]])
            bc_done = ev[1]
            pc.rc_size += 1            # flush skip byte (stale content)
            pc._write_block(bytes(pc.rc_buf[:pc.rc_size]), 1)
            pc._write_block(bytes(pc.bc_buf[:pc.bc_size]), 0)
            pc.rc_size = 0
            pc.bc_size = 0
    pc.put_rc_bulk(rc_bytes[rc_done:])
    pc.put_bc_bulk(bc_bytes[bc_done:])
    if regs is not None:
        pc.flush_chunk(*regs)

    # SIG_EOF chunk (WriteEOF + Flush): EncodeInt(9) on a fresh coder
    # = 5 direct bits slot(3) + 3 direct bits (1) -> bc byte 0x19
    # rc: 5 ShiftLows of a virgin coder -> five 0x00 bytes + skip
    for _ in range(5):
        pc.put_rc(0)
    pc.rc_size += 1                   # flush skip byte (stale content)
    pc.put_bc(0x19)                   # EncodeInt(9): 00011 001
    pc.put_bc(0)                      # flush partial byte (bc_bits==0 -> 0)
    pc.put_bc(0)                      # flush pad byte
    pc._write_block(bytes(pc.rc_buf[:pc.rc_size]), 1)
    pc._write_block(bytes(pc.bc_buf[:pc.bc_size]), 0)
    pc.rc_size = 0
    pc.bc_size = 0
    return bytes(pc.out)


def _dlt_bpb(block, chn):
    """GetDltBpb (csc_analyzer.cpp:166-182), vectorized: order-0 bpb x100
    after the channel delta.  The prev byte carries across channels in
    traversal order, exactly as the reference's single `prev` does."""
    a = np.frombuffer(bytes(block), np.uint8).astype(np.int32)
    size = len(a)
    freq = np.zeros(256, np.int64)
    carry = 0
    for i in range(chn):
        vals = a[i::chn]
        if len(vals) == 0:
            continue
        prevs = np.concatenate(([carry], vals[:-1]))
        freq += np.bincount((vals - prevs) & 0xFF, minlength=256)
        carry = int(vals[-1])
    lt = np.asarray(_LOG_TABLE, np.int64)
    bpb = size * int(lt[size >> 4])
    bpb -= int(np.sum(freq * lt[freq >> 4]))
    return (bpb & 0xFFFFFFFF) // size


def rle_tape(seg):
    """CompressRLE skeleton (csc_model.cpp:471-513) as tape tokens.

    seg: np.uint8 array (delta-filtered run payload).  Returns
    (kinds, a, b) int32 arrays of K_DLIT (a=byte, b=s_ctx) and K_RLEN
    (b=length-11) tokens.  A run token fires at position i when
    src[i-1..i+2] are equal and the equal stretch from i has length > 10;
    within a maximal equal-value stretch [s, e) that means the literal at
    s is followed by one run of length e-s-1 iff e-s >= 12.  s_ctx is
    always the previous consumed byte (0 at position 0)."""
    n = len(seg)
    if n == 0:
        return (np.zeros(0, np.int32),) * 3
    seg = np.asarray(seg, np.uint8)
    ctxs = np.concatenate(([0], seg[:-1].astype(np.int32)))
    neq = np.flatnonzero(np.diff(seg) != 0)
    starts = np.concatenate(([0], neq + 1))
    ends = np.concatenate((neq + 1, [np.int64(n)]))
    runs = np.flatnonzero(ends - starts >= 12)
    kk, aa, bb = [], [], []
    pos = 0
    for ri in runs:
        s, e = int(starts[ri]), int(ends[ri])
        # literals [pos, s], then one run token covering [s+1, e)
        kk.append(np.full(s + 1 - pos, K_DLIT, np.int32))
        aa.append(seg[pos:s + 1].astype(np.int32))
        bb.append(ctxs[pos:s + 1])
        kk.append(np.full(1, K_RLEN, np.int32))
        aa.append(np.zeros(1, np.int32))
        bb.append(np.asarray([e - s - 1 - 11], np.int32))
        pos = e
    kk.append(np.full(n - pos, K_DLIT, np.int32))
    aa.append(seg[pos:].astype(np.int32))
    bb.append(ctxs[pos:])
    return (np.concatenate(kk).astype(np.int32),
            np.concatenate(aa).astype(np.int32),
            np.concatenate(bb).astype(np.int32))


# the info word of a block in the exact parse's block table
# (plan_stream(..., exact=True)): the block's type in the low byte; BLK_SKIP
# for a block the analyzer typed DT_SKIP, which takes the previous block's
# final type (the low byte then holds the type it takes when that one is
# not DT_NORMAL); BLK_CHUNK for the first block of a raw chunk
BLK_TYPE = 0xFF
BLK_SKIP = 1 << 8
BLK_CHUNK = 1 << 9


class FastPlan(NamedTuple):
    """A stream's plan for the fast parse (K2 / K4): its filtered LZ input
    and its run table [(type, filtered_len, declared_size, chunk_last,
    payload)]."""
    lz: bytes
    runs: list
    parse = "fast"


class ExactPlan(NamedTuple):
    """A stream's plan for the exact parse (K5, K6): its filtered LZ input,
    the block table [NB, 2] int32 of the analyzer's 8 KB blocks before
    the duplicate-block probe (each block's cumulative end and its info
    word, BLK_TYPE / BLK_SKIP / BLK_CHUNK), and its EXE and ENGTXT runs
    by their offset in the LZ input (`exact_run_table` takes them as
    they are and builds the other runs from the parse's block types)."""
    lz: bytes
    blocks: np.ndarray
    filtered: dict
    parse = "exact"


def plan_stream(props, data, exact=False):
    """Analyzer pre-pass: the filtered LZ input and run table of one
    stream, or None when the device encode cannot take it (empty, an
    lz_mode other than the lazy parse of m1/m2 and the optimal parse of
    m3-m5, or, unless exact, over MAX_ENCODE).

    Returns a FastPlan (lz_input, run table).  Mirrors CSCEncoder::Compress
    (csc_encoder_main.cpp:85-146) for runs of DT_NORMAL / DT_EXE /
    DT_ENGTXT and DT_BAD / DT_ENTROPY / DT_DLT payload runs (the LZ
    window gets the RAW bytes of a payload run: golden codes one with
    encode_normal(..., 5), SlidePosFast's sparse insertion, csc_mf.cpp:
    208-241; payload carries the delta-filtered bytes for DLT).  As in
    csc_tpu's fast path (plan_stream with allow_nolz), the
    IsDuplicateBlock re-typing probe (csc_lz.cpp:102-112) is skipped: a
    duplicated 8KB block stays BAD/ENTROPY/DLT instead of being re-LZ'd,
    a rare ratio-only divergence from the reference.

    exact=True (the exact parse, K5 at m1 / m2, K6 at m3 / m4) returns an
    ExactPlan: the same LZ input, the block table of the analyzer's 8 KB
    blocks before that probe and the EXE / ENGTXT runs.  The probe reads
    the live hash tables, so the parse makes it and merges the blocks
    into runs; the run table is then built from its block types
    (`exact_run_table`).  The LZ input does not depend on the probe: a block it re-types DT_NORMAL keeps its raw bytes (a no-LZ
    block's LZ input is its raw bytes, which the probe reads), and EXE /
    ENGTXT blocks are never re-typed.
    """
    size = len(data)
    if size == 0 or (size > MAX_ENCODE and not exact):
        return None
    # m5's binary-tree finder (bt_size > 0) rides the optimal parse with
    # width-8 hash chains in its place, as csc_tpu's fast path does
    # (plan_stream with allow_ap, csc_tpu/ops/encode_host.py:272-279)
    if props.lz_mode not in (1, 2, 3):
        return None
    use_filters = (props.DLTFilter + props.EXEFilter + props.TXTFilter) > 0

    lz_parts = []
    run_table = []   # (type, filtered_len, declared_size, chunk_last)
    blocks = []      # (end, info) of the exact parse's block table
    filtered = {}    # the exact parse's EXE / ENGTXT runs by offset
    lz_off = 0
    for coff in range(0, size, props.raw_blocksize):
        chunk = data[coff:coff + props.raw_blocksize]
        csize = len(chunk)

        # 8KB typing walk (CSCEncoder::Compress, csc_encoder_main.cpp:95-127)
        types = []
        i = 0
        while i < csize:
            cur = min(MIN_BLOCK_SIZE, csize - i)
            if use_filters:
                t, bpb = native.analyze(chunk[i:i + cur])
            else:
                t, bpb = DT_NORMAL, 0
            skip = t == DT_SKIP
            if skip:
                t = types[-1][0] if types else DT_NORMAL
            if t != DT_NORMAL:
                if t == DT_EXE and props.EXEFilter == 0:
                    t = DT_NORMAL
                elif t == DT_ENGTXT and props.TXTFilter == 0:
                    t = DT_NORMAL
                elif t >= DT_DLT and props.DLTFilter == 0:
                    t = DT_NORMAL
            if DT_DLT <= t < DT_DLT + 5:
                # post-delta entropy veto (csc_encoder_main.cpp:118-121)
                if _dlt_bpb(chunk[i:i + cur],
                            DLT_INDEX[t - DT_DLT]) >= bpb * 0.95:
                    t = DT_NORMAL
            types.append((t, i, cur))
            # a skipped block's type above is the one it takes when the
            # previous block ends other than DT_NORMAL: with the probe, the
            # previous one may have been re-typed DT_NORMAL
            blocks.append((coff + i + cur, t | (BLK_SKIP if skip else 0)
                           | (BLK_CHUNK if i == 0 else 0)))
            i += cur

        # merge runs (same type, <= raw_blocksize)
        runs = []
        last_t, last_begin, last_size = DT_NORMAL, 0, 0
        for t, off, cur in types:
            if (last_size and (t != last_t
                               or last_size + cur > props.raw_blocksize)):
                runs.append((last_t, last_begin, last_size))
                last_begin = off
                last_size = 0
            last_t = t
            last_size += cur
        if last_size:
            runs.append((last_t, last_begin, last_size))

        # forward filters per run (compress_block, csc_encoder_main.cpp:35-59)
        for k, (t, off, rsize) in enumerate(runs):
            seg = bytearray(chunk[off:off + rsize])
            chunk_last = k == len(runs) - 1
            if t == DT_EXE:
                native.e89_forward(seg)
                run_table.append((DT_EXE, rsize, -1, chunk_last, None))
            elif t == DT_ENGTXT:
                if native.dict_forward(seg):
                    run_table.append((DT_ENGTXT, rsize, rsize, chunk_last,
                                      None))
                else:
                    run_table.append((DT_NORMAL, rsize, -1, chunk_last,
                                      None))
            elif exact:
                # the other runs come from the parse's block types
                pass
            elif t >= DT_DLT:
                # window gets the RAW bytes (mf-skip, csc_lz.cpp:114);
                # the RLE payload is the delta-filtered copy
                payload = bytearray(seg)
                native.delta_forward(payload, DLT_INDEX[t - DT_DLT])
                run_table.append((t, rsize, rsize, chunk_last,
                                  bytes(payload)))
            elif t >= DT_NO_LZ:
                run_table.append((t, rsize, rsize, chunk_last, None))
            else:
                run_table.append((DT_NORMAL, rsize, -1, chunk_last, None))
            if exact and t in (DT_EXE, DT_ENGTXT):
                filtered[lz_off] = run_table.pop()
            lz_parts.append(bytes(seg))
            lz_off += rsize
    if not exact:
        return FastPlan(b"".join(lz_parts), run_table)
    return ExactPlan(b"".join(lz_parts), np.array(blocks, np.int32),
                     filtered)


def exact_run_table(plan, btypes):
    """The run table of an ExactPlan from the final type of each block
    that K5 or K6 returns (after the
    duplicate-block probe and the skipped blocks' resolution): blocks of
    one type in one raw chunk merge into a run, as CSCEncoder::Compress
    merges them (the rawblock_limit split, csc_encoder_main.cpp:129, never
    falls inside a chunk of at most raw_blocksize bytes).  EXE and ENGTXT
    runs are the plan's own (the probe never touches them: their filtered
    bytes and the ENGTXT transform's verdict stand); a DT_DLT run's
    payload is the delta filter of its raw bytes, which the LZ input
    holds."""
    lz, table, own = plan
    ends = table[:, 0].astype(np.int64)
    chunk = (table[:, 1] & BLK_CHUNK) != 0
    nb = len(ends)
    out, start, k = [], 0, 0
    while k < nb:
        t = int(btypes[k])
        j = k + 1
        while j < nb and not chunk[j] and int(btypes[j]) == t:
            j += 1
        end = int(ends[j - 1])
        n = end - start
        last = j == nb or bool(chunk[j])
        if t in (DT_EXE, DT_ENGTXT):
            run = own.get(start)
            if run is None or run[1] != n or run[3] != last:
                raise ValueError(f"the {t} run at {start} ({n} bytes) is "
                                 f"not a run of the plan")
            out.append(run)
        elif t >= DT_DLT:
            payload = bytearray(lz[start:end])
            native.delta_forward(payload, DLT_INDEX[t - DT_DLT])
            out.append((t, n, n, last, bytes(payload)))
        elif t >= DT_NO_LZ:
            out.append((t, n, n, last, None))
        elif t in (DT_NORMAL, DT_FAST):
            # DT_FAST: a run of its own, coded as DT_NORMAL
            # (csc_encoder_main.cpp:63-65)
            out.append((DT_NORMAL, n, -1, last, None))
        else:
            raise ValueError(f"block {k}: no run takes type {t}")
        start, k = end, j
    return out
