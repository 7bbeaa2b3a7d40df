"""Host-side MemIO framing: demux the physical stream into contiguous RC/BC
byte arrays plus block-boundary tables, and remux on encode.

The tagged-block format is csc_memio.cpp:5-108.  A copy of
csc_tpu/ops/framing.py.  The decode kernel consumes the *demuxed* arrays;
block boundaries are needed because a chunk reset (csc_dec.cpp:657-680)
skips the tail of the current block of each substream.
"""
import numpy as np


def demux_stream(data: bytes, pos: int, bsize: int):
    """Split a physical stream into (rc_bytes, bc_bytes, rc_ends, bc_ends).

    *_ends[i] is the cumulative end offset of block i in the concatenated
    substream; block starts are ends[i-1] (0 for i=0).
    """
    rc_parts, bc_parts = [], []
    rc_ends, bc_ends = [], []
    rc_total = bc_total = 0
    n = len(data)
    view = memoryview(data)
    while pos < n:
        fb = data[pos]
        pos += 1
        if (fb >> 6) & 1:
            size = bsize
        else:
            if pos + 3 > n:
                break
            size = (data[pos] << 16) | (data[pos + 1] << 8) | data[pos + 2]
            pos += 3
        if size == 0 or size > bsize or pos + size > n:
            break
        block = view[pos:pos + size]
        pos += size
        if (fb >> 7) & 1:
            rc_parts.append(block)
            rc_total += size
            rc_ends.append(rc_total)
        else:
            bc_parts.append(block)
            bc_total += size
            bc_ends.append(bc_total)
    rc = np.frombuffer(b"".join(rc_parts), dtype=np.uint8)
    bc = np.frombuffer(b"".join(bc_parts), dtype=np.uint8)
    return rc, bc, np.array(rc_ends, np.int32), np.array(bc_ends, np.int32)


def batch_pad(arrays, pad_value=0, dtype=None):
    """Stack 1-D arrays of unequal length into [B, maxlen] with padding."""
    maxlen = max((len(a) for a in arrays), default=1)
    maxlen = max(maxlen, 1)
    b = len(arrays)
    dtype = dtype or arrays[0].dtype
    out = np.full((b, maxlen), pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
    return out


def pad_ends(ends_list, big=0x7FFFFFFF):
    """Pad per-stream block-end tables; trailing entries point past the end
    so the scan's block-advance logic saturates harmlessly."""
    maxlen = max((len(e) for e in ends_list), default=1) + 2
    b = len(ends_list)
    out = np.full((b, maxlen), big, dtype=np.int32)
    for i, e in enumerate(ends_list):
        out[i, :len(e)] = e
    return out
