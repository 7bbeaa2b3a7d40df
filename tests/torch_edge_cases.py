"""Edge streams that drive each mechanism of K1's and K2's designs
(csc_tpu_torch/csrc/decode_k1.cuh, encode_k2.cuh), shared by the host
tests of the g++ builds and the card tests: every case is a (name,
props, data) triple, built from seeds."""
import numpy as np
import torch

from csc_tpu_torch import corpus, props
from csc_tpu_torch.constants import F_COPY, F_IDLE, F_LITTREE
from csc_tpu_torch.ops import decode_scan


RING = 8192        # decode_k1.cuh: copies up to this distance read the ring


def k1_cases():
    """(name, props, data) streams that drive K1's copy, ring, reader and
    DLT paths.  Filler runs of one byte keep the long distances cheap to
    decode in lockstep."""
    w = corpus.words(1500, seed=21)

    def p(n, raw_blocksize=None, filters=False):
        q = props.props_init(max(n, 32 * 1024), 1)
        if not filters:
            q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    short = (b"q" * 300 + b"ab" * 150 + b"xyz" * 120 + b"0123456" * 60
             + b"0123456789abcde" * 30 + b"0123456789abcdef" * 30
             + b"0123456789abcdefg" * 30 + corpus.words(600, seed=22))
    # the second w at distance RING (the ring's farthest byte), then w
    # at 8196 and 12000: past the ring, from the window
    far = (w + b"#" * (RING - len(w)) + w
           + b"%" * (8196 - len(w)) + w[:1000]
           + b"&" * (12000 - 1000) + w[:800])
    ramp = corpus.dlt_ramp(12288)
    dlt = ramp + corpus.words(1200, seed=23) + ramp[-1500:] + b"!" * 200
    multi = (corpus.words(1200, seed=24) + b"-" * 900
             + corpus.words(1200, seed=24) + corpus.repetitive(2500, 25))
    return [("short_dist", p(len(short)), short),
            ("far", p(len(far)), far),
            ("dlt_then_lz", p(len(dlt), 12288, True), dlt),
            ("multichunk", p(len(multi), 1024), multi)]


def k2_cases(level):
    """(name, props, data) streams for K2's lane strides, limits and
    fold edges (filters off: every byte goes through the parse)."""
    rng = np.random.default_rng(91)

    def block(n):                 # bytes no earlier block repeats
        return rng.integers(97, 123, n, dtype=np.uint8).tobytes()

    def p(n):
        q = props.props_init(max(n, 32 * 1024), level)
        q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        return q
    # a phrase of each length repeated later, then a differing byte: the
    # extensions from the rep heads (4) and from EXT_CAP (8) end before,
    # at and after a 32-byte stride
    strides = bytearray()
    for n in (35, 36, 37, 39, 40, 41, 67, 68, 69, 71, 72, 73, 100):
        x = block(n)
        strides += x + block(5) + x + b"#" + block(3) + x + b"%"
    # a long repeat cut by the sub-block end (8192, then a limit that is
    # no multiple of 32) and by the stream's end; the stream starts with
    # the phrase it repeats at once (the HT2 quirk: a candidate at
    # distance == position)
    head = block(300)
    capped = head + block(7000) + head + block(1000) + head[:211]
    # good_len (32 at m1, 24 at m2) reached at a rep and then at a
    # candidate, mid-fold
    y = block(60)
    fold = (y + block(40) + y[:20] + block(3) + y + block(40) + y[10:50]
            + block(10) + y)
    return [("strides", p(len(strides)), bytes(strides)),
            ("capped", p(len(capped)), capped),
            ("fold", p(len(fold)), fold)]


def cut(a, n):
    """The batch's coder array cut to n bytes a row: rows then start off
    a 4-byte boundary and end inside a buffered word."""
    return np.ascontiguousarray(a[:, :n])


def caps_inside(arrays, wnd_size, i, steps):
    """Step caps of the plain version at which stream i stops inside a
    copy (a chunk done, more to come) and inside a literal (a bit
    decoded, more to come), the first of each within `steps` steps."""
    st = decode_scan.make_decode_state(
        wnd_size, *(torch.from_numpy(a) for a in arrays))
    fsm = decode_scan.IX["fsm"]
    node = decode_scan.IX["node"]
    caps, prev = {}, None
    for t in range(1, steps):
        fsm_a, has = decode_scan._present_states(st["regs"])
        if has[F_IDLE] == st["regs"].shape[1]:
            break
        st = decode_scan._step(st, wnd_size, fsm_a, has)
        f, nd = int(st["regs"][fsm, i]), int(st["regs"][node, i])
        if f == F_COPY and prev == F_COPY:
            caps.setdefault("copy", t)
        if f == F_LITTREE and 1 < nd < 256:
            caps.setdefault("literal", t)
        prev = f
        if len(caps) == 2:
            break
    return caps


def plain_each_step(arrays, wnd_size, steps):
    """The plain version's outputs (wnd, blk_log, wnd_pos, done, err,
    blk_cnt as numpy) after each of its first `steps` steps: a step cap
    at t stops it there.  Yields (t, outputs)."""
    st = decode_scan.make_decode_state(
        wnd_size, *(torch.from_numpy(a) for a in arrays))
    ix = decode_scan.IX
    for t in range(1, steps + 1):
        fsm_a, has = decode_scan._present_states(st["regs"])
        if has[F_IDLE] == st["regs"].shape[1]:
            return
        st = decode_scan._step(st, wnd_size, fsm_a, has)
        regs = st["regs"]
        yield t, [st["wnd"].numpy(), st["blk_log"].numpy()] + [
            regs[ix[n]].to(torch.int32).numpy()
            for n in ("wnd_pos", "done", "err", "blk_cnt")]
