"""Edge streams that drive each mechanism of K1's to K5's designs
(csc_tpu_torch/csrc/decode_k1.cuh, encode_k2.cuh, encode_k3.cuh,
encode_k4.cuh, encode_k5.cuh), shared by the host tests of the g++ builds
and the card tests: every K1 / K2 / K4 / K5 case is a (name, props, data)
triple, every K3
case a batch of stitched tapes with K3's other arguments, K4's window
cases K4's own arguments over hand-made candidates; all built from
seeds."""
import numpy as np
import torch

from csc_tpu_torch import corpus, props
from csc_tpu_torch.constants import (F_COPY, F_IDLE, F_LITTREE, K_DLIT,
                                     K_ELIT, K_END, K_FLUSH, K_INT, K_LIT,
                                     K_MATCH, K_RAW, K_REP, K_REP0L1, K_RLEN,
                                     K_SENT)
from csc_tpu_torch.ops import bits_scan, decode_scan, prices


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


def k1_block_log_case():
    """(props, data, stream) past a short block log: 384 bytes of
    periodic text and a DLT ramp in six 64-byte raw chunks, each its own
    typed block, then the end-of-stream block (seven logged), coded by
    the golden encoder."""
    from csc_tpu.golden.encoder import encode_stream
    data = corpus.repetitive(192, 4) + corpus.dlt_ramp(192)
    p = props.props_init(len(data), 1)
    p.raw_blocksize = 64
    return p, data, encode_stream(p, data)


def ring48(level):
    """("ring48", props, data): 48 KB of corpus.repetitive under a 36 KB
    dictionary (`props_init(26 KB)`, a ring off the 8 KB grid), a random
    8 KB block across the ring's end (a BAD run across it)."""
    rng = np.random.default_rng(5)
    data = bytearray(corpus.repetitive(48 * 1024, 7))
    data[32 * 1024:40 * 1024] = rng.integers(0, 256, 8 * 1024,
                                             dtype=np.uint8).tobytes()
    return ("ring48", props.props_init(26 * 1024, level), bytes(data))


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


def _ap_props(n, level, filters=False):
    q = props.props_init(max(n, 32 * 1024), level)
    if not filters:
        q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
    return q


def four_symbols(n, seed):
    """Random bytes over 'abcd': matches of 2-8 bytes at almost every
    position and almost none of 16 or more, so the optimal parse's
    stretches run on to the AP_LIMIT cap."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, n) + 97).astype(np.uint8).tobytes()


def ap_cases(level):
    """(name, props, data) streams for the optimal parse (m3-m5), held
    step for step to csc_tpu's and shared by K4's host and card tests:
    text; a BAD run (a DT_NO_LZ skip) then four-symbol bytes ending in a
    repeated phrase and one fresh byte, the longest stream, so that its
    last cell is the last column and a match into it is undone; long
    runs of one byte around text (rep extensions past 8 rounds at a
    stretch start, good_len, POST_MATCH); random bytes (lone literals);
    four-symbol bytes (a stretch ended at the AP_LIMIT cap); one byte."""
    rng = np.random.default_rng(73)
    text = corpus.torch_python_text(64 * 1024)
    sym = four_symbols(1200, 74)
    mixed = (rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + sym
             + sym[300:310] + b"\x01")
    runs = b"A" * 1500 + text[8000:9000] + b"A" * 1500
    return [("text", _ap_props(2048, level), text[:2048]),
            ("mixed_runs", _ap_props(len(mixed), level, True), mixed),
            ("a_runs", _ap_props(len(runs), level), runs),
            ("random", _ap_props(1024, level),
             rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()),
            ("cap", _ap_props(3000, level), four_symbols(3000, 75)),
            ("one_byte", _ap_props(1, level), b"x")]


def k4_cases(level):
    """(name, props, data) edge streams for K4 beyond ap_cases: a run of
    one byte across the 8 KB sub-block end (its lanes cut by the limit)
    and then text ending in a repeated phrase and one fresh byte, the
    longest stream (the last position's clamped reads, the last column);
    two bytes; a short phrase repeated at distances 1-3 (csc_tpu's match
    distance price at slots 0-2); a 40-byte phrase repeated after a lone
    byte, so that a stretch starts on a match of 40 bytes (more than 8
    rounds of extension, under m5's good_len of 48)."""
    text = corpus.torch_python_text(64 * 1024)
    run = b"B" * 8500 + text[20000:20700] + text[20100:20112] + b"\x02"
    phrase = bytes(np.random.default_rng(76).integers(97, 123, 40,
                                                      dtype=np.uint8))
    return [("run_then_text", _ap_props(len(run), level), run),
            ("two_bytes", _ap_props(2, level), b"zz"),
            ("near", _ap_props(40, level), b"xyz" * 6 + b"#" + b"qq" * 8
             + b"!"),
            ("long_rep", _ap_props(200, level), phrase + b"#" + phrase
             + b"%" + phrase + b"&" + phrase[:30])]


def _exact_props(level, lz_mode=None, raw_blocksize=None):
    """One preset a group: a 32 KB dictionary (hash_bits 16 at m1, 14 at
    m2), filters off."""
    q = props.props_init(32 * 1024, level)
    q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
    if lz_mode is not None:
        q.lz_mode = lz_mode
    if raw_blocksize:
        q.raw_blocksize = raw_blocksize
    return q


def exact_cases(level, lz_mode=None):
    """(name, props, data) streams that drive each mechanism of the exact
    parse (csc_tpu's encode_scan; K5, csrc/encode_k5.cuh), one preset:
    m1 or m2, or with lz_mode 1 (no lazy second probe, no level preset).

      text        a torch source slice: literals, matches, reps, both lazy
                  outcomes, rep0len1; it opens with a phrase it repeats at
                  once (a candidate at distance == position: HT2's quirk)
      subblock    long-match text across the 8 KB sub-block end (matches
                  cut at the limit); the sub-block's last byte starts an
                  8-byte phrase found nowhere else, repeated later: that
                  position's hashes read zeros past the end, so the
                  repeat finds no match there
      byte_run    one byte 1 500 times: HT2's quirk at position 1, then
                  a match of 1 498 bytes slid four positions a step
      zeros       text, 700 zero bytes, text: after each token the first
                  slow insertion hashes to 0, which the reset lasth6
                  equals, so its HT6 row does not shift
      good_len    a 60-byte phrase three times, 20-byte gaps: good_len at
                  an HT probe (every later gate fails on the -1 sentinel
                  but takes its step), then at rep 0 (on to HT2)
      three_symbols  random bytes over three symbols: short matches slid
                  one position a step, the first insertion after a token
                  often hashing like the last one before it (m2: the row
                  shifts, since each token resets lasth6 to 0)
      many        a phrase whose older copies share longer prefixes with
                  its last: HT2, then the HT6 row's copies each longer,
                  recorded one after another (15 records is the most a
                  find can make at width 8: 1 + 4 reps + HT2 + HT3 + 8,
                  so the slot clip at cnt + 2 == NCAND stays unreached;
                  and rep0len1's record never wins: the precheck at minlen
                  1 makes rep 0's match 2 bytes or more, which the pick
                  prefers, in the reference too)
      multichunk  1 KB raw blocks: a K_SENT_A at each run end
      one_byte    a literal, K_SENT_A, K_END
    """
    rng = np.random.default_rng(97)
    text = corpus.torch_python_text(64 * 1024)

    def block(n):                 # bytes no earlier block repeats
        return rng.integers(97, 123, n, dtype=np.uint8).tobytes()
    head = text[:40]
    opening = head + head + text[40:1400]
    unique = bytes(range(0xF1, 0xF9))
    sub = (corpus.repetitive(8191, 98) + unique + corpus.repetitive(900, 99)
           + b"#%" + unique + corpus.repetitive(300, 100))
    zeros = text[3000:3500] + b"\0" * 700 + text[3500:3800]
    y = block(60)
    gap1, gap2 = block(20), block(20)
    good = y + gap1 + y + gap2[:20] + y + block(8)
    z = block(40)
    many = bytearray()
    for k in range(9, 0, -1):     # older copies share more of z
        many += z[:4 + 4 * k] + b"#" + block(6)
    many += z + block(4)
    multi = corpus.repetitive(2600, 99)

    def p(raw_blocksize=None):
        return _exact_props(level, lz_mode, raw_blocksize)
    return [("text", p(), opening),
            ("subblock", p(), sub),
            ("byte_run", p(), b"a" * 1500),
            ("zeros", p(), zeros),
            ("three_symbols", p(), (np.random.default_rng(17).integers(
                0, 3, 1200) + 120).astype(np.uint8).tobytes()),
            ("good_len", p(), good),
            ("many", p(), bytes(many)),
            ("multichunk", p(1024), multi),
            ("one_byte", p(), b"x")]


def exact_small_cases(level):
    """A short group of the exact parse for cuts at every step: text with
    reps and a 300-byte repeat slid four positions a step."""
    text = corpus.torch_python_text(64 * 1024)
    q = _exact_props(level)
    return [("short_text", q, text[5000:5200] + text[5000:5300] + b"!"),
            ("short_run", q, b"xy" * 90 + b"z")]


def exact_nolz_cases(level):
    """(name, props, data) streams of every run type that golden's
    encoder codes and csc_tpu's exact parse does not take, one preset (a
    74 KB dictionary, filters on), for K5's block walk, its
    duplicate-block probe and its sparse insertion (csrc/encode_k5.cuh):

      bad       8 KB of random bytes (DT_BAD), then 600 bytes of text
      entropy   8 KB over ten symbols (DT_ENTROPY), then 300 bytes the
                analyzer types DT_SKIP: the run goes on as DT_ENTROPY
      dlt       a 4-channel ramp (a DT_DLT type), then a DT_SKIP block,
                which the post-delta veto makes DT_NORMAL (the analyzer's
                bpb of a skipped block is 0)
      dup_skip  8 792-byte raw chunks: random 8 KB and 600 bytes of text,
                then the same random 8 KB, which the probe re-types
                DT_NORMAL (against the tables after the first chunk), and
                a DT_SKIP block after it, which follows it to DT_NORMAL
                (the fast parse's plan keeps both DT_BAD)
      chunks    16 KB of random bytes in 8 KB raw chunks: a DT_BAD run
                per chunk, the second probed against the first's tables
    Each stream's LZ part is short: the plain version runs a find in
    tens of lockstep steps, a probe or a sparse sub-block in one."""
    rng = np.random.default_rng(23)
    text = corpus.torch_python_text(64 * 1024)
    rnd = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()

    def p(raw_blocksize=None):
        q = props.props_init(64 * 1024, level)
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    ten = (rng.integers(0, 10, 8192, dtype=np.uint8) * 7 + 65).tobytes()
    return [
        ("bad", p(), rnd + text[5000:5600]),
        ("entropy", p(), ten + text[9000:9300]),
        ("dlt", p(), corpus.dlt_ramp(8192) + text[12000:12300]),
        ("dup_skip", p(8792), rnd + text[7000:7600] + rnd
         + text[15000:15300]),
        ("chunks", p(8192), rng.integers(0, 256, 16 * 1024,
                                         dtype=np.uint8).tobytes()),
    ]


def k5_lane_cases(level):
    """(name, props, data) streams for the lane hazards of K5's warp
    design (csrc/encode_k5.cuh), one preset (m1 or m2), each under 8 KB
    and one run, so that its sub-block ends at its end:

      runs        runs of one to twelve equal bytes over three symbols:
                  lazy second finds whose HT2 / HT3 slot the first find's
                  finish just wrote, both lazy outcomes; slide passes
                  with repeated HT2 / HT3 hashes and repeated HT6 rows,
                  consecutive (runs of seven or more) or not
      period      a phrase of period two, repeated past 32 bytes: a slide
                  pass whose rows repeat every other position, a match
                  the warp extends past the lanes' 32-byte batch
      lanes       a key phrase (bytes 1-63) at the end; before it, eight
                  copies of its head, older ones sharing more (6 .. 13
                  bytes: the HT6 row), then four fragments sharing 5 .. 2
                  bytes amid background bytes (128-191), then four
                  matches of 24-byte blocks (64-127) whose distances reach
                  the fragments from the key, and 8 bytes found nowhere
                  else: at the key every rep lane and every HT6 slot
                  passes its gates and records (13 records at m2)
      good_len    exact_cases' good_len stream: the exit at an HT slot
                  and at rep 0
      end_*       a random block repeated at the stream's end, where the
                  sub-block ends: the match stops at climit, a multiple
                  of 4, or one word short of it (a byte changed), within
                  the lanes' batch (20 bytes) or past it (100)
    """
    rng = np.random.default_rng(510 + level)
    q = _exact_props(level)

    def rand(n, lo=128, hi=192):
        return rng.integers(lo, hi, n, dtype=np.uint8).tobytes()
    runs = b"".join(bytes([97 + int(rng.integers(0, 3))])
                    * int(rng.integers(1, 13)) for _ in range(90))
    ab = b"ab" * 24 + b"c"
    period = rand(20) + ab + rand(10) + ab + rand(8)
    z = rand(40, 1, 64)
    buf = bytearray(rand(20))
    for k in range(7, -1, -1):        # the row's copies, oldest first
        buf += z[:6 + k] + bytes([z[6 + k] % 63 + 1]) + rand(4)
    # the four blocks' copies come just before the key, after GAP bytes
    # found nowhere else; each block's source lies in the background
    # before the fragment its distance reaches
    block, gap = 24, 8
    frags = {}
    for k in range(3, -1, -1):        # the fragments, rep k's sharing 2 + k
        buf += rand(block * (k + 1) + gap + 4)
        frags[k] = len(buf)
        buf += z[:2 + k] + bytes([z[2 + k] % 63 + 1])
    buf += rand(4)
    first = len(buf)
    key = first + 4 * block + gap
    for j, k in enumerate((3, 2, 1, 0)):   # the last one sets rep 0
        src = first + block * j - (key - frags[k])
        data = rand(block, 64, 128)
        assert frags[k] - block * (k + 1) - gap - 4 <= src
        assert src + block <= frags[k]
        buf[src:src + block] = data
        buf += data
    buf += rng.permutation(np.arange(192, 256, dtype=np.uint8))[:gap] \
        .tobytes()
    assert len(buf) == key
    lanes = bytes(buf + z + rand(8))
    good = [c for c in exact_cases(level) if c[0] == "good_len"][0][2]
    short, long_ = rand(20), rand(100)

    def changed(b, i):
        return b[:i] + bytes([b[i] ^ 0x5A]) + b[i + 1:]
    return [("runs", q, runs), ("period", q, period), ("lanes", q, lanes),
            ("good_len", q, good),
            ("end_short_full", q, rand(30) + short + short),
            ("end_short_cut", q, rand(30) + short + changed(short, 16)),
            ("end_long_full", q, rand(30) + long_ + long_),
            ("end_long_cut", q, rand(30) + long_ + changed(long_, 96))]


def k4_top_cases():
    """(name, props, data) at m5 (good_len 48) for the top of K4's window:
    four-symbol bytes, whose matches of 2-8 bytes cover every position,
    so the first stretch runs to offset AP_LIMIT - 1, the last one the
    stretch-end checks let it reach, and relaxes into it."""
    return [("top", _ap_props(2100, 5), four_symbols(2100, 77))]


# K4's hand-made stream (k4_lane_inputs): four matches of LANE_COPY bytes
# at LANE_AT set the rep queue to LANE_REPS (most recent first); at
# LANE_P rep lane k matches 2 + k bytes and candidate row c 6 + c bytes
# at distance LANE_CAND + 19 c (no two of the copies at LANE_P - d lie a
# rep distance apart, so the queue stays as it is up to LANE_P)
LANE_N = 2048
LANE_COPY = 120
LANE_AT = (200, 400, 600, 800)
LANE_REPS = (690, 510, 330, 150)
LANE_P = 1800
LANE_CAND = 700


def k4_lane_inputs(ncand, width=None, last=False):
    """K4's arguments (data, candp, run_ends, run_skip, sizes, dict_sizes,
    prices) of one stream of random bytes over hand-made candidates, on
    the CPU.  At each of LANE_AT a candidate of LANE_COPY bytes (a FIND
    position of several 8-round steps, then a match past good_len that
    ends its stretch) sets the rep queue; at LANE_P every rep lane and
    every candidate row records, each longer than the one before it (C =
    ncand rows).  With last=True the stream ends in an 11-byte match
    whose relaxation lands on the last column (n - 1) at width n = its
    size (the default width).  Other positions have no candidate: their stretches end at lone
    literals."""
    rng = np.random.default_rng(80 + ncand)
    size = LANE_N if not last else 600
    width = width or size
    data = rng.integers(0, 256, size, dtype=np.uint8)
    cand = np.zeros((ncand, width), np.int32)
    if last:
        at = size - 12
        data[at:at + 11] = data[300:311]
        data[at + 11] = data[311] ^ 0xFF
        cand[0, at] = (at - 300) << 5 | 8
    else:
        for x, d in zip(LANE_AT, LANE_REPS[::-1]):
            for j in range(LANE_COPY):
                data[x + j] = data[x - d + j]
            data[x + LANE_COPY] = data[x - d + LANE_COPY] ^ 0xFF
            cand[0, x] = d << 5 | 8
        p = LANE_P
        for k, d in enumerate(LANE_REPS):
            data[p - d:p - d + 2 + k] = data[p:p + 2 + k]
            data[p - d + 2 + k] = data[p + 2 + k] ^ 0xFF
        for c in range(ncand):
            d, ln = LANE_CAND + 19 * c, 6 + c
            data[p - d:p - d + ln] = data[p:p + ln]
            data[p - d + ln] = data[p + ln] ^ 0xFF
            cand[c, p] = d << 5 | min(ln, 8)
    row = np.zeros((1, width), np.uint8)
    row[0, :size] = data
    pr = torch.from_numpy(prices.pack_prices(prices.snapshot_prices()))
    i32 = torch.int32
    return (torch.from_numpy(row), torch.from_numpy(cand[None]),
            torch.tensor([[size]], dtype=i32),
            torch.tensor([[0]], dtype=i32), torch.tensor([size], dtype=i32),
            torch.tensor([1 << 20], dtype=i32), pr)


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


def dist_table(s):
    """DIST_TABLE[s] (csc_model.cpp:45-55)."""
    return s if s < 4 else (1 << (s - 2)) + 1


def tapes(streams, width=None):
    """Token lists (kind, a, b, c) -> four [B, T] int32 tapes, each stream
    closed by K_END (T = the longest + 1, or `width`)."""
    t = width or max(len(x) for x in streams) + 1
    out = np.zeros((4, len(streams), t), np.int32)
    out[0] = K_END
    for i, x in enumerate(streams):
        if x:
            out[:, i, :len(x)] = np.array(x, np.int64).T
    return tuple(out)


def _k3_edges():
    """Streams that drive each token kind and each record of K3."""
    lens = (0, 1, 2, 7, 8, 15, 16, 142, 143, 144, 286, 287, 143 * 40 + 5)
    kinds = [(K_LIT, 65, 0, 0), (K_LIT, 66, 0, 0), (K_MATCH, 100, 5, 67),
             (K_REP0L1, 0, 0, 68), (K_REP, 2, 9, 69), (K_REP, 1, 20, 70),
             (K_REP, 3, 3, 71), (K_SENT, 59, 62, 0), (K_LIT, 72, 0, 0),
             (K_RAW, 0, 0, 0), (K_RAW, 0x55, 0, 0), (K_RAW, 0xABCD, 16, 0),
             (K_RAW, 0x1FF, 8, 0), (K_RAW, 7, 3, 0), (K_LIT, 73, 0, 0)]
    ints = [0, 1] + [v for k in list(range(1, 21)) + [24]
                     for v in ((1 << k) - 1, (1 << k) + 1)]
    kinds += [(K_INT, v, 0, 0) for v in ints]
    kinds += [(K_ELIT, x, 0, 0) for x in (0, 255, 97)]
    kinds += [(K_DLIT, x, vb, 0) for x, vb in ((3, 0), (200, 1), (0, 127),
                                               (255, 255), (9, 255))]
    kinds += [(K_RLEN, 0, vb, 0) for vb in (0, 5, 142, 143, 150)]
    kinds += [(K_FLUSH, 0, 0, 0), (K_LIT, 74, 0, 0), (K_REP0L1, 0, 0, 75),
              (K_LIT, 76, 0, 0), (K_SENT, 59, 62, 0), (K_ELIT, 1, 0, 0),
              (K_LIT, 77, 0, 0), (K_FLUSH, 0, 0, 0)]
    lengths = [(k, 1 + (vb % 4 if k == K_REP else 4000 + vb), vb, 90)
               for vb in lens for k in (K_MATCH, K_REP)]
    lengths += [(K_RLEN, 0, vb, 0) for vb in lens] + [(K_FLUSH, 0, 0, 0)]
    # a long run of P_LONGLEN bits (2 999 zeros), then a match's (499)
    long_run = [(K_LIT, 80, 0, 0), (K_RLEN, 0, 143 * 3000 + 17, 0),
                (K_MATCH, 300, 143 * 500, 81), (K_LIT, 82, 0, 0),
                (K_FLUSH, 0, 0, 0)]
    # each slot boundary, dist_table(s) - 1 and dist_table(s), up to 1 MB,
    # then past 2^22 (the direct bits in two pieces), every wire length
    dists = [d for s in range(1, 23) for d in (dist_table(s) - 1,
                                               dist_table(s))]
    dists += [(1 << 22) + 5, (1 << 24) + 3, (1 << 29) + 1, 0x7FFFFFF0]
    distances = [(K_MATCH, d, i % 8, i & 0xFF) for i, d in enumerate(dists)]
    distances += [(K_FLUSH, 0, 0, 0)]
    # 230 flushes, most back to back, 5 rc bytes each: the chunk log and
    # the rc map of 16-byte blocks clip at 64 entries
    flushes = [(K_FLUSH, 0, 0, 0)] * 40 + [(K_LIT, 90, 0, 0)] + \
        [(K_FLUSH, 0, 0, 0)] * 190
    # 64 matches of 33 records: a pass of 32 takes 15 of them (CAP 512)
    overrun = [(K_MATCH, (1 << 22) + 5 + i, 300, i) for i in range(64)]
    overrun += [(K_LIT, 91, 0, 0), (K_FLUSH, 0, 0, 0)]
    # bc bytes enough to fill a 64-entry map of 16-byte blocks
    raw = [(K_RAW, (i * 7919) & 0xFFFF, 16, 0) for i in range(600)]
    raw += [(K_FLUSH, 0, 0, 0)]
    return tapes([kinds, lengths, long_run, distances, flushes, overrun,
                  raw])


def _k3_random(rng, nstream=16, ntok=1250):
    """Seeded random tapes of every kind, 20 000 tokens in all."""
    kinds = np.array([K_LIT, K_MATCH, K_REP, K_REP0L1, K_SENT, K_ELIT,
                      K_DLIT, K_RLEN, K_RAW, K_INT, K_FLUSH])
    weight = np.array([40, 15, 8, 7, 2, 8, 6, 4, 5, 3, 2], float)
    streams = []
    for _ in range(nstream):
        k = rng.choice(kinds, ntok, p=weight / weight.sum())
        byte = rng.integers(0, 256, ntok)
        dist = (2.0 ** rng.uniform(0, 23, ntok)).astype(np.int64)
        wl = np.minimum(rng.geometric(0.15, ntok) - 1, 2000)
        wl = np.where(rng.random(ntok) < 0.03, rng.integers(143, 2000, ntok),
                      wl)
        nb = rng.choice([0, 8, 16], ntok, p=[0.05, 0.5, 0.45])
        raw = rng.integers(0, 1 << 16, ntok) & ((1 << nb) - 1)
        ints = (2.0 ** rng.uniform(0, 20, ntok)).astype(np.int64)
        a = np.select([k == K_MATCH, k == K_SENT, k == K_REP, k == K_RAW,
                       k == K_INT], [dist, dist, byte & 3, raw, ints], byte)
        b = np.select([(k == K_MATCH) | (k == K_REP) | (k == K_RLEN)
                       | (k == K_SENT), k == K_DLIT, k == K_RAW],
                      [wl, rng.integers(0, 256, ntok), nb], 0)
        c = rng.integers(0, 256, ntok)
        streams.append(list(zip(k, a, b, c)))
    return tapes(streams)


def _k3_cuts(rng, n=16):
    """Capacity cuts at each byte near the coded size: one capacity and
    prefixes of one tape whose rc sizes (the first n streams, skewed
    literals after random ones) and bc sizes (the last n, one raw byte
    more each) step a byte at a time across it."""
    head = [(K_LIT, int(x), 0, 0) for x in rng.integers(0, 256, 40)]
    rc_side = [head + [(K_LIT, 101, 0, 0)] * (2 * j) + [(K_FLUSH, 0, 0, 0)]
               for j in range(n)]
    bc_side = [head[:4] + [(K_RAW, 0x5A, 8, 0)] * (40 + j)
               + [(K_FLUSH, 0, 0, 0)] for j in range(n)]
    tp = tapes(rc_side + bc_side)
    big = (4096, 4096, 64, 64, 512)
    stats = bits_scan.bits_plain(*(torch.from_numpy(t) for t in tp),
                                 *big)[5].numpy()
    return tp, (int(stats[0, n // 2]), int(stats[1, n + n // 2]), 64, 64,
                512)


def k3_cases():
    """(name, tapes, args, held_to) batches that every K3 build must code
    like bits_scan.bits_plain: tapes are four [B, T] int32 numpy arrays,
    args (max_rc, max_bc, nmap, nchunk, bsize).  held_to "jax": csc_tpu's
    run_bits takes the batch too (its maps and chunk log hold 64 entries);
    "port": only the port's contract covers it."""
    rng = np.random.default_rng(71)
    edges = _k3_edges()
    cut_tapes, cut_args = _k3_cuts(rng)
    # a tape without K_END (the first), beside one that has it
    body = [(K_LIT, 60 + i, 0, 0) for i in range(20)] + \
        [(K_MATCH, 700, 30, 1), (K_RAW, 0x3C, 8, 0)]
    no_end = tapes([body * 2, body], width=2 * len(body))
    return [("edges", edges, (16384, 4096, 64, 64, 16), "jax"),
            ("edges_clipped", edges, (16384, 4096, 3, 5, 64), "port"),
            ("cuts", cut_tapes, cut_args, "jax"),
            ("random", _k3_random(rng), (32768, 8192, 64, 64, 64), "jax"),
            ("no_end", no_end, (4096, 4096, 64, 64, 512), "port")]


def exact_ap_cases(level):
    """(name, props, data) streams for the exact optimal parse of m3 / m4
    (K6: csrc/encode_k6.cuh, its plain version ops/exact_ap_scan.py), one
    preset (a 64 KB dictionary), each driving a mechanism the plain
    version counts (`stats`, the shadow model's `lp_calls`):

      text      12 KB of torch source, filters off: stretches ending at a
                literal tail and at good_len, rep0len1 picks, more than
                4 097 counted length prices (the cache rebuilt twice)
      engtxt    20 KB of text the TXT filter codes DT_ENGTXT
      exe       16 KB of an executable, DT_EXE
      limit     10 KB over four symbols: a stretch reaching AP_LIMIT
      split     12 000 bytes over five symbols: finds whose length cache
                is rebuilt after their first counted call, where the lanes
                before it must read the old cache (undone in K6's g++
                build, this stream's tape changes at m3 and m4)
      entropy_lz
                8 KB over ten symbols (DT_ENTROPY), then 4 KB of text: the
                text's literal prices read p_lit as CompressLiterals left
                it
      bad, entropy, dlt, dup_skip, chunks
                exact_nolz_cases': a DT_BAD, a DT_ENTROPY and a DT_DLT run
                (its delta's runs past 10 through the matchlen trees, read
                by the text after it), a probe hit, raw chunks
    """
    text = corpus.torch_python_text(256 * 1024)
    exe = corpus.torch_library_exe()

    def p(filters=True):
        q = props.props_init(64 * 1024, level)
        if not filters:
            q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        return q
    ex = exe[len(exe) // 3:len(exe) // 3 + 16000]
    rng = np.random.default_rng(29)
    ten = (rng.integers(0, 10, 8192, dtype=np.uint8) * 7 + 65).tobytes()
    cases = [("text", p(False), text[100000:112000]),
             ("engtxt", p(), text[30000:50000]),
             ("exe", p(), ex),
             ("limit", p(False), four_symbols(10000, 3 + level)),
             ("split", p(False), (np.random.default_rng(26).integers(
                 0, 5, 12000) + 97).astype(np.uint8).tobytes()),
             ("entropy_lz", p(), ten + text[20000:24000])]
    return cases + exact_nolz_cases(level)


def _letters(n, seed, base=97):
    return (np.random.default_rng(seed).integers(0, 26, n)
            + base).astype(np.uint8).tobytes()


BT_SMALL = 4096    # a bt_size below the stream (past a 16 MB dictionary)


def _bt_props(bt_size=None, filters=False):
    q = props.props_init(64 * 1024, 5)
    if not filters:
        q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
    if bt_size:
        q.bt_size = bt_size
    return q


def exact_bt_cases():
    """(name, props, data) streams for the exact optimal parse of m5 with
    golden's binary-tree finder (K6's tree: csrc/encode_k5.cuh `BT`,
    encode_k6.cuh; the plain version ops/exact_ap_scan.py), the m5
    preset of a 64 KB dictionary, each driving a mechanism the plain
    version counts (`stats`):

      text      8 KB of torch source: tree walks of many steps, their
                records, lengths 34-47 priced past the length cache
                (`long_lengths`), the distance gate
      repeat    a 3 000-byte block twice: good_len exits of the walk in a
                find and in the slide's insertions, a slide long enough
                for its stride-4 part
      cap       copies of ever longer prefixes of a phrase, newest
                shortest, then the phrase: a walk that records more than
                find_match's 30 slots hold (`cand_cap`)
      wrap      12 000 letters under a bt_size of 4 096: a phrase whose
                three-byte hash was taken since, found by the head
                candidate beyond the tree's range; bt_pos wrapping after
                a find (golden completes this stream)
      wrap_bad  text, 8 KB of random bytes (DT_BAD) and text and the
                random bytes again, under a bt_size of 4 096, filters
                on: the sparse insertion zeroes links of slots the text
                before it used, and the finds in the second copy walk
                them
      bad, entropy, dlt, dup_skip, chunks
                exact_nolz_cases': the sparse insertion (links zeroed,
                the head set) and a duplicate-block probe hit at the
                tree's head
    """
    text = corpus.torch_python_text(256 * 1024)
    phrase = _letters(100, 5, 65)
    r = _letters(12000, 7)
    wrap = (r[:1000] + phrase + r[1100:5000] + phrase[:3] + r[5003:9000]
            + phrase + r[9100:])
    t = _letters(60, 11, 65)
    fill = _letters(800, 12)
    cap = b"".join(t[:k] + b"#" + fill[k * 20:k * 20 + 20]
                   for k in range(40, 5, -1)) + t + fill[:50]
    block = text[60000:63000]
    rnd = np.random.default_rng(41).integers(0, 256, 8192,
                                              dtype=np.uint8).tobytes()
    return [("text", _bt_props(), text[100000:108000]),
            ("repeat", _bt_props(), block + block + text[63000:64000]),
            ("cap", _bt_props(), cap),
            ("wrap", _bt_props(BT_SMALL), wrap),
            ("wrap_bad", _bt_props(BT_SMALL, filters=True),
             text[150000:155000] + rnd + text[160000:160600] + rnd
             + text[170000:170300])] + exact_nolz_cases(5)


def bt_fault_case():
    """(name, props, data): the stream on which golden's binary tree
    raises IndexError (mf.py:359), a bt_size of 4 096: a 100-byte repeat
    ends at offset bt_size, so its slide's last insertion leaves bt_pos
    at bt_size, unwrapped, and the next find indexes link 2 * bt_size."""
    phrase = _letters(100, 5, 65)
    r = _letters(6000, 7)
    return ("fault", _bt_props(BT_SMALL),
            r[:2000] + phrase + r[2100:BT_SMALL - 100] + phrase
            + r[BT_SMALL:])


RING_D = 26 * 1024   # props_init's request: a 36 KB dictionary and ring


def _ring_props(level, filters=False, request=RING_D, raw_blocksize=None):
    q = props.props_init(request, level)
    if not filters:
        q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
    if raw_blocksize:
        q.raw_blocksize = raw_blocksize
    return q


def _ring_cut(text, wnd):
    """A stream that makes a source stop at the ring's end: text up to
    the ring's end whose last 300 bytes are a block P (two bytes no text
    holds at its end, so the first lap ends in a literal: golden's m5
    tree completes there), then P twice more, then text; after the wrap
    each position of P finds the last lap's P at distance 300, whose
    compare the ring cuts where a linear one would run on."""
    k = 1024
    p = text[100 * k:100 * k + 298] + b"\xfe\xff"
    return (text[:wnd - 300] + p + p + p
            + text[150 * k:150 * k + 60 * k - wnd - 600])


def exact_ap_ring_cases(level):
    """(name, props, data) streams longer than their dictionary for the
    exact optimal parse of m3 / m4 (golden's ring window: K6's ring
    kernel, csrc/encode_k6.cuh `RING`; the plain version ops/
    exact_ap_scan.py), each driving a rule the plain version counts
    (`stats`):

      text   96 KB of torch source under a 36 KB dictionary, filters off:
             ring ends at 36 and 72 KB, off the 8 KB grid (pieces cut
             there), the literal priced at ring position 0 (`ring_lit0`)
      lit0   40 KB of torch source under 36 KB, filters off: a stretch
             from ring position 0 whose literal price, at context 0 there,
             decides the path (at the previous lap's last byte as context
             the tokens differ at m3 and m4)
      cut    60 KB, the last 300 bytes of the first lap repeated past the
             wrap (`_ring_cut`): sources stopped at the ring's end
             (`ring_cut`)
      runs   96 KB under 36 KB, filters on: random bytes at 24-40 KB (a
             DT_BAD run across the first ring end), text, the first 8 KB
             of them again at 48 KB (DT_BAD, but the duplicate probe hits
             its first lap's copy, across the wrap, and re-types it
             DT_NORMAL), a DT_ENTROPY and a DT_DLT block up to the second
             ring end, text
      chunks 80 KB of repetitive text in two 40 KB raw chunks under a
             32 KB dictionary: a piece cut at the ring's end and the
             chunk's
    """
    k = 1024
    text = corpus.torch_python_text(512 * k)
    rng = np.random.default_rng(37)
    rnd = rng.integers(0, 256, 8 * k, dtype=np.uint8).tobytes()
    ten = (rng.integers(0, 10, 8 * k, dtype=np.uint8) * 7 + 65).tobytes()
    wnd = _ring_props(level).dict_size
    rnd2 = rng.integers(0, 256, 8 * k, dtype=np.uint8).tobytes()
    runs = (text[200 * k:224 * k] + rnd + rnd2 + text[240 * k:248 * k]
            + rnd + ten + corpus.dlt_ramp(8 * k) + text[260 * k:284 * k])
    return [("text", _ring_props(level), text[300 * k:396 * k]),
            ("lit0", _ring_props(level), text[147279:147279 + 40 * k]),
            ("cut", _ring_props(level), _ring_cut(text, wnd)),
            ("runs", _ring_props(level, True), runs),
            ("chunks", _ring_props(level, request=k,
                                   raw_blocksize=40 * k),
             corpus.repetitive(80 * k, 3))]


def exact_bt_ring_cases():
    """(name, props, data) streams longer than their dictionary at m5
    (K6's tree in its ring kernel), the m5 preset of a 36 KB dictionary,
    filters off; bt_size is the dictionary, so each is past bt_size too:

      cut    `_ring_cut` (the first lap ends in a literal, so golden's
             tree completes): the tree's walks stopped at the ring's end
      ring48 ring48: the random 8 KB across the ring's end (a DT_BAD run,
             the sparse insertion wrapping bt_pos) and repetitive text
      fault  72 KB of torch source: the first lap ends in a match whose
             slide leaves bt_pos at bt_size, so golden's next find raises
             IndexError (golden/mf.py:359)
    """
    k = 1024
    text = corpus.torch_python_text(512 * k)
    wnd = _ring_props(5).dict_size
    return [("cut", _ring_props(5), _ring_cut(text, wnd)),
            ring48(5),
            ("fault", _ring_props(5), text[:72 * k])]
