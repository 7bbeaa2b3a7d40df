"""Plain version of K6, the exact optimal parse of m3-m5: golden's
encoder (csc_tpu/golden/encoder.py, lz.py, mf.py, model.py; csc_lz.cpp's
compress_advanced and csc_mf.cpp's finders) run stream after stream, with
the token tape in place of the range coder.

The port's own copy of what it needs of golden: MatchFinder (find_match,
find_match_with_price, slide_pos, slide_pos_fast, test_find) with its
hash chains (m3 / m4) and its binary tree (m5: bt_size > 0, hash_width
0; below), the optimal parse (`_compress_advanced`, `_ap_backward`,
`_encode_nonlit`)
and the run walk of CSCEncoder::Compress over the analyzer's block table
(encode_host.plan_stream(..., exact=True)), as K5's plain version
(ops/exact_scan.py) reads it: a DT_SKIP block takes the previous block's
final type, a BAD / ENTROPY / DLT block is re-typed DT_NORMAL when the
duplicate-block probe hits against the tables as they stand at its run's
start, runs end at another type or raw chunk.

What K5 does not need and K6 does: the parse reads the model.  Each
stretch of up to AP_LIMIT positions is a shortest-path DP priced by the
model as every earlier symbol left it (ops/shadow_model.py, the prices
of ops/prices.py, with the length-price cache whose counter runs across
the whole stream), so every event the coder codes adapts the shadow
model here in stream order: the tokens of a stretch when its back-walk
codes them, an LZ run's sentinel, a DT_ENTROPY run's literals and the
runs longer than 10 of a DT_DLT run's delta-filtered bytes.

Output, as K5's: the tape of (kind | wire_len << 3, dist_code) words, a
K_SENT_A at every run's end and K_END at the stream's; the final type of
every block.  The tape is a capacity: a token past it ends the parse
(done 0, err ERR_OVERFLOW, tok_cnt the capacity).  The window is
golden's (LZ.encode_normal, golden/lz.py:28, 51-75): a ring of the
dictionary's bytes (8 zero bytes past its end), into which each piece is
copied at the ring position wnd_curpos, a piece ending at 8 KB or at the
ring's end, where wnd_curpos wraps to 0; the bytes past a piece are
the previous lap's (zeros in the first lap), and every finder's climit
stops a source at the ring's end (min(limit, wnd_size - cmp_pos)).  At
ring position 0 the literal price's context is 0 (golden/lz.py:269).  A
stream its dictionary covers never wraps, and its window is the stream's
own length (plus the 8 bytes).  Used by the tests and by the CPU path;
the card runs K6 (csrc/encode_k6.cuh).

The binary tree (mf.py:46-71, 114-195, 198-231, 335-404, 504-508; m5):
a head of 1 << bt_bits entries and a left and a right link for each of
bt_size slots, a position's slot bt_pos advancing with the positions.
A find walks the tree from the head (after the head candidate beyond
the tree's range, which has no distance limit but vld_rge), re-linking
the position into it as it goes, at most bt_cyc nodes, a link copied at
a good_len match; slide_pos inserts each position it does not skip the
same way (its compare capped at good_len), slide_pos_fast zeroes the
links of the 1/16 of positions it inserts, and test_find probes the
head.  A find records lengths up to good_len - 1 = 47 with their prices
(a length past 33 prices 768, no call of the length cache); find_match
keeps 30 records (MF_CAND_LIMIT: a later one lands in a slot nobody
reads).  Golden's own fault: slide_pos advances bt_pos past an
insertion without wrapping it, and find_match and slide_pos_fast use it
before they wrap, so in a stream longer than bt_size a link index can
reach 2 * bt_size, where golden raises IndexError (mf.py:359).  Here a
tree insertion that starts at bt_pos >= bt_size (the first link it
touches lies past the table) ends the parse there: done 0, err ERR_BT,
the tape as it stands.
"""
import numpy as np
import torch

from .. import native
from ..constants import (DT_NORMAL, DT_NO_LZ, DT_ENTROPY, DT_DLT,
                         DLT_INDEX, ERR_BT, ERR_OVERFLOW, K_LIT, K_MATCH,
                         K_REP,
                         K_REP0L1, K_SENT_A, K_END, MASK32, MF_DIST_BOUND,
                         MF_CAND_LIMIT, MIN_BLOCK_SIZE, HT2_SIZE, HT3_SIZE)
from . import exact_scan, prices
from .encode_host import BLK_TYPE, BLK_SKIP, BLK_CHUNK
from .shadow_model import ShadowModel

AP_LIMIT = 2048          # csc_lz.h:43
INF = 0xFFFFFFFF
DUP_LEN = 19             # the probe hits past 18 equal bytes
STATS = ("stretches", "at_limit", "at_end", "lit_tail", "good_exit",
         "imm_lit", "rep0len1", "probes", "dup_hits", "sparse",
         "entropy_bytes", "rle_runs", "chunks", "gated", "split_rebuilds",
         "bt_finds", "bt_steps", "bt_head_hits", "bt_good_exits",
         "bt_inserts", "bt_sparse", "bt_probe_hits", "bt_records",
         "bt_wraps", "long_lengths", "cand_cap", "ring_wraps",
         "ring_lit0", "ring_cut", "match_reach", "rep_reach")
# `match_reach` / `rep_reach`: the farthest a stretch's cell lies from its
# back cell where a match / a rep match entered it
MAX_GOOD_BT = 48          # m5's good_len: lengths 2 .. 47 a find
CAND_SLOTS = MF_CAND_LIMIT - 2  # find_match's records that are read


class BT:
    """The binary-tree finder of a preset (props bt_size, bt_hash_bits,
    bt_cyc), or none (size 0)."""

    def __init__(self, size=0, bits=0, cyc=32):
        self.size, self.bits, self.cyc = (size, bits, cyc) if size else (
            0, 0, cyc)

    @classmethod
    def of(cls, props):
        return cls(props.bt_size, props.bt_hash_bits, props.bt_cyc)


def check_inputs(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                 good_len, bt=None):
    """Raise on inputs K6 and this version do not take: K5's (ops/
    exact_scan.py; hash_width 0 with the binary tree), or a good_len past
    the lanes' lengths (32, or 48 with the binary tree)."""
    tree = bt is not None and bt.size > 0
    exact_scan.check_inputs(data, blocks, sizes, dict_sizes, hash_bits,
                            max(hash_width, 1) if tree else hash_width,
                            good_len)
    if good_len > (MAX_GOOD_BT if tree else 32):
        raise ValueError(f"good_len must be at most "
                         f"{MAX_GOOD_BT if tree else 32}, got {good_len}")
    if tree and (hash_width or not 1 <= bt.bits <= 25 or bt.cyc < 1):
        raise ValueError(f"the binary tree takes hash_width 0, bt_bits in "
                         f"[1, 25] and bt_cyc >= 1, got {hash_width}, "
                         f"{bt.bits}, {bt.cyc}")


def hash2(b0, b1):
    return ((b0 | (b1 << 8)) * 65521) & 0x3FFF


def hash3(b0, b1, b2):
    return ((b0 << 8) ^ (b1 << 5) ^ b2) & 0xFFFF


def hash6(w, p, bits):
    v = w[p] | (w[p + 1] << 8) | (w[p + 2] << 16) | (w[p + 3] << 24)
    v2 = w[p + 4] | (w[p + 5] << 8)
    return (((v ^ (v2 << 13)) * 2654435761) & MASK32) >> (32 - bits)


class _Full(Exception):
    """A token past the tape's capacity."""


class _BtFault(Exception):
    """A tree link index past 2 * bt_size: golden's IndexError."""


class _Stream:
    """One stream's parse: golden's LZ, MatchFinder (HT) and the walk of
    CSCEncoder::Compress, the shadow model in the coder's place."""

    def __init__(self, data, size, dict_size, hash_bits, hash_width,
                 good_len, cap, bt=None, bt_size=None):
        self.data = data
        self.size = size
        self.wnd_size = dict_size
        # golden's ring (its 8 bytes of padding past the end); a stream
        # the dictionary covers needs no more than its own length
        self.wnd = bytearray(min(size, dict_size) + 8)
        bt = bt or BT()
        self.bt_size = bt.size if bt_size is None else bt_size
        self.bt_bits, self.bt_cyc = bt.bits, bt.cyc
        self.bt_pos = 0
        if self.bt_size:
            self.bt_head = [0] * (1 << self.bt_bits)
            # golden's 2 * bt_size links; a stream shorter than bt_size
            # never reaches past its own positions
            self.bt_nodes = [0] * (2 * min(self.bt_size, size + 1))
        self.wnd_curpos = 0
        self.rep_dist = [dict_size] * 4
        self.vld_rge = dict_size - MIN_BLOCK_SIZE - 4
        self.pos = self.vld_rge
        self.bits = hash_bits
        self.width = hash_width
        self.good_len = good_len
        self.ht2 = [0] * HT2_SIZE
        self.ht3 = [0] * HT3_SIZE
        self.ht6 = [0] * (hash_width << hash_bits)
        self.model = ShadowModel()
        self.tape = []
        self.cap = cap
        self.stats = dict.fromkeys(STATS, 0)
        self.btypes = []
        self.c_len = [0] * MF_CAND_LIMIT
        self.c_dist = [0] * MF_CAND_LIMIT
        self.r_len = [0] * (good_len + 2)
        self.r_dist = [0] * (good_len + 2)
        self.r_price = [0] * (good_len + 2)
        n = AP_LIMIT + 1
        self.ap_dist, self.ap_state = [0] * n, [0] * n
        self.ap_back, self.ap_next = [0] * n, [0] * n
        self.ap_price, self.ap_lit = [0] * n, [0] * n
        self.ap_rep = [[0] * 4 for _ in range(n)]

    # ---------------------------------------------------------- the tape
    def put(self, w0, w1=0):
        if len(self.tape) >= self.cap:
            raise _Full
        self.tape.append((w0, w1))

    def token(self, length, dist, last):
        """One token (encode_nonlit's coordinates: dist 0 a literal, 1-4
        a rep, else 4 + the distance) on the tape and through the model;
        `last` the byte at its end (the literal's own)."""
        m = self.model
        if dist == 0:
            self.put(K_LIT)
            m.literal(last)
            return
        if dist == 1 and length == 1:
            self.put(K_REP0L1)
            m.rep0len1()
            self.stats["rep0len1"] += 1
        elif dist <= 4:
            self.put(K_REP | (length - 2) << 3, dist - 1)
            m.repdist(dist - 1, length - 2)
        else:
            self.put(K_MATCH | (length - 2) << 3, dist - 5)
            m.match(length - 2)
        m.ctx = last

    # -------------------------------------------------------- the finder
    def _extend(self, wpos, cmp_pos, climit):
        wnd = self.wnd
        n = 0
        step = 128
        while n < climit:
            m = min(step, climit - n)
            a = wnd[wpos + n:wpos + n + m]
            b = wnd[cmp_pos + n:cmp_pos + n + m]
            if a == b:
                n += m
                step = min(step * 2, 4096)
                continue
            for i in range(m):
                if a[i] != b[i]:
                    return n + i
            return n + m
        return n

    def find_match(self, rep_dist, wpos, limit):
        """find_match (csc_mf.cpp:243-495): the candidates into c_len /
        c_dist [1 ..], their count returned (at most CAND_SLOTS: a later
        record lands in the last slot, which is not counted)."""
        wnd, vld = self.wnd, self.vld_rge
        wnd_size, good, bound = self.wnd_size, self.good_len, MF_DIST_BOUND
        out_len, out_dist = self.c_len, self.c_dist
        h2 = hash2(wnd[wpos], wnd[wpos + 1])
        h3 = hash3(wnd[wpos], wnd[wpos + 1], wnd[wpos + 2])
        minlen, cnt, dist = 1, 1, 0

        def rec(length, code):
            nonlocal cnt
            out_len[cnt] = length
            out_dist[cnt] = code
            if cnt + 1 < MF_CAND_LIMIT:
                cnt += 1
            else:
                self.stats["cand_cap"] += 1

        for i in range(4):
            rd = rep_dist[i]
            if rd >= vld:
                continue
            cmp_pos = wpos - rd if wpos >= rd else wpos + wnd_size - rd
            climit = min(limit, wnd_size - cmp_pos)
            self.stats["ring_cut"] += climit < limit
            if minlen >= climit or wnd[cmp_pos + minlen] != wnd[wpos + minlen]:
                continue
            match_len = self._extend(wpos, cmp_pos, climit)
            if match_len and i == 0:
                rec(1, 1)
            if match_len > minlen:
                minlen = match_len
                rec(match_len, 1 + i)
                if match_len >= good:
                    dist = MASK32
                    break

        for table, h, strict in ((self.ht2, h2, True), (self.ht3, h3, False)):
            if ((self.pos - table[h]) & MASK32) <= dist:
                continue
            dist = (self.pos - table[h]) & MASK32
            if dist >= vld:
                continue
            # HT2's strict wpos > dist (csc_mf.cpp:306), HT3's >=
            if wpos > dist or (not strict and wpos == dist):
                cmp_pos = wpos - dist
            else:
                cmp_pos = wpos + wnd_size - dist
            climit = min(limit, wnd_size - cmp_pos)
            self.stats["ring_cut"] += climit < limit
            if minlen >= climit or wnd[cmp_pos + minlen] != wnd[wpos + minlen]:
                continue
            match_len = self._extend(wpos, cmp_pos, climit)
            if match_len > minlen:
                minlen = match_len
                if match_len <= 6 and dist >= bound[match_len]:
                    continue
                rec(match_len, 4 + dist)
                if match_len >= good:
                    dist = MASK32
        self.ht2[h2] = self.pos
        self.ht3[h3] = self.pos
        if self.bt_size:
            self.bt_walk(wpos, limit, minlen, rec)
            self.pos += 1
            return cnt - 1

        ht6, base = self.ht6, hash6(wnd, wpos, self.bits) * self.width
        for i in range(self.width):
            cand_dist = (self.pos - ht6[base + i]) & MASK32
            if cand_dist <= dist:
                continue
            dist = cand_dist
            if dist >= vld:
                continue
            cmp_pos = wpos - dist if wpos >= dist else wpos + wnd_size - dist
            climit = min(limit, wnd_size - cmp_pos)
            self.stats["ring_cut"] += climit < limit
            if minlen >= climit or wnd[cmp_pos + minlen] != wnd[wpos + minlen]:
                continue
            match_len = self._extend(wpos, cmp_pos, climit)
            if match_len > minlen:
                minlen = match_len
                if match_len <= 6 and dist >= bound[match_len]:
                    continue
                rec(match_len, 4 + dist)
                if match_len >= good:
                    break
        ht6[base + 1:base + self.width] = ht6[base:base + self.width - 1]
        ht6[base] = self.pos
        self.pos += 1
        return cnt - 1

    def bt_walk(self, wpos, limit, minlen=1, rec=None):
        """The tree's walk at wpos (limit the bytes to the piece's end):
        find_match's (mf.py:335-404; rec given: the head candidate beyond
        the tree's range first, then the walk that records each longer
        match, its compare up to climit, bt_pos wrapped after it) or
        slide_pos's insertion (mf.py:155-192: the compare capped at
        good_len, no records, bt_pos wrapped before it and advanced after
        it without a wrap), re-linking wpos into the tree; the head set.
        minlen is the finder's so far."""
        wnd, vld, st = self.wnd, self.vld_rge, self.stats
        wnd_size, good, bound = self.wnd_size, self.good_len, MF_DIST_BOUND
        bsz, nodes, find = self.bt_size, self.bt_nodes, rec is not None
        st["bt_finds" if find else "bt_inserts"] += 1
        hbt = hash6(wnd, wpos, self.bt_bits)
        dist = (self.pos - self.bt_head[hbt]) & MASK32
        if find and bsz <= dist < vld:
            # the head beyond the tree's range: no distance limit
            cmp_pos = wpos - dist if wpos >= dist else wpos + wnd_size - dist
            climit = min(limit, wnd_size - cmp_pos)
            st["ring_cut"] += climit < limit
            if minlen < climit and wnd[cmp_pos + minlen] == wnd[wpos + minlen]:
                match_len = self._extend(wpos, cmp_pos, climit)
                if match_len > minlen:
                    minlen = match_len
                    if match_len > 6 or dist < bound[match_len]:
                        rec(match_len, 4 + dist)
                        st["bt_head_hits"] += 1
        if not find and self.bt_pos >= bsz:
            self.bt_pos -= bsz
        if self.bt_pos >= bsz:
            raise _BtFault       # the walk's first link lies past the table
        l_idx = self.bt_pos * 2
        r_idx = l_idx + 1
        lenl = lenr = cyc = 0
        while True:
            if cyc >= self.bt_cyc or dist >= bsz or dist >= vld:
                nodes[l_idx] = nodes[r_idx] = 0
                break
            cyc += 1
            st["bt_steps"] += 1
            cmp_pos = wpos - dist if wpos >= dist else wpos + wnd_size - dist
            clen = min(lenl, lenr)
            climit = min(limit, wnd_size - cmp_pos)
            st["ring_cut"] += climit < limit
            if clen >= climit:
                nodes[l_idx] = nodes[r_idx] = 0
                break
            tlast = 2 * (self.bt_pos - dist if self.bt_pos >= dist
                         else self.bt_pos + bsz - dist)
            if wnd[wpos + clen] == wnd[cmp_pos + clen]:
                climit2 = climit if find else min(good, climit)
                clen += 1 + self._extend(wpos + clen + 1, cmp_pos + clen + 1,
                                         climit2 - clen - 1)
                if find and clen > minlen:
                    minlen = clen
                    if clen > 6 or dist < bound[clen]:
                        rec(clen, 4 + dist)
                        st["bt_records"] += 1
                if clen >= good:
                    nodes[l_idx] = nodes[tlast]
                    nodes[r_idx] = nodes[tlast + 1]
                    st["bt_good_exits"] += 1
                    break
                if clen >= climit2:
                    nodes[l_idx] = nodes[r_idx] = 0
                    break
            if wnd[cmp_pos + clen] < wnd[wpos + clen]:
                nodes[l_idx] = (self.pos - dist) & MASK32
                l_idx = tlast + 1
                dist = (self.pos - nodes[l_idx]) & MASK32
                lenl = clen
            else:
                nodes[r_idx] = (self.pos - dist) & MASK32
                r_idx = tlast
                dist = (self.pos - nodes[r_idx]) & MASK32
                lenr = clen
        self.bt_head[hbt] = self.pos
        self.bt_pos += 1
        if find and self.bt_pos >= bsz:
            self.bt_pos -= bsz
            st["bt_wraps"] += 1

    def find_match_with_price(self, state, rep_dist, wpos, limit):
        """FindMatchWithPrice (csc_mf.cpp:584-625): r_len[0] / r_dist[0]
        the last candidate (the longest), r_dist / r_price [1 ..] the
        price of each length (r_dist 0: none), priced at `state` by the
        live model; an early return at good_len fills r_*[0] alone."""
        m = self.model
        n = self.find_match(rep_dist, wpos, limit)
        r_len, r_dist, r_price = self.r_len, self.r_dist, self.r_price
        r_len[0] = self.c_len[n] if n else 1
        r_dist[0] = self.c_dist[n] if n else 0
        if r_len[0] >= self.good_len:
            return
        r_dist[1] = 0
        lpos = 1
        bound = MF_DIST_BOUND
        # a rebuild of the length cache after a counted call of this find
        # (the calls before it read the old cache: K6's lanes split there)
        rebuilds, calls = m.lp_rebuilds, m.lp_calls
        for i in range(1, n + 1):
            length, code = self.c_len[i], self.c_dist[i]
            if length == 1 and code == 1:
                r_price[1] = prices.rep0len1_price(m, state)
                r_dist[1] = 1
                continue
            if code <= 4:
                distprice = prices.repdist_price(m, state, code - 1)
                rdist = 0
            else:
                distprice = prices.matchdist_price(m, state, code - 5)
                rdist = code - 4
            while lpos < length:
                lpos += 1
                if lpos <= 6 and rdist >= bound[lpos]:
                    r_dist[lpos] = 0
                    self.stats["gated"] += 1
                    continue
                self.stats["long_lengths"] += lpos >= 34
                r_dist[lpos] = code
                r_price[lpos] = distprice + prices.matchlen_price(
                    m, lpos - 2)
                if m.lp_rebuilds != rebuilds:
                    self.stats["split_rebuilds"] += m.lp_calls - 1 > calls
                    rebuilds = m.lp_rebuilds

    def slide_pos(self, wnd_pos, length, limit):
        """SlidePos (csc_mf.cpp:134-206): insert wnd_pos + 1 .. + length
        - 1 (limit bytes from wnd_pos to the piece's end), four a step
        into HT2 / HT3 alone while i + 128 < length (bt_pos advancing by
        four), then the HT6 row shifted only for a hash other than the
        last one inserted (lasth6 = 0 at the start), or the tree's
        insertion."""
        wnd, w = self.wnd, self.width
        ht6 = self.ht6
        lasth6 = 0
        i = 1
        while i < length:
            wpos = wnd_pos + i
            self.ht2[hash2(wnd[wpos], wnd[wpos + 1])] = self.pos
            self.ht3[hash3(wnd[wpos], wnd[wpos + 1], wnd[wpos + 2])] = \
                self.pos
            if i + 128 < length:
                i += 4
                self.pos += 4
                self.bt_pos += 4
                continue
            if self.bt_size:
                self.bt_walk(wpos, limit - i)
                self.pos += 1
                i += 1
                continue
            h6 = hash6(wnd, wpos, self.bits)
            base = h6 * w
            if h6 != lasth6:
                ht6[base + 1:base + w] = ht6[base:base + w - 1]
            ht6[base] = self.pos
            lasth6 = h6
            self.pos += 1
            i += 1

    def slide_pos_fast(self, wnd_pos, length):
        """SlidePosFast (csc_mf.cpp:208-241): at the positions whose
        HASH2 is a multiple of 16, the HT6 row alone, or the tree's head
        with the position's links zeroed; bt_pos advancing and wrapping
        at every position."""
        wnd, w, ht6 = self.wnd, self.width, self.ht6
        bsz = self.bt_size
        for i in range(length):
            wpos = wnd_pos + i
            if hash2(wnd[wpos], wnd[wpos + 1]) % 16 == 0:
                if bsz:
                    if self.bt_pos >= bsz:
                        raise _BtFault
                    self.bt_nodes[2 * self.bt_pos] = 0
                    self.bt_nodes[2 * self.bt_pos + 1] = 0
                    self.bt_head[hash6(wnd, wpos, self.bt_bits)] = self.pos
                    self.stats["bt_sparse"] += 1
                else:
                    base = hash6(wnd, wpos, self.bits) * w
                    ht6[base + 1:base + w] = ht6[base:base + w - 1]
                    ht6[base] = self.pos
            self.pos += 1
            if bsz:
                self.bt_pos += 1
                if self.bt_pos >= bsz:
                    self.bt_pos -= bsz

    def is_duplicate_block(self, off, size):
        """IsDuplicateBlock (csc_lz.cpp:102-112, TestFind csc_mf.cpp:
        526-568): a position whose HASH2 is a multiple of 16 and whose
        HT6 row head (or the tree's head, mf.py:504-508) matches more than
        18 bytes from the window's frontier on; the block's bytes past the
        stream read as zeros."""
        data, wnd, n = self.data, self.wnd, len(self.data)
        wpos = self.wnd_curpos

        def b(k):
            return data[k] if k < n else 0
        for i in range(size):
            p, limit = off + i, size - i
            if hash2(b(p), b(p + 1)) % 16:
                continue
            v = b(p) | (b(p + 1) << 8) | (b(p + 2) << 16) | (b(p + 3) << 24)
            v2 = b(p + 4) | (b(p + 5) << 8)
            hv = ((v ^ (v2 << 13)) * 2654435761) & MASK32
            if self.bt_size:
                head = self.bt_head[hv >> (32 - self.bt_bits)]
            else:
                head = self.ht6[(hv >> (32 - self.bits)) * self.width]
            dist = (self.pos - head) & MASK32
            if dist >= self.vld_rge:
                continue
            cmp_pos = wpos - dist if wpos >= dist \
                else wpos + self.wnd_size - dist
            climit = min(limit, self.wnd_size - cmp_pos)
            k = 0
            while k < climit and b(p + k) == wnd[cmp_pos + k]:
                k += 1
            if k > DUP_LEN - 1:
                self.stats["bt_probe_hits"] += self.bt_size > 0
                return True
        return False

    # ------------------------------------------------------ the LZ parse
    def encode_normal(self, off, size, lz):
        """EncodeNormal (csc_lz.cpp:61-100) of data[off, off + size):
        pieces of 8 KB, or up to the ring's end, copied into the window,
        each parsed (lz) or sparsely inserted (no-LZ), wnd_curpos wrapping
        at the ring's end; an LZ run ends with the sentinel."""
        i = 0
        while i < size:
            cur = min(self.wnd_size - self.wnd_curpos, size - i,
                      MIN_BLOCK_SIZE)
            at = self.wnd_curpos
            self.wnd[at:at + cur] = self.data[off + i:off + i + cur]
            if lz:
                self.compress_advanced(cur)
            else:
                self.slide_pos_fast(at, cur)
                self.wnd_curpos += cur
                self.stats["sparse"] += 1
            if self.wnd_curpos >= self.wnd_size:
                self.wnd_curpos = 0
                self.stats["ring_wraps"] += 1
            i += cur
        if lz:
            self.model.sentinel()

    def encode_nonlit(self, length, dist):
        """encode_nonlit (csc_lz.cpp:127-154): the token and the rep
        queue."""
        rd = self.rep_dist
        self.token(length, dist, self.wnd[self.wnd_curpos + length - 1])
        if dist > 4:
            rd[1:] = rd[:3]
            rd[0] = dist - 4
        elif not (dist == 1 and length == 1):
            rd[:dist] = [rd[dist - 1]] + rd[:dist - 1]

    def ap_backward(self, end):
        """ap_backward (csc_lz.cpp:335-362): the stretch's path from its
        end back, then its tokens coded in order; the rep queue the end
        cell's."""
        back, nxt, dist, lit = self.ap_back, self.ap_next, self.ap_dist, \
            self.ap_lit
        i = end
        while i:
            nxt[back[i]] = i
            i = back[i]
        i = 0
        while i != end:
            n = nxt[i]
            self.token(n - i, dist[n], lit[n - 1])
            i = n
        self.rep_dist[:] = self.ap_rep[end]

    def _cap(self, extent, aplimit):
        """A stretch that covered `extent` positions ended at its cap:
        AP_LIMIT, or the piece's end (aplimit below AP_LIMIT).  (Its
        `apcur == aplimit` exit is never taken: at aplimit - 1 a match
        reaching the cap or the literal tail ends the stretch first.)"""
        if extent >= aplimit:
            self.stats["at_limit" if aplimit == AP_LIMIT else "at_end"] += 1

    def compress_advanced(self, size):
        """compress_advanced (csc_lz.cpp:207-333): the forward DP over
        stretches of at most AP_LIMIT positions of an 8 KB piece."""
        m, wnd = self.model, self.wnd
        r_len, r_dist, r_price = self.r_len, self.r_dist, self.r_price
        a_dist, a_state, a_back = self.ap_dist, self.ap_state, self.ap_back
        a_price, a_lit, a_rep = self.ap_price, self.ap_lit, self.ap_rep
        st = self.stats
        good = self.good_len
        i = 0
        while i < size:
            self.find_match_with_price(m.state, self.rep_dist,
                                       self.wnd_curpos, size - i)
            if r_dist[0] == 0:
                self.token(1, 0, wnd[self.wnd_curpos])
                st["imm_lit"] += 1
                i += 1
                self.wnd_curpos += 1
                continue
            st["stretches"] += 1
            apend = 1
            a_price[0] = 0
            a_back[0] = 0
            a_rep[0][:] = self.rep_dist
            a_state[0] = m.state
            aplimit = min(AP_LIMIT, size - i)
            apcur = 0
            while True:
                cur = self.wnd_curpos
                a_lit[apcur] = wnd[cur]
                if apcur:
                    back = a_back[apcur]
                    d = a_dist[apcur]
                    if d and apcur - back > 1:
                        k = "match_reach" if d > 4 else "rep_reach"
                        st[k] = max(st[k], apcur - back)
                    rep, brep = a_rep[apcur], a_rep[back]
                    rep[:] = brep
                    s = a_state[back]
                    if d == 0:
                        a_state[apcur] = (s * 4) & 0x3F
                    elif d <= 4:
                        if apcur - back == 1 and d == 1:
                            a_state[apcur] = (s * 4 + 2) & 0x3F
                        else:
                            a_state[apcur] = (s * 4 + 3) & 0x3F
                            rep[:d] = [brep[d - 1]] + brep[:d - 1]
                    else:
                        a_state[apcur] = (s * 4 + 1) & 0x3F
                        rep[1:] = brep[:3]
                        rep[0] = d - 4
                    if apcur < aplimit:
                        self.find_match_with_price(
                            a_state[apcur], rep, cur, size - i - apcur)
                if apcur == aplimit:
                    self.ap_backward(apcur)
                    i += apcur
                    break
                if r_len[0] == 1 and apcur + 1 == apend:
                    self.ap_backward(apcur)
                    self.token(1, 0, a_lit[apcur])
                    st["lit_tail"] += 1
                    self._cap(apcur + 1, aplimit)
                    i += apcur + 1
                    self.wnd_curpos += 1
                    break
                if apcur + 1 >= apend:
                    a_price[apend] = INF
                    apend += 1
                length = r_len[0]
                if length >= good or (length > 1
                                      and length + apcur >= aplimit):
                    self.ap_backward(apcur)
                    st["good_exit"] += 1
                    self._cap(apcur + length, aplimit)
                    i += apcur
                    self.encode_nonlit(length, r_dist[0])
                    self.slide_pos(cur, length, size - i)
                    i += length
                    self.wnd_curpos += length
                    break
                here = a_price[apcur]
                st["ring_lit0"] += cur == 0 and st["ring_wraps"] > 0
                cprice = prices.literal_price(m, a_state[apcur],
                                              wnd[cur - 1] if cur else 0,
                                              wnd[cur])
                if cprice + here < a_price[apcur + 1]:
                    a_dist[apcur + 1] = 0
                    a_back[apcur + 1] = apcur
                    a_price[apcur + 1] = cprice + here
                if r_dist[1] and r_price[1] + here < a_price[apcur + 1]:
                    a_dist[apcur + 1] = 1
                    a_back[apcur + 1] = apcur
                    a_price[apcur + 1] = r_price[1] + here
                while apcur + length >= apend:
                    a_price[apend] = INF
                    apend += 1
                while length > 1:
                    if (r_dist[length] and r_price[length] + here
                            < a_price[apcur + length]):
                        a_dist[apcur + length] = r_dist[length]
                        a_back[apcur + length] = apcur
                        a_price[apcur + length] = r_price[length] + here
                    length -= 1
                apcur += 1
                self.wnd_curpos += 1

    # ------------------------------------------------------ the run walk
    def compress_block(self, off, size, t):
        """_compress_block (golden/encoder.py:28-73) of one run, its
        model events, and the run's end on the tape."""
        if t < DT_NO_LZ:
            self.encode_normal(off, size, True)
        else:
            self.encode_normal(off, size, False)
            raw = self.data[off:off + size]
            if t == DT_ENTROPY:
                self.model.literals(raw)
                self.stats["entropy_bytes"] += size
            elif t >= DT_DLT:
                seg = bytearray(raw)
                native.delta_forward(seg, DLT_INDEX[t - DT_DLT])
                self.stats["rle_runs"] += self.model.rle(seg)
        self.put(K_SENT_A)

    def run(self, blocks):
        """CSCEncoder::Compress (golden/encoder.py:75-123) over the
        block table: per raw chunk, each block typed (DT_SKIP resolved,
        the duplicate-block probe for a no-LZ type) and merged into
        runs; returns the blocks' final types."""
        ends = [int(e) for e in blocks[:, 0]]
        info = [int(v) for v in blocks[:, 1]]
        nb = len(ends)
        btypes = self.btypes = [0] * nb
        j = 0
        while j < nb and (ends[j - 1] if j else 0) < self.size:
            # one raw chunk: blocks j .. k - 1
            k = j + 1
            while k < nb and not info[k] & BLK_CHUNK:
                k += 1
            self.stats["chunks"] += 1
            last_type, last_size = DT_NORMAL, 0
            last_begin = ends[j - 1] if j else 0
            for q in range(j, k):
                start = ends[q - 1] if q else 0
                if start >= self.size:
                    break       # the table's padding past the stream
                cur = ends[q] - start
                t = info[q] & BLK_TYPE
                if info[q] & BLK_SKIP and (q == j or last_type == DT_NORMAL):
                    t = DT_NORMAL
                if t >= DT_NO_LZ:
                    self.stats["probes"] += 1
                    if self.is_duplicate_block(start, cur):
                        t = DT_NORMAL
                        self.stats["dup_hits"] += 1
                btypes[q] = t
                if last_type != t:
                    if last_size:
                        self.compress_block(last_begin, last_size,
                                            last_type)
                    last_begin, last_size = start, 0
                last_type = t
                last_size += cur
            if last_size:
                self.compress_block(last_begin, last_size, last_type)
            j = k
        self.put(K_END)


def parse_stream(data, blocks, size, dict_size, hash_bits, hash_width,
                 good_len, cap, bt=None, bt_size=None):
    """One stream's parse: (tape words [(w0, w1)], done, err, btypes (the
    blocks typed so far when the tape filled or the tree faulted), the
    stream's _Stream for its model and counters)."""
    s = _Stream(bytes(data[:size]), size, dict_size, hash_bits,
                hash_width, good_len, cap, bt, bt_size)
    try:
        s.run(blocks)
        done, err = 1, 0
    except _Full:
        done, err = 0, ERR_OVERFLOW
    except _BtFault:
        done, err = 0, ERR_BT
    return s.tape, done, err, s.btypes, s


def exact_ap_plain(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                   good_len, max_tokens, bt=None, bt_sizes=None,
                   trace=None):
    """K6's function on data's device (the CPU): (tape [B, max_tokens,
    2] i32 of (kind | wire_len << 3, dist_code), tok_cnt, done, err [B]
    i32, btypes [B, NB] i32).  bt, a BT, gives the binary tree's bits
    and cycles and, unless bt_sizes ([B] i32) gives each stream's, its
    size.  trace, a list, gets each stream's _Stream (its `model` and
    `stats`).  A stream whose tape filled, or whose tree faulted (err
    ERR_BT), has the types of the blocks its walk reached."""
    check_inputs(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                 good_len, bt)
    b = data.shape[0]
    bts = ([int(v) for v in bt_sizes] if bt_sizes is not None
           else [bt.size if bt else 0] * b)
    data_np = data.cpu().numpy()
    blocks_np = blocks.cpu().numpy()
    tape = np.zeros((b, max_tokens, 2), np.int32)
    out = np.zeros((3, b), np.int32)
    btypes = np.zeros(blocks_np.shape[:2], np.int32)
    for j in range(b):
        words, done, err, types, s = parse_stream(
            data_np[j], blocks_np[j], int(sizes[j]), int(dict_sizes[j]),
            hash_bits, hash_width, good_len, max_tokens, bt, bts[j])
        if words:
            tape[j, :len(words)] = words
        out[:, j] = (len(words), done, err)
        btypes[j] = types
        if trace is not None:
            trace.append(s)
    dev = data.device
    t = [torch.from_numpy(a).to(dev) for a in (tape, out[0], out[1],
                                               out[2], btypes)]
    return tuple(t)
