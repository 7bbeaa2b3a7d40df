"""The adaptive model's state that the optimal parse's prices read, with
one update function a coded event: the exact optimal parse (K6) prices
each stretch by the model as every earlier symbol left it, so it carries
the probabilities the coder updates.

The port's own copy of what it needs of csc_tpu/golden/model.py (Model,
csc_model.cpp): the probability tables p_state, p_lit, p_repdist and the
matchlen trees (p_matchlen_slot / extra1 / extra2 / extra3), the pack
state, the literal context and the length-price cache (len_price and its
counter lp_rebuild_int, which ops/prices.py `matchlen_price` keeps).  It
has no range coder: an event adapts the probabilities its bits go
through (csc_coder.h:67-81, `bit`) and nothing else.  It leaves out
p_dist, p_matchdist_extra, p_longlen, p_delta, p_rle_len and p_rle_flag,
which no price reads.

The events, in stream order (golden/encoder.py `_compress_block`,
golden/lz.py):
  literal(c)            EncodeLiteral (model.py:64-76): ctx = c
  rep0len1()            EncodeRep0Len1 (:82-89): ctx = 0 (the parse sets
                        it to the byte after, lz.py:169)
  repdist(idx, lenw)    EncodeRepDistMatch (:134-148)
  match(lenw)           EncodeMatch (:172-195), its distance bits aside
  sentinel()            EncodeMatch(64, 0), an LZ run's end (lz.py:75)
  literals(raw)         CompressLiterals of a DT_ENTROPY run (:217-227)
  rle(delta)            CompressRLE of a DT_DLT run (:229-262): its runs
                        longer than 10 through the matchlen trees
lenw is the wire length, the match length - 2.
"""
from ..constants import PROB_INIT


def bit(probs, idx, v):
    """One coded bit's adaptation (csc_coder.h:67-81)."""
    p = probs[idx]
    probs[idx] = p + ((0xFFF - p) >> 5) if v else p - (p >> 5)


def equal_runs(src):
    """CompressRLE's runs (csc_model.cpp:471-513) of a byte sequence:
    within a maximal stretch [s, e) of equal bytes the literal at s is
    followed by one run of e - s - 1 bytes iff e - s >= 12; yields the run
    lengths."""
    n = len(src)
    s = 0
    for i in range(1, n + 1):
        if i == n or src[i] != src[i - 1]:
            if i - s >= 12:
                yield i - s - 1
            s = i


class ShadowModel:
    """Model's probabilities the prices read, its state and context, and
    the length-price cache; counters of the cache's calls and rebuilds."""

    def __init__(self):
        self.p_state = [PROB_INIT] * (64 * 3)
        self.p_lit = [PROB_INIT] * (256 * 256)
        self.p_repdist = [PROB_INIT] * (64 * 3)
        self.p_matchlen_slot = [PROB_INIT] * 2
        self.p_matchlen_extra1 = [PROB_INIT] * 8
        self.p_matchlen_extra2 = [PROB_INIT] * 8
        self.p_matchlen_extra3 = [PROB_INIT] * 128
        self.state = 0
        self.ctx = 0
        self.lp_rebuild_int = 0
        self.len_price = [0] * 32
        self.lp_calls = 0
        self.lp_rebuilds = 0

    def _tree(self, probs, base, c, top):
        """The bits of c below its leading 1 (at bit `top`), MSB first,
        each through probs[base + its prefix]."""
        for k in range(top - 1, -1, -1):
            bit(probs, base + (c >> (k + 1)), (c >> k) & 1)

    def _matchlen_1(self, length):
        # encode_matchlen_1, csc_model.cpp:113-145
        slot = self.p_matchlen_slot
        if length < 16:
            if length < 8:
                bit(slot, 0, 0)
                self._tree(self.p_matchlen_extra1, 0, length | 8, 3)
            else:
                bit(slot, 0, 1)
                bit(slot, 1, 0)
                self._tree(self.p_matchlen_extra2, 0, (length - 8) | 8, 3)
        else:
            bit(slot, 0, 1)
            bit(slot, 1, 1)
            self._tree(self.p_matchlen_extra3, 0, (length - 16) | 0x80, 7)

    def matchlen(self, length):
        """encode_matchlen_2 (csc_model.cpp:147-159): lengths past 142 go
        out as 143 and the rest (p_longlen's bits between are not
        kept)."""
        if length >= 143:
            self._matchlen_1(143)
            length = (length - 143) % 143
        self._matchlen_1(length)

    def _flag(self, *bits):
        for k, v in enumerate(bits):
            bit(self.p_state, self.state * 3 + k, v)

    def literal(self, c):
        self._flag(0)
        self.state = (self.state * 4) & 0x3F
        self._tree(self.p_lit, self.ctx * 256, c | 0x100, 8)
        self.ctx = c

    def rep0len1(self):
        self._flag(1, 0, 0)
        self.ctx = 0
        self.state = (self.state * 4 + 2) & 0x3F

    def repdist(self, rep_idx, lenw):
        self._flag(1, 0, 1)
        j = (rep_idx >> 1) & 1
        bit(self.p_repdist, self.state * 3, j)
        bit(self.p_repdist, self.state * 3 + 1 + j, rep_idx & 1)
        self.matchlen(lenw)
        self.state = (self.state * 4 + 3) & 0x3F

    def match(self, lenw):
        self._flag(1, 1)
        self.matchlen(lenw)
        self.state = (self.state * 4 + 1) & 0x3F

    def sentinel(self):
        self.match(0)

    def literals(self, raw):
        """CompressLiterals: order-1 literals through p_lit, ctx chained."""
        for c in raw:
            self._tree(self.p_lit, self.ctx * 256, c | 0x100, 8)
            self.ctx = c

    def rle(self, delta):
        """CompressRLE's runs of the delta-filtered bytes: each run of n >
        10 bytes codes n - 11 through the matchlen trees (its literals go
        through p_delta, which no price reads); returns the runs' count."""
        runs = 0
        for n in equal_runs(delta):
            self.matchlen(n - 11)
            runs += 1
        return runs
