"""The optimal parse's prices: the tables at the initial model, where
every probability is 2048 (csc_model.cpp:100-131, Init), which K4 reads,
and the live model's price functions, which the exact optimal parse (K6,
ops/exact_ap_scan.py) reads as every earlier symbol left the model.

The port's own copy of csc_tpu/ops/parse_ap.py `snapshot_prices` and of
what it reads of csc_tpu.golden.model.Model: the p_2_bits price table
(csc_model.cpp:68-70), FEncodeBit (`fprice`, csc_model.cpp:161-167),
GetLiteralPrice (:185-196), GetRep0Len1Price (:209-216), GetRepDistPrice
(:273-284), GetMatchDistPrice (:368-387), GetMatchLenPrice with its cache
(:286-299) and len_price_rebuild (:234-270).  Prices are in 1/128 bit.
The live functions take a shadow_model.ShadowModel.
"""
import math

import numpy as np

from ..constants import PROB_INIT

# p_2_bits: truncated -128 * log2(p / 4096) at the middle of each 8-wide
# probability bucket
P_2_BITS = [int(128 * math.log((i * 8 + 4) / 4096.0) / math.log(0.5))
            for i in range(4096 >> 3)]


def fprice(v, p):
    """The price of coding bit v under probability p (FEncodeBit)."""
    return P_2_BITS[p >> 3] if v else P_2_BITS[(4096 - p) >> 3]


def _rep0len1_price(p_state, s):
    return (fprice(1, p_state[s * 3]) + fprice(0, p_state[s * 3 + 1])
            + fprice(0, p_state[s * 3 + 2]))


def _repdist_price(p_state, p_repdist, s, rep_idx):
    ret = (fprice(1, p_state[s * 3]) + fprice(0, p_state[s * 3 + 1])
           + fprice(1, p_state[s * 3 + 2]))
    j = (rep_idx >> 1) & 1
    ret += fprice(j, p_repdist[s * 3])
    i = 1 + 1 + j
    j = rep_idx & 1
    ret += fprice(j, p_repdist[s * 3 + i - 1])
    return ret


def _len_prices(slot, extra1, extra2, extra3):
    out = []
    for length in range(32):
        ret = 0
        if length < 16:
            if length < 8:
                ret += fprice(0, slot[0])
                p = extra1
            else:
                ret += fprice(1, slot[0]) + fprice(0, slot[1])
                length -= 8
                p = extra2
            c = length | 0x08
            while c < 0x40:
                ret += fprice((c >> 2) & 1, p[c >> 3])
                c <<= 1
        else:
            ret += fprice(1, slot[0]) + fprice(1, slot[1])
            length -= 16
            c = length | 0x80
            while c < 0x4000:
                ret += fprice((c >> 6) & 1, extra3[c >> 7])
                c <<= 1
        out.append(ret)
    return out


def snapshot_prices():
    """The price tables of the initial model, as int32 numpy arrays:
    lit_tree [256] (the literal tree, context 0), flag0 [64] (the literal
    flag at each state), r01 [64], repd [64, 4], matchf [64] (the match
    flag pair, csc_model.cpp:368-373) and lenp [32]."""
    p_state = [PROB_INIT] * (64 * 3)
    p_repdist = [PROB_INIT] * (64 * 3)
    p_lit = [PROB_INIT] * 256
    lit = np.zeros(256, np.int32)
    for c in range(256):
        ret, cc = 0, c | 0x100
        while cc < 0x10000:
            ret += fprice((cc >> 7) & 1, p_lit[cc >> 8])
            cc <<= 1
        lit[c] = ret
    return dict(
        lit_tree=lit,
        flag0=np.array([fprice(0, p_state[s * 3]) for s in range(64)],
                       np.int32),
        r01=np.array([_rep0len1_price(p_state, s) for s in range(64)],
                     np.int32),
        repd=np.array([[_repdist_price(p_state, p_repdist, s, k)
                        for k in range(4)] for s in range(64)], np.int32),
        matchf=np.array([fprice(1, p_state[s * 3])
                         + fprice(1, p_state[s * 3 + 1]) for s in range(64)],
                        np.int32),
        lenp=np.array(_len_prices([PROB_INIT] * 2, [PROB_INIT] * 8,
                                  [PROB_INIT] * 8, [PROB_INIT] * 128),
                      np.int32))


# the tables' order and lengths in the packed int32 vector K4 and the
# plain version take (repd row-major: state * 4 + rep index)
TABLES = (("lit_tree", 256), ("flag0", 64), ("r01", 64), ("repd", 256),
          ("matchf", 64), ("lenp", 32))
PACKED_LEN = sum(n for _, n in TABLES)


def pack_prices(tables):
    """{name: array} -> one int32 numpy vector in TABLES order."""
    return np.concatenate([np.asarray(tables[name], np.int32).reshape(n)
                           for name, n in TABLES])


def unpack_prices(packed):
    """The inverse of pack_prices on a 1-d tensor: {name: int64 tensor},
    repd shaped [64, 4]."""
    out, at = {}, 0
    for name, n in TABLES:
        out[name] = packed[at:at + n].long()
        at += n
    out["repd"] = out["repd"].reshape(64, 4)
    return out


# ------------------------------------------------------------ live model
def literal_price(m, state, ctx, c):
    """GetLiteralPrice: the literal flag at `state`, then c's tree under
    context byte ctx."""
    ret = fprice(0, m.p_state[state * 3])
    base = ctx * 256
    p = m.p_lit
    c |= 0x100
    while c < 0x10000:
        ret += fprice((c >> 7) & 1, p[base + (c >> 8)])
        c <<= 1
    return ret


def rep0len1_price(m, state):
    """GetRep0Len1Price."""
    return _rep0len1_price(m.p_state, state)


def repdist_price(m, state, rep_idx):
    """GetRepDistPrice."""
    return _repdist_price(m.p_state, m.p_repdist, state, rep_idx)


def dist_slot(dist):
    """The slot of a match distance code (csc_model.cpp:331-340, the
    binary search of dist_table): the largest s <= 31 with
    DIST_TABLE[s] <= dist."""
    if dist < 2:
        return max(dist, 0)
    return min(2 + (dist - 1).bit_length() - 1, 31)


def matchdist_price(m, state, dist):
    """GetMatchDistPrice: the match flag pair, then the slot alone at 128
    a bit, slot + 2 bits past slot 2 and 2 bits at slots 0-2 (K4 prices
    the slot as 128 * max(slot + 2, 4), csc_tpu's own parse_ap.py)."""
    slot = dist_slot(dist)
    return (fprice(1, m.p_state[state * 3])
            + fprice(1, m.p_state[state * 3 + 1])
            + (slot + 2 if slot > 2 else 2) * 128)


def len_price_rebuild(m):
    """len_price_rebuild: the cache of the 32 length prices from the
    matchlen trees as they stand; the counter starts again at 4096."""
    m.len_price = _len_prices(m.p_matchlen_slot, m.p_matchlen_extra1,
                              m.p_matchlen_extra2, m.p_matchlen_extra3)
    m.lp_rebuild_int = 4096
    m.lp_rebuilds += 1


def matchlen_price(m, match_len):
    """GetMatchLenPrice: 768 from 32 on (not counted); else the cached
    price, the cache rebuilt on the call that finds the counter at 0 and
    the counter decremented on every other, so every 4 097 counted
    calls."""
    if match_len >= 32:
        return 128 * 6
    m.lp_calls += 1
    if m.lp_rebuild_int == 0:
        len_price_rebuild(m)
    else:
        m.lp_rebuild_int -= 1
    return m.len_price[match_len]
