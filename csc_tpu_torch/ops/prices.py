"""The optimal parse's price tables at the initial model, where every
probability is 2048 (csc_model.cpp:100-131, Init).

The port's own copy of csc_tpu/ops/parse_ap.py `snapshot_prices` and of
what it reads of csc_tpu.golden.model.Model: the p_2_bits price table
(csc_model.cpp:68-70), FEncodeBit (`fprice`, csc_model.cpp:161-167),
GetRep0Len1Price (:209-216), GetRepDistPrice (:273-284) and
len_price_rebuild (:234-270).  Prices are in 1/128 bit.
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
