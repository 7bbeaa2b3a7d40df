"""Plain PyTorch version of the K3 phase-B coder: B stitched token tapes
range- and bit-coded in lockstep, one coded bit, direct-bit write or
carry-run byte per stream per step.

A torch port of csc_tpu/ops/encode_bits.py (`make_bits_state`,
`encode_bits_step`, `run_bits`), field for field: the model FSM of
csc_model.cpp (flags, literal / rep / length / distance trees, EncodeInt,
CompressBad raw bytes, CompressLiterals, CompressRLE), EncodeBit with the
12-bit shift-5 adaptation (csc_coder.h:67-81), EncDirect16 and the
ShiftLow carry run (csc_coder.cpp:76-112), the chunk flush
(csc_coder.cpp:40-74) with probabilities kept across it, and the
64 KB-crossing maps and chunk log that the host remux needs.  One model
state transition per literal (the parked-literal fix, csc_tpu 98304f3).
Every register is int64 (uint32 coder words masked to 32 bits); output
writes clip at the last byte of each buffer while the counters run on,
as in the reference, so a counter past its capacity flags ERR_OVERFLOW.

`bits_plain` runs it to the end and returns what the kernel
(csrc/encode_k3.cuh) returns.  A tape without K_END is coded to its end,
done = 0 (csc_tpu's scan re-reads its last token instead: its pipeline
always ends a tape with K_END).  `modelled_bits` counts the bits each
tape codes through a probability.
"""
import numpy as np
import torch

from ..constants import (DIST_TABLE, REV16_TABLE, P_STATE, P_LIT, P_DIST,
                         P_MDEXTRA, P_MLSLOT, P_MLEX1, P_MLEX2, P_MLEX3,
                         P_LONGLEN, P_REPDIST, P_DELTA, P_RLEFLAG, NPROB,
                         MASK32, K_LIT, K_MATCH, K_REP, K_REP0L1, K_END,
                         K_INT, K_SENT, K_FLUSH, K_RAW, K_ELIT, K_DLIT,
                         K_RLEN, B_DONE, B_NEXT, B_FLAG, B_LITTREE,
                         B_REPTREE, B_LENSLOT, B_LENTREE, B_LONGLEN,
                         B_DISTSLOT, B_DISTEXTRA, B_DISTDIRECT, B_INT,
                         B_FLUSH, B_RAW, B_RLEFLAG, B_DLITTREE, NBSTATES,
                         ERR_OVERFLOW)
from .decode_scan import _PDIST_POS, _PDIST_BITS

REGS = ["rc_cnt", "bc_cnt", "low", "lowhi", "range", "cache", "cachesize",
        "pending", "pend_carry", "bc_val", "bc_bits", "mstate", "ctx",
        "tok_i", "fsm", "kind", "va", "vb", "vc", "flag_i", "node", "bits_c",
        "len_phase", "len_left", "lenv", "len_tbl", "sub_i", "slot", "ebits",
        "elen", "pdist_pos", "sbits", "dir_val", "dir_rem", "after_len",
        "flush_i", "chunk_cnt", "done"]
U32 = {"low", "range", "bc_val"}
TABLES = ["tok_kind", "tok_a", "tok_b", "tok_c", "probs", "rc_out",
          "bc_out", "rc_blkmap", "bc_blkmap", "chunk_log"]
_BIT_STATES = (B_FLAG, B_LITTREE, B_REPTREE, B_LENSLOT, B_LENTREE,
               B_LONGLEN, B_DISTSLOT, B_DISTEXTRA, B_RLEFLAG, B_DLITTREE)
_IS_BIT = np.zeros(NBSTATES, bool)
_IS_BIT[list(_BIT_STATES)] = True
_CONST = {}


def _consts(dev):
    c = _CONST.get(dev)
    if c is None:
        c = {"dist": torch.as_tensor(np.array(DIST_TABLE, np.int64),
                                     device=dev),
             "rev16": torch.as_tensor(np.array(REV16_TABLE, np.int64),
                                      device=dev),
             "pdist_pos": torch.as_tensor(_PDIST_POS, device=dev),
             "pdist_bits": torch.as_tensor(_PDIST_BITS, device=dev),
             "is_bit": torch.as_tensor(_IS_BIT, device=dev)}
        _CONST[dev] = c
    return c


def check_inputs(kind, a, b, c):
    """Raise on tapes K3 and this version do not take: four [B, T] int32
    tensors on one device."""
    for name, t in (("kind", kind), ("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != kind.shape:
            raise ValueError(f"tape {name}: want [B, T] int32 like kind, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != kind.device:
            raise ValueError(f"tape {name} on {t.device}, kind on "
                             f"{kind.device}")


def make_bits_state(kind, a, b, c, max_rc, max_bc, nmap, nchunk):
    """Initial state on the tapes' device (make_bits_state's fields)."""
    check_inputs(kind, a, b, c)
    bsz, dev = kind.shape[0], kind.device
    z = torch.zeros(bsz, dtype=torch.int64, device=dev)
    st = {name: z.clone() for name in REGS}
    st["range"] += MASK32
    st["cachesize"] += 1
    st["fsm"] += B_NEXT
    for name, t in (("tok_kind", kind), ("tok_a", a), ("tok_b", b),
                    ("tok_c", c)):
        st[name] = t
    st["probs"] = torch.full((bsz, NPROB), 2048, dtype=torch.int32,
                             device=dev)
    st["rc_out"] = torch.zeros((bsz, max_rc), dtype=torch.uint8, device=dev)
    st["bc_out"] = torch.zeros((bsz, max_bc), dtype=torch.uint8, device=dev)
    st["rc_blkmap"] = torch.zeros((bsz, nmap), dtype=torch.int32,
                                  device=dev)
    st["bc_blkmap"] = torch.zeros((bsz, nmap), dtype=torch.int32,
                                  device=dev)
    st["chunk_log"] = torch.zeros((bsz, nchunk, 2), dtype=torch.int32,
                                  device=dev)
    return st


def state_from_numpy(st, device):
    """encode_bits' state (numpy or jax arrays) -> this module's state on
    `device`; the JAX state keeps the block size apart (BSIZE_REF)."""
    dev = torch.device(device)
    out = {name: torch.as_tensor(np.asarray(st[name]).astype(np.int64),
                                 device=dev) for name in REGS}
    for name in TABLES:
        out[name] = torch.as_tensor(np.array(st[name]), device=dev)
    return out


def state_to_numpy(st):
    """This module's state -> encode_bits' field names and dtypes."""
    out = {}
    for name in REGS:
        v = st[name].cpu().numpy()
        out[name] = v.astype(np.uint32) if name in U32 else \
            v.astype(np.int32)
    for name in TABLES:
        out[name] = st[name].cpu().numpy().copy()
    return out


def _gather(tbl, idx):
    return tbl.gather(1, idx[:, None])[:, 0].long()


def _put(tbl, idx, mask, val):
    """tbl[b, idx[b]] = val[b] where mask, in place."""
    cur = tbl.gather(1, idx[:, None])[:, 0]
    tbl.scatter_(1, idx[:, None],
                 torch.where(mask, val.to(tbl.dtype), cur)[:, None])


def _log_cross(blkmap, cnt_after, other_cnt, mask, bsize):
    """Record other_cnt at each bsize boundary crossing of cnt_after."""
    crossed = mask & (cnt_after > 0) & (cnt_after % bsize == 0)
    idx = (cnt_after // bsize - 1).clamp(0, blkmap.shape[1] - 1)
    _put(blkmap, idx, crossed, other_cnt)


def _bitlen(v):
    r = torch.zeros_like(v)
    x = v
    for sh in (16, 8, 4, 2, 1):
        big = x >= (1 << sh)
        r = r + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return torch.where(v > 0, r + 1, 0)


def bits_step(st, bsize):
    """One lockstep step of every live stream (encode_bits_step)."""
    k = _consts(st["fsm"].device)
    fsm = st["fsm"]
    alive = st["done"] == 0
    draining = alive & (st["pending"] > 0)
    active = alive & (st["pending"] == 0)
    fsm_a = torch.where(active, fsm, B_DONE)
    has = torch.bincount(fsm_a, minlength=NBSTATES).tolist()
    new = dict(st)

    def upd(name, cond, val):
        new[name] = torch.where(cond, val, new[name])

    if any(has[s] for s in _BIT_STATES):
        _bit_op(st, new, upd, fsm_a, has, k, bsize)
    if has[B_DISTDIRECT] or has[B_RAW] or has[B_INT]:
        _direct_ops(st, new, upd, fsm_a, k, bsize)
    if has[B_FLUSH]:
        _flush_op(st, new, upd, fsm_a, bsize)
    if has[B_NEXT]:
        _next_op(st, new, upd, fsm_a)
    if bool(draining.any()):
        run_byte = (0xFF + st["pend_carry"]) & 0xFF
        cnt = new["rc_cnt"]
        _put(st["rc_out"], cnt.clamp(0, st["rc_out"].shape[1] - 1),
             draining, run_byte)
        cnt = torch.where(draining, cnt + 1, cnt)
        _log_cross(st["rc_blkmap"], cnt, new["bc_cnt"], draining, bsize)
        new["rc_cnt"] = cnt
        new["pending"] = torch.where(draining, st["pending"] - 1,
                                     new["pending"])
    return new


def _bit_op(st, new, upd, fsm_a, has, k, bsize):
    """One range-coded bit: its value and probability from the FSM state,
    EncodeBit, ShiftLow, then the state's transition."""
    node, kind, fi = st["node"], st["kind"], st["flag_i"]
    mstate3 = st["mstate"] * 3
    bits_c, va, vb = st["bits_c"], st["va"], st["vb"]
    is_flag = fsm_a == B_FLAG
    is_lit = fsm_a == B_LITTREE
    is_rept = fsm_a == B_REPTREE
    is_lslot = fsm_a == B_LENSLOT
    is_ltree = fsm_a == B_LENTREE
    is_long = fsm_a == B_LONGLEN
    is_dslot = fsm_a == B_DISTSLOT
    is_dext = fsm_a == B_DISTEXTRA
    is_rlef = fsm_a == B_RLEFLAG
    is_dlit = fsm_a == B_DLITTREE
    is_bit = k["is_bit"][fsm_a]
    is_l3 = st["len_tbl"] != 3

    is_mt = (kind == K_MATCH) | (kind == K_SENT)
    bit = torch.zeros_like(node)
    pidx = torch.zeros_like(node)
    if has[B_FLAG]:
        flag_bit = torch.where(
            kind == K_LIT, 0, torch.where(
                is_mt, 1, torch.where(
                    kind == K_REP0L1, (fi == 0).long(), torch.where(
                        kind == K_REP, torch.where(fi == 1, 0, 1), 0))))
        nflags = torch.where(kind == K_LIT, 1, torch.where(is_mt, 2, 3))
        bit = torch.where(is_flag, flag_bit, bit)
        pidx = torch.where(is_flag, P_STATE + mstate3 + fi, pidx)
    if has[B_LITTREE] or has[B_DLITTREE]:
        bit = torch.where(is_lit | is_dlit, (bits_c >> 7) & 1, bit)
        pidx = torch.where(is_lit, P_LIT + st["ctx"] * 256 + node, pidx)
        pidx = torch.where(is_dlit, P_DELTA + vb * 256 + node, pidx)
    if has[B_REPTREE]:
        bit = torch.where(is_rept, torch.where(st["sub_i"] == 0,
                                               (va >> 1) & 1, va & 1), bit)
        pidx = torch.where(is_rept, P_REPDIST + mstate3 + node - 1, pidx)
    if has[B_LENSLOT]:
        bit = torch.where(is_lslot, torch.where(
            st["sub_i"] == 0, (st["lenv"] >= 8).long(),
            (st["lenv"] >= 16).long()), bit)
        pidx = torch.where(is_lslot, P_MLSLOT + st["sub_i"], pidx)
    if has[B_LENTREE]:
        bit = torch.where(is_ltree, torch.where(is_l3, (bits_c >> 2) & 1,
                                                (bits_c >> 6) & 1), bit)
        ltree_base = torch.where(~is_l3, P_MLEX3, torch.where(
            st["len_tbl"] == 1, P_MLEX1, torch.where(st["len_tbl"] == 2,
                                                     P_MLEX2, 0)))
        pidx = torch.where(is_ltree & (~is_l3 | (st["len_tbl"] == 1)
                                       | (st["len_tbl"] == 2)),
                           ltree_base + node, pidx)
    if has[B_LONGLEN]:
        bit = torch.where(is_long, (st["len_left"] <= 0).long(), bit)
        pidx = torch.where(is_long, P_LONGLEN, pidx)
    if has[B_DISTSLOT]:
        bit = torch.where(is_dslot, (bits_c >> (st["sbits"] - 1).clamp(
            min=0)) & 1, bit)
        pidx = torch.where(is_dslot, P_DIST + st["pdist_pos"] + node, pidx)
    if has[B_DISTEXTRA]:
        bit = torch.where(is_dext, (bits_c >> 3) & 1, bit)
        pidx = torch.where(is_dext, P_MDEXTRA + (st["ebits"] - 1) * 16
                           + node, pidx)
    if has[B_RLEFLAG]:
        bit = torch.where(is_rlef, (kind == K_RLEN).long(), bit)
        pidx = torch.where(is_rlef, P_RLEFLAG, pidx)
    pidx = torch.where(is_bit, pidx, 0)

    # EncodeBit
    probs = st["probs"]
    p = _gather(probs, pidx)
    rng0 = st["range"]
    bound = (rng0 >> 12) * p
    bset = bit == 1
    new_p = torch.where(bset, p + ((0xFFF - p) >> 5), p - (p >> 5))
    _put(probs, pidx, is_bit, new_p)
    rng = torch.where(is_bit, torch.where(bset, bound, rng0 - bound), rng0)
    low_sum = (st["low"] + torch.where(is_bit & ~bset, bound, 0)) & MASK32
    lowhi = st["lowhi"] + (low_sum < st["low"]).long()
    low = low_sum
    renorm = is_bit & (rng < (1 << 24))
    rng = torch.where(renorm, (rng << 8) & MASK32, rng)
    trigger = renorm & ((low < 0xFF000000) | (lowhi != 0))
    carry = torch.where(trigger, lowhi, 0)
    first_byte = (st["cache"] + carry) & 0xFF
    rc_out = st["rc_out"]
    _put(rc_out, st["rc_cnt"].clamp(0, rc_out.shape[1] - 1), trigger,
         first_byte)
    rc_cnt = torch.where(trigger, st["rc_cnt"] + 1, st["rc_cnt"])
    _log_cross(st["rc_blkmap"], rc_cnt, st["bc_cnt"], trigger, bsize)
    run_more = trigger & (st["cachesize"] > 1)
    upd("pending", run_more, st["cachesize"] - 1)
    upd("pend_carry", run_more, carry)
    upd("cache", trigger, (low >> 24) & 0xFF)
    ncsize = torch.where(trigger, 0, st["cachesize"])
    ncsize = torch.where(renorm, ncsize + 1, ncsize)
    upd("cachesize", is_bit, ncsize)
    low = torch.where(renorm, (low << 8) & MASK32, low)
    lowhi = torch.where(renorm, 0, lowhi)
    new["low"] = torch.where(is_bit, low, st["low"])
    new["lowhi"] = torch.where(is_bit, lowhi, st["lowhi"])
    new["range"] = rng
    new["rc_cnt"] = rc_cnt

    nnode = node * 2 + bit
    nsub = st["sub_i"] + 1
    # FLAG
    if has[B_FLAG]:
        c = is_flag
        nfi = fi + 1
        upd("flag_i", c, nfi)
        flags_done = c & (nfi >= nflags)
        fd_lit = flags_done & (kind == K_LIT)
        upd("fsm", fd_lit, B_LITTREE)
        upd("node", fd_lit, 1)
        upd("bits_c", fd_lit, va | 0x100)
        upd("mstate", fd_lit, (st["mstate"] * 4) & 0x3F)
        fd_r01 = flags_done & (kind == K_REP0L1)
        upd("mstate", fd_r01, (st["mstate"] * 4 + 2) & 0x3F)
        upd("ctx", fd_r01, st["vc"])
        upd("fsm", fd_r01, B_NEXT)
        fd_rep = flags_done & (kind == K_REP)
        upd("fsm", fd_rep, B_REPTREE)
        upd("node", fd_rep, 1)
        upd("sub_i", fd_rep, 0)
        fd_match = flags_done & is_mt
        upd("fsm", fd_match, B_LENSLOT)
        upd("sub_i", fd_match, 0)
        upd("after_len", fd_match, 1)
        upd("len_phase", fd_match, 0)
        upd("len_left", fd_match, 0)
        upd("lenv", fd_match, vb.clamp(max=143))

    # LITTREE
    if has[B_LITTREE]:
        upd("bits_c", is_lit, (bits_c << 1) & 0x1FFFF)
        upd("node", is_lit, nnode)
        lit_done = is_lit & (nnode >= 0x100)
        upd("ctx", lit_done, va)
        upd("fsm", lit_done, B_NEXT)

    # REPTREE
    if has[B_REPTREE]:
        upd("node", is_rept, nnode)
        upd("sub_i", is_rept, nsub)
        rep_done = is_rept & (nsub >= 2)
        upd("fsm", rep_done, B_LENSLOT)
        upd("sub_i", rep_done, 0)
        upd("after_len", rep_done, 0)
        upd("len_phase", rep_done, 0)
        upd("len_left", rep_done, 0)
        upd("lenv", rep_done, vb.clamp(max=143))

    # LENSLOT
    if has[B_LENSLOT]:
        lv = st["lenv"]
        slot_done = is_lslot & ((lv < 8) | (nsub >= 2))
        upd("sub_i", is_lslot & ~slot_done, nsub)
        tbl = torch.where(lv < 8, 1, torch.where(lv < 16, 2, 3))
        lbase = torch.where(lv < 8, 0, torch.where(lv < 16, 8, 16))
        tree_c = torch.where(tbl == 3, (lv - 16) | 0x80, (lv - lbase) | 0x08)
        upd("len_tbl", slot_done, tbl)
        upd("bits_c", slot_done, tree_c)
        upd("node", slot_done, 1)
        upd("fsm", slot_done, B_LENTREE)

    # LENTREE
    if has[B_LENTREE]:
        upd("bits_c", is_ltree, (bits_c << 1) & 0x7FFF)
        upd("node", is_ltree, nnode)
        t_done = is_ltree & torch.where(is_l3, nnode >= 0x8, nnode >= 0x80)
        # matchlen_2: 143 in phase 0 with a longer real length continues in
        # the long-length loop (csc_model.cpp:147-159)
        was143 = (st["len_phase"] == 0) & (vb >= 143)
        go_long = t_done & was143
        upd("fsm", go_long, B_LONGLEN)
        upd("len_left", go_long, (vb - 143) // 143)
        len_fin = t_done & ~was143
        lf_rep = len_fin & (st["after_len"] == 0)
        upd("mstate", lf_rep, (st["mstate"] * 4 + 3) & 0x3F)
        upd("ctx", lf_rep, st["vc"])
        upd("fsm", lf_rep, B_NEXT)
        # RLE run length: no mstate / ctx updates (csc_model.cpp:492)
        upd("fsm", len_fin & (st["after_len"] == 2), B_NEXT)
        lf_match = len_fin & (st["after_len"] == 1)
        wl_c = vb.clamp(0, 6)
        nsbits = k["pdist_bits"][wl_c]
        upd("pdist_pos", lf_match, k["pdist_pos"][wl_c])
        upd("sbits", lf_match, nsbits)
        slot = (torch.searchsorted(k["dist"], va.contiguous(), right=True)
                - 1).clamp(0, 31)
        upd("slot", lf_match, slot)
        upd("node", lf_match, 1)
        upd("bits_c", lf_match, slot | (1 << nsbits))
        upd("fsm", lf_match, B_DISTSLOT)

    # LONGLEN
    if has[B_LONGLEN]:
        upd("len_left", is_long & (st["len_left"] > 0), st["len_left"] - 1)
        fin_l = is_long & (st["len_left"] == 0)
        upd("len_phase", fin_l, 1)
        upd("lenv", fin_l, ((vb - 143) % 143).clamp(max=143))
        upd("sub_i", fin_l, 0)
        upd("fsm", fin_l, B_LENSLOT)

    # DISTSLOT
    if has[B_DISTSLOT]:
        upd("bits_c", is_dslot, (bits_c << 1) & 0x7FF)
        upd("node", is_dslot, nnode)
        ds_done = is_dslot & (nnode >= (1 << st["sbits"]))
        small = ds_done & (st["slot"] <= 2)
        upd("mstate", small, (st["mstate"] * 4 + 1) & 0x3F)
        upd("ctx", small & (kind != K_SENT), st["vc"])
        upd("fsm", small, B_NEXT)
        big = ds_done & (st["slot"] > 2)
        ebits = (st["slot"] - 2).clamp(min=1)
        extra_len = va - (1 << ebits.clamp(max=30)) - 1
        upd("ebits", big, ebits)
        upd("elen", big, extra_len)
        need_dir = big & (ebits > 4)
        upd("dir_val", need_dir, extra_len >> 4)
        upd("dir_rem", need_dir, ebits - 4)
        upd("fsm", need_dir, B_DISTDIRECT)
        go_ext = big & ~need_dir
        upd("bits_c", go_ext, k["rev16"][extra_len & 0xF] | 0x10)
        upd("node", go_ext, 1)
        upd("fsm", go_ext, B_DISTEXTRA)

    # DISTEXTRA
    if has[B_DISTEXTRA]:
        upd("bits_c", is_dext, (bits_c << 1) & 0x1FF)
        upd("node", is_dext, nnode)
        de_done = is_dext & (nnode >= 0x10)
        upd("mstate", de_done, (st["mstate"] * 4 + 1) & 0x3F)
        upd("ctx", de_done & (kind != K_SENT), st["vc"])
        upd("fsm", de_done, B_NEXT)

    # RLEFLAG: one flag bit, then a delta literal or a run length
    if has[B_RLEFLAG]:
        to_dlit = is_rlef & (kind == K_DLIT)
        upd("fsm", to_dlit, B_DLITTREE)
        upd("node", to_dlit, 1)
        upd("bits_c", to_dlit, va | 0x100)
        to_rlen = is_rlef & (kind == K_RLEN)
        upd("fsm", to_rlen, B_LENSLOT)
        upd("sub_i", to_rlen, 0)
        upd("after_len", to_rlen, 2)
        upd("len_phase", to_rlen, 0)
        upd("len_left", to_rlen, 0)
        upd("lenv", to_rlen, vb.clamp(max=143))

    # DLITTREE: order-1 literal through p_delta[s_ctx]; ctx untouched
    if has[B_DLITTREE]:
        upd("bits_c", is_dlit, (bits_c << 1) & 0x1FFFF)
        upd("node", is_dlit, nnode)
        upd("fsm", is_dlit & (nnode >= 0x100), B_NEXT)


def _direct_ops(st, new, upd, fsm_a, k, bsize):
    """EncDirect16 writes: the direct distance bits, CompressBad raw
    bytes and EncodeInt."""
    bcv, bcb = new["bc_val"], new["bc_bits"]
    bc_out, bc_cnt = st["bc_out"], new["bc_cnt"]
    bc_map = st["bc_blkmap"]
    cap = bc_out.shape[1] - 1

    def enc_direct(mask, val, nbits):
        nonlocal bcv, bcb, bc_cnt
        nv = ((bcv << nbits.clamp(0, 31)) | val) & MASK32
        bcv = torch.where(mask, nv, bcv)
        bcb = torch.where(mask, bcb + nbits, bcb)
        for _ in range(3):
            emit = mask & (bcb >= 8)
            byte = (bcv >> (bcb - 8).clamp(0, 31)) & 0xFF
            _put(bc_out, bc_cnt.clamp(0, cap), emit, byte)
            bc_cnt = torch.where(emit, bc_cnt + 1, bc_cnt)
            _log_cross(bc_map, bc_cnt, new["rc_cnt"], emit, bsize)
            bcb = torch.where(emit, bcb - 8, bcb)

    zero = torch.zeros_like(bcv)
    # DISTDIRECT
    c = fsm_a == B_DISTDIRECT
    two = st["dir_rem"] > 16
    nbits = torch.where(two, st["dir_rem"] - 16, st["dir_rem"])
    val = torch.where(two, (st["dir_val"] >> 16) & 0xFFFF,
                      st["dir_val"] & ((1 << nbits.clamp(0, 30)) - 1))
    enc_direct(c, val, torch.where(c, nbits, 0))
    upd("dir_rem", c & two, 16)
    upd("dir_val", c & two, st["dir_val"] & 0xFFFF)
    dd_done = c & ~two
    upd("bits_c", dd_done, k["rev16"][st["elen"] & 0xF] | 0x10)
    upd("node", dd_done, 1)
    upd("fsm", dd_done, B_DISTEXTRA)

    # RAW (CompressBad payload: a bytes, b bits)
    c = fsm_a == B_RAW
    enc_direct(c, torch.where(c, st["va"] & MASK32, zero),
               torch.where(c, st["vb"], zero))
    upd("fsm", c, B_NEXT)

    # INT (EncodeInt, csc_model.cpp:389-414)
    c = fsm_a == B_INT
    v = st["va"]
    slot_i = (_bitlen(v) - 1).clamp(min=0)
    ph0 = c & (st["sub_i"] == 0)
    enc_direct(ph0, slot_i, torch.where(ph0, 5, zero))
    upd("sub_i", ph0, 1)
    ph1 = c & (st["sub_i"] == 1)
    nb1 = torch.where(slot_i == 0, 1, slot_i)
    vv = torch.where(slot_i == 0, v, v - (1 << slot_i.clamp(0, 30)))
    enc_direct(ph1, vv, torch.where(ph1, nb1, zero))
    upd("fsm", ph1, B_NEXT)
    new["bc_val"], new["bc_bits"], new["bc_cnt"] = bcv, bcb, bc_cnt


def _flush_op(st, new, upd, fsm_a, bsize):
    """Chunk flush (csc_coder.cpp:40-74): five ShiftLows, the bc partial
    byte and pad, a chunk-log entry, a coder reset; probabilities
    persist (csc_encoder_main.cpp:141-145)."""
    c = fsm_a == B_FLUSH
    fstep = c & (st["flush_i"] < 5)
    low = st["low"]
    ftrig = fstep & ((low < 0xFF000000) | (st["lowhi"] != 0))
    fcarry = torch.where(ftrig, st["lowhi"], 0)
    rc_out = st["rc_out"]
    _put(rc_out, new["rc_cnt"].clamp(0, rc_out.shape[1] - 1), ftrig,
         (st["cache"] + fcarry) & 0xFF)
    new["rc_cnt"] = torch.where(ftrig, new["rc_cnt"] + 1, new["rc_cnt"])
    _log_cross(st["rc_blkmap"], new["rc_cnt"], new["bc_cnt"], ftrig, bsize)
    frun = ftrig & (st["cachesize"] > 1)
    upd("pending", frun, st["cachesize"] - 1)
    upd("pend_carry", frun, fcarry)
    upd("cache", ftrig, (low >> 24) & 0xFF)
    upd("cachesize", fstep, torch.where(ftrig, 0, st["cachesize"]) + 1)
    upd("low", fstep, (low << 8) & MASK32)
    upd("lowhi", fstep, 0)
    upd("flush_i", fstep, st["flush_i"] + 1)

    fdone = c & (st["flush_i"] >= 5)
    pb1 = torch.where(st["bc_bits"] > 0,
                      (st["bc_val"] << (8 - st["bc_bits"].clamp(0, 8)))
                      & 0xFF, 0)
    bco = st["bc_out"]
    cap = bco.shape[1] - 1
    bcc = new["bc_cnt"]
    for byte in (pb1, torch.zeros_like(pb1)):
        _put(bco, bcc.clamp(0, cap), fdone, byte)
        bcc = torch.where(fdone, bcc + 1, bcc)
        _log_cross(st["bc_blkmap"], bcc, new["rc_cnt"], fdone, bsize)
    new["bc_cnt"] = bcc
    clog = st["chunk_log"]
    ci = st["chunk_cnt"].clamp(max=clog.shape[1] - 1)
    entry = torch.stack([new["rc_cnt"], bcc], dim=1).to(clog.dtype)
    barange = torch.arange(clog.shape[0], device=clog.device)
    cur = clog[barange, ci]
    clog[barange, ci] = torch.where(fdone[:, None], entry, cur)
    upd("chunk_cnt", fdone, st["chunk_cnt"] + 1)
    upd("low", fdone, 0)
    upd("lowhi", fdone, 0)
    upd("range", fdone, MASK32)
    upd("cache", fdone, 0)
    upd("cachesize", fdone, 1)
    upd("bc_val", fdone, 0)
    upd("bc_bits", fdone, 0)
    upd("fsm", fdone, B_NEXT)


def _next_op(st, new, upd, fsm_a):
    """Fetch the next token and enter its first state; a stream past the
    end of a tape without K_END stops there with done = 0."""
    fetch = fsm_a == B_NEXT
    past = fetch & (st["tok_i"] >= st["tok_kind"].shape[1])
    upd("fsm", past, B_DONE)
    c = fetch & ~past
    ti = st["tok_i"].clamp(0, st["tok_kind"].shape[1] - 1)
    kk = _gather(st["tok_kind"], ti)
    a = _gather(st["tok_a"], ti)
    upd("tok_i", c, st["tok_i"] + 1)
    upd("kind", c, kk)
    upd("va", c, a)
    upd("vb", c, _gather(st["tok_b"], ti))
    upd("vc", c, _gather(st["tok_c"], ti))
    upd("flag_i", c, 0)
    is_end = c & (kk == K_END)
    upd("done", is_end, 1)
    upd("fsm", is_end, B_DONE)
    is_int = c & (kk == K_INT)
    upd("fsm", is_int, B_INT)
    upd("sub_i", is_int, 0)
    is_fl = c & (kk == K_FLUSH)
    upd("fsm", is_fl, B_FLUSH)
    upd("flush_i", is_fl, 0)
    upd("fsm", c & (kk == K_RAW), B_RAW)
    # ELIT: straight into the literal tree, no LZ flags, mstate untouched
    # (CompressLiterals, csc_model.cpp:448-461)
    is_el = c & (kk == K_ELIT)
    upd("fsm", is_el, B_LITTREE)
    upd("node", is_el, 1)
    upd("bits_c", is_el, a | 0x100)
    # DLIT / RLEN lead with the p_rle_flag bit
    upd("fsm", c & ((kk == K_DLIT) | (kk == K_RLEN)), B_RLEFLAG)
    is_tok = c & (kk != K_END) & (kk != K_INT) & (kk != K_FLUSH) \
        & (kk != K_RAW) & (kk != K_ELIT) & (kk != K_DLIT) & (kk != K_RLEN)
    upd("fsm", is_tok, B_FLAG)


def run_bits(st, bsize, max_steps):
    """Step until every stream has stopped (at K_END, or at the end of a
    tape without it) or max_steps; returns (state, steps taken)."""
    steps = 0
    while steps < max_steps and not bool(
            ((st["fsm"] == B_DONE) & (st["pending"] == 0)).all()):
        st = bits_step(st, bsize)
        steps += 1
    return st, steps


def outputs_of(st):
    """K3's outputs from a state: (rc_out, bc_out, rc_blkmap, bc_blkmap,
    chunk_log, stats [5, B] int32 rows rc_cnt, bc_cnt, chunk_cnt, done,
    err)."""
    rc_cnt, bc_cnt = st["rc_cnt"], st["bc_cnt"]
    err = torch.where((rc_cnt >= st["rc_out"].shape[1])
                      | (bc_cnt >= st["bc_out"].shape[1]), ERR_OVERFLOW, 0)
    stats = torch.stack([rc_cnt, bc_cnt, st["chunk_cnt"], st["done"],
                         err]).to(torch.int32)
    return (st["rc_out"], st["bc_out"], st["rc_blkmap"], st["bc_blkmap"],
            st["chunk_log"], stats)


def bits_plain(kind, a, b, c, max_rc, max_bc, nmap, nchunk, bsize,
               max_steps=None):
    """K3's function, as lockstep torch ops on the tapes' device."""
    st = make_bits_state(kind, a, b, c, max_rc, max_bc, nmap, nchunk)
    if max_steps is None:
        max_steps = 24 * kind.shape[1] + max_rc + max_bc + 65536
    st, _ = run_bits(st, bsize, max_steps)
    return outputs_of(st)


def _len_value_bits(lv):
    return torch.where(lv < 8, 4, torch.where(lv < 16, 5, 9))


def _length_bits(vb):
    """Modelled bits of a wire length: slot bits and tree, and past 143
    the long-length run, its closing bit and the remainder's."""
    tail = vb - 143
    long_ = vb >= 143
    return _len_value_bits(vb.clamp(max=143)) + torch.where(
        long_, tail.clamp(min=0) // 143 + 1
        + _len_value_bits(tail.clamp(min=0) % 143), 0)


def modelled_bits(kind, a, b, c):
    """Bits each tape codes through a probability (a binary decision of
    the model), up to its first K_END: a literal 9 (flag + tree), an
    ENTROPY literal 8, a DLT literal 9, K_REP0L1 3, K_REP 5 + its length's,
    K_RLEN 1 + its length's, a match or sentinel 2 + its length's + its
    slot tree (3-5) + 4 extra bits past slot 2.  Direct bits are not
    modelled.  [B] int64."""
    check_inputs(kind, a, b, c)
    k = _consts(kind.device)
    kind, a, b = kind.long(), a.long(), b.long()
    live = torch.cumsum(kind == K_END, dim=1) == 0
    lb = _length_bits(b)
    w = b.clamp(0, 6)
    slot = (torch.searchsorted(k["dist"], a.contiguous(), right=True)
            - 1).clamp(0, 31)
    match = 2 + lb + k["pdist_bits"][w] + torch.where(slot > 2, 4, 0)
    bits = torch.zeros_like(kind)
    for kk, v in ((K_LIT, 9), (K_ELIT, 8), (K_DLIT, 9), (K_REP0L1, 3),
                  (K_REP, 5 + lb), (K_RLEN, 1 + lb), (K_MATCH, match),
                  (K_SENT, match)):
        bits = torch.where(kind == kk, v, bits)
    return (bits * live).sum(dim=1)
