"""Plain PyTorch version of the K1 decode kernel: B CSC streams decoded in
lockstep, one micro-op per stream per step.

A torch port of csc_tpu/ops/decode_scan.py (`make_decode_state`,
`decode_step`, `run_decode`): each step decodes one range-coder bit, reads
<= 16 direct bits, or copies <= 16 window bytes for every live stream, as
masked tensor ops over the batch.  It keeps decode_scan's state, layout and
semantics (linear window, DLT inverse fused in-window, typed-block log for
the host EXE/ENGTXT inverse filters) and adds the corrupt-stream halts of
the TPU kernel (pallas_decode.py:1056-1058, 1104-1106, 1144-1145,
1180-1181, 1503-1512) plus decode_scan's invalid-block-type stop:

* a copy whose distance is <= 0 or exceeds the bytes written;
* rep0len1 with wnd_pos <= rep0 (decode_scan wraps by wnd_size there);
* an invalid block type;
* an rc or bc read past its array, or a chunk re-prime past the rc array;
* a write past the window.  The stream then reports the window position
  it would have reached (at most MAX_WINDOW + 1), so a caller that sized
  the window from a guess can regrow it.

A halting micro-op takes no effect: the stream keeps its state from
before the op, with err = ERR_CORRUPT and done = 1.  The hand-written
kernel (csrc/decode_k1.cuh) decodes each stream straight through and must
give the same window, block log, wnd_pos, done and err.

Registers live in one [NREG, B] int64 tensor (uint32 coder fields masked
to 32 bits); probabilities in [B, NPROB] int32, the window in [B, W] u8.
`decode_step` writes the probability, window and block-log tensors in
place to spare a copy of each per step.
"""
import numpy as np
import torch

from ..constants import (
    DIST_TABLE, REV16_TABLE, DLT_INDEX, DT_NORMAL, DT_EXE, DT_ENGTXT,
    DT_BAD, DT_ENTROPY, SIG_EOF, DT_DLT,
    P_STATE, P_REPDIST, P_DIST, P_MDEXTRA, P_MLSLOT, P_MLEX1, P_MLEX2,
    P_MLEX3, P_LONGLEN, P_RLEFLAG, P_LIT, P_DELTA, NPROB,
    F_IDLE, F_FLAG1, F_FLAG2, F_FLAG3, F_LITTREE, F_REPTREE, F_LENSLOT0,
    F_LENSLOT1, F_LENTREE3, F_LENTREE7, F_LONGLEN, F_DISTSLOT, F_DISTEXTRA,
    F_RLEFLAG, F_RLETREE, F_ENTTREE, F_INTSLOT, F_INTNUM, F_DISTDIRECT,
    F_BADBYTES, F_COPY, F_RLERUN, NSTATES,
    IP_BLOCKTYPE, IP_CONT, IP_SIZE_BAD, IP_SIZE_ENT, IP_SIZE_RLE,
    IP_SIZE_TXT, LF_MATCH, LF_REP, LF_RLE,
    COPY_CHUNK, MASK32, ERR_CORRUPT, MAX_BLOCKS, MAX_WINDOW)

# decode_scan's int32 registers (decode_scan.py:129-137), then its uint32
# coder registers and the rep queue
INT_REGS = [
    "rc_ptr", "rc_blk", "bc_bits", "bc_ptr", "bc_blk",
    "fsm", "int_purpose", "int_slot", "direct_acc", "direct_rem",
    "mstate", "ctx", "wnd_pos", "node", "len_acc", "len_phase", "len_for",
    "len_base", "len_tbl", "wire_len", "rep_idx", "slot", "ebits", "elen",
    "pdist_pos", "sbits", "dist", "cpy_src", "cpy_rem", "size_rem",
    "blk_size", "chn", "rle_i", "rle_rel", "prev", "last_delta", "sctx",
    "eof", "done", "err", "blk_start", "blk_cnt",
]
U32_REGS = ["rc_code", "rc_range", "bc_val"]
REGS = INT_REGS + U32_REGS + ["rep0", "rep1", "rep2", "rep3"]
IX = {n: i for i, n in enumerate(REGS)}
_REP_ROWS = [IX["rep0"], IX["rep1"], IX["rep2"], IX["rep3"]]

_BIT_STATES = (F_FLAG1, F_FLAG2, F_FLAG3, F_LITTREE, F_REPTREE, F_LENSLOT0,
               F_LENSLOT1, F_LENTREE3, F_LENTREE7, F_LONGLEN, F_DISTSLOT,
               F_DISTEXTRA, F_RLEFLAG, F_RLETREE, F_ENTTREE)
_DIR_STATES = (F_INTSLOT, F_INTNUM, F_DISTDIRECT, F_BADBYTES)


def _dist_pos_bits_np():
    # slot-tree segment by wire length (csc_model.cpp:308-329), for wire
    # lengths 0..6+ (clamped at 6)
    pos = np.zeros(7, np.int64)
    bits = np.zeros(7, np.int64)
    for ln in range(7):
        if ln == 0:
            pos[ln], bits[ln] = 0, 3
        elif ln <= 2:
            pos[ln], bits[ln] = 16 * (ln - 1) + 8, 4
        elif ln <= 5:
            pos[ln], bits[ln] = 32 * (ln - 3) + 8 + 16 * 2, 5
        else:
            pos[ln], bits[ln] = 32 * 3 + 8 + 16 * 2, 5
    return pos, bits


_PDIST_POS, _PDIST_BITS = _dist_pos_bits_np()
_DLT_CHN = np.zeros(32, np.int64)
for _i, _c in enumerate(DLT_INDEX):
    _DLT_CHN[DT_DLT + _i] = _c
_IS_BIT = np.zeros(NSTATES, bool)
_IS_BIT[list(_BIT_STATES)] = True
_IS_DIR = np.zeros(NSTATES, bool)
_IS_DIR[list(_DIR_STATES)] = True

_TABLES = {}


def _tables(device):
    t = _TABLES.get(device)
    if t is None:
        def mk(a):
            return torch.as_tensor(a, device=device)
        t = {"pdist_pos": mk(_PDIST_POS), "pdist_bits": mk(_PDIST_BITS),
             "dist": mk(np.array(DIST_TABLE, np.int64)),
             "rev16": mk(np.array(REV16_TABLE, np.int64)),
             "dlt_chn": mk(_DLT_CHN), "is_bit": mk(_IS_BIT),
             "is_dir": mk(_IS_DIR),
             "k16": torch.arange(COPY_CHUNK, device=device)}
        _TABLES[device] = t
    return t


def check_inputs(rc, bc, rc_ends, bc_ends):
    """Raise on inputs K1 and this version do not take: rc/bc [B, L] u8,
    rc_ends/bc_ends [B, NB] i32, all on rc's device, rc >= 5 bytes wide."""
    b = rc.shape[0] if rc.dim() == 2 else -1
    for name, t, dt in (("rc", rc, torch.uint8), ("bc", bc, torch.uint8),
                        ("rc_ends", rc_ends, torch.int32),
                        ("bc_ends", bc_ends, torch.int32)):
        if t.dtype != dt or t.dim() != 2 or t.shape[0] != b \
                or t.shape[1] < 1:
            raise ValueError(f"{name}: want [B, N] {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != rc.device:
            raise ValueError(f"{name} on {t.device}, rc on {rc.device}")
    if rc.shape[1] < 5:
        raise ValueError("rc must hold at least the 5 priming bytes")


def make_decode_state(wnd_size, rc, bc, rc_ends, bc_ends,
                      max_blocks=MAX_BLOCKS):
    """Initial state for B streams.  rc/bc: [B, L] u8 padded; *_ends:
    [B, NB] i32 padded with 0x7FFFFFFF.  The state lives on rc's device."""
    check_inputs(rc, bc, rc_ends, bc_ends)
    b, dev = rc.shape[0], rc.device
    regs = torch.zeros((len(REGS), b), dtype=torch.int64, device=dev)
    # coder priming (csc_dec.cpp:336-345): rc_code from rc bytes 1..4
    r = rc[:, 1:5].long()
    regs[IX["rc_code"]] = (r[:, 0] << 24) | (r[:, 1] << 16) | (r[:, 2] << 8) \
        | r[:, 3]
    regs[IX["rc_range"]] = MASK32
    regs[IX["rc_ptr"]] = 5
    regs[IX["fsm"]] = F_INTSLOT
    regs[IX["direct_rem"]] = 5
    return {
        "regs": regs,
        "probs": torch.full((b, NPROB), 2048, dtype=torch.int32, device=dev),
        # +COPY_CHUNK slack for the 16-wide copy writes
        "wnd": torch.zeros((b, wnd_size + COPY_CHUNK), dtype=torch.uint8,
                           device=dev),
        "rc": rc, "bc": bc, "rc_ends": rc_ends, "bc_ends": bc_ends,
        "blk_log": torch.zeros((b, max_blocks, 2), dtype=torch.int32,
                               device=dev),
    }


def state_from_numpy(st, device):
    """decode_scan's state dict (numpy or jax arrays) -> this module's
    state on `device`, field by field."""
    b = np.asarray(st["fsm"]).shape[0]
    regs = np.zeros((len(REGS), b), np.int64)
    for name in INT_REGS + U32_REGS:
        regs[IX[name]] = np.asarray(st[name]).astype(np.int64)
    regs[_REP_ROWS] = np.asarray(st["reps"]).astype(np.int64).T
    dev = torch.device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(st[name]), device=dev).to(dtype)
    return {"regs": torch.as_tensor(regs, device=dev),
            "probs": t("probs", torch.int32), "wnd": t("wnd", torch.uint8),
            "rc": t("rc", torch.uint8), "bc": t("bc", torch.uint8),
            "rc_ends": t("rc_ends", torch.int32),
            "bc_ends": t("bc_ends", torch.int32),
            "blk_log": t("blk_log", torch.int32)}


def state_to_numpy(st):
    """This module's state -> decode_scan's field names and dtypes."""
    regs = st["regs"].cpu().numpy()
    out = {}
    for name in INT_REGS:
        out[name] = regs[IX[name]].astype(np.int32)
    for name in U32_REGS:
        out[name] = regs[IX[name]].astype(np.uint32)
    out["reps"] = regs[_REP_ROWS].T.astype(np.int32)
    for name in ("probs", "wnd", "rc", "bc", "rc_ends", "bc_ends",
                 "blk_log"):
        out[name] = st[name].cpu().numpy()
    return out


def _gather(tbl, idx):
    return tbl.gather(1, idx[:, None])[:, 0].long()


def _present_states(regs):
    """Per-state count of live streams (dead streams count as F_IDLE)."""
    fsm_a = torch.where(regs[IX["done"]] == 0, regs[IX["fsm"]], F_IDLE)
    return fsm_a, torch.bincount(fsm_a, minlength=NSTATES).tolist()


def decode_step(st, wnd_size):
    """One lockstep micro-op for every live stream."""
    fsm_a, has = _present_states(st["regs"])
    return _step(st, wnd_size, fsm_a, has)


def _step(st, wnd_size, fsm_a, has):
    R = st["regs"]
    B = R.shape[1]
    dev = R.device
    T = _tables(dev)
    rows = list(R.unbind(0))
    N = {}             # new register values, by name

    def g(name):
        return rows[IX[name]]

    def upd(name, cond, val):
        N[name] = torch.where(cond, val, N[name] if name in N else g(name))

    false = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    barange = torch.arange(B, device=dev)
    fsm = g("fsm")
    node = g("node")
    mstate = g("mstate")
    wnd_pos = g("wnd_pos")
    rcl = st["rc"].shape[1]
    bcl = st["bc"].shape[1]
    nb_rc = st["rc_ends"].shape[1]
    nb_bc = st["bc_ends"].shape[1]
    corrupt = []       # halts that leave wnd_pos as it was
    overflow = []      # (cond, would-be wnd_pos): window-overflow halts

    def has_any(*states):
        return any(has[s] for s in states)

    # =============================== BIT micro-op ========================
    any_bit = has_any(*_BIT_STATES)
    is_bit = false
    bit = false
    if any_bit:
        is_bit = T["is_bit"][fsm_a]
        m3 = mstate * 3
        ctx = g("ctx")
        pidx = zero
        forms = {
            F_FLAG1: lambda: P_STATE + m3,
            F_FLAG2: lambda: P_STATE + m3 + 1,
            F_FLAG3: lambda: P_STATE + m3 + 2,
            F_LITTREE: lambda: P_LIT + ctx * 256 + node,
            F_REPTREE: lambda: P_REPDIST + m3 + node - 1,
            F_LENSLOT0: lambda: P_MLSLOT,
            F_LENSLOT1: lambda: P_MLSLOT + 1,
            F_LENTREE3: lambda: torch.where(g("len_tbl") == 1, P_MLEX1,
                                            P_MLEX2) + node,
            F_LENTREE7: lambda: P_MLEX3 + node,
            F_LONGLEN: lambda: P_LONGLEN,
            F_DISTSLOT: lambda: P_DIST + g("pdist_pos") + node,
            F_DISTEXTRA: lambda: P_MDEXTRA + (g("ebits") - 1) * 16 + node,
            F_RLEFLAG: lambda: P_RLEFLAG,
            F_RLETREE: lambda: P_DELTA + g("sctx") * 256 + node,
            F_ENTTREE: lambda: P_LIT + ctx * 256 + node,
        }
        for s in _BIT_STATES:
            if has[s]:
                pidx = torch.where(fsm_a == s, forms[s](), pidx)

        # range-coder refill BEFORE the bit (csc_dec.cpp:11-22)
        rc_range, rc_code = g("rc_range"), g("rc_code")
        rc_ptr, rc_blk = g("rc_ptr"), g("rc_blk")
        need_refill = is_bit & (rc_range < (1 << 24))
        corrupt.append(need_refill & (rc_ptr >= rcl))
        rng = torch.where(need_refill, (rc_range << 8) & MASK32, rc_range)
        rbyte = _gather(st["rc"], rc_ptr.clamp(max=rcl - 1))
        code = torch.where(need_refill, ((rc_code << 8) & MASK32) + rbyte,
                           rc_code)
        rc_ptr_n = torch.where(need_refill, rc_ptr + 1, rc_ptr)
        rc_end = _gather(st["rc_ends"], rc_blk.clamp(0, nb_rc - 1))
        rc_blk_n = torch.where(need_refill & (rc_ptr_n >= rc_end),
                               rc_blk + 1, rc_blk)

        p = _gather(st["probs"], pidx)
        bound = (rng >> 12) * p
        bit = (code < bound) & is_bit
        new_p = torch.where(bit, p + ((0xFFF - p) >> 5), p - (p >> 5))
        rng = torch.where(is_bit, torch.where(bit, bound, rng - bound), rng)
        code = torch.where(is_bit & ~bit, code - bound, code)
    nbit = ~bit
    nnode = node * 2 + bit.long()

    # =============================== DIRECT micro-op =====================
    any_dir = has_any(*_DIR_STATES)
    is_dir = false
    if any_dir:
        is_dir = T["is_dir"][fsm_a]
        direct_rem = g("direct_rem")
        two_phase = direct_rem > 16
        nbits = torch.where(two_phase, direct_rem - 16, direct_rem)
        nbits = torch.where(fsm == F_BADBYTES,
                            torch.where(g("size_rem") >= 2, 16, 8), nbits)
        nbits = torch.where(is_dir, nbits, 0)
        bc_val, bc_bits = g("bc_val"), g("bc_bits")
        bc_ptr, bc_blk = g("bc_ptr"), g("bc_blk")
        for _ in range(3):  # <= 2 byte refills for 16 bits + 1 slack
            need = is_dir & (bc_bits < nbits)
            corrupt.append(need & (bc_ptr >= bcl))
            bbyte = _gather(st["bc"], bc_ptr.clamp(max=bcl - 1))
            bc_val = torch.where(need, ((bc_val << 8) | bbyte) & MASK32,
                                 bc_val)
            bc_ptr = torch.where(need, bc_ptr + 1, bc_ptr)
            bc_end = _gather(st["bc_ends"], bc_blk.clamp(0, nb_bc - 1))
            bc_blk = torch.where(need & (bc_ptr >= bc_end), bc_blk + 1,
                                 bc_blk)
            bc_bits = torch.where(need, bc_bits + 8, bc_bits)
        shift = (bc_bits - nbits).clamp(min=0)
        mask = (torch.ones_like(nbits) << nbits) - 1
        dval = torch.where(is_dir, (bc_val >> shift) & mask, 0)
        bc_bits = torch.where(is_dir, bc_bits - nbits, bc_bits)

    # =============================== COPY micro-op =======================
    wnd = st["wnd"]
    wnd_cap = wnd_size + COPY_CHUNK
    if has[F_COPY]:
        is_mcopy = fsm_a == F_COPY
        k16 = T["k16"]
        chunk = g("cpy_rem").clamp(max=COPY_CHUNK)
        safe_dist = g("dist").clamp(min=1)
        # overlap-safe: byte k of the chunk = wnd[cpy_src + (k mod dist)]
        src_idx = (g("cpy_src")[:, None] + k16[None, :] % safe_dist[:, None]
                   ).clamp(0, wnd_cap - 1)
        src_bytes = wnd.gather(1, src_idx)
        # dead rows write back their own bytes at 0..15: indices stay
        # distinct per row, so the scatter below has one winner each
        dst_idx = (torch.where(is_mcopy, wnd_pos, 0)[:, None]
                   + k16[None, :]).clamp(0, wnd_cap - 1)
        write_mask = is_mcopy[:, None] & (k16[None, :] < chunk[:, None])

    # ========================== transitions ==============================
    lit_write = ent_write = rle_write = run_write = bad_write = false
    wrote2 = false
    reset = false
    bt = false
    lit_byte = ent_byte = rle_orig = run_orig = bad_b0 = zero
    rle_wpos = run_wpos = zero

    def to_int(cond, purpose):
        upd("fsm", cond, F_INTSLOT)
        upd("int_purpose", cond, purpose)
        upd("direct_rem", cond, 5)

    if has[F_FLAG1]:
        c = is_bit & (fsm == F_FLAG1)
        upd("fsm", c & bit, F_FLAG2)
        upd("fsm", c & nbit, F_LITTREE)
        upd("node", c & nbit, 1)

    if has[F_FLAG2]:
        c = is_bit & (fsm == F_FLAG2)
        cb = c & bit
        upd("fsm", cb, F_LENSLOT0)
        upd("len_for", cb, LF_MATCH)
        upd("len_acc", cb, 0)
        upd("len_phase", cb, 0)
        upd("fsm", c & nbit, F_FLAG3)

    if has[F_FLAG3]:
        c = is_bit & (fsm == F_FLAG3)
        c0 = c & nbit   # rep0len1 (csc_dec.cpp:523-529)
        rep0 = g("rep0")
        upd("mstate", c0, (mstate * 4 + 2) & 0x3F)
        upd("dist", c0, rep0)
        # the reference wraps the ring when wnd_pos <= rep0 (strict '>',
        # csc_dec.cpp:525); a linear window holds no such byte
        corrupt.append(c0 & ((rep0 <= 0) | (wnd_pos <= rep0)))
        overflow.append((c0, wnd_pos + 1))
        upd("cpy_src", c0, wnd_pos - rep0)
        upd("cpy_rem", c0, 1)
        upd("fsm", c0, F_COPY)
        cb = c & bit
        upd("fsm", cb, F_REPTREE)
        upd("node", cb, 1)

    if has[F_LITTREE]:
        c = is_bit & (fsm == F_LITTREE)
        lit_done = c & (nnode >= 0x100)
        lit_byte = nnode & 0xFF
        upd("node", c, nnode)
        upd("ctx", lit_done, lit_byte)
        upd("mstate", lit_done, (mstate * 4) & 0x3F)
        upd("wnd_pos", lit_done, wnd_pos + 1)
        upd("fsm", lit_done, F_FLAG1)
        overflow.append((lit_done, wnd_pos + 1))
        lit_write = lit_done

    if has[F_REPTREE]:
        c = is_bit & (fsm == F_REPTREE)
        rep_done = c & (nnode >= 4)
        upd("node", c, nnode)
        upd("rep_idx", rep_done, nnode & 3)
        upd("fsm", rep_done, F_LENSLOT0)
        upd("len_for", rep_done, LF_REP)
        upd("len_acc", rep_done, 0)
        upd("len_phase", rep_done, 0)

    if has[F_LENSLOT0]:
        c = is_bit & (fsm == F_LENSLOT0)
        cb = c & nbit
        upd("fsm", cb, F_LENTREE3)
        upd("len_tbl", cb, 1)
        upd("len_base", cb, 0)
        upd("node", cb, 1)
        upd("fsm", c & bit, F_LENSLOT1)
    if has[F_LENSLOT1]:
        c = is_bit & (fsm == F_LENSLOT1)
        cb = c & nbit
        upd("fsm", cb, F_LENTREE3)
        upd("len_tbl", cb, 2)
        upd("len_base", cb, 8)
        upd("node", cb, 1)
        cb = c & bit
        upd("fsm", cb, F_LENTREE7)
        upd("len_base", cb, 16)
        upd("node", cb, 1)

    if has_any(F_LENTREE3, F_LENTREE7):
        c3 = is_bit & (fsm == F_LENTREE3)
        c7 = is_bit & (fsm == F_LENTREE7)
        done3 = c3 & (nnode >= 0x8)
        done7 = c7 & (nnode >= 0x80)
        upd("node", c3 | c7, nnode)
        lenv = torch.where(done3, g("len_base") + (nnode & 0x7),
                           g("len_base") + (nnode & 0x7F))
        len_complete = done3 | done7
        len_phase, len_for = g("len_phase"), g("len_for")
        goes_long = len_complete & (len_phase == 0) & (lenv == 143)
        upd("fsm", goes_long, F_LONGLEN)
        upd("len_acc", goes_long, 143)
        wl = torch.where(len_phase == 0, lenv, g("len_acc") + lenv)
        len_done = len_complete & ~goes_long
        upd("wire_len", len_done, wl)

        ld_match = len_done & (len_for == LF_MATCH)
        upd("fsm", ld_match, F_DISTSLOT)
        upd("node", ld_match, 1)
        wl_c = wl.clamp(0, 6)
        upd("pdist_pos", ld_match, T["pdist_pos"][wl_c])
        upd("sbits", ld_match, T["pdist_bits"][wl_c])

        ld_rep = len_done & (len_for == LF_REP)
        upd("mstate", ld_rep, (mstate * 4 + 3) & 0x3F)
        reps = R[_REP_ROWS]                                  # [4, B]
        rep_idx = g("rep_idx")
        rdist = reps.gather(0, rep_idx.clamp(0, 3)[None, :])[0]
        # rotate reps[0..rep_idx] (csc_dec.cpp:538-541)
        shifted = torch.cat([rdist[None, :], reps[:3]], dim=0)
        rot = torch.where(torch.arange(4, device=dev)[:, None]
                          <= rep_idx[None, :], shifted, reps)
        for k in range(4):
            upd(f"rep{k}", ld_rep, rot[k])
        upd("dist", ld_rep, rdist)
        corrupt.append(ld_rep & ((rdist <= 0) | (rdist > wnd_pos)))
        overflow.append((ld_rep, wnd_pos + wl + 2))
        upd("cpy_src", ld_rep, wnd_pos - rdist)
        upd("cpy_rem", ld_rep, wl + 2)
        upd("fsm", ld_rep, F_COPY)

        ld_rle = len_done & (len_for == LF_RLE)
        upd("fsm", ld_rle, F_RLERUN)
        upd("cpy_rem", ld_rle, wl + 11)

    if has[F_LONGLEN]:
        c = is_bit & (fsm == F_LONGLEN)
        upd("len_acc", c & nbit, g("len_acc") + 143)
        cb = c & bit
        upd("fsm", cb, F_LENSLOT0)
        upd("len_phase", cb, 1)

    if has_any(F_DISTSLOT, F_DISTEXTRA):
        small = edone = false
        slot = zero
        if has[F_DISTSLOT]:
            c = is_bit & (fsm == F_DISTSLOT)
            sbits = g("sbits")
            sdone = c & (nnode >= (torch.ones_like(sbits) << sbits))
            upd("node", c, nnode)
            slot = nnode & ((torch.ones_like(sbits) << sbits) - 1)
            upd("slot", sdone, slot)
            small = sdone & (slot <= 2)
            big = sdone & (slot > 2)
            ebits = slot - 2
            upd("ebits", big, ebits)
            upd("elen", big, 0)
            need_direct = big & (ebits > 4)
            upd("fsm", need_direct, F_DISTDIRECT)
            upd("direct_rem", need_direct, ebits - 4)
            upd("direct_acc", need_direct, 0)
            cb = big & ~need_direct
            upd("fsm", cb, F_DISTEXTRA)
            upd("node", cb, 1)
        dist_big = zero
        if has[F_DISTEXTRA]:
            c = is_bit & (fsm == F_DISTEXTRA)
            edone = c & (nnode >= 0x10)
            upd("node", c, nnode)
            dist_big = (T["dist"][g("slot").clamp(0, 32)]
                        + (g("elen") << 4) + T["rev16"][nnode & 0xF])

        # --- match_complete (from `small` or `edone`)
        mc = small | edone
        dist_raw = torch.where(small, slot, dist_big)
        upd("mstate", mc, (mstate * 4 + 1) & 0x3F)
        wire_len = g("wire_len")
        sentinel = mc & (wire_len == 0) & (dist_raw == 64)
        normal_match = mc & ~sentinel
        nd = dist_raw + 1
        upd("dist", normal_match, nd)
        for k, v in enumerate([nd, g("rep0"), g("rep1"), g("rep2")]):
            upd(f"rep{k}", normal_match, v)
        corrupt.append(normal_match & (nd > wnd_pos))
        overflow.append((normal_match, wnd_pos + wire_len + 2))
        upd("cpy_src", normal_match, wnd_pos - nd)
        upd("cpy_rem", normal_match, wire_len + 2)
        upd("fsm", normal_match, F_COPY)
        # LZ block end -> continuation int
        to_int(sentinel, IP_CONT)

    if has[F_RLEFLAG]:
        c = is_bit & (fsm == F_RLEFLAG)
        cb = c & nbit
        upd("fsm", cb, F_RLETREE)
        upd("node", cb, 1)
        cb = c & bit
        upd("fsm", cb, F_LENSLOT0)
        upd("len_for", cb, LF_RLE)
        upd("len_acc", cb, 0)
        upd("len_phase", cb, 0)

    if has[F_RLETREE]:
        # delta-domain literal; fused inverse-delta + interleave
        c = is_bit & (fsm == F_RLETREE)
        rdone = c & (nnode >= 0x100)
        upd("node", c, nnode)
        delta_byte = nnode & 0xFF
        rle_orig = (delta_byte + g("prev")) & 0xFF
        upd("prev", rdone, rle_orig)
        upd("last_delta", rdone, delta_byte)
        upd("sctx", rdone, delta_byte)
        rle_write = rdone
        rle_wpos = g("blk_start") + g("rle_rel")
        sz = g("blk_size")
        nrel = g("rle_rel") + g("chn")
        upd("rle_rel", rdone, torch.where(nrel >= sz, g("rle_i") + 1, nrel))
        upd("rle_i", rdone, torch.where(nrel >= sz, g("rle_i") + 1,
                                        g("rle_i")))
        nszrem = g("size_rem") - 1
        upd("size_rem", rdone, nszrem)
        rle_blk_done = rdone & (nszrem == 0)
        upd("fsm", rdone & ~rle_blk_done, F_RLEFLAG)
        to_int(rle_blk_done, IP_CONT)
        upd("wnd_pos", rle_blk_done, g("blk_start") + sz)

    if has[F_ENTTREE]:
        c = is_bit & (fsm == F_ENTTREE)
        ent_done = c & (nnode >= 0x100)
        upd("node", c, nnode)
        ent_byte = nnode & 0xFF
        upd("ctx", ent_done, ent_byte)
        ent_write = ent_done
        upd("wnd_pos", ent_done, wnd_pos + 1)
        nszrem2 = g("size_rem") - 1
        upd("size_rem", ent_done, nszrem2)
        ent_blk_done = ent_done & (nszrem2 == 0)
        upd("node", ent_done & ~ent_blk_done, 1)
        to_int(ent_blk_done, IP_CONT)

    # ====================== DIRECT transitions ===========================
    if has[F_INTSLOT]:
        c = is_dir & (fsm == F_INTSLOT)
        upd("int_slot", c, dval)
        upd("fsm", c, F_INTNUM)
        upd("direct_rem", c, dval.clamp(min=1))
        upd("direct_acc", c, 0)

    if has[F_INTNUM]:
        c = is_dir & (fsm == F_INTNUM)
        ph1 = c & two_phase
        upd("direct_acc", ph1, dval)
        upd("direct_rem", ph1, 16)
        cdone = c & ~two_phase
        int_slot = g("int_slot")
        num = ((g("direct_acc") << nbits) | dval) + torch.where(
            int_slot > 0, torch.ones_like(int_slot) << int_slot.clamp(0, 30),
            0)

        ip = g("int_purpose")
        bt = cdone & (ip == IP_BLOCKTYPE)
        upd("blk_cnt", bt, g("blk_cnt") + 1)
        upd("blk_start", bt, wnd_pos)
        upd("fsm", bt & ((num == DT_NORMAL) | (num == DT_EXE)), F_FLAG1)
        to_int(bt & (num == DT_ENGTXT), IP_SIZE_TXT)
        to_int(bt & (num == DT_BAD), IP_SIZE_BAD)
        to_int(bt & (num == DT_ENTROPY), IP_SIZE_ENT)
        t_eof = bt & (num == SIG_EOF)
        upd("eof", t_eof, 1)
        to_int(t_eof, IP_CONT)
        t_dlt = bt & (num >= DT_DLT) & (num < DT_DLT + 5)
        to_int(t_dlt, IP_SIZE_RLE)
        upd("chn", t_dlt, T["dlt_chn"][num.clamp(0, 31)])
        # invalid block type: the reference throws DECODE_ERROR
        # (csc_dec.cpp:653)
        corrupt.append(bt & ~((num == DT_NORMAL) | (num == DT_EXE)
                              | (num == DT_ENGTXT) | (num == DT_BAD)
                              | (num == DT_ENTROPY) | (num == SIG_EOF)
                              | ((num >= DT_DLT) & (num < DT_DLT + 5))))

        sb = cdone & (ip == IP_SIZE_BAD)
        upd("size_rem", sb, num)
        upd("fsm", sb & (num > 0), F_BADBYTES)
        to_int(sb & (num == 0), IP_CONT)

        se = cdone & (ip == IP_SIZE_ENT)
        upd("size_rem", se, num)
        upd("node", se, 1)
        upd("fsm", se & (num > 0), F_ENTTREE)
        to_int(se & (num == 0), IP_CONT)

        sr = cdone & (ip == IP_SIZE_RLE)
        upd("size_rem", sr, num)
        upd("blk_size", sr, num)
        for name in ("prev", "sctx", "last_delta", "rle_i", "rle_rel"):
            upd(name, sr, 0)
        upd("fsm", sr & (num > 0), F_RLEFLAG)
        to_int(sr & (num == 0), IP_CONT)
        # a BAD / ENTROPY / DLT block writes num bytes at wnd_pos
        overflow.append((sb | se | sr, wnd_pos + num))

        upd("fsm", cdone & (ip == IP_SIZE_TXT), F_FLAG1)

        # --- CONT: num==1 -> chunk reset (csc_dec.cpp:657-680)
        ct = cdone & (ip == IP_CONT)
        reset = ct & (num == 1)
        rc_blk0 = g("rc_blk")
        r_start = _gather(st["rc_ends"], rc_blk0.clamp(0, nb_rc - 1))
        corrupt.append(reset & (r_start + 5 > rcl))
        rb = st["rc"].gather(
            1, (r_start[:, None] + torch.arange(1, 5, device=dev)[None, :])
            .clamp(0, rcl - 1)).long()
        prime = (rb[:, 0] << 24) | (rb[:, 1] << 16) | (rb[:, 2] << 8) \
            | rb[:, 3]
        upd("rc_blk", reset, rc_blk0 + 1)
        reset_rc_ptr = r_start + 5
        bc_blk0 = g("bc_blk")
        b_start = _gather(st["bc_ends"], bc_blk0.clamp(0, nb_bc - 1))
        upd("bc_blk", reset, bc_blk0 + 1)

        fin = ct & (g("eof") == 1)
        upd("done", fin, 1)
        upd("fsm", fin, F_IDLE)
        to_int(ct & (g("eof") == 0), IP_BLOCKTYPE)

    if has[F_DISTDIRECT]:
        c = is_dir & (fsm == F_DISTDIRECT)
        ph1 = c & two_phase
        upd("direct_acc", ph1, dval)
        upd("direct_rem", ph1, 16)
        cd = c & ~two_phase
        upd("elen", cd, (g("direct_acc") << nbits) | dval)
        upd("fsm", cd, F_DISTEXTRA)
        upd("node", cd, 1)

    if has[F_BADBYTES]:
        # dval holds 1-2 big-endian raw bytes
        c = is_dir & (fsm == F_BADBYTES)
        wrote2 = c & (nbits == 16)
        bad_b0 = torch.where(wrote2, dval >> 8, dval) & 0xFF
        nwr = torch.where(wrote2, 2, 1)
        upd("wnd_pos", c, wnd_pos + nwr)
        nszb = g("size_rem") - nwr
        upd("size_rem", c, nszb)
        to_int(c & (nszb == 0), IP_CONT)
        bad_write = c

    # ====================== COPY transitions =============================
    if has[F_COPY]:
        c = is_mcopy
        upd("cpy_src", c, g("cpy_src") + chunk)
        upd("wnd_pos", c, wnd_pos + chunk)
        ncrem = g("cpy_rem") - chunk
        upd("cpy_rem", c, ncrem)
        copy_done = c & (ncrem == 0)
        last_off = (chunk - 1).clamp(0, COPY_CHUNK - 1)
        last_byte = src_bytes.gather(1, last_off[:, None])[:, 0].long()
        upd("ctx", copy_done, last_byte)
        upd("fsm", copy_done, F_FLAG1)

    if has[F_RLERUN]:
        # one byte per step: the constant delta added in the original domain
        c = fsm_a == F_RLERUN
        last_delta = g("last_delta")
        run_orig = (last_delta + g("prev")) & 0xFF
        upd("prev", c, run_orig)
        run_wpos = g("blk_start") + g("rle_rel")
        nrel2 = g("rle_rel") + g("chn")
        sz2 = g("blk_size")
        upd("rle_rel", c, torch.where(nrel2 >= sz2, g("rle_i") + 1, nrel2))
        upd("rle_i", c, torch.where(nrel2 >= sz2, g("rle_i") + 1,
                                    g("rle_i")))
        nrun = g("cpy_rem") - 1
        nsz3 = g("size_rem") - 1
        upd("cpy_rem", c, nrun)
        upd("size_rem", c, nsz3)
        upd("sctx", c, last_delta)
        rle_done2 = c & (nsz3 == 0)
        run_end = c & (nrun == 0) & ~rle_done2
        upd("fsm", run_end, F_RLEFLAG)
        to_int(rle_done2, IP_CONT)
        upd("wnd_pos", rle_done2, g("blk_start") + sz2)
        run_write = c

    # ====================== halts ========================================
    # a halting micro-op takes no effect; a window overflow reports the
    # position the stream would have reached, so the caller can regrow
    halt_c = false
    for cnd in corrupt:
        halt_c = halt_c | cnd
    halt_w = false
    would = zero
    for cnd, pos in overflow:
        over = cnd & (pos > wnd_size)
        halt_w = halt_w | over
        would = torch.where(over, pos, would)
    halt_w = halt_w & ~halt_c
    halt = halt_c | halt_w
    ok = ~halt

    # ====================== array writes =================================
    if any_bit:
        keep = is_bit & ok
        st["probs"][barange, pidx] = torch.where(
            keep, new_p, p).to(torch.int32)
    if has[F_INTNUM]:
        blk_log = st["blk_log"]
        logpos = g("blk_cnt").clamp(max=blk_log.shape[1] - 1)
        entry = torch.stack([num, wnd_pos], dim=-1).to(torch.int32)
        blk_log[barange, logpos] = torch.where(
            (bt & ok)[:, None], entry, blk_log[barange, logpos])
    if has[F_COPY]:
        cur16 = wnd.gather(1, dst_idx)
        wnd.scatter_(1, dst_idx, torch.where(write_mask & ok[:, None],
                                             src_bytes, cur16))
    one_mask = (lit_write | ent_write | rle_write | run_write | bad_write) \
        & ok
    if has_any(F_LITTREE, F_ENTTREE, F_RLETREE, F_RLERUN, F_BADBYTES):
        one_pos = torch.where(
            lit_write | ent_write | bad_write, wnd_pos,
            torch.where(rle_write, rle_wpos, run_wpos))
        one_val = torch.where(
            lit_write, lit_byte, torch.where(
                ent_write, ent_byte, torch.where(
                    rle_write, rle_orig, torch.where(
                        run_write, run_orig, bad_b0))))
        one_pos = torch.where(one_mask, one_pos, 0).clamp(0, wnd_cap - 1)
        wnd[barange, one_pos] = torch.where(
            one_mask, one_val.to(torch.uint8), wnd[barange, one_pos])
    if has[F_BADBYTES]:
        w2 = wrote2 & ok
        two_pos = torch.where(w2, wnd_pos + 1, 0).clamp(0, wnd_cap - 1)
        wnd[barange, two_pos] = torch.where(
            w2, (dval & 0xFF).to(torch.uint8), wnd[barange, two_pos])

    # ====================== coder registers ==============================
    if any_bit:
        upd("rc_code", is_bit, code)
        upd("rc_range", is_bit, rng)
        upd("rc_ptr", need_refill, rc_ptr_n)
        upd("rc_blk", is_bit, rc_blk_n)
    if any_dir:
        upd("bc_val", is_dir, bc_val)
        upd("bc_bits", is_dir, bc_bits)
        upd("bc_ptr", is_dir, bc_ptr)
        upd("bc_blk", is_dir & ~reset, bc_blk)
        if has[F_INTNUM]:
            upd("rc_code", reset, prime)
            upd("rc_range", reset, MASK32)
            upd("rc_ptr", reset, reset_rc_ptr)
            upd("bc_val", reset, 0)
            upd("bc_bits", reset, 0)
            upd("bc_ptr", reset, b_start)

    regs = torch.stack([N.get(name, rows[i]) for i, name in enumerate(REGS)])
    regs = torch.where(halt[None, :], R, regs)
    regs[IX["err"]] = torch.where(halt, ERR_CORRUPT, regs[IX["err"]])
    regs[IX["done"]] = torch.where(halt, 1, regs[IX["done"]])
    regs[IX["wnd_pos"]] = torch.where(
        halt_w, would.clamp(max=MAX_WINDOW + 1), regs[IX["wnd_pos"]])
    new = dict(st)
    new["regs"] = regs
    return new


def run_decode(st, wnd_size, max_steps):
    """Step until every stream is done or `max_steps` steps have run.
    Returns (final state, steps run)."""
    steps = 0
    b = st["regs"].shape[1]
    while steps < max_steps:
        fsm_a, has = _present_states(st["regs"])
        if has[F_IDLE] == b:
            break
        st = _step(st, wnd_size, fsm_a, has)
        steps += 1
    return st, steps


# no autograd state a step: the lockstep loop runs about a fifth faster
@torch.inference_mode()
def decode_plain(rc, bc, rc_ends, bc_ends, wnd_size, max_steps,
                 max_blocks=MAX_BLOCKS):
    """The whole decode as K1's wrapper returns it: (wnd [B, wnd_size+16]
    u8, blk_log [B, max_blocks, 2] i32, wnd_pos, done, err, blk_cnt [B]
    i32), on the inputs' device."""
    st = make_decode_state(wnd_size, rc, bc, rc_ends, bc_ends, max_blocks)
    final, _ = run_decode(st, wnd_size, max_steps)
    regs = final["regs"]

    def reg(name):
        return regs[IX[name]].to(torch.int32)
    return (final["wnd"], final["blk_log"], reg("wnd_pos"), reg("done"),
            reg("err"), reg("blk_cnt"))
