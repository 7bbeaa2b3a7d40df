"""Plain PyTorch version of the K2 lazy-parse kernel: B streams parsed in
lockstep over precomputed candidates, about one token per step.

A torch port of csc_tpu/ops/encode_scan_fast.py (`make_fast_state`,
`fast_parse_step`, `run_fast_parse`), field for field: the candidate fold
of find_match's record semantics (distance-gate chain over MF_DIST_BOUND,
minlen growth, the good_len exit, the HT2 wrap quirk, the vld_rge gate,
csc_mf.cpp:243-495), the FindMatch best pick through SecondMatchBetter
(csc_mf.cpp:570-582), the lazy second probe of csc_lz.cpp:156-199, live
extension of rep lanes and of candidates capped at EXT_CAP, run
boundaries through run_ends / run_skip with K_SENT_A sentinels, and
K_END.  The state holds the same fields as the JAX state
(`state_from_numpy` / `state_to_numpy` carry it across), with every
register in int64; the tape and register tensors are updated in place.

`parse_plain` runs it to the end and returns what the kernel
(csrc/encode_k2.cuh) returns: the two-word tape (kind | wire_len << 3,
dist_code; K2 writes no literal or last-match bytes, the stitcher fills
them from the data), tok_cnt, done and err.
"""
import numpy as np
import torch

from ..constants import (MF_DIST_BOUND, EXT_CAP, K_LIT, K_MATCH, K_REP,
                         K_REP0L1, K_END, K_SENT_A, FB_BLOCK, FB_FIND,
                         FB_DONE, ERR_OVERFLOW)
from .parse_pre import unpack_candidates, words4

_BOUND = list(MF_DIST_BOUND) + [0x7FFFFFFF]
_REGS = ["size", "vld_rge", "wpos", "run_idx", "run_end", "fsm", "blk_off",
         "blk_len", "blk_i", "probe2", "armed", "have_u1", "u1_len",
         "u1_dist", "tok_cnt", "done"]
_TAPE = ["tok_kind", "tok_a", "tok_b", "tok_c"]
_LANES = ["cand_d", "cand_l", "ext_q", "ext_l", "ext_lim"]


def check_inputs(data, candp, run_ends, run_skip, sizes, dict_sizes):
    """Raise on inputs K2 and this version do not take."""
    b = data.shape[0] if data.dim() == 2 else -1
    want = (("data", data, torch.uint8, 2), ("candp", candp, torch.int32, 3),
            ("run_ends", run_ends, torch.int32, 2),
            ("run_skip", run_skip, torch.int32, 2),
            ("sizes", sizes, torch.int32, 1),
            ("dict_sizes", dict_sizes, torch.int32, 1))
    for name, t, dt, nd in want:
        if t.dtype != dt or t.dim() != nd or t.shape[0] != b:
            raise ValueError(f"{name}: want {nd}-d {dt} with {b} rows, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != data.device:
            raise ValueError(f"{name} on {t.device}, data on {data.device}")
    if candp.shape[2] != data.shape[1] or candp.shape[1] < 3:
        raise ValueError("candp must be [B, 2 + hash_width, N]")
    if run_skip.shape != run_ends.shape or run_ends.shape[1] < 1:
        raise ValueError("run_ends and run_skip must both be [B, R >= 1]")


def tape_capacity(n, r):
    """Tape tokens enough for any parse of N positions in R runs: one per
    position, a sentinel per run, K_END, and slack."""
    return n + 2 * r + 64


def make_parse_state(data, candp, run_ends, run_skip, sizes, dict_sizes,
                     max_tokens):
    """Initial state on data's device (make_fast_state's fields)."""
    check_inputs(data, candp, run_ends, run_skip, sizes, dict_sizes)
    b, dev = data.shape[0], data.device
    z = torch.zeros(b, dtype=torch.int64, device=dev)
    c = candp.shape[1]
    st = {name: z.clone() for name in _REGS}
    st["size"] = sizes.long()
    st["vld_rge"] = dict_sizes.long() - 8 * 1024 - 4
    st["run_end"] = run_ends[:, 0].long()
    st["fsm"] += FB_BLOCK
    st["data"] = data
    st["in4"] = words4(data)
    st["cand"] = unpack_candidates(candp)
    st["reps"] = dict_sizes.long()[:, None].repeat(1, 4)
    st["run_ends"] = run_ends
    st["run_skip"] = run_skip
    st["cand_d"] = torch.zeros((b, c), dtype=torch.int64, device=dev)
    st["cand_l"] = torch.zeros((b, c), dtype=torch.int64, device=dev)
    st["ext_q"] = torch.full((b, 4 + c), -1, dtype=torch.int64, device=dev)
    st["ext_l"] = torch.zeros((b, 4 + c), dtype=torch.int64, device=dev)
    st["ext_lim"] = torch.zeros((b, 4 + c), dtype=torch.int64, device=dev)
    for name in _TAPE:
        st[name] = torch.zeros((b, max_tokens), dtype=torch.int64,
                               device=dev)
    return st


def state_from_numpy(st, device):
    """encode_scan_fast's state (numpy or jax arrays) -> this module's
    state on `device`."""
    dev = torch.device(device)

    def t(name, dtype=torch.int64):
        return torch.as_tensor(np.array(st[name]), device=dev).to(dtype)
    out = {name: t(name) for name in _REGS + _TAPE + _LANES + ["in4",
                                                               "reps"]}
    out["data"] = t("data", torch.uint8)
    out["cand"] = t("cand", torch.int32)
    out["run_ends"] = t("run_ends", torch.int32)
    out["run_skip"] = t("run_skip", torch.int32)
    return out


def state_to_numpy(st):
    """This module's state -> encode_scan_fast's field names and dtypes."""
    out = {}
    for name in _REGS + _TAPE + _LANES + ["reps", "run_ends", "run_skip",
                                          "cand"]:
        out[name] = st[name].cpu().numpy().astype(np.int32)
    out["data"] = st["data"].cpu().numpy().copy()
    out["in4"] = st["in4"].cpu().numpy().astype(np.uint32)
    return out


def _gather(tbl, idx):
    return tbl.gather(1, idx[:, None])[:, 0].long()


def second_better(l1, d1, l2, d2):
    """SecondMatchBetter (csc_mf.cpp:570-582)."""
    cof21 = 4 * (l2 - l1).clamp(0, 3)
    cof12 = 4 * (l1 - l2).clamp(0, 3)
    return (l2 > 1) & (
        (l2 > l1 + 3)
        | ((l2 > l1) & (d2 <= 4))
        | ((l2 + 2 > l1) & (d2 <= 4) & (d1 > 4))
        | ((l2 >= l1) & ((d2 >> cof21) <= d1))
        | ((l2 < l1) & (l2 + 2 >= l1) & (d1 > 4) & ((d1 >> cof12) > d2)))


def _put(tbl, pos, mask, val):
    """tbl[b, pos[b]] = val[b] where mask, in place."""
    cur = tbl.gather(1, pos[:, None])[:, 0]
    tbl.scatter_(1, pos[:, None], torch.where(mask, val, cur)[:, None])


def _eq_bytes(x):
    return torch.where(
        x == 0, 4, torch.where(
            (x & 0xFF) != 0, 0, torch.where(
                (x & 0xFFFF) != 0, 1, torch.where(
                    (x & 0xFFFFFF) != 0, 2, 3))))


def parse_step(st, good_len):
    """One lockstep step of every live stream (fast_parse_step)."""
    fsm = st["fsm"]
    active = st["done"] == 0
    new = dict(st)

    def upd(name, cond, val):
        new[name] = torch.where(cond, val, new[name])

    wpos = st["wpos"]
    tape_w = st["tok_kind"].shape[1]
    tpos_ok = st["tok_cnt"] < tape_w
    tpos = st["tok_cnt"].clamp(0, tape_w - 1)
    r_max = st["run_ends"].shape[1] - 1

    # ---------------- FB_BLOCK ----------------------------------------
    c = active & (fsm == FB_BLOCK)
    if bool(c.any()):
        need_new = c & (st["blk_i"] >= st["blk_len"])
        nboff = st["blk_off"] + st["blk_len"]
        run_done = need_new & (nboff >= st["run_end"]) & (st["blk_len"] > 0)
        _put(st["tok_kind"], tpos, run_done & tpos_ok,
             torch.full_like(wpos, K_SENT_A))
        upd("tok_cnt", run_done, st["tok_cnt"] + 1)
        nridx = st["run_idx"] + 1
        upd("run_idx", run_done, nridx)
        upd("run_end", run_done, _gather(st["run_ends"],
                                         nridx.clamp(0, r_max)))
        upd("blk_off", run_done, nboff)
        upd("blk_len", run_done, 0)
        upd("blk_i", run_done, 0)
        upd("have_u1", run_done, 0)

        fresh = need_new & ~run_done
        stream_end = fresh & (nboff >= st["size"])
        _put(st["tok_kind"], tpos, stream_end & tpos_ok,
             torch.full_like(wpos, K_END))
        upd("tok_cnt", stream_end, st["tok_cnt"] + 1)
        upd("done", stream_end, 1)
        upd("fsm", stream_end, FB_DONE)
        start_blk = fresh & ~stream_end
        cur_skip = _gather(st["run_skip"],
                           new["run_idx"].clamp(0, r_max)) == 1
        skip = start_blk & cur_skip
        upd("blk_off", start_blk, nboff)
        upd("blk_len", start_blk,
            torch.clamp(st["run_end"] - nboff, max=8 * 1024))
        upd("blk_i", start_blk, 0)
        upd("have_u1", start_blk, 0)
        # BAD/ENTROPY/DLT run: no parse, consume the whole run; the next
        # FB_BLOCK step emits its sentinel
        run_len = new["run_end"] - nboff
        upd("blk_len", skip, run_len)
        upd("blk_i", skip, run_len)
        upd("wpos", skip, wpos + run_len)
        go = (c & ~need_new) | (start_blk & ~skip)
        upd("fsm", go, FB_FIND)
        upd("armed", go, 0)
        upd("probe2", go & (st["have_u1"] == 0), 0)

    # ---------------- FB_FIND (arm + extend + pick) ---------------------
    c = active & (fsm == FB_FIND)
    if bool(c.any()):
        _find(st, new, c, good_len, tpos, upd)
    return new


def _find(st, new, c, good_len, tpos, upd):
    wpos = st["wpos"]
    ppos = wpos + st["probe2"]
    limit = st["blk_len"] - st["blk_i"] - st["probe2"]
    need_find = (st["have_u1"] == 0) | (st["probe2"] == 1)
    fresh = c & (st["armed"] == 0) & need_find
    ncand = st["cand_d"].shape[1]
    n = st["cand"].shape[2]

    # arm: rep lanes 0..3 and capped-candidate continuations
    dk = st["reps"]
    qk = ppos[:, None] - dk
    rep_q = torch.where((dk > 0) & (qk >= 0), qk, -1)
    pc = ppos.clamp(0, n - 1)
    cv = st["cand"].gather(2, pc[:, None, None].expand(
        -1, 2 * ncand, 1))[:, :, 0].long()
    cds, cls = cv[:, 0::2], cv[:, 1::2]
    need = (cls >= EXT_CAP) & (limit[:, None] > EXT_CAP) & (cds > 0)
    lanes_q = torch.cat([rep_q, torch.where(need, ppos[:, None] - cds, -1)],
                        dim=1)
    lanes_lim = limit[:, None].expand(-1, 4 + ncand)
    lanes_l0 = torch.cat([torch.zeros_like(rep_q),
                          torch.where(need, EXT_CAP, 0)], dim=1)
    fc = fresh[:, None]
    q = torch.where(fc, lanes_q, st["ext_q"])
    lim = torch.where(fc, lanes_lim, st["ext_lim"])
    ln = torch.where(fc, lanes_l0, st["ext_l"])
    new["cand_d"] = torch.where(fc, cds, st["cand_d"])
    new["cand_l"] = torch.where(fc, cls, st["cand_l"])
    upd("armed", fresh, 1)
    arming = fresh | (c & (st["armed"] == 1))

    # extend live lanes 4 bytes per round, at most 8 rounds a step
    in4 = st["in4"]
    nw = in4.shape[1]
    alive = (q >= 0) & (ln < lim) & arming[:, None]
    it = 0
    while it < 8 and bool(alive.any()):
        w1 = in4.gather(1, (ppos[:, None] + ln).clamp(0, nw - 1))
        w2 = in4.gather(1, (q + ln).clamp(0, nw - 1))
        eq = _eq_bytes(w1 ^ w2)
        adv = torch.minimum(eq, (lim - ln).clamp(min=0))
        ln = torch.where(alive, ln + adv, ln)
        alive = alive & (eq == 4) & (adv == 4) & (ln < lim)
        it += 1
    ac = arming[:, None]
    new["ext_q"] = torch.where(ac, q, st["ext_q"])
    new["ext_lim"] = torch.where(ac, lim, st["ext_lim"])
    new["ext_l"] = torch.where(ac, ln, st["ext_l"])
    settled = arming & ~alive.any(dim=1)

    # pick: fold + lazy decision, the same step the extensions settle
    c = (c & (st["armed"] == 0) & ~need_find) | settled
    probe2 = st["probe2"] == 1
    ext_l = new["ext_l"]
    minlen = torch.ones_like(wpos)
    dist_var = torch.zeros_like(wpos)
    gl = torch.zeros_like(c)
    best_l = torch.ones_like(wpos)
    best_d = torch.zeros_like(wpos)

    def consider(bl, bd, hv, l2, d2):
        take = ~hv | (hv & second_better(bl, bd, l2, d2))
        return torch.where(take, l2, bl), torch.where(take, d2, bd), \
            torch.ones_like(hv)

    # rep0len1 (csc_mf.cpp:281-287): observable iff the rep0 lane >= 2
    r01 = ext_l[:, 0] >= 2
    best_l = torch.where(r01, 1, best_l)
    best_d = torch.where(r01, 1, best_d)
    have = r01
    for k in range(4):
        lk = torch.minimum(ext_l[:, k], limit)
        bet = ~gl & (lk > minlen)
        minlen = torch.where(bet, lk, minlen)
        bl2, bd2, hv2 = consider(best_l, best_d, have, lk,
                                 torch.full_like(lk, k + 1))
        best_l = torch.where(bet, bl2, best_l)
        best_d = torch.where(bet, bd2, best_d)
        have = torch.where(bet, hv2, have)
        gl = gl | (bet & (lk >= good_len))

    vld = st["vld_rge"] & 0xFFFFFFFF
    bound_tbl = torch.as_tensor(_BOUND, device=wpos.device)
    for ci in range(ncand):
        dv = new["cand_d"][:, ci]
        lv = new["cand_l"][:, ci]
        lv = torch.where(new["ext_q"][:, 4 + ci] >= 0, ext_l[:, 4 + ci], lv)
        lv = torch.minimum(lv, limit)
        du = dv & 0xFFFFFFFF
        gate = (dv > 0) & (du > (dist_var & 0xFFFFFFFF)) & ~gl
        dist_var = torch.where(gate, dv, dist_var)
        ok = gate & (du < vld)
        if ci == 0:            # HT2 wraparound quirk (csc_mf.cpp:306)
            ok = ok & (dv != ppos)
        bet = ok & (lv > minlen)
        minlen = torch.where(bet, lv, minlen)
        blen = bound_tbl[lv.clamp(0, 7)]
        rec = bet & ((lv > 6) | (dv < blen))
        bl2, bd2, hv2 = consider(best_l, best_d, have, lv, dv + 4)
        best_l = torch.where(rec, bl2, best_l)
        best_d = torch.where(rec, bd2, best_d)
        have = torch.where(rec, hv2, have)
        gl = gl | (bet & (lv >= good_len))

    u_len = torch.where(have, best_l, 1)
    u_dist = torch.where(have, best_d, 0)

    # lazy decision (encode_scan E_DECIDE)
    first = c & ~probe2
    u1_len = torch.where(st["have_u1"] == 1, st["u1_len"], u_len)
    u1_dist = torch.where(st["have_u1"] == 1, st["u1_dist"], u_dist)
    take_now = first & ((u1_len == 1) | (u1_len >= good_len))
    go2 = first & ~take_now
    upd("u1_len", go2, u1_len)
    upd("u1_dist", go2, u1_dist)
    upd("probe2", go2, 1)
    upd("armed", go2, 0)
    second = c & probe2
    smb = second_better(st["u1_len"], st["u1_dist"], u_len, u_dist)
    lit = second & smb
    mt = second & ~smb
    em_len = torch.where(take_now, u1_len, torch.where(lit, 1, st["u1_len"]))
    em_dist = torch.where(take_now, u1_dist,
                          torch.where(lit, 0, st["u1_dist"]))
    emitted = take_now | lit | mt
    upd("u1_len", lit, u_len)
    upd("u1_dist", lit, u_dist)
    upd("have_u1", lit, 1)
    upd("have_u1", take_now | mt, 0)
    upd("probe2", lit | mt, 0)
    upd("blk_i", emitted, st["blk_i"] + em_len)
    upd("wpos", emitted, wpos + em_len)
    _emit_token(st, new, emitted, em_len, em_dist, tpos)
    upd("armed", emitted, 0)
    boundary = emitted & (new["blk_i"] >= st["blk_len"])
    upd("fsm", boundary, FB_BLOCK)


def _emit_token(st, new, mask, u_len, u_dist, tpos):
    """encode_scan._emit_token: one token and the rep queue update."""
    wpos = st["wpos"]
    is_lit = u_dist == 0
    is_r01 = (u_dist == 1) & (u_len == 1)
    is_rep = (u_dist <= 4) & ~is_lit & ~is_r01
    is_match = u_dist > 4
    data = st["data"]
    n = data.shape[1]
    lit_byte = _gather(data, wpos.clamp(0, n - 1))
    kind = torch.where(is_lit, K_LIT, torch.where(
        is_r01, K_REP0L1, torch.where(is_rep, K_REP, K_MATCH)))
    a = torch.where(is_lit, lit_byte, torch.where(
        is_r01, 0, torch.where(is_rep, u_dist - 1, u_dist - 5)))
    b = torch.where(is_rep | is_match, u_len - 2, 0)
    last_byte = _gather(data, (wpos + u_len - 1).clamp(0, n - 1))
    for name, val in zip(_TAPE, (kind, a, b, last_byte)):
        _put(st[name], tpos, mask, val)
    new["tok_cnt"] = torch.where(mask, st["tok_cnt"] + 1, new["tok_cnt"])

    reps = st["reps"]
    rd = reps.gather(1, (u_dist - 1).clamp(0, 3)[:, None])
    cols = torch.arange(4, device=reps.device)[None, :]
    rot = torch.where(cols <= (u_dist - 1)[:, None],
                      torch.cat([rd, reps[:, :3]], dim=1), reps)
    push = torch.cat([(u_dist - 4)[:, None], reps[:, :3]], dim=1)
    reps2 = torch.where((mask & is_rep)[:, None], rot, reps)
    new["reps"] = torch.where((mask & is_match)[:, None], push, reps2)


def run_parse(st, good_len, max_steps):
    """Step until every stream is done or max_steps; returns (state,
    steps taken)."""
    steps = 0
    while steps < max_steps and not bool((st["done"] == 1).all()):
        st = parse_step(st, good_len)
        steps += 1
    return st, steps


def tape_of(st):
    """K2's outputs from a state: (tape [B, T, 2] int32, tok_cnt, done,
    err [B] int32)."""
    kind = st["tok_kind"]
    wire = (kind == K_MATCH) | (kind == K_REP)
    w0 = kind | (torch.where(wire, st["tok_b"], 0) << 3)
    w1 = torch.where(wire, st["tok_a"], 0)
    tape = torch.stack([w0, w1], dim=2).to(torch.int32)
    cnt = st["tok_cnt"]
    err = torch.where(cnt > kind.shape[1], ERR_OVERFLOW, 0)
    return (tape, cnt.to(torch.int32), st["done"].to(torch.int32),
            err.to(torch.int32))


# no autograd state a step: the lockstep loop runs about a fifth faster
@torch.inference_mode()
def parse_plain(data, candp, run_ends, run_skip, sizes, dict_sizes,
                good_len, max_tokens, max_steps=None):
    """K2's function, as lockstep torch ops on data's device."""
    st = make_parse_state(data, candp, run_ends, run_skip, sizes,
                          dict_sizes, max_tokens)
    if max_steps is None:
        max_steps = 8 * data.shape[1] + 4096
    st, _ = run_parse(st, int(good_len), max_steps)
    return tape_of(st)
