"""Plain PyTorch version of the K4 optimal (AP) parse of m3-m5: B streams
parsed in lockstep over precomputed candidates, one FSM action a step.

A torch port of csc_tpu/ops/parse_ap.py (`make_ap_state`,
`ap_parse_step`, `_stretch_reset`, `_to_mark`, `_emit_ap`,
`run_ap_parse`), field for field and step for step: the price-directed
DP of compress_advanced (csc_lz.cpp:207-333) over stretches of at most
AP_LIMIT cells under snapshot prices (ops/prices.py).  A stream walks
BLOCK (8 KB sub-blocks and runs, K_SENT_A, K_END) -> FIND (rebuild the
node's state and rep queue from its back pointer, arm the rep and
candidate lanes, extend them at most 8 rounds of 4 bytes a step, fold
them in find_match order, price every length 2..good_len, end the
stretch on a lone literal, a good_len match or the cap, else relax the
literal, rep0len1 and match cells) -> MARK (next pointers from the end
node back to the stretch start) -> WALK (emit the path's tokens, then
the post-stretch literal or match).  The state holds the JAX state's
fields (`state_from_numpy` / `state_to_numpy` carry it across), every
register in int64 (no value leaves int32's range: prices stay below INF
+ a stretch's worth); the cell arrays and the tape are updated in place,
each phase reading its cells before it writes them, as the JAX step
reads its input state.

Three behaviours of csc_tpu's step are kept because its output depends
on them:
  - a stream whose lanes extend more than 8 rounds settles in a later
    step, and that step prices with the node state rebuilt from its back
    pointer; at a stretch start that is (state * 4) & 0x3F of the entry
    state, not the entry state itself (parse_ap.py:316-318).  The
    initial model's tables price every state alike, so this shows only
    under other tables;
  - a match relaxed into the last column (N - 1) of the cell arrays is
    undone: every longer length of the grid clips onto that cell and,
    last in the scatter, writes its old value back (parse_ap.py:530-548);
  - a match's distance price is 128 * max(slot + 2, 4) (parse_ap.py:460-
    462), where golden's GetMatchDistPrice charges (slot > 2 ? slot + 2
    : 2) * 128.

`parse_ap_plain` runs it to the end and returns what the kernel
(csrc/encode_k4.cuh) returns: K2's two-word tape (kind | wire_len << 3,
dist_code), tok_cnt, done, err and the FIND positions at which the
lanes ran (`found`).
"""
import numpy as np
import torch

from ..constants import (MF_DIST_BOUND, DIST_TABLE, EXT_CAP, K_LIT,
                         K_MATCH, K_REP, K_REP0L1, K_END, K_SENT_A, AP_LIMIT,
                         INF, AP_BLOCK, AP_FIND, AP_MARK, AP_WALK, AP_DONE,
                         POST_NONE, POST_LIT, POST_MATCH, ERR_OVERFLOW,
                         ERR_STEPS)
from . import parse_scan, prices as prices_mod
from .parse_pre import unpack_candidates, words4

_BOUND = list(MF_DIST_BOUND) + [0x7FFFFFFF]
_REGS = ["size", "vld_rge", "wpos", "mstate", "run_idx", "run_end", "fsm",
         "blk_off", "blk_len", "blk_i", "armed", "sid", "s0", "apend", "end",
         "walk", "post", "post_len", "post_dist", "tok_cnt", "done"]
_CELLS = ["price", "stamp", "back", "ndist", "nstate", "nxt"]
_TAPE = ["tok_kind", "tok_a", "tok_b", "tok_c"]
_LANES = ["cand_d", "cand_l", "ext_q", "ext_l", "ext_lim"]
_PRICES = ["pr_" + name for name, _ in prices_mod.TABLES]


def check_inputs(data, candp, run_ends, run_skip, sizes, dict_sizes,
                 prices):
    """Raise on inputs K4 and this version do not take."""
    parse_scan.check_inputs(data, candp, run_ends, run_skip, sizes,
                            dict_sizes)
    if (prices.dtype != torch.int32 or prices.dim() != 1
            or prices.shape[0] != prices_mod.PACKED_LEN):
        raise ValueError(f"prices: want a [{prices_mod.PACKED_LEN}] int32 "
                         f"vector (prices.pack_prices), got "
                         f"{tuple(prices.shape)} {prices.dtype}")
    if prices.device != data.device:
        raise ValueError(f"prices on {prices.device}, data on {data.device}")


def make_ap_state(data, candp, run_ends, run_skip, sizes, dict_sizes,
                  prices, max_tokens):
    """Initial state on data's device (make_ap_state's fields)."""
    check_inputs(data, candp, run_ends, run_skip, sizes, dict_sizes, prices)
    b, n = data.shape
    dev = data.device
    c = candp.shape[1]
    z = torch.zeros(b, dtype=torch.int64, device=dev)
    st = {name: z.clone() for name in _REGS}
    st["size"] = sizes.long()
    st["vld_rge"] = dict_sizes.long() - 8 * 1024 - 4
    st["run_end"] = run_ends[:, 0].long()
    st["fsm"] += AP_BLOCK
    st["data"] = data
    st["in4"] = words4(data)
    st["cand"] = unpack_candidates(candp)
    st["reps"] = dict_sizes.long()[:, None].repeat(1, 4)
    st["run_ends"] = run_ends
    st["run_skip"] = run_skip
    for name in _CELLS:
        st[name] = torch.zeros((b, n), dtype=torch.int64, device=dev)
    st["stamp"] -= 1
    st["nrep"] = torch.zeros((b, 4, n), dtype=torch.int64, device=dev)
    st["cand_d"] = torch.zeros((b, c), dtype=torch.int64, device=dev)
    st["cand_l"] = torch.zeros((b, c), dtype=torch.int64, device=dev)
    st["ext_q"] = torch.full((b, 4 + c), -1, dtype=torch.int64, device=dev)
    st["ext_l"] = torch.zeros((b, 4 + c), dtype=torch.int64, device=dev)
    st["ext_lim"] = torch.zeros((b, 4 + c), dtype=torch.int64, device=dev)
    for name in _TAPE:
        st[name] = torch.zeros((b, max_tokens), dtype=torch.int64,
                               device=dev)
    for name, t in prices_mod.unpack_prices(prices).items():
        st["pr_" + name] = t
    return st


def state_from_numpy(st, device):
    """parse_ap's state (numpy or jax arrays) -> this module's state on
    `device`."""
    dev = torch.device(device)

    def t(name, dtype=torch.int64):
        return torch.as_tensor(np.array(st[name]), device=dev).to(dtype)
    out = {name: t(name) for name in (_REGS + _CELLS + _TAPE + _LANES
                                      + _PRICES + ["in4", "reps", "nrep"])}
    out["data"] = t("data", torch.uint8)
    out["cand"] = t("cand", torch.int32)
    out["run_ends"] = t("run_ends", torch.int32)
    out["run_skip"] = t("run_skip", torch.int32)
    return out


def state_to_numpy(st):
    """This module's state -> parse_ap's field names and dtypes."""
    out = {}
    for name in (_REGS + _CELLS + _TAPE + _LANES + _PRICES
                 + ["reps", "nrep", "run_ends", "run_skip", "cand"]):
        v = st[name].cpu().numpy()
        if v.dtype == np.int64 and v.size and (
                v.min() < -2 ** 31 or v.max() >= 2 ** 31):
            raise OverflowError(f"{name} leaves int32's range")
        out[name] = v.astype(np.int32)
    out["data"] = st["data"].cpu().numpy().copy()
    out["in4"] = st["in4"].cpu().numpy().astype(np.uint32)
    return out


def _gather(tbl, idx):
    return tbl.gather(1, idx[:, None])[:, 0].long()


def _put(tbl, pos, mask, val):
    """tbl[b, pos[b]] = val[b] where mask, in place."""
    cur = tbl.gather(1, pos[:, None])[:, 0]
    tbl.scatter_(1, pos[:, None], torch.where(mask, val, cur)[:, None])


def _dist_slot(dist):
    """_dist_slot (csc_model.cpp:331-340): the count of DIST_TABLE[1:]
    entries <= dist, elementwise."""
    tbl = torch.as_tensor(DIST_TABLE[1:], device=dist.device)
    return (dist[..., None] >= tbl).sum(dim=-1)


def _excl_cummax(x, first):
    """[B, L] -> the max of `first` and of x[:, :i], at each i."""
    pad = torch.full_like(x[:, :1], first)
    return torch.cummax(torch.cat([pad, x[:, :-1]], dim=1), dim=1).values \
        .clamp(min=first)


def _excl_cumany(x):
    """[B, L] bool -> whether any of x[:, :i] holds, at each i."""
    return _excl_cummax(x.long(), 0) > 0


def _next_state(s, u_len, u_dist):
    """The model state after a token (literal, rep0len1, rep, match)."""
    return torch.where(u_dist == 0, (s * 4) & 0x3F, torch.where(
        (u_dist == 1) & (u_len == 1), (s * 4 + 2) & 0x3F, torch.where(
            u_dist <= 4, (s * 4 + 3) & 0x3F, (s * 4 + 1) & 0x3F)))


class _Step:
    """One lockstep step: reads `st` (the input state), builds `new`."""

    def __init__(self, st, good_len):
        self.st, self.new = st, dict(st)
        self.good_len = good_len
        self.n = st["data"].shape[1]
        self.tape_w = st["tok_kind"].shape[1]

    def upd(self, name, cond, val):
        self.new[name] = torch.where(cond, val, self.new[name])

    def clip(self, idx):
        return idx.clamp(0, self.n - 1)

    def cell(self, name, idx):
        return _gather(self.st[name], self.clip(idx))

    def cell_set(self, name, mask, idx, val):
        _put(self.new[name], self.clip(idx), mask, val)

    def nrep_at(self, idx):
        i = self.clip(idx)[:, None, None].expand(-1, 4, 1)
        return self.st["nrep"].gather(2, i)[:, :, 0]

    def stretch_reset(self, mask, s0_new, mstate, reps):
        """_stretch_reset: a new stretch rooted at s0_new."""
        new = self.new
        self.upd("sid", mask, new["sid"] + 1)
        self.upd("s0", mask, s0_new)
        self.upd("apend", mask, torch.ones_like(s0_new))
        z = torch.zeros_like(s0_new)
        for name, val in (("price", z), ("stamp", new["sid"]),
                          ("back", s0_new), ("ndist", z),
                          ("nstate", mstate)):
            self.cell_set(name, mask, s0_new, val)
        i = self.clip(s0_new)[:, None, None].expand(-1, 4, 1)
        cur = new["nrep"].gather(2, i)[:, :, 0]
        new["nrep"].scatter_(2, i, torch.where(mask[:, None], reps,
                                               cur)[:, :, None])

    def to_mark(self, mask, end, post, post_len, post_dist):
        self.upd("end", mask, end)
        self.upd("walk", mask, end)
        self.upd("post", mask, torch.full_like(end, post))
        self.upd("post_len", mask, post_len)
        self.upd("post_dist", mask, post_dist)
        self.upd("fsm", mask, AP_MARK)

    def emit(self, mask, u_len, u_dist, pos):
        """_emit_ap: one token at tok_cnt (the last entry when the tape is
        full), and the live state and rep queue after it."""
        if not bool(mask.any()):
            return
        new = self.new
        tpos = new["tok_cnt"].clamp(0, self.tape_w - 1)
        is_lit = u_dist == 0
        is_r01 = (u_dist == 1) & (u_len == 1)
        is_rep = (u_dist <= 4) & ~is_lit & ~is_r01
        is_match = u_dist > 4
        data = self.st["data"]
        kind = torch.where(is_lit, K_LIT, torch.where(
            is_r01, K_REP0L1, torch.where(is_rep, K_REP, K_MATCH)))
        a = torch.where(is_lit, _gather(data, self.clip(pos)), torch.where(
            is_r01, 0, torch.where(is_rep, u_dist - 1, u_dist - 5)))
        b = torch.where(is_rep | is_match, u_len - 2, 0)
        last = _gather(data, self.clip(pos + u_len - 1))
        for name, val in zip(_TAPE, (kind, a, b, last)):
            _put(new[name], tpos, mask, val)
        self.upd("tok_cnt", mask, new["tok_cnt"] + 1)
        self.upd("mstate", mask, _next_state(new["mstate"], u_len, u_dist))
        reps = new["reps"]
        rd = reps.gather(1, (u_dist - 1).clamp(0, 3)[:, None])
        cols = torch.arange(4, device=reps.device)[None, :]
        rot = torch.where(cols <= (u_dist - 1)[:, None],
                          torch.cat([rd, reps[:, :3]], dim=1), reps)
        push = torch.cat([(u_dist - 4)[:, None], reps[:, :3]], dim=1)
        reps2 = torch.where((mask & is_rep)[:, None], rot, reps)
        new["reps"] = torch.where((mask & is_match)[:, None], push, reps2)

    # ---------------------------------------------------------- AP_BLOCK
    def block(self, c):
        st = self.st
        wpos = st["wpos"]
        tpos_ok = st["tok_cnt"] < self.tape_w
        tpos = st["tok_cnt"].clamp(0, self.tape_w - 1)
        r_max = st["run_ends"].shape[1] - 1
        need_new = c & (st["blk_i"] >= st["blk_len"])
        nboff = st["blk_off"] + st["blk_len"]
        run_done = need_new & (nboff >= st["run_end"]) & (st["blk_len"] > 0)
        _put(self.new["tok_kind"], tpos, run_done & tpos_ok,
             torch.full_like(wpos, K_SENT_A))
        self.upd("tok_cnt", run_done, st["tok_cnt"] + 1)
        nridx = st["run_idx"] + 1
        self.upd("run_idx", run_done, nridx)
        self.upd("run_end", run_done,
                 _gather(st["run_ends"], nridx.clamp(0, r_max)))
        self.upd("blk_off", run_done, nboff)
        self.upd("blk_len", run_done, 0)
        self.upd("blk_i", run_done, 0)

        fresh = need_new & ~run_done
        stream_end = fresh & (nboff >= st["size"])
        _put(self.new["tok_kind"], tpos, stream_end & tpos_ok,
             torch.full_like(wpos, K_END))
        self.upd("tok_cnt", stream_end, st["tok_cnt"] + 1)
        self.upd("done", stream_end, 1)
        self.upd("fsm", stream_end, AP_DONE)
        start_blk = fresh & ~stream_end
        cur_skip = _gather(st["run_skip"],
                           self.new["run_idx"].clamp(0, r_max)) == 1
        skip = start_blk & cur_skip
        self.upd("blk_off", start_blk, nboff)
        self.upd("blk_len", start_blk,
                 torch.clamp(st["run_end"] - nboff, max=8 * 1024))
        self.upd("blk_i", start_blk, 0)
        run_len = self.new["run_end"] - nboff
        self.upd("blk_len", skip, run_len)
        self.upd("blk_i", skip, run_len)
        self.upd("wpos", skip, wpos + run_len)
        go = (c & ~need_new) | (start_blk & ~skip)
        self.upd("fsm", go, AP_FIND)
        self.upd("armed", go, 0)
        self.stretch_reset(go, self.new["wpos"], st["mstate"], st["reps"])

    # ----------------------------------------------------------- AP_FIND
    def find(self, c):
        st, new = self.st, self.new
        wpos, s0 = st["wpos"], st["s0"]
        apcur = wpos - s0
        limit = st["blk_len"] - st["blk_i"] - apcur
        aplimit = torch.clamp(st["blk_len"] - st["blk_i"], max=AP_LIMIT)

        # node reconstruction on first touch (csc_lz.cpp:211-233)
        fresh = c & (st["armed"] == 0)
        back_b = self.cell("back", wpos)
        nd = self.cell("ndist", wpos)
        bstate = self.cell("nstate", back_b)
        brep = self.nrep_at(back_b)
        ln_tok = wpos - back_b
        is_r01_n = (nd == 1) & (ln_tok == 1)
        is_rep_n = (nd >= 1) & (nd <= 4) & ~is_r01_n
        nstate_v = torch.where(
            nd == 0, (bstate * 4) & 0x3F, torch.where(
                is_r01_n, (bstate * 4 + 2) & 0x3F, torch.where(
                    is_rep_n, (bstate * 4 + 3) & 0x3F, (bstate * 4 + 1)
                    & 0x3F)))
        # rep queue: rotate to front for a rep match, push a new distance
        di = (nd - 1).clamp(0, 3)
        rfront = brep.gather(1, di[:, None])
        cols = torch.arange(4, device=wpos.device)[None, :]
        rot = torch.where(cols == 0, rfront, torch.where(
            cols <= di[:, None], torch.cat([rfront, brep[:, :3]], dim=1),
            brep))
        psh = torch.cat([(nd - 4)[:, None], brep[:, :3]], dim=1)
        nrep_v = torch.where(is_rep_n[:, None], rot,
                             torch.where((nd > 4)[:, None], psh, brep))
        node_first = fresh & (apcur == 0)
        # a stretch start keeps the entry node _stretch_reset wrote
        nstate_n = torch.where(node_first, self.cell("nstate", wpos),
                               nstate_v)
        nrep_n = torch.where(node_first[:, None], self.nrep_at(wpos),
                             nrep_v)
        wr = fresh & (apcur > 0)
        self.cell_set("nstate", wr, wpos, nstate_v)
        i = self.clip(wpos)[:, None, None].expand(-1, 4, 1)
        cur = new["nrep"].gather(2, i)[:, :, 0]
        new["nrep"].scatter_(2, i, torch.where(wr[:, None], nrep_v,
                                               cur)[:, :, None])

        at_cap = fresh & (apcur >= aplimit)
        # the cap: emit the path to apcur, no find (csc_lz.cpp:239-242)
        z = torch.zeros_like(wpos)
        self.to_mark(at_cap, wpos, POST_NONE, z, z)

        # arm the rep lanes (the node's queue) and capped candidates
        arm = fresh & ~at_cap
        ncand = st["cand_d"].shape[1]
        qk = wpos[:, None] - nrep_n
        rep_q = torch.where(arm[:, None] & (nrep_n > 0) & (qk >= 0), qk, -1)
        pc = self.clip(wpos)
        cv = st["cand"].gather(2, pc[:, None, None].expand(
            -1, 2 * ncand, 1))[:, :, 0].long()
        cds, cls = cv[:, 0::2], cv[:, 1::2]
        need = (cls >= EXT_CAP) & (limit[:, None] > EXT_CAP) & (cds > 0)
        lanes_q = torch.cat([rep_q, torch.where(
            arm[:, None] & need, wpos[:, None] - cds, -1)], dim=1)
        lanes_l0 = torch.cat([torch.zeros_like(rep_q),
                              torch.where(need, EXT_CAP, 0)], dim=1)
        ac = arm[:, None]
        q = torch.where(ac, lanes_q, st["ext_q"])
        lim = torch.where(ac, limit[:, None].expand(-1, 4 + ncand),
                          st["ext_lim"])
        ln = torch.where(ac, lanes_l0, st["ext_l"])
        new["cand_d"] = torch.where(ac, cds, st["cand_d"])
        new["cand_l"] = torch.where(ac, cls, st["cand_l"])
        self.upd("armed", arm, 1)
        arming = arm | (c & (st["armed"] == 1) & ~at_cap)

        # extend the live lanes 4 bytes a round, at most 8 rounds a step
        in4 = st["in4"]
        nw = in4.shape[1]
        alive = (q >= 0) & (ln < lim) & arming[:, None]
        it = 0
        while it < 8 and bool(alive.any()):
            w1 = in4.gather(1, (wpos[:, None] + ln).clamp(0, nw - 1))
            w2 = in4.gather(1, (q + ln).clamp(0, nw - 1))
            eq = parse_scan._eq_bytes(w1 ^ w2)
            adv = torch.minimum(eq, (lim - ln).clamp(min=0))
            ln = torch.where(alive, ln + adv, ln)
            alive = alive & (eq == 4) & (adv == 4) & (ln < lim)
            it += 1
        ag = arming[:, None]
        new["ext_q"] = torch.where(ag, q, st["ext_q"])
        new["ext_lim"] = torch.where(ag, lim, st["ext_lim"])
        new["ext_l"] = torch.where(ag, ln, st["ext_l"])
        proc = arming & ~alive.any(dim=1)
        if bool(proc.any()):
            self.process(proc, nstate_n, limit, aplimit)

    def process(self, proc, nstate_p, limit, aplimit):
        """The settled streams: fold, per-length prices, stretch-end
        checks, relaxation."""
        st, new = self.st, self.new
        good_len = self.good_len
        wpos, s0 = st["wpos"], st["s0"]
        apcur = wpos - s0
        ext_l, ext_q = new["ext_l"], new["ext_q"]
        dev = wpos.device
        bound_tbl = torch.as_tensor(_BOUND, device=dev)

        # The fold in find_match order over the lanes (reps 0-3, then the
        # candidate rows), each lane's step of its running minlen, distance
        # gate and good_len exit written as prefix maxima: a lane passes
        # the gate iff its distance beats every earlier candidate's, raises
        # minlen iff it beats every earlier passing lane's length, and the
        # first lane to reach good_len ends the fold after itself.
        dv = new["cand_d"]
        lv = torch.where(ext_q[:, 4:] >= 0, ext_l[:, 4:], new["cand_l"])
        lens = torch.minimum(torch.cat([ext_l[:, :4], lv], dim=1),
                             limit[:, None])
        dist_var = _excl_cummax(dv.clamp(min=0), 0)
        ok_c = (dv > 0) & (dv > dist_var) & (
            dv < (st["vld_rge"] & 0xFFFFFFFF)[:, None])    # unsigned
        ok_c[:, 0] &= dv[:, 0] != wpos     # HT2 wrap quirk (csc_mf.cpp:306)
        ok = torch.cat([torch.ones_like(ok_c[:, :4]), ok_c], dim=1)
        minlen = _excl_cummax(torch.where(ok, lens, 1), 1)
        bet = ok & (lens > minlen)
        trig = bet & (lens >= good_len)
        bet &= ~_excl_cumany(trig)
        lv = lens[:, 4:]
        near = (lv > 6) | (dv < bound_tbl[lv.clamp(0, 7)])
        rec = bet & torch.cat([torch.ones_like(near[:, :4]), near], dim=1)
        dists = torch.cat([torch.arange(1, 5, device=dev).expand(
            len(wpos), 4), dv + 4], dim=1)
        r01 = ext_l[:, 0] >= 2
        has = rec.any(dim=1)
        last = rec.shape[1] - 1 - rec.flip(1).long().argmax(dim=1)
        appt0_l = torch.where(has, lens.gather(1, last[:, None])[:, 0], 1)
        appt0_d = torch.where(has, dists.gather(1, last[:, None])[:, 0],
                              r01.long())
        # base prices: csc_tpu's distance price, not golden's (module
        # docstring)
        bases = torch.cat([st["pr_repd"][nstate_p], (
            st["pr_matchf"][nstate_p][:, None]
            + 128 * torch.clamp(_dist_slot(dv - 1) + 2, min=4))], dim=1)
        rdists = torch.cat([torch.zeros_like(dv[:, :4]), dv], dim=1)
        r01p = st["pr_r01"][nstate_p]

        # per-length prices (FindMatchWithPrice's sweep): each recorded
        # lane prices the lengths past the longest recorded before it, so
        # every length has at most one lane
        ls = torch.arange(2, good_len + 1, device=dev)[None, None, :]
        lp_l = st["pr_lenp"][(ls - 2).clamp(0, 31)]
        lpos = _excl_cummax(torch.where(rec, lens, 1), 1)
        m = (rec[:, :, None] & (ls > lpos[:, :, None])
             & (ls <= lens[:, :, None]))
        gated = m & (ls <= 6) & (rdists[:, :, None]
                                 >= bound_tbl[ls.clamp(0, 7)])
        fill = m & ~gated
        appt_d = (fill * dists[:, :, None]).sum(dim=1)
        appt_p = torch.where(fill.any(dim=1), (
            fill * (bases[:, :, None] + lp_l)).sum(dim=1), INF)
        ls = ls[0]

        # stretch-end checks (csc_lz.cpp:239-267, in order)
        apend = st["apend"]
        lone = proc & (appt0_l == 1) & (apcur + 1 == apend)
        one, z = torch.ones_like(wpos), torch.zeros_like(wpos)
        self.to_mark(lone, wpos, POST_LIT, one, z)
        grow1 = proc & ~lone & (apcur + 1 >= apend)
        apend = torch.where(grow1, apcur + 2, apend)
        big = proc & ~lone & ((appt0_l >= good_len)
                              | ((appt0_l > 1) & (appt0_l + apcur >= aplimit)))
        self.to_mark(big, wpos, POST_MATCH, appt0_l, appt0_d)

        # relaxation
        relax = proc & ~lone & ~big
        sid = st["sid"]
        myp = torch.where(self.cell("stamp", wpos) == sid,
                          self.cell("price", wpos), 0)
        nxt1 = wpos + 1
        cp1 = torch.where(self.cell("stamp", nxt1) == sid,
                          self.cell("price", nxt1), INF)
        lit_b = self.cell("data", wpos)
        litp = (st["pr_lit_tree"][lit_b.clamp(0, 255)]
                + st["pr_flag0"][nstate_p])
        win_l = relax & (litp + myp < cp1)
        for name, val in (("price", litp + myp), ("back", wpos),
                          ("ndist", z), ("stamp", sid)):
            self.cell_set(name, win_l, nxt1, val)
        # rep0len1 into the same cell, after the literal
        cp1b = torch.where(win_l, litp + myp, cp1)
        win_r = relax & r01 & (r01p + myp < cp1b)
        for name, val in (("price", r01p + myp), ("back", wpos),
                          ("ndist", one), ("stamp", sid)):
            self.cell_set(name, win_r, nxt1, val)
        # matches into cells apcur + L, L in [2, appt0_l]; a cell read
        # after the literal's and rep0len1's writes.  A target at or past
        # the last column is never written (module docstring).
        tgt = wpos[:, None] + ls
        inside = tgt < self.n - 1
        tgt = self.clip(tgt)
        curp = torch.where(new["stamp"].gather(1, tgt) == sid[:, None],
                           new["price"].gather(1, tgt), INF)
        newp = appt_p + myp[:, None]
        win_m = ((appt_d > 0) & (ls <= appt0_l[:, None]) & relax[:, None]
                 & inside & (newp < curp))
        rows, cells = win_m.nonzero(as_tuple=True)
        tcol = tgt[rows, cells]
        new["price"][rows, tcol] = newp[rows, cells]
        new["back"][rows, tcol] = wpos[rows]
        new["ndist"][rows, tcol] = appt_d[rows, cells]
        new["stamp"][rows, tcol] = sid[rows]

        apend = torch.where(relax & (appt0_l > 1),
                            torch.maximum(apend, apcur + appt0_l + 1), apend)
        self.upd("apend", relax, apend)
        self.upd("wpos", relax, wpos + 1)
        self.upd("armed", proc, 0)

    # ----------------------------------------------------------- AP_MARK
    def mark(self, c):
        st = self.st
        wk = st["walk"]
        at_s0 = c & (wk <= st["s0"])
        bk = self.cell("back", wk)
        self.cell_set("nxt", c & ~at_s0, bk, wk)
        self.upd("walk", c & ~at_s0, bk)
        self.upd("walk", at_s0, st["s0"])
        self.upd("fsm", at_s0, AP_WALK)

    # ----------------------------------------------------------- AP_WALK
    def walk(self, c):
        st, new = self.st, self.new
        wk = st["walk"]
        at_end = c & (wk >= st["end"])
        emitting = c & ~at_end
        nx = self.cell("nxt", wk)
        self.emit(emitting, nx - wk, self.cell("ndist", nx), wk)
        self.upd("walk", emitting, nx)

        # the end node: its state and queue, the post action, then the
        # next stretch (or the next block when this one is consumed)
        end, post = st["end"], st["post"]
        self.upd("mstate", at_end, self.cell("nstate", end))
        new["reps"] = torch.where(at_end[:, None], self.nrep_at(end),
                                  new["reps"])
        p_lit = at_end & (post == POST_LIT)
        one, z = torch.ones_like(wk), torch.zeros_like(wk)
        self.emit(p_lit, one, z, end)
        p_mat = at_end & (post == POST_MATCH)
        self.emit(p_mat, st["post_len"], st["post_dist"], end)
        adv = torch.where(p_lit, 1, torch.where(p_mat, st["post_len"], 0))
        self.upd("blk_i", at_end, st["blk_i"] + (end - st["s0"]) + adv)
        self.upd("wpos", at_end, end + adv)
        boundary = at_end & (new["blk_i"] >= st["blk_len"])
        self.upd("fsm", at_end & ~boundary, AP_FIND)
        self.upd("fsm", boundary, AP_BLOCK)
        self.upd("armed", at_end, 0)
        self.stretch_reset(at_end & ~boundary, new["wpos"], new["mstate"],
                           new["reps"])


def ap_parse_step(st, good_len):
    """One lockstep step of every live stream (ap_parse_step)."""
    s = _Step(st, int(good_len))
    active = st["done"] == 0
    fsm = st["fsm"]
    for state, phase in ((AP_BLOCK, s.block), (AP_FIND, s.find),
                         (AP_MARK, s.mark), (AP_WALK, s.walk)):
        c = active & (fsm == state)
        if bool(c.any()):
            phase(c)
    return s.new


def run_ap_parse(st, good_len, max_steps):
    """Step until every stream is done or max_steps; returns (state,
    steps taken)."""
    steps = 0
    while steps < max_steps and not bool((st["done"] == 1).all()):
        st = ap_parse_step(st, good_len)
        steps += 1
    return st, steps


def max_steps_for(n):
    """csc_tpu's step budget of a group of width n (pipeline.py:412): FIND
    visits each position a small number of times, MARK and WALK one step a
    token."""
    return 16 * n + 4096


def tape_of(st):
    """K4's outputs from a state: (tape [B, T, 2] int32, tok_cnt, done,
    err [B] int32); err is ERR_OVERFLOW when the tape filled, else
    ERR_STEPS when the stream is not done."""
    tape, cnt, done, err = parse_scan.tape_of(st)
    err = torch.where(err == ERR_OVERFLOW, err,
                      torch.where(done == 0, ERR_STEPS, 0)).to(torch.int32)
    return tape, cnt, done, err


def found(before, after):
    """[B] int32: 1 where the step from state `before` to `after` finished
    a FIND position whose lanes ran (read its candidate rows): it relaxed
    (wpos moved on) or ended the stretch on a literal or a match, not at
    the cap."""
    ended = (after["fsm"] == AP_MARK) & (after["post"] != POST_NONE)
    return ((before["fsm"] == AP_FIND) & (before["done"] == 0)
            & ((after["wpos"] != before["wpos"]) | ended)).to(torch.int32)


# no autograd state a step: the lockstep loop runs about a fifth faster
@torch.inference_mode()
def parse_ap_plain(data, candp, run_ends, run_skip, sizes, dict_sizes,
                   prices, good_len, max_tokens, max_steps=None):
    """K4's function, as lockstep torch ops on data's device: (tape,
    tok_cnt, done, err, finds [B] int32, the FIND positions at which the
    lanes ran)."""
    st = make_ap_state(data, candp, run_ends, run_skip, sizes, dict_sizes,
                       prices, max_tokens)
    if max_steps is None:
        max_steps = max_steps_for(data.shape[1])
    finds = torch.zeros(data.shape[0], dtype=torch.int32,
                        device=data.device)
    steps = 0
    while steps < max_steps and not bool((st["done"] == 1).all()):
        before = st
        st = ap_parse_step(st, int(good_len))
        finds += found(before, st)
        steps += 1
    return tape_of(st) + (finds,)
