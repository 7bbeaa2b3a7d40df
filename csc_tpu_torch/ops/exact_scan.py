"""Plain PyTorch version of the K5 exact m1/m2 parse: B streams parsed in
lockstep with live hash tables, one micro-op a stream a step.

A torch port of csc_tpu/ops/encode_scan.py (`make_encode_state`,
`encode_parse_step`, `_mask_lookahead`, `_best_candidate`, `_emit_token`,
`_scatter_rowvals`, `run_parse`), field for field and step for step: the
exact emulation of csc_mf.cpp's HT2 / HT3 / HT6 finders (candidate gates,
MTF row updates, the stride-4 insertion skip) and csc_lz.cpp's lazy parser
(compress_normal, csc_lz.cpp:156-199) for lz_mode 1 and 2.  A stream walks
E_BLOCK (8 KB sub-blocks and runs, K_SENT_A, K_END) -> E_PREP (hashes of
the probe position, masked at the sub-block end) -> E_PROBE (the four
reps, HT2, HT3 and the HT6 row, one a step; the finish step inserts the
position) with E_EXT (4 bytes of match extension a step) -> E_DECIDE
(FindMatch's pick, SecondMatchBetter, the lazy second probe at wpos + 1)
-> E_INS (SlidePos, one insertion a step, four positions a step while
128 remain).

The port's own part takes every run golden's encoder codes (csc_tpu
hands a stream with a DT_BAD / DT_ENTROPY / DT_DLT run to golden): the
input is the analyzer's block table (encode_host.plan_stream(...,
exact=True)) and the parse merges the blocks into runs itself, as
CSCEncoder::Compress does (golden/encoder.py:75-123), because one thing
decides a run's extent that only the live tables know: IsDuplicateBlock
(golden/lz.py:77-82, mf.py:483-519), which re-types a BAD / ENTROPY /
DLT block DT_NORMAL when one of its positions matches 19 bytes or more
at the HT6 row head.  Golden tests each block while the run before it is
not yet coded, so every block of a run, and the first block after it,
is probed against the tables as they stand at the run's start.  So at a
run's start (the stream's start, or the run-end step after K_SENT_A)
the blocks are walked: a block's type is its analyzer type (a DT_SKIP
block takes the previous block's final type), and a no-LZ type costs
one E_DUP step, the probe; the run ends before the first block of
another final type or of another raw chunk.  A no-LZ run's sub-blocks
take one E_SPARSE step each: SlidePosFast (golden's encode_normal(...,
5), mf.py:198-231), the HT6 row shifted at the 1/16 of the positions
whose HASH2 is a multiple of 16, no token, no table else.  A stream of
LZ runs alone never reaches E_DUP or E_SPARSE, so its steps are csc_tpu's.

A stream longer than its dictionary meets golden's ring window (LZ.
encode_normal, golden/lz.py:28, 51-75): the window is a ring of wnd =
the dictionary's bytes, so a byte's ring position is its offset mod wnd.
The stream stays linear here; what follows the ring is (`ring`, set when
a stream of the batch is longer than its dictionary, so that the others
run csc_tpu's ops): a sub-block also ends at the ring's end, so after
the first wrap a run's pieces are cut there and then every 8 KB from
ring position 0; the bytes past a sub-block's end are the previous
lap's (offset p - wnd; zeros in the first lap and in the 8 bytes of
padding past the ring's end), in the hashes (`_hashes`) and in the
duplicate probe's window; a source may not cross the ring's end (each
finder's climit = min(limit, wnd - cmp_pos), mf.py:256-257, 284-285,
308-309, 418-419, 513-514), which in linear terms limits a candidate
whose source lies in the previous lap (distance past the ring position
r) to distance - r bytes, and HT2's strict `wpos > dist` (mf.py:284)
refuses distance == r.  Every source is within the last vld_rge <
wnd bytes, so it is read where it lies in the stream.

The state holds the JAX state's fields (`state_from_numpy` /
`state_to_numpy` carry it across; csc_tpu's `run_ends` is the block
table's ends, every run one NORMAL block: `lz_blocks`), every register
in int64; the hash tables, the candidate slots, the tape and the block
types are updated in place.  The port's own registers (`_OWN`): `steps`,
each stream's count of the steps in which it was active, which K5 counts
too, and the walk's `tb` (the next block), `run_type` (-1 before the
run's first block), `next_ft` (the final type of block tb when the walk
that ended the last run made it, else -1) and `prev_ft`; with the block
table `blocks` and the output `btypes` (each block's final type) they
are left out of the comparison with csc_tpu's state, as is `wnd`, the
window's size (the dictionary; vld_rge + 8196 in csc_tpu's state).

`exact_plain` runs it under a step budget and returns what the kernel
(csrc/encode_k5.cuh) returns: K2's two-word tape (kind | wire_len << 3,
dist_code), tok_cnt, done, err, steps and the block types.
"""
import numpy as np
import torch

from ..constants import (MF_DIST_BOUND, K_LIT, K_MATCH, K_REP, K_REP0L1,
                         K_END, K_SENT_A, HT2_SIZE, HT3_SIZE, NCAND, E_DONE,
                         E_BLOCK, E_PREP, E_PROBE, E_EXT, E_DECIDE, E_INS,
                         PH_REP0, PH_HT2, PH_HT3, PH_HT6, PH_DONE, MASK32,
                         DT_NORMAL, DT_NO_LZ)
from . import parse_ap_scan
from .encode_host import BLK_TYPE, BLK_SKIP, BLK_CHUNK
from .parse_pre import _H6_MUL_HI, _H6_MUL_LO, _low_bytes_mask, _mul32, \
    words4
from .parse_scan import second_better

_BOUND = list(MF_DIST_BOUND) + [0x7FFFFFFF]
_REGS = ["size", "vld_rge", "pos", "wpos", "run_idx", "run_end", "fsm",
         "blk_off", "blk_len", "blk_i", "phase", "ht6_k", "minlen", "cnt",
         "dist", "h2", "h3", "h6", "ext_dist", "ext_len", "ext_climit",
         "probe_limit", "have_u1", "u1_len", "u1_dist", "probe2",
         "ins_base", "ins_i", "ins_len", "ins_limit", "lasth6", "tok_cnt",
         "done"]
_TABLES = ["reps", "ht2", "ht3", "ht6", "cand_len", "cand_dist"]
_TAPE = ["tok_kind", "tok_a", "tok_b", "tok_c"]
_OWN = ["steps", "tb", "run_type", "next_ft", "prev_ft", "wnd"]
SUB_BLOCK = 8 * 1024
# the port's own micro-ops (csc_tpu's exact parse takes LZ runs only)
E_DUP = 7          # IsDuplicateBlock of one block
E_SPARSE = 8       # SlidePosFast over one sub-block of a no-LZ run
DUP_LEN = 19       # a probe hits at a match longer than 18 bytes
MAX_BUDGET = 2 ** 62 - 1   # K5 counts its steps in int64
STEPS_MAX = 2 ** 31 - 1    # and reports them in int32, saturated


def check_inputs(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                 good_len):
    """Raise on inputs K5 and this version do not take."""
    b = data.shape[0] if data.dim() == 2 else -1
    want = (("data", data, torch.uint8, 2),
            ("blocks", blocks, torch.int32, 3),
            ("sizes", sizes, torch.int32, 1),
            ("dict_sizes", dict_sizes, torch.int32, 1))
    for name, t, dt, nd in want:
        if t.dtype != dt or t.dim() != nd or t.shape[0] != b:
            raise ValueError(f"{name}: want {nd}-d {dt} with {b} rows, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != data.device:
            raise ValueError(f"{name} on {t.device}, data on {data.device}")
    if blocks.shape[1] < 1 or blocks.shape[2] != 2:
        raise ValueError(f"blocks must be [B, NB >= 1, 2], got "
                         f"{tuple(blocks.shape)}")
    if not 1 <= hash_width <= 8 or not 1 <= hash_bits <= 24:
        raise ValueError(f"hash_width must be in [1, 8] and hash_bits in "
                         f"[1, 24], got {hash_width}, {hash_bits}")
    if good_len < 2:
        raise ValueError(f"good_len must be >= 2, got {good_len}")


def table_sizes(hash_bits, hash_width):
    """Entries of the three per-stream hash tables (ht2, ht3, ht6)."""
    return HT2_SIZE, HT3_SIZE, hash_width << hash_bits


def lz_blocks(run_ends):
    """The block table [B, R, 2] of LZ runs [B, R] (cumulative ends,
    every run an LZ run): one DT_NORMAL block a run, each at a chunk start
    so that none merge; K5 then parses them as csc_tpu's encode_scan
    parses run_ends."""
    blocks = torch.zeros(run_ends.shape + (2,), dtype=torch.int32,
                         device=run_ends.device)
    blocks[..., 0] = run_ends
    blocks[..., 1] = DT_NORMAL | BLK_CHUNK
    return blocks


def _words2(data):
    d = torch.nn.functional.pad(data.long(), (0, 8))
    n = data.shape[1]
    return d[:, :n] | (d[:, 1:n + 1] << 8)


def make_exact_state(data, blocks, sizes, dict_sizes, hash_bits,
                     hash_width, good_len, lazy, max_tokens):
    """Initial state on data's device (make_encode_state's fields, the
    first run walked) and its cfg."""
    check_inputs(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                 good_len)
    b, dev = data.shape[0], data.device
    z = torch.zeros(b, dtype=torch.int64, device=dev)
    st = {name: z.clone() for name in _REGS + _OWN}
    st["size"] = sizes.long()
    st["vld_rge"] = dict_sizes.long() - 8 * 1024 - 4
    st["pos"] = st["vld_rge"].clone()
    st["fsm"] += E_BLOCK
    st["run_type"] -= 1
    st["next_ft"] -= 1
    st["prev_ft"] += DT_NORMAL
    st["wnd"] = dict_sizes.long()
    st["ring"] = bool((st["size"] > st["wnd"]).any())
    st["data"] = data
    st["in4"] = words4(data)
    st["in2"] = _words2(data)
    st["blocks"] = blocks
    st["btypes"] = torch.zeros(blocks.shape[:2], dtype=torch.int64,
                               device=dev)
    st["reps"] = dict_sizes.long()[:, None].repeat(1, 4)
    for name, size in zip(("ht2", "ht3", "ht6"),
                          table_sizes(hash_bits, hash_width)):
        st[name] = torch.zeros((b, size), dtype=torch.int64, device=dev)
    for name in ("cand_len", "cand_dist"):
        st[name] = torch.zeros((b, NCAND), dtype=torch.int64, device=dev)
    for name in _TAPE:
        st[name] = torch.zeros((b, max_tokens), dtype=torch.int64,
                               device=dev)
    cfg = dict(hash_bits=int(hash_bits), hash_width=int(hash_width),
               good_len=int(good_len), lazy=1 if lazy else 0)
    # the first run's walk: golden probes the stream's first blocks against
    # empty tables, but K5 spends E_DUP steps on them all the same
    s = _Step(st, cfg)
    s.walk(st["done"] == 0)
    return s.new, cfg


def state_from_numpy(st, device):
    """encode_scan's state (numpy or jax arrays), or state_to_numpy(...,
    own=True)'s, -> this module's state on `device`.  A state of
    encode_scan's has no block table: every run is one DT_NORMAL block
    (`lz_blocks`), the walk has taken runs 0 .. run_idx and `steps` is
    0."""
    dev = torch.device(device)

    def t(name, dtype=torch.int64):
        return torch.as_tensor(np.array(st[name]), device=dev).to(dtype)
    out = {name: t(name) for name in _REGS + _TABLES + _TAPE
           + ["in4", "in2"]}
    out["data"] = t("data", torch.uint8)
    if "blocks" in st:
        out["blocks"] = t("blocks", torch.int32)
        for name in _OWN + ["btypes"]:
            out[name] = t(name)
        out["ring"] = bool((out["size"] > out["wnd"]).any())
        return out
    out["wnd"] = out["vld_rge"] + 8 * 1024 + 4
    out["ring"] = bool((out["size"] > out["wnd"]).any())
    out["blocks"] = lz_blocks(t("run_ends", torch.int32))
    out["steps"] = torch.zeros_like(out["done"])
    out["tb"] = out["run_idx"] + 1
    out["run_type"] = torch.full_like(out["done"], DT_NORMAL)
    out["next_ft"] = torch.full_like(out["done"], -1)
    out["prev_ft"] = out["run_type"].clone()
    nb = out["blocks"].shape[1]
    out["btypes"] = torch.where(
        torch.arange(nb, device=dev)[None, :] < out["tb"][:, None],
        DT_NORMAL, 0)
    return out


def state_to_numpy(st, own=False):
    """This module's state -> encode_scan's field names and dtypes
    (`run_ends` the block ends); own=True adds the port's own registers,
    the block table and the block types."""
    out = {"run_ends": st["blocks"][..., 0].cpu().numpy().copy()}
    for name in _REGS + _TABLES + _TAPE + (_OWN + ["btypes"] if own
                                           else []):
        v = st[name].cpu().numpy()
        if v.dtype == np.int64 and v.size and (
                v.min() < -2 ** 31 or v.max() >= 2 ** 31):
            raise OverflowError(f"{name} leaves int32's range")
        out[name] = v.astype(np.int32)
    out["data"] = st["data"].cpu().numpy().copy()
    if own:
        out["blocks"] = st["blocks"].cpu().numpy().copy()
    for name in ("in4", "in2"):
        out[name] = st[name].cpu().numpy().astype(np.uint32)
    return out


def _gather(tbl, idx):
    """tbl[b, idx[b]] (or tbl[b, idx[b, k]] for a 2-d idx), the index
    clipped into the row (csc_tpu's gathers either clip or, where they
    read past the row, are masked after)."""
    idx = idx.clamp(0, tbl.shape[1] - 1)
    if idx.dim() == 2:
        return tbl.gather(1, idx).long()
    return tbl.gather(1, idx[:, None])[:, 0].long()


def _put(tbl, pos, mask, val):
    """tbl[b, pos[b]] = val[b] where mask, in place (`_scatter1`)."""
    pos = pos[:, None]
    cur = tbl.gather(1, pos)[:, 0]
    tbl.scatter_(1, pos, torch.where(mask, val, cur)[:, None])


def _hashes(in2, in4, p, rem, hash_bits, lap=None):
    """h2, h3, h6 of position p ([B] or [B, K]), the bytes at and after
    the sub-block end (rem bytes ahead) read as zeros (`_mask_lookahead`:
    the reference's window holds only the sub-blocks copied so far,
    csc_lz.cpp:63-67).  With the ring (lap = (wnd, the ring's end rem_r
    bytes ahead, a later lap) as `_Step.lap` gives them), the bytes from the
    sub-block's end to the ring's end are the previous lap's, at p -
    wnd, in a later lap."""
    v2 = _gather(in2, p) & _low_bytes_mask(rem, 2)
    v4 = _gather(in4, p) & _low_bytes_mask(rem, 4)
    v2b = _gather(in2, p + 4) & _low_bytes_mask(rem - 4, 2)
    if lap is not None and bool(((rem < 6) & lap[2]).any()):
        wnd, rem_r, later = lap
        q = p - wnd

        def ghost(tbl, at, lo, hi, k):
            m = _low_bytes_mask(hi, k) & ~_low_bytes_mask(lo, k)
            return torch.where(later, _gather(tbl, at) & m, 0)
        v2 = v2 | ghost(in2, q, rem, rem_r, 2)
        v4 = v4 | ghost(in4, q, rem, rem_r, 4)
        v2b = v2b | ghost(in2, q + 4, rem - 4, rem_r - 4, 2)
    h2 = (v2 * 65521) & 0x3FFF
    b0 = v2 & 0xFF
    b1 = (v2 >> 8) & 0xFF
    b2 = (v4 >> 16) & 0xFF
    h3 = ((b0 << 8) ^ (b1 << 5) ^ b2) & 0xFFFF
    h6 = _mul32(v4 ^ (v2b << 13), _H6_MUL_HI, _H6_MUL_LO) >> (32 - hash_bits)
    return h2, h3, h6


def _eq_bytes(x):
    return torch.where(
        x == 0, 4, torch.where(
            (x & 0xFF) != 0, 0, torch.where(
                (x & 0xFFFF) != 0, 1, torch.where(
                    (x & 0xFFFFFF) != 0, 2, 3))))


class _Step:
    """One lockstep step: `st` the state before it, `new` the state after
    (registers replaced, tables written in place); each phase reads its
    streams' registers from `st`."""

    def __init__(self, st, cfg):
        self.st, self.cfg = st, cfg
        self.new = dict(st)

    def upd(self, name, cond, val):
        self.new[name] = torch.where(cond, val, self.new[name])

    def lap(self, p):
        """`_hashes`' lap of positions p ([B] or [B, K]) in the current
        sub-block: (wnd, the bytes from p to the ring's end, whether the
        ring is past its first lap), shaped as p; None without the
        ring."""
        st = self.st
        if not st["ring"]:
            return None
        wnd, off = st["wnd"], st["blk_off"]
        start = off - off % wnd
        if p.dim() == 2:
            wnd, start = wnd[:, None], start[:, None]
        return wnd, start + wnd - p, start > 0

    def block(self, c):
        st, upd = self.st, self.upd
        tape_w = st["tok_kind"].shape[1]
        tok = st["tok_cnt"]
        # the run-end and stream-end markers land only inside the tape
        # (encode_scan.py:208, 223); emitted tokens clip (:569)
        tok_ok = tok < tape_w
        tpos = tok.clamp(0, tape_w - 1)
        need_new = c & (st["blk_i"] >= st["blk_len"])
        nboff = st["blk_off"] + st["blk_len"]
        run_done = need_new & (nboff >= st["run_end"]) & (st["blk_len"] > 0)
        _put(st["tok_kind"], tpos, run_done & tok_ok,
             torch.full_like(tok, K_SENT_A))
        upd("tok_cnt", run_done, tok + 1)
        upd("run_idx", run_done, st["run_idx"] + 1)
        upd("blk_off", run_done, nboff)
        upd("blk_len", run_done, 0)
        upd("blk_i", run_done, 0)
        upd("have_u1", run_done, 0)
        upd("run_type", run_done, -1)

        fresh = need_new & ~run_done
        stream_end = fresh & (nboff >= st["size"])
        _put(st["tok_kind"], tpos, stream_end & tok_ok,
             torch.full_like(tok, K_END))
        upd("tok_cnt", stream_end, tok + 1)
        upd("done", stream_end, 1)
        upd("fsm", stream_end, E_DONE)
        start_blk = fresh & ~stream_end
        upd("blk_off", start_blk, nboff)
        blen = torch.clamp(st["run_end"] - nboff, max=SUB_BLOCK)
        if st["ring"]:
            # a piece also ends at the ring's end (golden/lz.py:63)
            blen = torch.minimum(blen, st["wnd"] - nboff % st["wnd"])
        upd("blk_len", start_blk, blen)
        upd("blk_i", start_blk, 0)
        upd("have_u1", start_blk, 0)
        # a sub-block of a no-LZ run: SlidePosFast
        sparse = start_blk & (st["run_type"] >= DT_NO_LZ)
        upd("fsm", sparse, E_SPARSE)
        go = ((c & ~need_new) | start_blk) & ~sparse
        # a pending first pick (have_u1) skips the find
        upd("fsm", go & (st["have_u1"] == 1), E_DECIDE)
        upd("fsm", go & (st["have_u1"] == 0), E_PREP)
        upd("probe2", go & (st["have_u1"] == 0), 0)
        # the next run's walk, against the tables as the run left them
        self.walk(run_done)

    def walk(self, m, hit=None):
        """The walk at a run's start for the streams m, on the new state:
        blocks tb, tb + 1, ... are typed and merged into the run until one
        of another final type (its type kept in next_ft for the next run),
        another raw chunk or the stream's end ends it; run_end is set, fsm
        E_BLOCK.  A block whose type is no-LZ needs the probe: the walk
        stops there with fsm E_DUP, and the E_DUP step hands the probe's
        result in `hit` ([B] bool) to go on."""
        new, upd = self.new, self.upd
        blocks = new["blocks"]
        nb = blocks.shape[1]
        ends = blocks[..., 0].long()
        info = blocks[..., 1].long()
        m = m.clone()
        while bool(m.any()):
            j = new["tb"]
            jc = j.clamp(max=nb - 1)
            end_prev = _gather(ends, j - 1)
            start = torch.where(j == 0, 0, end_prev)
            more = (j < nb) & (start < new["size"])
            inf = _gather(info, jc)
            cs = (j == 0) | ((inf & BLK_CHUNK) != 0)
            taken = new["run_type"] >= 0
            # the stream's end (run_end as csc_tpu's clipped gather leaves
            # it past the last run) or the chunk's
            fin = m & ~more
            upd("run_end", fin, torch.where(taken, end_prev,
                                            _gather(ends, jc)))
            fin_cs = m & more & taken & cs
            upd("run_end", fin_cs, end_prev)
            go = m & more & ~(taken & cs)
            known = go & (new["next_ft"] >= 0)
            pre = inf & BLK_TYPE
            follow = ((inf & BLK_SKIP) != 0) & (cs | (new["prev_ft"]
                                                      == DT_NORMAL))
            pre = torch.where(follow, DT_NORMAL, pre)
            need = go & ~known & (pre >= DT_NO_LZ)
            if hit is not None:
                # the streams of the E_DUP step, at the block they probed
                pre = torch.where(need & hit, DT_NORMAL, pre)
                need = torch.zeros_like(need)
                hit = None
            upd("fsm", need, E_DUP)
            det = go & ~need
            f = torch.where(known, new["next_ft"], pre)
            _put(new["btypes"], jc, det, f)
            upd("prev_ft", det, f)
            upd("next_ft", known, -1)
            first = det & ~taken
            upd("run_type", first, f)
            differ = det & taken & (f != new["run_type"])
            upd("next_ft", differ, f)
            upd("run_end", differ, end_prev)
            upd("tb", det & ~differ, j + 1)
            ended = fin | fin_cs | differ
            upd("fsm", ended, E_BLOCK)
            m = m & ~(ended | need)

    def dup(self, c):
        """E_DUP: IsDuplicateBlock (golden/lz.py:77-82, TestFind mf.py:
        483-519) of block tb against the tables as they stand, then the
        walk goes on.  Each position i of the block whose HASH2 is a
        multiple of 16 takes the head of its HT6 row (slot 0, read min(w,
        8) times in golden, all alike): a distance below vld_rge and the
        window's bytes there (from wpos on, the previous lap's, zeros in
        the first: the run in front is not coded yet) equal to the
        block's for 19 bytes or more, within the block and before the
        ring's end, make the block a duplicate.  A hit needs 19 bytes
        before the block's end, so only positions whose hashed bytes lie
        inside the block count (golden hashes bytes past it for the
        others, to no effect); the block's bytes are its raw bytes (a
        no-LZ block's LZ input)."""
        st = self.st
        w, bits = self.cfg["hash_width"], self.cfg["hash_bits"]
        blocks, data = st["blocks"], st["data"]
        nb, n = blocks.shape[1], data.shape[1]
        j = st["tb"].clamp(0, nb - 1)
        ends = blocks[..., 0].long()
        s0 = torch.where(st["tb"] == 0, 0, _gather(ends, j - 1))[:, None]
        blen = _gather(ends, j)[:, None] - s0
        i = torch.arange(SUB_BLOCK, device=data.device)[None, :]
        b = [_gather(data, s0 + i + k) for k in range(6)]
        h2 = ((b[0] | (b[1] << 8)) * 65521) & 0x3FFF
        v4 = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        h6 = _mul32(v4 ^ ((b[4] | (b[5] << 8)) << 13), _H6_MUL_HI,
                    _H6_MUL_LO) >> (32 - bits)
        wpos, pos = st["wpos"][:, None], st["pos"][:, None]
        dist = (pos - _gather(st["ht6"], h6 * w)) & MASK32
        ok = (c[:, None] & (h2 % 16 == 0) & (i + DUP_LEN <= blen)
              & (dist < (st["vld_rge"][:, None] & MASK32)))
        cmp = wpos - dist
        if st["ring"]:
            # ring coordinates: a source in the previous lap (dist past
            # the ring position r) ends at the ring's end, dist - r bytes
            # on; one in this lap may run on into the previous lap's
            # bytes up to the ring's end, wnd - (r - dist) bytes on
            wnd = st["wnd"][:, None]
            r = wpos % wnd
            ok = ok & (torch.where(dist > r, dist - r, wnd - r + dist)
                       >= DUP_LEN)
            later = wpos >= wnd
        else:
            ok = ok & (dist <= wpos)
        for k in range(DUP_LEN):
            at = cmp + k
            past = (torch.where(later, _gather(data, at - wnd), 0)
                    if st["ring"] else 0)
            win = torch.where(at < wpos, _gather(data, at), past)
            ok = ok & (_gather(data, s0 + i + k) == win)
        self.walk(c, ok.any(dim=1))

    def sparse(self, c):
        """E_SPARSE: SlidePosFast (golden/mf.py:198-231) over the sub-block
        [blk_off, blk_off + blk_len) of a no-LZ run: at each position
        whose HASH2 (the window past the sub-block read as zeros) is a
        multiple of 16 the HT6 row shifts down and takes the position's
        pos; no other table, no token (golden's encode_normal(..., 5))."""
        st, upd = self.st, self.upd
        w = self.cfg["hash_width"]
        i = torch.arange(SUB_BLOCK, device=c.device)[None, :]
        p = st["blk_off"][:, None] + i
        end = (st["blk_off"] + st["blk_len"])[:, None]
        h2, _, h6 = _hashes(st["in2"], st["in4"], p, end - p,
                            self.cfg["hash_bits"], self.lap(p))
        ins = c[:, None] & (i < st["blk_len"][:, None]) & (h2 % 16 == 0)
        ht6 = st["ht6"]
        flat = ht6.view(-1)
        row0 = torch.arange(ht6.shape[0], device=c.device)[:, None] \
            * ht6.shape[1]
        # the insertions in order, grouped by row: the last w of a row
        # become its slots 0 .. w - 1 (newest first), its old entries
        # shift down by the row's count
        keys = (row0 + h6 * w)[ins]
        vals = (st["pos"][:, None] + i)[ins]
        keys, order = torch.sort(keys, stable=True)
        vals = vals[order]
        rows, counts = torch.unique_consecutive(keys, return_counts=True)
        group = torch.repeat_interleave(
            torch.arange(len(rows), device=c.device), counts)
        last = (torch.cumsum(counts, 0) - 1)[group]
        rank = last - torch.arange(len(keys), device=c.device)
        col = torch.arange(w, device=c.device)[None, :]
        old = flat[rows[:, None] + col]
        keep = col + counts[:, None] < w
        flat[(rows[:, None] + col + counts[:, None])[keep]] = old[keep]
        top = rank < w
        flat[keys[top] + rank[top]] = vals[top]
        upd("pos", c, st["pos"] + st["blk_len"])
        upd("wpos", c, st["wpos"] + st["blk_len"])
        upd("blk_i", c, st["blk_len"])
        upd("fsm", c, E_BLOCK)

    def prep(self, c):
        st, upd = self.st, self.upd
        ppos = st["wpos"] + st["probe2"]
        h2, h3, h6 = _hashes(st["in2"], st["in4"], ppos,
                             st["blk_off"] + st["blk_len"] - ppos,
                             self.cfg["hash_bits"], self.lap(ppos))
        upd("h2", c, h2)
        upd("h3", c, h3)
        upd("h6", c, h6)
        upd("minlen", c, 1)
        upd("cnt", c, 0)
        upd("dist", c, 0)
        upd("probe_limit", c, st["blk_len"] - st["blk_i"] - st["probe2"])
        upd("phase", c, PH_REP0)
        upd("ht6_k", c, 0)
        upd("fsm", c, E_PROBE)

    def probe(self, c):
        st, upd = self.st, self.upd
        w = self.cfg["hash_width"]
        ph = st["phase"]
        pos = st["pos"]
        ppos = st["wpos"] + st["probe2"]
        dist_u = st["dist"] & MASK32       # -1: every later gate fails
        ht6base = st["h6"] * w
        is_rep = c & (ph <= 3)
        is_ht2 = c & (ph == PH_HT2)
        is_ht3 = c & (ph == PH_HT3)
        is_ht6 = c & (ph == PH_HT6)
        fin = c & (ph == PH_DONE)
        probing = is_rep | is_ht2 | is_ht3 | is_ht6
        if bool(probing.any()):
            cand = torch.where(
                ph <= 3, _gather(st["reps"], ph.clamp(0, 3)), torch.where(
                    ph == PH_HT2, pos - _gather(st["ht2"], st["h2"]),
                    torch.where(
                        ph == PH_HT3, pos - _gather(st["ht3"], st["h3"]),
                        torch.where(ph == PH_HT6, pos - _gather(
                            st["ht6"], ht6base + st["ht6_k"].clamp(0, w - 1)),
                            0))))
            cand_u = cand & MASK32
            # distance gates (csc_mf.cpp:303,334,456), unsigned
            gate_ok = torch.where(ph <= 3, True, cand_u > dist_u)
            vld_ok = cand_u < (st["vld_rge"] & MASK32)
            # an HT probe takes the candidate's distance once gated in,
            # valid or not (csc_mf.cpp:304,335,457)
            upd("dist", (is_ht2 | is_ht3 | is_ht6) & gate_ok, cand)
            # HT2 wraparound quirk (csc_mf.cpp:306): distance == position
            if st["ring"]:
                # in ring coordinates (r the ring position), a source in
                # the previous lap ends at the ring's end
                wnd = st["wnd"]
                r = ppos - (st["blk_off"] - st["blk_off"] % wnd)
                wrap = (cand > r) | (is_ht2 & (cand == r))
                climit = torch.where(wrap, torch.minimum(
                    st["probe_limit"], cand - r), st["probe_limit"])
            else:
                climit = torch.where(is_ht2 & (cand == ppos), 0,
                                     st["probe_limit"])
            ml = st["minlen"]
            pb = _gather(st["data"], ppos + ml)
            cb = _gather(st["data"], ppos - cand + ml)
            pre_ok = (ml < climit) & (pb == cb)
            do_ext = gate_ok & vld_ok & pre_ok & probing
            upd("ext_dist", do_ext, cand)
            upd("ext_len", do_ext, 0)
            upd("ext_climit", do_ext, climit)
            upd("fsm", do_ext, E_EXT)
            skip = probing & ~do_ext
            nk = st["ht6_k"] + 1
            nph = torch.where(
                ph <= 3, ph + 1, torch.where(
                    ph == PH_HT2, PH_HT3, torch.where(
                        ph == PH_HT3, PH_HT6, torch.where(
                            nk < w, ph, PH_DONE))))
            upd("ht6_k", skip & is_ht6, nk)
            upd("phase", skip, nph)
        if bool(fin.any()):
            # find_match's tail (csc_mf.cpp:365,487-491): insert the
            # position into HT2 and HT3, MTF-shift it into its HT6 row
            _put(st["ht2"], st["h2"], fin, pos)
            _put(st["ht3"], st["h3"], fin, pos)
            row_idx = ht6base[:, None] + torch.arange(w, device=pos.device)
            row = st["ht6"].gather(1, row_idx)
            shifted = torch.cat([pos[:, None], row[:, :w - 1]], dim=1)
            st["ht6"].scatter_(1, row_idx,
                               torch.where(fin[:, None], shifted, row))
            upd("pos", fin, pos + 1)
            upd("fsm", fin, E_DECIDE)

    def ext(self, c):
        st, upd = self.st, self.upd
        w = self.cfg["hash_width"]
        in4 = st["in4"]
        ppos = st["wpos"] + st["probe2"]
        el = st["ext_len"]
        x = _gather(in4, ppos + el) ^ _gather(in4, ppos - st["ext_dist"]
                                              + el)
        eq = _eq_bytes(x)
        adv = torch.minimum(eq, st["ext_climit"] - el)
        nel = el + adv
        cont = c & (eq == 4) & (adv == 4) & (nel < st["ext_climit"])
        upd("ext_len", c, nel)
        done = c & ~cont
        ph = st["phase"]
        is_rep = ph <= 3
        cnt = st["cnt"]
        # rep0len1 (csc_mf.cpp:281-287)
        r01 = done & (ph == 0) & (nel > 0)
        tpos = cnt.clamp(0, NCAND - 1)
        one = torch.ones_like(cnt)
        _put(st["cand_len"], tpos, r01, one)
        _put(st["cand_dist"], tpos, r01, one)
        cnt = torch.where(r01 & (cnt + 2 < NCAND), cnt + 1, cnt)
        better = done & (nel > st["minlen"])
        bound = torch.as_tensor(_BOUND, device=nel.device)[nel.clamp(0, 7)]
        rec = better & (is_rep | (nel > 6) | (st["ext_dist"] < bound))
        upd("minlen", better, nel)
        tpos = cnt.clamp(0, NCAND - 1)
        _put(st["cand_len"], tpos, rec, nel)
        _put(st["cand_dist"], tpos, rec,
             torch.where(is_rep, ph + 1, st["ext_dist"] + 4))
        cnt = torch.where(rec & (cnt + 2 < NCAND), cnt + 1, cnt)
        upd("cnt", done, cnt)
        gl_exit = better & (nel >= self.cfg["good_len"])
        upd("dist", gl_exit, -1)
        nk = st["ht6_k"] + 1
        nph = torch.where(
            is_rep, ph + 1, torch.where(
                ph == PH_HT2, PH_HT3, torch.where(
                    ph == PH_HT3, PH_HT6, torch.where(nk < w, ph, PH_DONE))))
        upd("ht6_k", done & (ph == PH_HT6), nk)
        # good_len at a rep: on to HT2, whose gate the sentinel fails
        # (csc_mf.cpp:294-298)
        nph = torch.where(gl_exit & is_rep, PH_HT2, nph)
        upd("phase", done, nph)
        upd("fsm", done, E_PROBE)

    def decide(self, c):
        st, upd = self.st, self.upd
        wpos = st["wpos"]
        u_len, u_dist = best_candidate(st["cand_len"], st["cand_dist"],
                                       st["cnt"])
        probe2 = st["probe2"] == 1
        first = c & ~probe2
        held = st["have_u1"] == 1
        u1_len = torch.where(held, st["u1_len"], u_len)
        u1_dist = torch.where(held, st["u1_dist"], u_dist)
        take_now = first & ((u1_len == 1) | (self.cfg["lazy"] == 0)
                            | (u1_len >= self.cfg["good_len"]))
        go2 = first & ~take_now
        upd("u1_len", go2, u1_len)
        upd("u1_dist", go2, u1_dist)
        upd("probe2", go2, 1)
        upd("fsm", go2, E_PREP)

        second = c & probe2
        smb = second_better(st["u1_len"], st["u1_dist"], u_len, u_dist)
        lit = second & smb
        mt = second & ~smb
        # the token: u1 now, a literal, or u1 after the second probe
        em = take_now | lit | mt
        em_len = torch.where(take_now, u1_len,
                             torch.where(lit, 1, st["u1_len"]))
        em_dist = torch.where(take_now, u1_dist,
                              torch.where(lit, 0, st["u1_dist"]))
        self.emit(em, em_len, em_dist)
        # take_now slides from wpos; a match after the second probe from
        # wpos + 1 (that position is in the tables already)
        slide = take_now | mt
        upd("ins_base", slide, torch.where(mt, wpos + 1, wpos))
        upd("ins_i", slide, 1)
        upd("ins_len", slide, torch.where(mt, em_len - 1, em_len))
        upd("ins_limit", slide, st["blk_len"] - st["blk_i"]
            - torch.where(mt, 1, 0))
        upd("lasth6", slide, 0)
        upd("blk_i", em, st["blk_i"] + em_len)
        upd("wpos", em, wpos + em_len)
        upd("have_u1", slide, 0)
        upd("probe2", lit | mt, 0)
        upd("fsm", slide, E_INS)
        upd("u1_len", lit, u_len)
        upd("u1_dist", lit, u_dist)
        upd("have_u1", lit, 1)
        upd("fsm", lit, E_BLOCK)

    def emit(self, mask, u_len, u_dist):
        """`_emit_token`: one token (encode_nonlit coords, csc_lz.cpp:127-
        154) at the clipped tape position, and the rep queue update."""
        st, new = self.st, self.new
        wpos = st["wpos"]
        tape_w = st["tok_kind"].shape[1]
        tpos = st["tok_cnt"].clamp(0, tape_w - 1)
        is_lit = u_dist == 0
        is_r01 = (u_dist == 1) & (u_len == 1)
        is_rep = (u_dist <= 4) & ~is_lit & ~is_r01
        is_match = u_dist > 4
        kind = torch.where(is_lit, K_LIT, torch.where(
            is_r01, K_REP0L1, torch.where(is_rep, K_REP, K_MATCH)))
        a = torch.where(is_lit, _gather(st["data"], wpos), torch.where(
            is_r01, 0, torch.where(is_rep, u_dist - 1, u_dist - 5)))
        b = torch.where(is_rep | is_match, u_len - 2, 0)
        # SetLiteralCtx(last byte) after the token (csc_lz.cpp:172,192)
        last = _gather(st["data"], wpos + u_len - 1)
        for name, val in zip(_TAPE, (kind, a, b, last)):
            _put(st[name], tpos, mask, val)
        self.upd("tok_cnt", mask, st["tok_cnt"] + 1)
        reps = st["reps"]
        rd = reps.gather(1, (u_dist - 1).clamp(0, 3)[:, None])
        cols = torch.arange(4, device=reps.device)[None, :]
        rot = torch.where(cols <= (u_dist - 1)[:, None],
                          torch.cat([rd, reps[:, :3]], dim=1), reps)
        push = torch.cat([(u_dist - 4)[:, None], reps[:, :3]], dim=1)
        reps2 = torch.where((mask & is_rep)[:, None], rot, reps)
        new["reps"] = torch.where((mask & is_match)[:, None], push, reps2)

    def ins(self, c):
        st, upd = self.st, self.upd
        w = self.cfg["hash_width"]
        pos = st["pos"]
        done = c & (st["ins_i"] >= st["ins_len"])
        upd("fsm", done, E_BLOCK)
        ins = c & ~done
        if not bool(ins.any()):
            return
        ipos = st["ins_base"] + st["ins_i"]
        h2, h3, h6 = _hashes(st["in2"], st["in4"], ipos,
                             st["blk_off"] + st["blk_len"] - ipos,
                             self.cfg["hash_bits"], self.lap(ipos))
        _put(st["ht2"], h2, ins, pos)
        _put(st["ht3"], h3, ins, pos)
        # stride-4 fast path (csc_mf.cpp:145): no HT6 while i + 128 < len
        fast = ins & (st["ins_i"] + 128 < st["ins_len"])
        slow = ins & ~fast
        row_idx = (h6 * w)[:, None] + torch.arange(w, device=pos.device)
        row = st["ht6"].gather(1, row_idx)
        # the row shifts only for a hash other than the last one inserted
        shift = (slow & (h6 != st["lasth6"]))[:, None]
        row2 = torch.where(shift, torch.cat([row[:, :1], row[:, :w - 1]],
                                            dim=1), row)
        row2 = torch.where(slow[:, None], torch.cat([pos[:, None],
                                                     row2[:, 1:]], dim=1),
                           row2)
        st["ht6"].scatter_(1, row_idx, row2)
        upd("lasth6", slow, h6)
        step = torch.where(fast, 4, 1)
        upd("ins_i", ins, st["ins_i"] + step)
        upd("pos", ins, pos + step)


def best_candidate(cand_len, cand_dist, cnt):
    """FindMatch's pick (csc_mf.cpp:497-524) over the first cnt slots:
    the first, then each later one SecondMatchBetter prefers; (1, 0)
    (a literal) when there is none."""
    best_len = torch.ones_like(cnt)
    best_dist = torch.zeros_like(cnt)
    have = torch.zeros_like(cnt, dtype=torch.bool)
    for i in range(NCAND):
        valid = i < cnt
        l2, d2 = cand_len[:, i], cand_dist[:, i]
        take = valid & (~have | second_better(best_len, best_dist, l2, d2))
        best_len = torch.where(take, l2, best_len)
        best_dist = torch.where(take, d2, best_dist)
        have = have | valid
    return best_len, best_dist


def encode_parse_step(st, cfg):
    """One lockstep micro-op of every live stream."""
    s = _Step(st, cfg)
    active = st["done"] == 0
    fsm = st["fsm"]
    for state, phase in ((E_BLOCK, s.block), (E_PREP, s.prep),
                         (E_PROBE, s.probe), (E_EXT, s.ext),
                         (E_DECIDE, s.decide), (E_INS, s.ins),
                         (E_DUP, s.dup), (E_SPARSE, s.sparse)):
        c = active & (fsm == state)
        if bool(c.any()):
            phase(c)
    s.new["steps"] = st["steps"] + active.long()
    return s.new


def run_parse(st, cfg, max_steps):
    """Step until every stream is done or max_steps; returns (state,
    steps taken)."""
    steps = 0
    while steps < max_steps and not bool((st["done"] == 1).all()):
        st = encode_parse_step(st, cfg)
        steps += 1
    return st, steps


def max_steps_for(n):
    """csc_tpu's step budget of a group of width n (pipeline.py:439): 64 *
    n + 4096, past int32 from n = 32 MB on (K5 counts in int64)."""
    return min(64 * n + 4096, MAX_BUDGET)


def tape_of(st):
    """K5's outputs from a state: (tape [B, T, 2] int32, tok_cnt, done,
    err, steps [B] int32, btypes [B, NB] int32); err is ERR_OVERFLOW when
    the tape filled, else ERR_STEPS when the stream is not done; steps
    past int32's range read as its maximum; btypes holds each block's
    final type (0 for a block the parse did not reach)."""
    return parse_ap_scan.tape_of(st) + (
        st["steps"].clamp(max=STEPS_MAX).to(torch.int32),
        st["btypes"].to(torch.int32))


# no autograd state a step: the lockstep loop runs about a fifth faster
@torch.inference_mode()
def exact_plain(data, blocks, sizes, dict_sizes, hash_bits, hash_width,
                good_len, lazy, max_tokens, max_steps=None):
    """K5's function, as lockstep torch ops on data's device."""
    st, cfg = make_exact_state(data, blocks, sizes, dict_sizes,
                               hash_bits, hash_width, good_len, lazy,
                               max_tokens)
    if max_steps is None:
        max_steps = max_steps_for(data.shape[1])
    st, _ = run_parse(st, cfg, max_steps)
    return tape_of(st)

