"""Tape stitching on the device: K2's parse tape -> K3's phase-B tapes.

A torch port of csc_tpu/ops/stitch_dev.py (`stitch_device_tapes` with
fill_from_data, `_stitch_dev`, `plan_out_bound`).  Each run of a stream
becomes, with batched gathers:

  K_INT type [, K_INT size]             header (csc_encoder_main.cpp:128-145)
  parse-tape segment + K_SENT           LZ runs (csc_lz.cpp:97)
  | K_RAW byte pairs / K_ELIT literals  BAD / ENTROPY payloads read from
                                        the LZ input (csc_model.cpp:448-469)
  | K_DLIT / K_RLEN tokens              DT_DLT payloads (CompressRLE,
                                        csc_model.cpp:471-513)
  K_INT cont [, K_FLUSH]                tail
and K_END fills the rest.  K2 writes no literal or last-match bytes:
each LZ token's byte position is the run's LZ-input offset plus the
cumulative consumed length of the LZ tokens before it, and the bytes are
gathered from the data.  The RLE skeletons of DT_DLT runs are computed on
the host (encode_host.rle_tape) and ride an auxiliary tape packed one
int32 per token (kind << 30 | b << 8 | a).
"""
import numpy as np
import torch

from ..constants import (DT_ENGTXT, DT_NO_LZ, DT_BAD, DT_DLT, K_END,
                         K_SENT_A, K_LIT, K_MATCH, K_REP, K_REP0L1, K_INT,
                         K_SENT, K_FLUSH, K_RAW, K_ELIT, K_DLIT, K_RLEN)
from .encode_host import rle_tape


def plan_out_bound(run_tables, tl_in, dlt_toks=None):
    """Upper bound of the stitched tape length.  LZ segments are bounded
    by the parse tape length; headers, tails, sentinels and payload sizes
    are known from the run table.  dlt_toks: per-stream list of per-run
    aux token counts (0 for non-DLT runs), needed when a run is DT_DLT."""
    worst = 0
    for j, rt in enumerate(run_tables):
        extra = 1                      # K_END
        for k, (t, rlen, _decl, last, _pl) in enumerate(rt):
            extra += 1 + (1 if (t == DT_ENGTXT or t >= DT_NO_LZ) else 0)
            extra += 1 + (1 if last else 0)
            if t >= DT_DLT:
                extra += dlt_toks[j][k]
            elif t == DT_BAD:
                extra += (rlen + 1) // 2
            elif t >= DT_NO_LZ:
                extra += rlen
            else:
                extra += 1             # K_SENT
        worst = max(worst, tl_in + extra)
    return worst


def _run_arrays(run_tables, device):
    """Per-run tables [B, R] int64 and the packed DT_DLT aux tape."""
    b = len(run_tables)
    r = max(len(rt) for rt in run_tables)
    cols = {k: np.zeros((b, r), np.int64) for k in
            ("rtype", "rdecl", "rlen", "rlast", "rvalid", "loff", "astart",
             "aplen")}
    packs = [[] for _ in run_tables]
    dlt_toks = [[0] * len(rt) for rt in run_tables]
    for j, rt in enumerate(run_tables):
        acc = aacc = 0
        for k, (t, ln, decl, last, pl) in enumerate(rt):
            cols["rtype"][j, k] = t
            cols["rdecl"][j, k] = decl
            cols["rlen"][j, k] = ln
            cols["rlast"][j, k] = 1 if last else 0
            cols["rvalid"][j, k] = 1
            cols["loff"][j, k] = acc
            acc += ln
            if t >= DT_DLT:
                kk, aa, bb = rle_tape(np.frombuffer(pl, np.uint8))
                # b shares bits 8..29 with the kind flag at bit 30
                if int(bb.max(initial=0)) >= 1 << 22:
                    raise ValueError("DLT run length overflows the aux "
                                     "tape packing")
                packs[j].append(((kk == K_RLEN).astype(np.int64) << 30)
                                | (bb.astype(np.int64) << 8) | aa)
                dlt_toks[j][k] = len(kk)
                cols["astart"][j, k] = aacc
                cols["aplen"][j, k] = len(kk)
                aacc += len(kk)
    auxl = max(1, max(sum(len(p) for p in ps) for ps in packs))
    aux = np.zeros((b, auxl), np.int64)
    for j, ps in enumerate(packs):
        if ps:
            cat = np.concatenate(ps)
            aux[j, :len(cat)] = cat
    out = {k: torch.as_tensor(v, device=device) for k, v in cols.items()}
    out["aux"] = torch.as_tensor(aux, device=device)
    return out, dlt_toks


def stitch_tapes(tape, data, run_tables, tl_out=None):
    """K2's tape [B, TL_in, 2] (w0 = kind | wire_len << 3, w1 = dist_code)
    and the LZ input data [B, N] u8 -> phase-B tapes (kind, a, b, c),
    each [B, TL_out] int32, on data's device, and TL_out."""
    dev = data.device
    runs, dlt_toks = _run_arrays(run_tables, dev)
    w0 = tape[:, :, 0].long()
    tk = w0 & 7
    ta = tape[:, :, 1].long()
    tb = w0 >> 3
    b, tl_in = tk.shape
    if tl_out is None:
        tl_out = plan_out_bound(run_tables, tl_in, dlt_toks)
    rtype, rdecl, rlen = runs["rtype"], runs["rdecl"], runs["rlen"]
    rlast, rvalid, loff = runs["rlast"], runs["rvalid"], runs["loff"]
    r = rtype.shape[1]
    n = data.shape[1]
    data_l = data.long()

    # per-run LZ segment bounds from the K_SENT_A sentinels
    iota_t = torch.arange(tl_in, device=dev)
    m = (tk == K_SENT_A) & (rvalid.sum(dim=1, keepdim=True) > 0)
    cum = torch.cumsum(m.long(), dim=1)
    # sp[:, k]: position of the (k+1)-th sentinel (0 if none); misses go
    # to a spare column
    sp = torch.zeros((b, r + 1), dtype=torch.int64, device=dev)
    hit = m & (cum <= r)
    sp.scatter_(1, torch.where(hit, cum - 1, r),
                iota_t.expand(b, tl_in).contiguous())
    sp = sp[:, :r]
    seg_start = torch.nn.functional.pad(sp[:, :-1] + 1, (1, 0))
    seg_len = sp - seg_start

    # per-run output lengths
    is_lz = rtype < DT_NO_LZ
    has_size = (rtype == DT_ENGTXT) | (rtype >= DT_NO_LZ)
    hlen = torch.where(rvalid > 0, 1 + has_size.long(), 0)
    plen_nolz = torch.where(rtype == DT_BAD, (rlen + 1) // 2, rlen)
    plen_nolz = torch.where(rtype >= DT_DLT, runs["aplen"], plen_nolz)
    plen = torch.where(is_lz, seg_len + 1, plen_nolz)
    plen = torch.where(rvalid > 0, plen, 0)
    tlen = torch.where(rvalid > 0, 1 + rlast, 0)
    rl_total = hlen + plen + tlen
    out_end = torch.cumsum(rl_total, dim=1)
    out_start = out_end - rl_total
    total = out_end[:, -1:]

    # output index -> (run, offset)
    o = torch.arange(tl_out, device=dev).expand(b, tl_out)
    if r > 1:
        ridx = torch.searchsorted(out_end[:, :-1].contiguous(),
                                  o.contiguous(), right=True)
    else:
        ridx = torch.zeros_like(o)

    def g(tbl):
        return tbl.gather(1, ridx)

    off = o - g(out_start)
    hlen_g, plen_g, type_g = g(hlen), g(plen), g(rtype)
    last_g, loff_g, rlen_g = g(rlast), g(loff), g(rlen)
    segl_g = g(seg_len)
    p = off - hlen_g
    t_off = p - plen_g
    is_hdr = off < hlen_g
    is_pay = ~is_hdr & (p < plen_g)
    is_lz_g = type_g < DT_NO_LZ
    is_bad_g = type_g == DT_BAD
    is_dlt_g = type_g >= DT_DLT
    pc = p.clamp(min=0)

    in_idx = (g(seg_start) + pc).clamp(0, tl_in - 1)
    lz_k, lz_a, lz_b = tk.gather(1, in_idx), ta.gather(1, in_idx), \
        tb.gather(1, in_idx)
    bi0 = (loff_g + torch.where(is_bad_g, 2 * pc, pc)).clamp(0, n - 1)
    d0 = data_l.gather(1, bi0)
    d1 = data_l.gather(1, (bi0 + 1).clamp(0, n - 1))
    pair_full = (2 * pc + 1) < rlen_g

    kk = torch.full((b, tl_out), K_END, dtype=torch.int64, device=dev)
    aa = torch.zeros_like(kk)
    bb = torch.zeros_like(kk)
    is_tail0 = ~is_hdr & ~is_pay & (t_off == 0)
    is_tail1 = ~is_hdr & ~is_pay & (t_off == 1) & (last_g > 0)
    kk = torch.where(is_tail0, K_INT, kk)
    aa = torch.where(is_tail0, last_g, aa)
    kk = torch.where(is_tail1, K_FLUSH, kk)
    in_seg = is_pay & is_lz_g & (p < segl_g)
    kk = torch.where(in_seg, lz_k, kk)
    aa = torch.where(in_seg, lz_a, aa)
    bb = torch.where(in_seg, lz_b, bb)
    at_sent = is_pay & is_lz_g & (p == segl_g)
    kk = torch.where(at_sent, K_SENT, kk)
    aa = torch.where(at_sent, 64, aa)
    is_badp = is_pay & is_bad_g
    kk = torch.where(is_badp, K_RAW, kk)
    aa = torch.where(is_badp, torch.where(pair_full, (d0 << 8) | d1, d0),
                     aa)
    bb = torch.where(is_badp, torch.where(pair_full, 16, 8), bb)
    is_entp = is_pay & ~is_lz_g & ~is_bad_g & ~is_dlt_g
    kk = torch.where(is_entp, K_ELIT, kk)
    aa = torch.where(is_entp, d0, aa)
    is_dltp = is_pay & is_dlt_g
    aux = runs["aux"]
    packed = aux.gather(1, (g(runs["astart"]) + pc).clamp(
        0, aux.shape[1] - 1))
    kk = torch.where(is_dltp, torch.where(packed >> 30 != 0, K_RLEN, K_DLIT),
                     kk)
    aa = torch.where(is_dltp, packed & 0xFF, aa)
    bb = torch.where(is_dltp, (packed >> 8) & 0x3FFFFF, bb)
    is_h0 = is_hdr & (off == 0)
    is_h1 = is_hdr & (off == 1)
    kk = torch.where(is_h0 | is_h1, K_INT, kk)
    aa = torch.where(is_h0, type_g, aa)
    aa = torch.where(is_h1, g(rdecl), aa)
    bb = torch.where(is_hdr, 0, bb)

    # literal and last-match bytes from the data (fill_from_data)
    is_lzk = ((kk == K_LIT) | (kk == K_REP0L1) | (kk == K_MATCH)
              | (kk == K_REP)) & in_seg
    consumed = torch.where((kk == K_MATCH) | (kk == K_REP), bb + 2, 1)
    consumed = torch.where(is_lzk, consumed, 0)
    cex = torch.cumsum(consumed, dim=1) - consumed
    lz_rlen = torch.where(is_lz & (rvalid > 0), rlen, 0)
    lzcum = torch.cumsum(lz_rlen, dim=1) - lz_rlen
    posn = (loff_g + cex - g(lzcum)).clamp(0, n - 1)
    dlit = data_l.gather(1, posn)
    dlast = data_l.gather(1, (posn + (consumed - 1).clamp(min=0)).clamp(
        0, n - 1))
    aa = torch.where(is_lzk & (kk == K_LIT), dlit, aa)
    cc = torch.where(is_lzk, dlast, 0)

    past = o >= total
    kk = torch.where(past, K_END, kk)
    aa = torch.where(past, 0, aa)
    bb = torch.where(past, 0, bb)
    cc = torch.where(past, 0, cc)
    return (kk.to(torch.int32), aa.to(torch.int32), bb.to(torch.int32),
            cc.to(torch.int32), tl_out)
