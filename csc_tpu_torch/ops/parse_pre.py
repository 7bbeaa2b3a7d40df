"""Match-finder precompute of the fast parse, as torch ops on the data's
device: for every position, the previous occurrences of its ht2, ht3 and
ht6 hashes (ht6 followed down a chain of hash_width links) and their
match lengths capped at EXT_CAP.

A port of csc_tpu/ops/parse_pre.py (`precompute_candidates`,
`pack_candidates`).  Candidates are previous occurrences of the same
hash, so they come from one stable sort per hash stream and gathers; the
sequential parse (K2) then folds them.  The occurrence chains treat every
position as inserted, the documented approximation of csc_tpu's fast path
against csc_mf.cpp's finder.  Hashes follow csc_mf.cpp:26-43 (same table
sizes), and lookahead bytes at each 8 KB sub-block end are masked to zero
the way the reference's window copy makes them (csc_lz.cpp:63-67).
The TPU build's stage-jitted variant (`_precompute_staged`) works around
an XLA miscompile and has no counterpart here.
"""
import torch

from ..constants import EXT_CAP, MASK32

_H6_MUL_HI, _H6_MUL_LO = 2654435761 >> 16, 2654435761 & 0xFFFF


def _low_bytes_mask(rem, nmax):
    """0xFF.. mask of min(rem, nmax) bytes (0 for rem <= 0)."""
    k = rem.clamp(0, nmax)
    return (torch.ones_like(k) << (8 * k)) - 1


def _mul32(x, hi, lo):
    """(x * (hi << 16 | lo)) mod 2^32 for 0 <= x < 2^32, without int64
    overflow."""
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def words4(data):
    """[B, N] u8 -> [B, N] int64 little-endian 4-byte words at each
    position, zero past the end."""
    d = torch.nn.functional.pad(data.long(), (0, 8))
    n = data.shape[1]
    return d[:, :n] | (d[:, 1:n + 1] << 8) | (d[:, 2:n + 2] << 16) \
        | (d[:, 3:n + 3] << 24)


def block_ends(run_ends, n):
    """[B, N] end of each position's 8 KB sub-block, clamped to its run's
    end (csc_lz.cpp:63-67).  run_ends: [B, R] cumulative run ends."""
    run_ends = run_ends.long()
    pos = torch.arange(n, device=run_ends.device).expand(
        run_ends.shape[0], n).contiguous()
    r = run_ends.shape[1]
    ridx = torch.searchsorted(run_ends, pos, right=True).clamp(0, r - 1)
    starts = torch.nn.functional.pad(run_ends[:, :-1], (1, 0))
    run_start = starts.gather(1, ridx)
    run_end = run_ends.gather(1, ridx)
    blk_off = run_start + ((pos - run_start) // 8192) * 8192
    return torch.minimum(blk_off + 8192, run_end)


def hashes(data, blk_end, hash_bits):
    """(in4, h2, h3, h6) per position, [B, N] int64 each."""
    n = data.shape[1]
    d = torch.nn.functional.pad(data.long(), (0, 8))
    in4 = words4(data)
    in2 = d[:, :n] | (d[:, 1:n + 1] << 8)
    v2b = d[:, 4:n + 4] | (d[:, 5:n + 5] << 8)
    rem = blk_end - torch.arange(n, device=data.device)
    v2 = in2 & _low_bytes_mask(rem, 2)
    v4 = in4 & _low_bytes_mask(rem, 4)
    v2bm = v2b & _low_bytes_mask(rem - 4, 2)
    h2 = (v2 * 65521) & 0x3FFF
    b0 = v2 & 0xFF
    b1 = (v2 >> 8) & 0xFF
    b2 = (v4 >> 16) & 0xFF
    h3 = ((b0 << 8) ^ (b1 << 5) ^ b2) & 0xFFFF
    h6 = _mul32(v4 ^ (v2bm << 13), _H6_MUL_HI, _H6_MUL_LO) \
        >> (32 - hash_bits)
    return in4, h2, h3, h6


def prev_occ(h):
    """prev[b, p] = largest q < p with h[b, q] == h[b, p], else -1."""
    _, order = torch.sort(h, dim=1, stable=True)
    h_s = h.gather(1, order)
    prev_s = torch.where(h_s[:, 1:] == h_s[:, :-1], order[:, :-1], -1)
    prev_s = torch.nn.functional.pad(prev_s, (1, 0), value=-1)
    return torch.empty_like(order).scatter_(1, order, prev_s)


def _eq_bytes(x):
    """Equal low bytes of a 4-byte xor word: 4 when x == 0."""
    return torch.where(
        x == 0, 4, torch.where(
            (x & 0xFF) != 0, 0, torch.where(
                (x & 0xFFFF) != 0, 1, torch.where(
                    (x & 0xFFFFFF) != 0, 2, 3))))


def ext_lens(in4, qpos, blk_end, cap):
    """Match length between p and qpos[p] (or 0 where qpos < 0), capped
    at min(cap, blk_end[p] - p): 4-byte word compares."""
    b, n = qpos.shape
    climit = torch.clamp(blk_end - torch.arange(n, device=qpos.device),
                         max=cap)
    ln = torch.zeros_like(qpos)
    active = qpos >= 0
    rounds = (cap + 3) // 4
    in4_pad = torch.nn.functional.pad(in4, (0, 4 * rounds))
    for it in range(rounds):
        sh = 4 * it
        w1 = in4_pad[:, sh:sh + n]
        w2 = in4.gather(1, (qpos + sh).clamp(0, n - 1))
        eq = _eq_bytes(w1 ^ w2)
        adv = torch.minimum(eq, (climit - ln).clamp(min=0))
        ln = torch.where(active, ln + adv, ln)
        active = active & (eq == 4) & (adv == 4) & (ln < climit)
    return ln


def precompute_candidates(data, run_ends, hash_bits, hash_width,
                          cap=EXT_CAP):
    """data: [B, N] u8 tensor (the LZ input, zero past each stream's end);
    run_ends: [B, R] cumulative run ends, on data's device.

    Returns cand [B, 2C, N] int32 with C = 2 + hash_width, as (dist, len)
    row pairs ordered ht2, ht3, ht6_0..w-1; dist 0 = no candidate; len ==
    cap means 'extend live'."""
    b, n = data.shape
    blk_end = block_ends(run_ends, n)
    in4, h2, h3, h6 = hashes(data, blk_end, int(hash_bits))
    p6 = prev_occ(h6)
    chains = [prev_occ(h2), prev_occ(h3), p6]
    cur = p6
    for _ in range(1, int(hash_width)):
        nxt = cur.gather(1, cur.clamp(0, n - 1))
        cur = torch.where(cur >= 0, nxt, -1)
        chains.append(cur)
    pos = torch.arange(n, device=data.device)
    cand = torch.empty((b, 2 * len(chains), n), dtype=torch.int32,
                       device=data.device)
    for k, q in enumerate(chains):
        cand[:, 2 * k] = torch.where(q >= 0, pos - q, 0)
        cand[:, 2 * k + 1] = ext_lens(in4, q, blk_end, cap)
    return cand


def pack_candidates(cand):
    """[B, 2C, N] (dist, len) row pairs -> [B, C, N] int32 dist<<5 | len,
    K2's candidate input (len <= EXT_CAP fits 5 bits; no candidate = 0)."""
    d = cand[:, 0::2]
    ln = cand[:, 1::2]
    return torch.where(d > 0, (d << 5) | ln.clamp(0, 31), 0).to(
        torch.int32).contiguous()


def unpack_candidates(candp):
    """The inverse of pack_candidates: [B, C, N] -> [B, 2C, N] int32."""
    b, c, n = candp.shape
    cand = torch.empty((b, 2 * c, n), dtype=torch.int32,
                       device=candp.device)
    cand[:, 0::2] = candp >> 5
    cand[:, 1::2] = candp & 31
    return cand
