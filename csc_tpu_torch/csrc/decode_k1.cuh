// K1: straight per-stream CSC decoder (csc_dec.cpp:476-682 semantics, in
// the linear-window form of csc_tpu/ops/decode_scan.py).
//
// One call decodes one whole stream.  The coder state, rep queue, model
// state and context stay in locals; probabilities are uint16_t.  The
// same source builds with nvcc (the __global__ wrapper in decode_k1.cu)
// and with g++ (the test harness decode_k1_host.cpp), so the CPU tests
// hold this logic against the plain PyTorch version
// (csc_tpu_torch/ops/decode_scan.py) before it runs on a card.
//
// Contract with the plain version, for every stream: the same window
// bytes, typed-block log, wnd_pos, done and err.  Micro-ops are counted
// as the lockstep version counts its steps (one per range-coder bit, one
// per direct read of <= 16 bits, one per copy chunk of <= 16 bytes, one
// per RLE run byte), so a step cap stops both at the same point.  A
// halting micro-op (corrupt stream, window overflow) writes nothing.
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define K1_FN __host__ __device__ inline

namespace k1 {

// probability layout (decode_scan.py:38-50); p_delta lives apart
constexpr int P_STATE = 0;
constexpr int P_REPDIST = 192;
constexpr int P_DIST = 384;
constexpr int P_MDEXTRA = 552;
constexpr int P_MLSLOT = 1016;
constexpr int P_MLEX1 = 1018;
constexpr int P_MLEX2 = 1026;
constexpr int P_MLEX3 = 1034;
constexpr int P_LONGLEN = 1162;
constexpr int P_RLEFLAG = 1163;
constexpr int P_LIT = 2048;
constexpr int NPROB_MAIN = 2048 + 65536;   // small trees + p_lit
constexpr int NPROB_DELTA = 65536;         // p_delta (DT_DLT blocks)

// block types (csc_typedef.h:20-40)
constexpr int64_t DT_NORMAL = 0x01;
constexpr int64_t DT_ENGTXT = 0x02;
constexpr int64_t DT_EXE = 0x03;
constexpr int64_t DT_ENTROPY = 0x07;
constexpr int64_t DT_BAD = 0x08;
constexpr int64_t SIG_EOF = 0x09;
constexpr int64_t DT_DLT = 0x10;

constexpr int ERR_CORRUPT = 1;
constexpr int COPY_CHUNK = 16;
constexpr int64_t MAX_WINDOW = int64_t(1) << 30;

struct Stream {
    const uint8_t* rc;       // demuxed range-coder bytes, rcl long
    int64_t rcl;
    const uint8_t* bc;       // demuxed bit-coder bytes, bcl long
    int64_t bcl;
    const int32_t* rc_ends;  // cumulative block ends, padded 0x7FFFFFFF
    int32_t nb_rc;
    const int32_t* bc_ends;
    int32_t nb_bc;
    uint8_t* wnd;            // wnd_size + COPY_CHUNK bytes, zeroed
    int64_t wnd_size;
    uint16_t* probs;         // NPROB_MAIN entries, all 2048
    uint16_t* pdelta;        // NPROB_DELTA entries, all 2048
    int32_t* blk_log;        // [max_blocks][2]: (block type, start)
    int32_t max_blocks;
    int64_t max_steps;
};

struct Result {
    int32_t wnd_pos, done, err, blk_cnt;
};

struct Dec {
    Stream s;
    uint32_t code, range, bc_val;
    int64_t rc_ptr, bc_ptr;
    int32_t rc_blk, bc_blk, bc_bits;
    int64_t budget;          // micro-ops left before the step cap
    int64_t wnd_pos;
    int32_t mstate, ctx;
    int64_t rep0, rep1, rep2, rep3;
    int32_t blk_cnt, done, err;
    bool stop;
};

K1_FN int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// DIST_TABLE (csc_model.cpp:45-55): s for s < 4, else 2^(s-2) + 1
K1_FN int64_t dist_table(int slot) {
    return slot < 4 ? slot : (int64_t(1) << (slot - 2)) + 1;
}

// REV16_TABLE (csc_model.cpp:57-62): 4-bit reversal
K1_FN int rev4(int v) {
    return ((v & 1) << 3) | ((v & 2) << 1) | ((v & 4) >> 1) | ((v & 8) >> 3);
}

K1_FN bool take(Dec& d) {
    if (d.budget <= 0) {
        d.stop = true;
        return false;
    }
    --d.budget;
    return true;
}

K1_FN void corrupt(Dec& d) {
    d.err = ERR_CORRUPT;
    d.done = 1;
    d.stop = true;
}

// a write past the window: report where the stream would have got to
K1_FN void overflow(Dec& d, int64_t would) {
    corrupt(d);
    d.wnd_pos = would < MAX_WINDOW + 1 ? would : MAX_WINDOW + 1;
}

// DecodeBit (csc_dec.cpp:10-35): refill before the bit, shift-5 adapt
K1_FN int bit(Dec& d, uint16_t* p) {
    if (!take(d)) return 0;
    if (d.range < (1u << 24)) {
        if (d.rc_ptr >= d.s.rcl) {
            corrupt(d);
            return 0;
        }
        d.range <<= 8;
        d.code = (d.code << 8) + d.s.rc[d.rc_ptr];
        ++d.rc_ptr;
        if (d.rc_ptr >= d.s.rc_ends[clampi(d.rc_blk, 0, d.s.nb_rc - 1)])
            ++d.rc_blk;
    }
    uint32_t pv = *p;
    uint32_t bound = (d.range >> 12) * pv;
    if (d.code < bound) {
        d.range = bound;
        *p = (uint16_t)(pv + ((0xFFFu - pv) >> 5));
        return 1;
    }
    d.range -= bound;
    d.code -= bound;
    *p = (uint16_t)(pv - (pv >> 5));
    return 0;
}

// binary tree of nbits bits rooted at base[1]; returns the final node
K1_FN int tree(Dec& d, uint16_t* base, int nbits) {
    int node = 1;
    for (int i = 0; i < nbits; ++i) {
        int b = bit(d, base + node);
        if (d.stop) return 0;
        node = node * 2 + b;
    }
    return node;
}

// coder_decode_direct (csc_dec.cpp:65-87): one micro-op, nbits <= 16
K1_FN uint32_t direct(Dec& d, int nbits) {
    if (!take(d)) return 0;
    while (d.bc_bits < nbits) {
        if (d.bc_ptr >= d.s.bcl) {
            corrupt(d);
            return 0;
        }
        d.bc_val = (d.bc_val << 8) | d.s.bc[d.bc_ptr];
        ++d.bc_ptr;
        if (d.bc_ptr >= d.s.bc_ends[clampi(d.bc_blk, 0, d.s.nb_bc - 1)])
            ++d.bc_blk;
        d.bc_bits += 8;
    }
    uint32_t v = (d.bc_val >> (d.bc_bits - nbits)) & ((1u << nbits) - 1u);
    d.bc_bits -= nbits;
    return v;
}

// DecodeDirect (csc_dec.cpp:37-42): > 16 bits take two micro-ops
K1_FN uint32_t direct_long(Dec& d, int nbits) {
    if (nbits <= 16) return direct(d, nbits);
    uint32_t hi = direct(d, nbits - 16);
    if (d.stop) return 0;
    uint32_t lo = direct(d, 16);
    return (hi << 16) | lo;
}

// decode_int (csc_dec.cpp:89-96); the slot shift saturates at 30 as in
// decode_scan
K1_FN int64_t read_int(Dec& d) {
    int slot = (int)direct(d, 5);
    if (d.stop) return 0;
    uint32_t v = direct_long(d, slot > 1 ? slot : 1);
    if (d.stop) return 0;
    return (int64_t)v + (slot > 0 ? (int64_t(1) << (slot < 30 ? slot : 30))
                                  : 0);
}

// decode_matchlen_1 (csc_dec.cpp:187-218)
K1_FN int64_t len1(Dec& d) {
    uint16_t* P = d.s.probs;
    int b = bit(d, P + P_MLSLOT);
    if (d.stop) return 0;
    if (!b) return tree(d, P + P_MLEX1, 3) & 7;
    b = bit(d, P + P_MLSLOT + 1);
    if (d.stop) return 0;
    if (!b) return 8 + (tree(d, P + P_MLEX2, 3) & 7);
    return 16 + (tree(d, P + P_MLEX3, 7) & 0x7F);
}

// decode_matchlen_2 (csc_dec.cpp:220-232)
K1_FN int64_t match_len(Dec& d) {
    int64_t l = len1(d);
    if (d.stop || l != 143) return l;
    int64_t acc = 143;
    for (;;) {
        int b = bit(d, d.s.probs + P_LONGLEN);
        if (d.stop) return 0;
        if (b) break;
        acc += 143;
    }
    return acc + len1(d);
}

// overlap-safe LZ copy, 16 bytes per micro-op (csc_dec.cpp:497-507)
K1_FN void copy(Dec& d, int64_t dist, int64_t len) {
    uint8_t* w = d.s.wnd;
    int64_t src = d.wnd_pos - dist;
    while (len > 0) {
        if (!take(d)) return;
        int64_t chunk = len < COPY_CHUNK ? len : COPY_CHUNK;
        for (int64_t k = 0; k < chunk; ++k) w[d.wnd_pos + k] = w[src + k];
        d.wnd_pos += chunk;
        src += chunk;
        len -= chunk;
    }
    d.ctx = w[d.wnd_pos - 1];
}

K1_FN void push_rep(Dec& d, int64_t dist) {
    d.rep3 = d.rep2;
    d.rep2 = d.rep1;
    d.rep1 = d.rep0;
    d.rep0 = dist;
}

// lz_decode (csc_dec.cpp:476-571) up to the block-end sentinel
K1_FN void lz_block(Dec& d) {
    uint16_t* P = d.s.probs;
    uint8_t* w = d.s.wnd;
    for (;;) {
        int m3 = d.mstate * 3;
        int f = bit(d, P + P_STATE + m3);
        if (d.stop) return;
        if (!f) {                                          // literal
            int node = tree(d, P + P_LIT + d.ctx * 256, 8);
            if (d.stop) return;
            if (d.wnd_pos + 1 > d.s.wnd_size) return overflow(d, d.wnd_pos + 1);
            d.ctx = node & 0xFF;
            d.mstate = (d.mstate * 4) & 0x3F;
            w[d.wnd_pos++] = (uint8_t)d.ctx;
            continue;
        }
        f = bit(d, P + P_STATE + m3 + 1);
        if (d.stop) return;
        if (f) {                                           // match
            int64_t len = match_len(d);
            if (d.stop) return;
            int lc = len < 6 ? (int)len : 6;
            int pos = lc == 0 ? 0 : (lc <= 2 ? 16 * (lc - 1) + 8
                                             : (lc <= 5 ? 32 * (lc - 3) + 40
                                                        : 136));
            int sbits = lc == 0 ? 3 : (lc <= 2 ? 4 : 5);
            int slot = tree(d, P + P_DIST + pos, sbits) & ((1 << sbits) - 1);
            if (d.stop) return;
            int64_t dist_raw = slot;
            if (slot > 2) {
                int ebits = slot - 2;
                uint32_t elen = 0;
                if (ebits > 4) {
                    elen = direct_long(d, ebits - 4);
                    if (d.stop) return;
                }
                int nib = tree(d, P + P_MDEXTRA + (ebits - 1) * 16, 4);
                if (d.stop) return;
                dist_raw = dist_table(slot) + ((int64_t)elen << 4)
                    + rev4(nib & 0xF);
            }
            d.mstate = (d.mstate * 4 + 1) & 0x3F;
            if (len == 0 && dist_raw == 64) return;        // block end
            int64_t nd = dist_raw + 1;
            push_rep(d, nd);
            if (nd > d.wnd_pos) return corrupt(d);
            if (d.wnd_pos + len + 2 > d.s.wnd_size)
                return overflow(d, d.wnd_pos + len + 2);
            copy(d, nd, len + 2);
            if (d.stop) return;
            continue;
        }
        f = bit(d, P + P_STATE + m3 + 2);
        if (d.stop) return;
        if (!f) {                                          // rep0len1
            d.mstate = (d.mstate * 4 + 2) & 0x3F;
            // the reference wraps its ring when wnd_pos <= rep0
            // (csc_dec.cpp:525); a linear window holds no such byte
            if (d.rep0 <= 0 || d.wnd_pos <= d.rep0) return corrupt(d);
            if (d.wnd_pos + 1 > d.s.wnd_size) return overflow(d, d.wnd_pos + 1);
            copy(d, d.rep0, 1);
            if (d.stop) return;
            continue;
        }
        int rep_idx = tree(d, P + P_REPDIST + m3 - 1, 2) & 3;  // rep match
        if (d.stop) return;
        int64_t len = match_len(d);
        if (d.stop) return;
        d.mstate = (d.mstate * 4 + 3) & 0x3F;
        // rotate reps[0..rep_idx] (csc_dec.cpp:538-541)
        int64_t o0 = d.rep0, o1 = d.rep1, o2 = d.rep2;
        int64_t rdist = rep_idx == 0 ? o0 : rep_idx == 1 ? o1
                      : rep_idx == 2 ? o2 : d.rep3;
        if (rep_idx >= 1) d.rep1 = o0;
        if (rep_idx >= 2) d.rep2 = o1;
        if (rep_idx >= 3) d.rep3 = o2;
        d.rep0 = rdist;
        if (rdist <= 0 || rdist > d.wnd_pos) return corrupt(d);
        if (d.wnd_pos + len + 2 > d.s.wnd_size)
            return overflow(d, d.wnd_pos + len + 2);
        copy(d, rdist, len + 2);
        if (d.stop) return;
    }
}

// decode_literals (csc_dec.cpp:169-185): order-1 bytes sharing p_lit
K1_FN void entropy_block(Dec& d) {
    int64_t size = read_int(d);
    if (d.stop) return;
    if (d.wnd_pos + size > d.s.wnd_size) return overflow(d, d.wnd_pos + size);
    for (int64_t i = 0; i < size; ++i) {
        int node = tree(d, d.s.probs + P_LIT + d.ctx * 256, 8);
        if (d.stop) return;
        d.ctx = node & 0xFF;
        d.s.wnd[d.wnd_pos++] = (uint8_t)d.ctx;
    }
}

// decode_bad (csc_dec.cpp:98-108): raw bytes, two per micro-op
K1_FN void bad_block(Dec& d) {
    int64_t rem = read_int(d);
    if (d.stop) return;
    if (d.wnd_pos + rem > d.s.wnd_size) return overflow(d, d.wnd_pos + rem);
    uint8_t* w = d.s.wnd;
    while (rem > 0) {
        if (rem >= 2) {
            uint32_t v = direct(d, 16);
            if (d.stop) return;
            w[d.wnd_pos] = (uint8_t)(v >> 8);
            w[d.wnd_pos + 1] = (uint8_t)v;
            d.wnd_pos += 2;
            rem -= 2;
        } else {
            uint32_t v = direct(d, 8);
            if (d.stop) return;
            w[d.wnd_pos++] = (uint8_t)v;
            rem -= 1;
        }
    }
}

// decode_rle (csc_dec.cpp:110-153) with the inverse delta of
// csc_dec.cpp:644-651 fused in: each delta byte is added to the previous
// original byte of its channel and written at its interleaved position
// (RLE decode order is the inverse delta's channel-major order)
K1_FN void dlt_block(Dec& d, int64_t chn) {
    int64_t size = read_int(d);
    if (d.stop) return;
    if (d.wnd_pos + size > d.s.wnd_size) return overflow(d, d.wnd_pos + size);
    uint8_t* w = d.s.wnd + d.wnd_pos;
    int prev = 0, last_delta = 0, sctx = 0;
    int64_t rel = 0, lane = 0, rem = size;
    while (rem > 0) {
        int f = bit(d, d.s.probs + P_RLEFLAG);
        if (d.stop) return;
        int64_t run = 1;
        if (!f) {
            int delta = tree(d, d.s.pdelta + sctx * 256, 8) & 0xFF;
            if (d.stop) return;
            last_delta = sctx = delta;
        } else {
            run = match_len(d) + 11;
            if (d.stop) return;
        }
        // a literal writes its byte in the micro-op of its last bit; a
        // run writes one byte per micro-op
        do {
            if (f && !take(d)) return;
            prev = (last_delta + prev) & 0xFF;
            w[rel] = (uint8_t)prev;
            rel += chn;
            if (rel >= size) rel = ++lane;
            --run;
            --rem;
            sctx = last_delta;
        } while (run != 0 && rem != 0);
    }
    d.wnd_pos += size;
}

K1_FN bool valid_type(int64_t t) {
    return t == DT_NORMAL || t == DT_EXE || t == DT_ENGTXT || t == DT_BAD
        || t == DT_ENTROPY || t == SIG_EOF || (t >= DT_DLT && t < DT_DLT + 5);
}

// per-chunk coder re-init (csc_dec.cpp:657-680): rc primes from bytes
// 1..4 of its next block, bc restarts at its next block
K1_FN void chunk_reset(Dec& d) {
    int64_t r = d.s.rc_ends[clampi(d.rc_blk, 0, d.s.nb_rc - 1)];
    if (r + 5 > d.s.rcl) return corrupt(d);
    const uint8_t* rc = d.s.rc;
    d.code = ((uint32_t)rc[r + 1] << 24) | ((uint32_t)rc[r + 2] << 16)
           | ((uint32_t)rc[r + 3] << 8) | rc[r + 4];
    d.range = 0xFFFFFFFFu;
    d.rc_ptr = r + 5;
    ++d.rc_blk;
    d.bc_ptr = d.s.bc_ends[clampi(d.bc_blk, 0, d.s.nb_bc - 1)];
    ++d.bc_blk;
    d.bc_val = 0;
    d.bc_bits = 0;
}

// Decoder::Decompress loop (csc_dec.cpp:586-682) over the whole stream
K1_FN Result decode_stream(const Stream& s) {
    Dec d;
    d.s = s;
    const uint8_t* rc = s.rc;
    d.code = ((uint32_t)rc[1] << 24) | ((uint32_t)rc[2] << 16)
           | ((uint32_t)rc[3] << 8) | rc[4];
    d.range = 0xFFFFFFFFu;
    d.bc_val = 0;
    d.rc_ptr = 5;
    d.bc_ptr = 0;
    d.rc_blk = d.bc_blk = d.bc_bits = 0;
    d.budget = s.max_steps;
    d.wnd_pos = 0;
    d.mstate = d.ctx = 0;
    d.rep0 = d.rep1 = d.rep2 = d.rep3 = 0;
    d.blk_cnt = d.done = d.err = 0;
    d.stop = false;
    for (;;) {
        int64_t type = read_int(d);
        if (d.stop) break;
        if (!valid_type(type)) {
            corrupt(d);
            break;
        }
        int32_t at = d.blk_cnt < s.max_blocks ? d.blk_cnt : s.max_blocks - 1;
        s.blk_log[2 * at] = (int32_t)type;
        s.blk_log[2 * at + 1] = (int32_t)d.wnd_pos;
        ++d.blk_cnt;
        if (type == DT_NORMAL || type == DT_EXE) {
            lz_block(d);
        } else if (type == DT_ENGTXT) {
            read_int(d);            // declared size, unused (csc_dec.cpp:603)
            if (!d.stop) lz_block(d);
        } else if (type == DT_BAD) {
            bad_block(d);
        } else if (type == DT_ENTROPY) {
            entropy_block(d);
        } else if (type >= DT_DLT) {
            const int64_t chn_of[5] = {1, 2, 3, 4, 8};   // DLT_INDEX
            dlt_block(d, chn_of[type - DT_DLT]);
        }
        if (d.stop) break;
        int64_t cont = read_int(d);
        if (d.stop) break;
        if (cont == 1) {
            chunk_reset(d);
            if (d.stop) break;
        }
        if (type == SIG_EOF) {
            d.done = 1;
            break;
        }
    }
    Result r;
    r.wnd_pos = (int32_t)d.wnd_pos;
    r.done = d.done;
    r.err = d.err;
    r.blk_cnt = d.blk_cnt;
    return r;
}

}  // namespace k1
