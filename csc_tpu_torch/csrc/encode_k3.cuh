// K3: straight per-stream phase-B coder (the model FSM of csc_model.cpp
// driving the range coder of csc_coder.h / csc_coder.cpp, in the token
// tape form of csc_tpu/ops/encode_bits.py).
//
// One call codes one whole stitched token tape.  The coder registers
// (low, lowhi, range, cache, cachesize, bc_val, bc_bits), the model state
// and the literal context stay in locals; probabilities are uint16_t as
// K1 keeps them (12-bit values): the small trees and p_lit in one table,
// p_delta in another.  The same source builds with nvcc (the __global__
// wrapper in encode_k3.cu) and with g++ (the test harness
// encode_k3_host.cpp), so the CPU tests hold this logic against the plain
// PyTorch version (csc_tpu_torch/ops/bits_scan.py) before it runs on a
// card.
//
// Contract with the plain version, for every stream: the same rc and bc
// bytes, 64 KB-crossing maps, chunk log, rc_cnt, bc_cnt, chunk_cnt, done
// and err.  As in the reference, a write past an output buffer lands on
// its last byte while the counter runs on; err = ERR_OVERFLOW then.
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define K3_FN __host__ __device__ inline

namespace k3 {

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
constexpr int NPROB_DELTA = 65536;         // p_delta (DT_DLT runs)

// phase-B token kinds (encode_scan.py:36-41, encode_bits.py:43-49)
constexpr int32_t K_LIT = 0;
constexpr int32_t K_MATCH = 1;
constexpr int32_t K_REP = 2;
constexpr int32_t K_REP0L1 = 3;
constexpr int32_t K_END = 5;
constexpr int32_t K_RAW = 6;
constexpr int32_t K_ELIT = 7;
constexpr int32_t K_DLIT = 8;
constexpr int32_t K_RLEN = 9;
constexpr int32_t K_INT = 10;
constexpr int32_t K_SENT = 11;
constexpr int32_t K_FLUSH = 12;

constexpr int32_t ERR_OVERFLOW = 1;

struct Stream {
    const int32_t* kind;      // stitched tapes, T tokens each
    const int32_t* a;
    const int32_t* b;
    const int32_t* c;
    int64_t ntok;
    uint8_t* rc_out;          // max_rc bytes
    int64_t max_rc;
    uint8_t* bc_out;          // max_bc bytes
    int64_t max_bc;
    int32_t* rc_map;          // [nmap] bc_cnt at each rc bsize crossing
    int32_t* bc_map;          // [nmap] rc_cnt at each bc bsize crossing
    int32_t nmap;
    int32_t* chunk_log;       // [nchunk][2] (rc_cnt, bc_cnt) after a flush
    int32_t nchunk;
    int64_t bsize;
    uint16_t* probs;          // NPROB_MAIN entries, all 2048
    uint16_t* pdelta;         // NPROB_DELTA entries, all 2048
};

struct Result {
    int32_t rc_cnt, bc_cnt, chunk_cnt, done, err;
};

// DIST_TABLE (csc_model.cpp:45-55): s for s < 4, else 2^(s-2) + 1
K3_FN int64_t dist_table(int slot) {
    return slot < 4 ? slot : (int64_t(1) << (slot - 2)) + 1;
}

// REV16_TABLE (csc_model.cpp:57-62): 4-bit reversal
K3_FN int32_t rev4(int32_t v) {
    return ((v & 1) << 3) | ((v & 2) << 1) | ((v & 4) >> 1) | ((v & 8) >> 3);
}

K3_FN int32_t bitlen(int64_t v) {
    int32_t r = 0;
    while (v > 0) {
        ++r;
        v >>= 1;
    }
    return r;
}

struct Coder {
    Stream s;
    uint32_t low, range, bc_val;
    int32_t lowhi, cache, cachesize, bc_bits;
    int64_t rc_cnt, bc_cnt;
    int32_t chunk_cnt;
    int32_t mstate, ctx;

    K3_FN void log_cross(int32_t* map, int64_t cnt, int64_t other) {
        if (cnt > 0 && cnt % s.bsize == 0) {
            int64_t i = cnt / s.bsize - 1;
            if (i >= s.nmap) i = s.nmap - 1;
            map[i] = (int32_t)other;
        }
    }

    K3_FN void put_rc(uint32_t byte) {
        s.rc_out[rc_cnt < s.max_rc ? rc_cnt : s.max_rc - 1] = (uint8_t)byte;
        ++rc_cnt;
        log_cross(s.rc_map, rc_cnt, bc_cnt);
    }

    K3_FN void put_bc(uint32_t byte) {
        s.bc_out[bc_cnt < s.max_bc ? bc_cnt : s.max_bc - 1] = (uint8_t)byte;
        ++bc_cnt;
        log_cross(s.bc_map, bc_cnt, rc_cnt);
    }

    // RC_ShiftLow (csc_coder.cpp:89-112)
    K3_FN void shift_low() {
        if (low < 0xFF000000u || lowhi != 0) {
            const uint32_t carry = (uint32_t)lowhi;
            put_rc((cache + carry) & 0xFF);
            for (int32_t i = 1; i < cachesize; ++i) put_rc((0xFF + carry) & 0xFF);
            cache = (int32_t)((low >> 24) & 0xFF);
            cachesize = 0;
        }
        ++cachesize;
        low <<= 8;
        lowhi = 0;
    }

    // EncodeBit (csc_coder.h:67-81): 12-bit probability, shift-5 adapt
    K3_FN void bit(uint16_t* pp, int32_t v) {
        const uint32_t p = *pp;
        const uint32_t bound = (range >> 12) * p;
        if (v) {
            range = bound;
            *pp = (uint16_t)(p + ((0xFFF - p) >> 5));
        } else {
            const uint32_t sum = low + bound;
            lowhi += sum < low;
            low = sum;
            range -= bound;
            *pp = (uint16_t)(p - (p >> 5));
        }
        if (range < (1u << 24)) {
            range <<= 8;
            shift_low();
        }
    }

    // EncDirect16 (csc_coder.cpp:76-87): nbits <= 16
    K3_FN void direct(uint32_t val, int32_t nbits) {
        bc_val = (bc_val << nbits) | val;
        bc_bits += nbits;
        while (bc_bits >= 8) {
            put_bc((bc_val >> (bc_bits - 8)) & 0xFF);
            bc_bits -= 8;
        }
    }

    // a tree of nbits bits, most significant first, from node 1
    K3_FN void tree(uint16_t* base, uint32_t val, int32_t nbits) {
        uint32_t node = 1;
        for (int32_t i = nbits - 1; i >= 0; --i) {
            const int32_t v = (val >> i) & 1;
            bit(base + node, v);
            node = node * 2 + v;
        }
    }

    // EncodeInt (csc_model.cpp:389-414)
    K3_FN void enc_int(int32_t v) {
        int32_t slot = bitlen(v) - 1;
        if (slot < 0) slot = 0;
        direct((uint32_t)slot, 5);
        if (slot == 0) direct((uint32_t)v, 1);
        else direct((uint32_t)(v - (1 << (slot < 30 ? slot : 30))), slot);
    }

    // one length value lv <= 143: slot bits then its tree
    K3_FN void len_value(int32_t lv) {
        uint16_t* p = s.probs;
        bit(p + P_MLSLOT, lv >= 8);
        if (lv < 8) {
            tree(p + P_MLEX1, (uint32_t)lv, 3);
            return;
        }
        bit(p + P_MLSLOT + 1, lv >= 16);
        if (lv < 16) tree(p + P_MLEX2, (uint32_t)(lv - 8), 3);
        else tree(p + P_MLEX3, (uint32_t)(lv - 16), 7);
    }

    // encode_matchlen_1 / _2 (csc_model.cpp:147-159): a wire length
    // >= 143 codes 143, a run of long-length bits, then the remainder
    K3_FN void length(int32_t vb) {
        len_value(vb < 143 ? vb : 143);
        if (vb >= 143) {
            for (int32_t k = (vb - 143) / 143; k > 0; --k)
                bit(s.probs + P_LONGLEN, 0);
            bit(s.probs + P_LONGLEN, 1);
            const int32_t rem = (vb - 143) % 143;
            len_value(rem < 143 ? rem : 143);
        }
    }

    // distance slot + extra bits (csc_model.cpp:300-345); wire length
    // wl picks the slot tree
    K3_FN void distance(int32_t dist, int32_t wl) {
        int32_t pos, sbits;
        const int32_t w = wl < 6 ? wl : 6;
        if (w == 0) {
            pos = 0;
            sbits = 3;
        } else if (w <= 2) {
            pos = 16 * (w - 1) + 8;
            sbits = 4;
        } else if (w <= 5) {
            pos = 32 * (w - 3) + 8 + 32;
            sbits = 5;
        } else {
            pos = 32 * 3 + 8 + 32;
            sbits = 5;
        }
        int32_t slot = 0;
        while (slot < 31 && dist_table(slot + 1) <= dist) ++slot;
        tree(s.probs + P_DIST + pos, (uint32_t)slot, sbits);
        if (slot <= 2) return;
        const int32_t ebits = slot - 2 > 1 ? slot - 2 : 1;
        const int32_t elen = dist - (1 << (ebits < 30 ? ebits : 30)) - 1;
        if (ebits > 4) {
            int32_t rem = ebits - 4;
            const int32_t dv = elen >> 4;
            if (rem > 16) {
                direct((uint32_t)((dv >> 16) & 0xFFFF), rem - 16);
                rem = 16;
                direct((uint32_t)(dv & 0xFFFF), rem);
            } else {
                direct((uint32_t)(dv & ((1 << (rem < 30 ? rem : 30)) - 1)),
                       rem);
            }
        }
        tree(s.probs + P_MDEXTRA + (ebits - 1) * 16,
             (uint32_t)rev4(elen & 0xF), 4);
    }

    // Coder::Flush (csc_coder.cpp:40-74), then a coder reset; the
    // probabilities persist (csc_encoder_main.cpp:141-145)
    K3_FN void flush() {
        for (int i = 0; i < 5; ++i) shift_low();
        put_bc(bc_bits > 0 ? (bc_val << (8 - bc_bits)) & 0xFF : 0);
        put_bc(0);
        const int32_t ci = chunk_cnt < s.nchunk ? chunk_cnt : s.nchunk - 1;
        s.chunk_log[2 * ci] = (int32_t)rc_cnt;
        s.chunk_log[2 * ci + 1] = (int32_t)bc_cnt;
        ++chunk_cnt;
        low = 0;
        lowhi = 0;
        range = 0xFFFFFFFFu;
        cache = 0;
        cachesize = 1;
        bc_val = 0;
        bc_bits = 0;
    }

    K3_FN Result run() {
        low = 0;
        range = 0xFFFFFFFFu;
        bc_val = 0;
        lowhi = 0;
        cache = 0;
        cachesize = 1;
        bc_bits = 0;
        rc_cnt = 0;
        bc_cnt = 0;
        chunk_cnt = 0;
        mstate = 0;
        ctx = 0;
        int32_t done = 0;
        uint16_t* p = s.probs;
        for (int64_t t = 0; t < s.ntok; ++t) {
            const int32_t kind = s.kind[t];
            const int32_t va = s.a[t], vb = s.b[t], vc = s.c[t];
            if (kind == K_END) {
                done = 1;
                break;
            } else if (kind == K_INT) {
                enc_int(va);
            } else if (kind == K_FLUSH) {
                flush();
            } else if (kind == K_RAW) {
                direct((uint32_t)va, vb);
            } else if (kind == K_ELIT) {
                // CompressLiterals (csc_model.cpp:448-461): no flags
                tree(p + P_LIT + ctx * 256, (uint32_t)va, 8);
                ctx = va;
            } else if (kind == K_DLIT || kind == K_RLEN) {
                // CompressRLE (csc_model.cpp:471-513): flag bit, then a
                // delta literal through p_delta[s_ctx] or a run length
                bit(p + P_RLEFLAG, kind == K_RLEN);
                if (kind == K_DLIT) tree(s.pdelta + vb * 256, (uint32_t)va, 8);
                else length(vb);
            } else {
                uint16_t* pf = p + P_STATE + mstate * 3;
                if (kind == K_LIT) {
                    bit(pf, 0);
                    mstate = (mstate * 4) & 0x3F;
                    tree(p + P_LIT + ctx * 256, (uint32_t)va, 8);
                    ctx = va;
                } else if (kind == K_REP0L1) {
                    bit(pf, 1);
                    bit(pf + 1, 0);
                    bit(pf + 2, 0);
                    mstate = (mstate * 4 + 2) & 0x3F;
                    ctx = vc;
                } else if (kind == K_REP) {
                    bit(pf, 1);
                    bit(pf + 1, 0);
                    bit(pf + 2, 1);
                    // rep index: 2 bits from node 1 (P_REPDIST + node - 1)
                    uint16_t* pr = p + P_REPDIST + mstate * 3 - 1;
                    const int32_t hi = (va >> 1) & 1, lo = va & 1;
                    bit(pr + 1, hi);
                    bit(pr + 2 + hi, lo);
                    length(vb);
                    mstate = (mstate * 4 + 3) & 0x3F;
                    ctx = vc;
                } else {   // K_MATCH, K_SENT
                    bit(pf, 1);
                    bit(pf + 1, 1);
                    length(vb);
                    distance(va, vb);
                    mstate = (mstate * 4 + 1) & 0x3F;
                    if (kind != K_SENT) ctx = vc;
                }
            }
        }
        const int32_t err = (rc_cnt >= s.max_rc || bc_cnt >= s.max_bc)
                                ? ERR_OVERFLOW : 0;
        return Result{(int32_t)rc_cnt, (int32_t)bc_cnt, chunk_cnt, done, err};
    }
};

K3_FN Result code_stream(const Stream& s) {
    Coder c;
    c.s = s;
    return c.run();
}

}  // namespace k3
