// K3: per-stream phase-B coder (the model FSM of csc_model.cpp driving
// the range coder of csc_coder.h / csc_coder.cpp, in the token tape form
// of csc_tpu/ops/encode_bits.py), in three stages a pass of tokens goes
// through:
//
//   expansion  32 tokens a pass, one a lane: each lane turns its token
//              into records (one uint32 each: a coded bit with the address
//              of its probability, a direct-bit write, a run of zero bits
//              at P_LONGLEN, a flush).  Only the probability values depend
//              on earlier bits; their addresses, the model state (mstate,
//              the last three model codes) and the literal context come
//              from the tape alone, by one warp scan, and each lane's
//              records land at its offset from a warp prefix sum.
//   walk       one thread replaces each coded bit's address by the
//              probability it codes with, and adapts the table: a bit's
//              probability depends on the earlier bits at its address
//              only, never on the coder.  Two records in a row never name
//              one address (within a token the addresses climb through
//              distinct trees; a token's first record is a flag,
//              P_RLEFLAG or a literal tree's root, which no token's last
//              record names), so a pair's two loads go out before either
//              store.
//   coder      one thread runs the range-coder chain alone: per coded bit
//              the bound, range / low (64 bits, the carry in bit 32) and
//              the normalization, with no branch: the ShiftLow it implies
//              is deferred to a buffer, drained (bytes out, int32 counters
//              that count down to the next bsize crossing) before any
//              other record and at the end of a pass.
//
// The walk and the coder take the records four at a time: a group of
// coded bits runs straight through, any other group record by record.  On
// the card a taken branch costs about as much as the bit itself.
//
// A pass takes the longest prefix of its 32 tokens whose records fit CAP;
// the tokens left over start the next pass.  A token has at most MAX_REC
// records (a long length's run of P_LONGLEN zero bits is one record per
// RUN_MAX bits), so every pass takes at least one.
//
// The same source builds with nvcc (encode_k3.cu: an expanding warp, a
// walking lane and a coding lane in two more warps, passes handed on
// through a ring in shared memory) and with g++ (the test harness
// encode_k3_host.cpp: each pass expanded, walked, then coded).  The lane
// operations sit behind `Lanes`: in the nvcc build a lane's own value with
// __ballot_sync / __shfl_sync, in the g++ build all 32 lanes' values
// computed in a loop; both builds share the stages, and the CPU tests hold
// them against the plain PyTorch version (csc_tpu_torch/ops/bits_scan.py)
// before they run on a card.
//
// Contract with the plain version, for every stream: the same rc and bc
// bytes, 64 KB-crossing maps, chunk log, rc_cnt, bc_cnt, chunk_cnt, done
// and err.  As in the reference, a write past an output buffer lands on
// its last byte while the counter runs on; err = ERR_OVERFLOW then.  A
// tape without K_END is coded to its end with done = 0.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define K3_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define K3_FN inline __attribute__((always_inline))
#endif

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
constexpr int32_t K_NONE = -1;      // a lane past the tape's end

constexpr int32_t ERR_OVERFLOW = 1;
constexpr int WARP = 32;

// Records.  Bits 31..30 are the type:
//   00 coded bit   as expanded: bit 19 p_delta table, bit 18 the bit, bits
//                  17..0 the probability's byte address in shared memory
//                  (the small trees and p_lit; in the g++ build, from the
//                  table's start) or its index in p_delta.  As walked: bit
//                  12 the bit, bits 11..0 the probability.
//   01 direct      bits 28..24 nbits (<= 16), bits 23..0 value
//   10 zero run    at P_LONGLEN; as expanded: bits 17..0 the count; as
//                  walked: bits 29..12 the count, bits 11..0 the first
//                  probability
//   11 flush
// A direct write of 0 bits is a no-op: it pads a pass to whole groups of
// four, and one group past them, which the stages read ahead.
constexpr uint32_t R_TYPE = 3u << 30;
constexpr uint32_t R_DIRECT = 1u << 30;
constexpr uint32_t R_RUN = 2u << 30;
constexpr uint32_t R_FLUSH = 3u << 30;
constexpr uint32_t R_DELTA = 1u << 19;
constexpr uint32_t R_BIT = 1u << 18;
constexpr uint32_t R_OFF = R_BIT - 1;
constexpr uint32_t RUN_MAX = (1u << 18) - 1;
// a match: 2 flags + length (9 + 58 runs + 1 + 9) + distance 11
constexpr int MAX_REC = 2 + 77 + 11;
#ifndef K3_CAP
#define K3_CAP 512
#endif
constexpr uint32_t R_NOP = R_DIRECT;
constexpr int CAP = K3_CAP;   // records of one pass
constexpr int SLOT = CAP + 8; // + the no-ops read ahead (16-byte multiple)
static_assert(CAP >= MAX_REC, "a pass must take any one token");
static_assert(CAP % 4 == 0, "a pass is whole groups of four records");

// a pass's header: record count, last pass, K_END reached
constexpr int32_t H_LAST = 1 << 30;
constexpr int32_t H_DONE = 1 << 29;
constexpr int32_t H_NREC = (1 << 24) - 1;

K3_FN uint32_t low_mask(int32_t n) { return (1u << n) - 1; }

K3_FN int32_t clz32(uint32_t v) {
#ifdef __CUDA_ARCH__
    return __clz(v);
#else
    return v ? __builtin_clz(v) : 32;
#endif
}

K3_FN int32_t popc32(uint32_t v) {
#ifdef __CUDA_ARCH__
    return __popc(v);
#else
    return __builtin_popcount(v);
#endif
}

K3_FN int32_t bitlen(int32_t v) { return v > 0 ? 32 - clz32((uint32_t)v) : 0; }

// the largest slot s <= 31 with DIST_TABLE[s] <= d (csc_model.cpp:45-55:
// s for s < 4, else 2^(s-2) + 1)
K3_FN int32_t dist_slot(int32_t d) {
    if (d <= 0) return 0;
    const int32_t s = bitlen(d - 1) + 1;
    return s < 31 ? s : 31;
}

// REV16_TABLE (csc_model.cpp:57-62): 4-bit reversal
K3_FN int32_t rev4(int32_t v) {
    return ((v & 1) << 3) | ((v & 2) << 1) | ((v & 4) >> 1) | ((v & 8) >> 3);
}

// ------------------------------------------------------------------ lanes
// One int32 a lane.  nvcc: this lane's value; g++: all 32.
#ifdef __CUDA_ARCH__
struct Lanes {
    int32_t v;
};
K3_FN int lane_id() { return threadIdx.x & (WARP - 1); }
template <class F>
K3_FN Lanes lanes(F f) { return Lanes{f(lane_id())}; }
template <class F>
K3_FN void each(F f) { f(lane_id()); }
K3_FN int32_t own(const Lanes& x, int) { return x.v; }
K3_FN int32_t get(const Lanes& x, int src) {
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
}
K3_FN uint32_t ballot(const Lanes& x) {
    return __ballot_sync(0xFFFFFFFFu, x.v != 0);
}
// lane l gets lane l - d's value, lanes below d get `fill`
K3_FN Lanes shift_up(const Lanes& x, int d, int32_t fill) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x.v, d);
    return Lanes{lane_id() >= d ? y : fill};
}
#else
struct Lanes {
    int32_t v[WARP];
};
template <class F>
K3_FN Lanes lanes(F f) {
    Lanes x;
    for (int l = 0; l < WARP; ++l) x.v[l] = f(l);
    return x;
}
template <class F>
K3_FN void each(F f) {
    for (int l = 0; l < WARP; ++l) f(l);
}
K3_FN int32_t own(const Lanes& x, int l) { return x.v[l]; }
K3_FN int32_t get(const Lanes& x, int src) { return x.v[src]; }
K3_FN uint32_t ballot(const Lanes& x) {
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) m |= (uint32_t)(x.v[l] != 0) << l;
    return m;
}
K3_FN Lanes shift_up(const Lanes& x, int d, int32_t fill) {
    Lanes y;
    for (int l = 0; l < WARP; ++l) y.v[l] = l >= d ? x.v[l - d] : fill;
    return y;
}
#endif

// inclusive scan under an associative op with identity `id`
template <class Op>
K3_FN Lanes scan(Lanes x, int32_t id, Op op) {
    for (int d = 1; d < WARP; d <<= 1) {
        const Lanes y = shift_up(x, d, id);
        x = lanes([&](int l) { return op(own(y, l), own(x, l)); });
    }
    return x;
}

// ------------------------------------------------------------- model state
// A token's effect on (mstate, ctx) as one int32: bits 9..8 the number k
// of model codes it appends (0 or 1; up to 3 once composed), bits 5..0
// those codes, bit 24 "sets ctx", bits 23..16 the ctx byte.  mstate is
// the last three model codes (mstate = (mstate * 4 + code) & 0x3F).
K3_FN int32_t effect(int32_t kind, int32_t a, int32_t c) {
    int32_t code = 1;          // K_MATCH, K_SENT (and any other kind)
    int32_t ctx = c, sets = 1;
    switch (kind) {
        case K_LIT: code = 0; ctx = a; break;
        case K_REP0L1: code = 2; break;
        case K_REP: code = 3; break;
        case K_SENT: sets = 0; break;
        case K_ELIT: code = -1; ctx = a; break;
        case K_END: case K_NONE: case K_INT: case K_FLUSH: case K_RAW:
        case K_DLIT: case K_RLEN: code = -1; sets = 0; break;
        default: break;
    }
    return (code >= 0 ? (1 << 8) | code : 0) |
           (sets ? (1 << 24) | ((ctx & 0xFF) << 16) : 0);
}

// x then y
K3_FN int32_t compose(int32_t x, int32_t y) {
    const int32_t kx = (x >> 8) & 3, ky = (y >> 8) & 3;
    const int32_t k = kx + ky < 3 ? kx + ky : 3;
    const int32_t codes =
        (((x & 63) << (2 * ky)) | (y & 63)) & low_mask(2 * k);
    const int32_t ctx = (y >> 24) & 1 ? y & 0x1FF0000 : x & 0x1FF0000;
    return ctx | (k << 8) | codes;
}

K3_FN int32_t apply_mstate(int32_t e, int32_t mstate) {
    const int32_t k = (e >> 8) & 3;
    return ((mstate << (2 * k)) | (e & 63)) & 63;
}

K3_FN int32_t apply_ctx(int32_t e, int32_t ctx) {
    return (e >> 24) & 1 ? (e >> 16) & 0xFF : ctx;
}

// --------------------------------------------------------------- expansion
// Where a token's records go (small-table offsets as byte addresses from
// pbase).
struct Write {
    uint32_t* p;
    uint32_t pbase;
    K3_FN void rec(uint32_t r) { *p++ = r; }
    K3_FN void bit(uint32_t off, uint32_t v) {
        *p++ = (pbase + 2 * off) | (v ? R_BIT : 0);
    }
};

K3_FN void bit(Write& o, int32_t off, int32_t v) {
    o.bit((uint32_t)off, (uint32_t)v);
}

// a tree of nbits bits, most significant first, from node 1, in the
// small tables or (Delta) in p_delta
template <bool Delta = false>
K3_FN void tree(Write& o, uint32_t base, uint32_t val, int32_t nbits) {
    uint32_t node = 1;
    for (int32_t i = nbits - 1; i >= 0; --i) {
        const uint32_t v = (val >> i) & 1;
        if (Delta) o.rec(R_DELTA | (base + node) | (v ? R_BIT : 0));
        else o.bit(base + node, v);
        node = node * 2 + v;
    }
}

// EncDirect16 (csc_coder.cpp:76-87) of nbits <= 31, as pieces of at most
// 16 bits.  A value may hold bits above nbits: the reference ORs them into
// the bits still buffered (at most 7), so 7 of them are kept.
K3_FN void direct(Write& o, uint32_t val, int32_t nbits) {
    if (nbits > 16) {
        o.rec(R_DIRECT | (uint32_t)(nbits - 16) << 24 |
              ((val >> 16) & low_mask(nbits - 9)));
        val &= 0xFFFF;
        nbits = 16;
    }
    o.rec(R_DIRECT | (uint32_t)nbits << 24 | (val & low_mask(nbits + 7)));
}

// one length value lv <= 143: slot bits then its tree
K3_FN void len_value(Write& o, int32_t lv) {
    bit(o, P_MLSLOT, lv >= 8);
    if (lv < 8) {
        tree(o, P_MLEX1, (uint32_t)lv, 3);
        return;
    }
    bit(o, P_MLSLOT + 1, lv >= 16);
    if (lv < 16) tree(o, P_MLEX2, (uint32_t)(lv - 8), 3);
    else tree(o, P_MLEX3, (uint32_t)(lv - 16), 7);
}

// encode_matchlen_1 / _2 (csc_model.cpp:147-159): a wire length >= 143
// codes 143, a run of long-length bits, then the remainder
K3_FN void length(Write& o, int32_t vb) {
    len_value(o, vb < 143 ? vb : 143);
    if (vb >= 143) {
        for (uint32_t run = (uint32_t)((vb - 143) / 143); run > 0;) {
            const uint32_t k = run < RUN_MAX ? run : RUN_MAX;
            o.rec(R_RUN | k);
            run -= k;
        }
        bit(o, P_LONGLEN, 1);
        len_value(o, (vb - 143) % 143);
    }
}

// distance slot + extra bits (csc_model.cpp:300-345); wire length wl
// picks the slot tree
K3_FN void distance(Write& o, int32_t dist, int32_t wl) {
    int32_t pos, sbits;
    const int32_t w = wl < 6 ? wl : 6;
    if (w <= 0) {
        pos = 0;
        sbits = 3;
    } else if (w <= 2) {
        pos = 16 * (w - 1) + 8;
        sbits = 4;
    } else {
        pos = 32 * (w < 6 ? w - 3 : 3) + 8 + 32;
        sbits = 5;
    }
    const int32_t slot = dist_slot(dist);
    tree(o, P_DIST + pos, (uint32_t)slot, sbits);
    if (slot <= 2) return;
    const int32_t ebits = slot - 2 > 1 ? slot - 2 : 1;
    const int32_t elen = dist - (1 << (ebits < 30 ? ebits : 30)) - 1;
    if (ebits > 4) {
        const int32_t rem = ebits - 4;
        const int32_t dv = elen >> 4;
        if (rem > 16) {
            direct(o, (uint32_t)((dv >> 16) & 0xFFFF), rem - 16);
            direct(o, (uint32_t)(dv & 0xFFFF), 16);
        } else {
            direct(o, (uint32_t)(dv & ((1 << rem) - 1)), rem);
        }
    }
    tree(o, P_MDEXTRA + (ebits - 1) * 16, (uint32_t)rev4(elen & 0xF), 4);
}

// the records of one token under the model state before it
K3_FN void expand(Write& o, int32_t kind, int32_t va, int32_t vb, int32_t vc,
                  int32_t mstate, int32_t ctx) {
    const int32_t pf = P_STATE + mstate * 3;
    switch (kind) {
        case K_INT: {   // EncodeInt (csc_model.cpp:389-414)
            const int32_t slot = va > 1 ? bitlen(va) - 1 : 0;
            direct(o, (uint32_t)slot, 5);
            if (slot == 0) direct(o, (uint32_t)va, 1);
            else direct(o, (uint32_t)(va - (1 << slot)), slot);
            break;
        }
        case K_FLUSH: o.rec(R_FLUSH); break;
        case K_RAW: direct(o, (uint32_t)va, vb); break;
        case K_ELIT:    // CompressLiterals (csc_model.cpp:448-461): no flags
            tree(o, P_LIT + ctx * 256, (uint32_t)va, 8);
            break;
        case K_DLIT:    // CompressRLE (csc_model.cpp:471-513): flag bit,
            bit(o, P_RLEFLAG, 0);   // then a delta literal in p_delta[s_ctx]
            tree<true>(o, (uint32_t)(vb * 256), (uint32_t)va, 8);
            break;
        case K_RLEN:    // or a run length
            bit(o, P_RLEFLAG, 1);
            length(o, vb);
            break;
        case K_LIT:
            bit(o, pf, 0);
            tree(o, P_LIT + ctx * 256, (uint32_t)va, 8);
            break;
        case K_REP0L1:
            bit(o, pf, 1);
            bit(o, pf + 1, 0);
            bit(o, pf + 2, 0);
            break;
        case K_REP: {
            bit(o, pf, 1);
            bit(o, pf + 1, 0);
            bit(o, pf + 2, 1);
            // rep index: 2 bits from node 1 (P_REPDIST + node - 1)
            const int32_t hi = (va >> 1) & 1;
            bit(o, P_REPDIST + mstate * 3, hi);
            bit(o, P_REPDIST + mstate * 3 + 1 + hi, va & 1);
            length(o, vb);
            break;
        }
        default:   // K_MATCH, K_SENT
            bit(o, pf, 1);
            bit(o, pf + 1, 1);
            length(o, vb);
            distance(o, va, vb);
    }
}

// The number of records `expand` writes for a token, in closed form.
K3_FN int32_t len_value_records(int32_t lv) {
    return lv < 8 ? 4 : lv < 16 ? 5 : 9;
}

K3_FN int32_t length_records(int32_t vb) {
    int32_t n = len_value_records(vb < 143 ? vb : 143);
    if (vb >= 143) {
        const uint32_t run = (uint32_t)((vb - 143) / 143);
        n += (int32_t)((run + RUN_MAX - 1) / RUN_MAX) + 1 +
             len_value_records((vb - 143) % 143);
    }
    return n;
}

K3_FN int32_t distance_records(int32_t dist, int32_t wl) {
    const int32_t sbits = wl <= 0 ? 3 : wl <= 2 ? 4 : 5;
    const int32_t slot = dist_slot(dist);
    if (slot <= 2) return sbits;
    const int32_t rem = (slot - 2 > 1 ? slot - 2 : 1) - 4;
    return sbits + 4 + (rem > 16 ? 2 : rem > 0 ? 1 : 0);
}

K3_FN int32_t records(int32_t kind, int32_t va, int32_t vb) {
    switch (kind) {
        case K_INT: {
            const int32_t slot = va > 1 ? bitlen(va) - 1 : 0;
            return 2 + (slot > 16);
        }
        case K_FLUSH: return 1;
        case K_RAW: return vb > 16 ? 2 : 1;
        case K_ELIT: return 8;
        case K_DLIT: case K_LIT: return 9;
        case K_RLEN: return 1 + length_records(vb);
        case K_REP0L1: return 3;
        case K_REP: return 5 + length_records(vb);
        default: return 2 + length_records(vb) + distance_records(va, vb);
    }
}

// Expansion of one stream's tape, a pass at a time (one warp).
struct Expander {
    const int32_t* kind;
    const int32_t* a;
    const int32_t* b;
    const int32_t* c;
    int64_t ntok;
    int64_t t0;            // the next token
    int32_t mstate, ctx;   // the model state before it
    uint32_t pbase;        // the small tables' byte address

    // Expand the next tokens into recs (SLOT entries); returns the
    // header: record count | H_LAST | H_DONE.
    K3_FN int32_t pass(uint32_t* recs) {
        const int64_t base = t0, n = ntok;
        auto tape = [&](const int32_t* x, int32_t past) {
            return lanes(
                [&](int l) { return base + l < n ? x[base + l] : past; });
        };
        const Lanes tk = tape(kind, K_NONE), ta = tape(a, 0), tb = tape(b, 0),
                    tc = tape(c, 0);
        const uint32_t stops = ballot(lanes([&](int l) {
            return own(tk, l) == K_END || own(tk, l) == K_NONE;
        }));
        const int32_t nlive = stops ? 31 - clz32(stops & (0u - stops)) : WARP;
        const int32_t stop_kind = get(tk, nlive & (WARP - 1));
        const Lanes eff = scan(lanes([&](int l) {
            return l < nlive ? effect(own(tk, l), own(ta, l), own(tc, l)) : 0;
        }), 0, [](int32_t x, int32_t y) { return compose(x, y); });
        const Lanes before = shift_up(eff, 1, 0);
        const int32_t ms = mstate, cx = ctx;
        const Lanes cnt = lanes([&](int l) {
            return l < nlive ? records(own(tk, l), own(ta, l), own(tb, l)) : 0;
        });
        const Lanes end =
            scan(cnt, 0, [](int32_t x, int32_t y) { return x + y; });
        const int32_t m = popc32(ballot(lanes([&](int l) {
            return l < nlive && own(end, l) <= CAP;
        })));
        const int32_t nrec = m > 0 ? get(end, m - 1) : 0;
        const int32_t last_eff = m > 0 ? get(eff, m - 1) : 0;
        each([&](int l) {
            if (l < m) {
                const int32_t e = own(before, l);
                Write w{recs + own(end, l) - own(cnt, l), pbase};
                expand(w, own(tk, l), own(ta, l), own(tb, l), own(tc, l),
                       apply_mstate(e, ms), apply_ctx(e, cx));
            }
            if (l == 0)
                for (int32_t j = nrec; j < ((nrec + 3) & ~3) + 4; ++j)
                    recs[j] = R_NOP;
        });
        mstate = apply_mstate(last_eff, ms);
        ctx = apply_ctx(last_eff, cx);
        t0 = base + m;
        const bool last = stops != 0 && m == nlive;
        return nrec | (last ? H_LAST : 0) |
               (last && stop_kind == K_END ? H_DONE : 0);
    }
};

// ------------------------------------------------------------------- walk
// The probability tables: the small trees and p_lit at byte addresses
// (nvcc: shared addresses, read and written with 32-bit addressing),
// p_delta by index.
struct Tables {
    uint8_t* probs;     // NPROB_MAIN entries, all 2048 at the start,
                        // minus their byte address
    uint16_t* pdelta;   // NPROB_DELTA entries, all 2048 at the start

    K3_FN uint32_t ld(uint32_t a) const {
#ifdef __CUDA_ARCH__
        unsigned short v;
        asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
        return v;
#else
        return *(const uint16_t*)(probs + a);
#endif
    }

    K3_FN void st(uint32_t a, uint32_t v) const {
#ifdef __CUDA_ARCH__
        asm volatile("st.shared.u16 [%0], %1;" ::"r"(a), "h"((unsigned short)v)
                     : "memory");
#else
        *(uint16_t*)(probs + a) = (uint16_t)v;
#endif
    }

    // the probability a coded-bit record names (0 for other records)
    K3_FN uint32_t fetch(uint32_t r) const {
        if (r & R_TYPE) return 0;
        return r & R_DELTA ? pdelta[r & R_OFF] : ld(r & R_OFF);
    }

    K3_FN void store(uint32_t r, uint32_t v) const {
        if (r & R_DELTA) pdelta[r & R_OFF] = (uint16_t)v;
        else st(r & R_OFF, v);
    }
};

// EncodeBit's adaptation (csc_coder.h:67-81): shift 5 towards 0 or 0xFFF
K3_FN uint32_t adapt(uint32_t p, uint32_t bit) {
    return bit ? p + ((0xFFF - p) >> 5) : p - (p >> 5);
}

struct Rec4 {
    uint32_t x, y, z, w;
};

// A pass's records for the walk and the coder: nvcc reads and writes them
// at their 32-bit shared address sa, g++ through the pointer p.
struct Ring {
    uint32_t* p;
    uint32_t sa;
    K3_FN uint32_t at(int32_t i) const {
#ifdef __CUDA_ARCH__
        uint32_t x;
        asm volatile("ld.shared.u32 %0, [%1];" : "=r"(x) : "r"(sa + 4 * i));
        return x;
#else
        return p[i];
#endif
    }
    // records 4g .. 4g + 3 (16-byte aligned)
    K3_FN Rec4 group(int32_t g) const {
#ifdef __CUDA_ARCH__
        Rec4 x;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                     : "r"(sa + 16 * g));
        return x;
#else
        return Rec4{p[4 * g], p[4 * g + 1], p[4 * g + 2], p[4 * g + 3]};
#endif
    }
    K3_FN void set(int32_t i, uint32_t x) const {
#ifdef __CUDA_ARCH__
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(sa + 4 * i), "r"(x)
                     : "memory");
#else
        p[i] = x;
#endif
    }
};

// One expanded record under the probability p it names (if a coded bit):
// the walked record; adapts the table.
K3_FN uint32_t walk1(const Tables& t, uint32_t r, uint32_t p, uint32_t plong) {
    const uint32_t type = r & R_TYPE;
    if (type == 0) {
        const uint32_t bit = (r >> 18) & 1;
        t.store(r, adapt(p, bit));
        return p | bit << 12;
    }
    if (type == R_RUN) {
        const uint32_t k = r & RUN_MAX;
        const uint32_t p0 = t.ld(plong);
        uint32_t q = p0;
        for (uint32_t j = 0; j < k; ++j) q -= q >> 5;
        t.st(plong, q);
        return R_RUN | k << 12 | p0;
    }
    return r;
}

// Two consecutive small-table bits at i: both probabilities are loaded
// before either is stored (two records in a row never name one address).
K3_FN void walk_bits(const Tables& t, Ring q, int32_t i, uint32_t ra,
                     uint32_t rb) {
    const uint32_t pa = t.ld(ra & R_OFF), pb = t.ld(rb & R_OFF);
    const uint32_t ba = (ra >> 18) & 1, bb = (rb >> 18) & 1;
    t.st(ra & R_OFF, adapt(pa, ba));
    t.st(rb & R_OFF, adapt(pb, bb));
    q.set(i, pa | ba << 12);
    q.set(i + 1, pb | bb << 12);
}

// Rewrite a pass's n records in place (the expander pads it with no-ops
// to whole groups of four), a group at a time, read a group ahead.  A
// group of small-table bits runs as two pairs with no branch; any other
// group (with a p_delta bit, a run, a direct write or a flush) takes its
// records one after the other, so after a run the closing bit (P_LONGLEN
// too) loads what the run stored.
K3_FN void walk(const Tables& t, Ring q, int32_t n, uint32_t plong) {
    uint32_t r0 = q.at(0), r1 = q.at(1), r2 = q.at(2), r3 = q.at(3);
    for (int32_t i = 0; i < n; i += 4) {
        const uint32_t n0 = q.at(i + 4), n1 = q.at(i + 5), n2 = q.at(i + 6),
                       n3 = q.at(i + 7);
        if (((r0 | r1 | r2 | r3) & (R_TYPE | R_DELTA)) == 0) {
            walk_bits(t, q, i, r0, r1);
            walk_bits(t, q, i + 2, r2, r3);
        } else {
            q.set(i, walk1(t, r0, t.fetch(r0), plong));
            q.set(i + 1, walk1(t, r1, t.fetch(r1), plong));
            q.set(i + 2, walk1(t, r2, t.fetch(r2), plong));
            q.set(i + 3, walk1(t, r3, t.fetch(r3), plong));
        }
        r0 = n0;
        r1 = n1;
        r2 = n2;
        r3 = n3;
    }
}

// ------------------------------------------------------------------ coder
struct Out {
    uint8_t* rc_out;          // max_rc bytes
    int32_t max_rc;
    uint8_t* bc_out;          // max_bc bytes
    int32_t max_bc;
    int32_t* rc_map;          // [nmap] bc_cnt at each rc bsize crossing
    int32_t* bc_map;          // [nmap] rc_cnt at each bc bsize crossing
    int32_t nmap;
    int32_t* chunk_log;       // [nchunk][2] (rc_cnt, bc_cnt) after a flush
    int32_t nchunk;
    int32_t bsize;
};

struct Result {
    int32_t rc_cnt, bc_cnt, chunk_cnt, done, err;
};

struct Coder {
    Out s;
    Ring tops;                // CAP + 1 entries: deferred ShiftLows
    int32_t ntop;
    uint64_t low;             // the carry in bit 32
    uint32_t range, bc_val;
    int32_t cache, cachesize, bc_bits;
    int32_t rc_cnt, bc_cnt, chunk_cnt;
    int32_t rc_left, bc_left;   // bytes to the next bsize crossing
    int32_t rc_blk, bc_blk;     // crossings so far

    K3_FN void init(const Out& o, Ring t) {
        s = o;
        tops = t;
        ntop = 0;
        rc_cnt = bc_cnt = chunk_cnt = 0;
        rc_left = bc_left = o.bsize;
        rc_blk = bc_blk = 0;
        reset();
    }

    K3_FN void reset() {
        low = 0;
        range = 0xFFFFFFFFu;
        cache = 0;
        cachesize = 1;
        bc_val = 0;
        bc_bits = 0;
    }

    K3_FN void put_rc(uint32_t byte) {
        s.rc_out[rc_cnt < s.max_rc ? rc_cnt : s.max_rc - 1] = (uint8_t)byte;
        ++rc_cnt;
        if (--rc_left == 0) {
            rc_left = s.bsize;
            s.rc_map[rc_blk < s.nmap ? rc_blk : s.nmap - 1] = bc_cnt;
            ++rc_blk;
        }
    }

    K3_FN void put_bc(uint32_t byte) {
        s.bc_out[bc_cnt < s.max_bc ? bc_cnt : s.max_bc - 1] = (uint8_t)byte;
        ++bc_cnt;
        if (--bc_left == 0) {
            bc_left = s.bsize;
            s.bc_map[bc_blk < s.nmap ? bc_blk : s.nmap - 1] = rc_cnt;
            ++bc_blk;
        }
    }

    // RC_ShiftLow (csc_coder.cpp:89-112) of the top of low: v = bits 32..24
    // (the carry and the byte that leaves low)
    K3_FN void top(uint32_t v) {
        if (v != 0xFF) {
            const uint32_t carry = v >> 8;
            put_rc((cache + carry) & 0xFF);
            for (; cachesize > 1; --cachesize) put_rc((0xFF + carry) & 0xFF);
            cache = (int32_t)(v & 0xFF);
            cachesize = 0;
        }
        ++cachesize;
    }

    K3_FN void shift_low() {
        top((uint32_t)(low >> 24) & 0x1FF);
        low = (low & 0x00FFFFFFu) << 8;
    }

    // the ShiftLows the coded bits deferred, in order
    K3_FN void drain() {
        for (int32_t j = 0; j < ntop; ++j) top(tops.at(j));
        ntop = 0;
    }

    // EncodeBit (csc_coder.h:67-81) under a 12-bit probability
    K3_FN void code_bit(uint32_t p, bool v) {
        const uint32_t bound = (range >> 12) * p;
        low += v ? 0 : bound;
        range = v ? bound : range - bound;
        if (range < (1u << 24)) {
            range <<= 8;
            shift_low();
        }
    }

    // EncodeBit without a branch: the normalization's ShiftLow is deferred
    // (its top of low kept in `tops`), a no-op under probability 0 and bit
    // 0.  Until the next drain only coded bits run, which write nothing
    // but rc bytes, so the bytes and crossings come out as without it.
    K3_FN void defer_bit(uint32_t p, bool v) {
        const uint32_t bound = (range >> 12) * p;
        low += v ? 0 : bound;
        range = v ? bound : range - bound;
        const bool norm = range < (1u << 24);
        tops.set(ntop, (uint32_t)(low >> 24) & 0x1FF);
        ntop += norm;
        low = norm ? (low & 0x00FFFFFFu) << 8 : low;
        range = norm ? range << 8 : range;
    }

    // Coder::Flush (csc_coder.cpp:40-74), then a coder reset; the
    // probabilities persist (csc_encoder_main.cpp:141-145)
    K3_FN void flush() {
        for (int i = 0; i < 5; ++i) shift_low();
        put_bc(bc_bits > 0 ? (bc_val << (8 - bc_bits)) & 0xFF : 0);
        put_bc(0);
        const int32_t ci = chunk_cnt < s.nchunk ? chunk_cnt : s.nchunk - 1;
        s.chunk_log[2 * ci] = rc_cnt;
        s.chunk_log[2 * ci + 1] = bc_cnt;
        ++chunk_cnt;
        reset();
    }

    // every walked record but a coded bit
    K3_FN void slow(uint32_t r) {
        switch (r & R_TYPE) {
            case R_DIRECT: {   // EncDirect16 (csc_coder.cpp:76-87)
                const int32_t n = (r >> 24) & 31;
                bc_val = (bc_val << n) | (r & 0xFFFFFF);
                bc_bits += n;
                while (bc_bits >= 8) {
                    put_bc((bc_val >> (bc_bits - 8)) & 0xFF);
                    bc_bits -= 8;
                }
                break;
            }
            case R_RUN: {
                uint32_t p = r & 0xFFF;
                for (uint32_t k = (r >> 12) & RUN_MAX; k > 0; --k) {
                    code_bit(p, false);
                    p -= p >> 5;
                }
                break;
            }
            default: flush();
        }
    }

    // One walked record: the coded-bit step runs for every record (a no-op
    // for the others), then any other record after a drain.
    K3_FN void code(uint32_t r) {
        const bool bit_rec = (r & R_TYPE) == 0;
        defer_bit(bit_rec ? r & 0xFFF : 0, bit_rec && (r & (1u << 12)));
        if (!bit_rec) {
            drain();
            slow(r);
        }
    }

    // Code one walked pass of n records (the expander pads it with no-ops
    // to whole groups of four), a group at a time, read a group ahead.  A
    // group of coded bits runs with no branch taken; any other group goes
    // record by record.
    K3_FN void code(Ring q, int32_t n) {
        Rec4 cur = q.group(0);
        for (int32_t g = 0; 4 * g < n; ++g) {
            const Rec4 next = q.group(g + 1);
            if (((cur.x | cur.y | cur.z | cur.w) & R_TYPE) == 0) {
                defer_bit(cur.x & 0xFFF, cur.x & (1u << 12));
                defer_bit(cur.y & 0xFFF, cur.y & (1u << 12));
                defer_bit(cur.z & 0xFFF, cur.z & (1u << 12));
                defer_bit(cur.w & 0xFFF, cur.w & (1u << 12));
            } else {
                code(cur.x);
                code(cur.y);
                code(cur.z);
                code(cur.w);
            }
            cur = next;
        }
        drain();
    }

    K3_FN Result result(int32_t done) const {
        const int32_t err = (rc_cnt >= s.max_rc || bc_cnt >= s.max_bc)
                                ? ERR_OVERFLOW : 0;
        return Result{rc_cnt, bc_cnt, chunk_cnt, done, err};
    }
};

}  // namespace k3
