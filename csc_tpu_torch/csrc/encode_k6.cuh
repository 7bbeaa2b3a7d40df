// K6: per-stream exact optimal parse of m3-m5, priced by the live
// model, one warp a stream: golden's compress_advanced (csc_lz.cpp:
// 207-362, golden/lz.py:156-295) over csc_mf.cpp's finders (the hash
// chains of m3 / m4, the binary tree of m5), with the run walk,
// duplicate-block probe and sparse insertion of CSCEncoder::Compress, so
// the tape it writes codes, through the stitch and K3, the reference
// encoder's own bytes.
//
// The finder, the window of hashes, the slide, the walk, the probe and
// the sparse insertion are K5's (encode_k5.cuh, `k5::Parser`): K6 holds
// one and calls it.
// What is new is the optimal parse and the model it reads:
//
//   - a stretch of at most AP_LIMIT positions of an 8 KB piece is a
//     shortest-path DP: at each position a find (K5's `find_records`,
//     its records in lane order, which is find_match's candidate list),
//     priced at the state and rep queue the cell's best path leaves
//     (find_match_with_price, golden/mf.py:529-560); the cell of each
//     length 2 .. len - 1 is relaxed by lane `length`, so a find's
//     lengths relax in one pass; the literal and rep0len1 relax the
//     next cell;
//   - the stretch ends at golden's exits (the immediate literal, the
//     literal tail at the frontier, a match of good_len or one reaching
//     the cap); its back-walk then codes its tokens in order;
//   - every coded event adapts the shadow model in stream order: the
//     tokens, an LZ run's sentinel (EncodeMatch(64, 0)), a DT_ENTROPY
//     run's literals (CompressLiterals, p_lit and ctx) and a DT_DLT run's
//     delta runs past 10 bytes (CompressRLE through the matchlen trees;
//     the run's delta filter and its scan are made here);
//   - prices (golden/model.py:264-346): the literal flag and tree (the
//     previous window byte as context; the coding context is the
//     model's ctx), rep0len1, a rep's flags and index, a match's flag
//     pair and slot alone (256 at slots 0-2), and the length price from
//     a cache of 32, rebuilt from the matchlen trees by the counted call
//     that finds its counter at 0 (every 4 097 counted calls; a call
//     skipped by the distance gate does not count); lanes price their
//     lengths at once, so the lanes before the rebuilding call in lane
//     order read the old cache and the others the new one.
//
// The model's small trees (p_state, p_repdist, the matchlen trees, 530
// probabilities), the length cache and the p_2_bits table sit in shared
// memory; p_lit (64 K probabilities a stream) and the stretch's cells
// (AP_LIMIT + 1 of them: price, back pointer, distance code, the walk's
// next pointer, state and rep queue) in device memory, a slice a stream.
// Lane 0 writes the model's probabilities and the tape, the others wait
// at a __syncwarp before they read them again; the lanes of a DT_ENTROPY
// run's literals each adapt one level of the literal tree (no two levels
// share a probability).
//
// m5 (BT, an instantiation of its own: the parse of m3 / m4 keeps its
// code): K5's finder with the binary tree (encode_k5.cuh, `BT`), whose
// records past the lanes' are the tree's; find_match keeps 30 of them
// (MF_CAND_LIMIT).  A find relaxes lengths 2 .. good_len - 1 = 47, two a
// lane: lane l the lengths l and 32 + l; a length of 34 or more prices
// 768 and makes no call of the length cache (GetMatchLenPrice), so the
// calls are the lengths up to 33, the low half's before the high half's.
// Where golden's tree raises IndexError (a link past 2 * bt_size,
// ops/exact_ap_scan.py), the finder sets bt_bad and the parse ends
// before it codes anything more (done 0, err ERR_BT).
//
// The ring (RING, an instantiation of its own beside each of the two
// above, chosen per stream by size > dict_size, so that a stream its
// dictionary covers keeps its code and registers): a stream longer than
// its dictionary meets golden's ring window, whose rules are K5's
// (encode_k5.cuh, "The ring"): pieces cut at the ring's end, the
// previous lap's bytes past a piece's end, no source across the ring's
// end (the tree's compares too); the optimal parse adds one, the literal
// price's context is 0 at ring position 0 (golden/lz.py:269; the coding
// context is still the model's ctx).
//
// The tape is a capacity: a token past it ends the parse (done 0, err
// ERR_OVERFLOW, tok_cnt the capacity).  K6 has no step budget: csc_tpu
// has no device loop for these streams (it codes them with golden).
//
// The same source builds with nvcc (encode_k6.cu) and with g++ (the
// test harness encode_k6_host.cpp), as K5's does; the CPU tests hold it
// against the plain version (csc_tpu_torch/ops/exact_ap_scan.py): the
// same tape words over the first tok_cnt tokens, the same tok_cnt, done,
// err and block types.
#pragma once
#include "encode_k5.cuh"

namespace k6 {

// a phase mark of K6's phase-clock build (k5::K6Phase), else nothing
#if defined(K6_PHASES) && defined(__CUDA_ARCH__)
#define K6_MARK(i) f.k6_phase(i)
#else
#define K6_MARK(i)
#endif

using k5::Lanes;
using k5::ballot;
using k5::each;
using k5::gather;
using k5::get;
using k5::lanes;
using k5::leader;
using k5::own;
using k5::popc;
using k5::set;
using k5::sync;

constexpr int32_t AP_LIMIT = 2048;          // csc_lz.h:43
constexpr int32_t CELLS = AP_LIMIT + 8;     // a cell row, padded
constexpr uint32_t INF = 0xFFFFFFFFu;
constexpr int32_t MAX_GOOD = 32;            // a length a lane
constexpr int32_t MAX_GOOD_BT = 48;         // two lengths a lane (m5)
constexpr int32_t CAND_SLOTS = 30;          // find_match's records read
constexpr int32_t ERR_BT = 3;               // golden's tree IndexError
// the cells' rows
enum { C_PRICE, C_BACK, C_DIST, C_NEXT, C_STATE, C_REP, NFIELD = C_REP + 4 };
// the small trees, in one array of probabilities
constexpr int32_t M_STATE = 0;      // p_state [64 * 3]
constexpr int32_t M_REPD = 192;     // p_repdist [64 * 3]
constexpr int32_t M_SLOT = 384;     // p_matchlen_slot [2]
constexpr int32_t M_X1 = 386;       // p_matchlen_extra1 [8]
constexpr int32_t M_X2 = 394;       // p_matchlen_extra2 [8]
constexpr int32_t M_X3 = 402;       // p_matchlen_extra3 [128]
constexpr int32_t M_SMALL = 530;
constexpr int32_t NLIT = 256 * 256;
constexpr int32_t NP2B = 512;
constexpr int32_t PROB_INIT = 2048;
constexpr int32_t DT_ENTROPY = 7;
constexpr int32_t DT_DLT = 16;

// K6's stream: K5's (its lazy flag and step budget unused, its tape
// K6's) and the model's and the cells' memory
struct Stream {
    k5::Stream s;
    uint16_t* small;       // [M_SMALL]
    int32_t* lenp;         // [32], the length-price cache
    uint16_t* p2b;         // [NP2B], the p_2_bits table
    uint16_t* lit;         // [NLIT]
    int32_t* cells;        // [NFIELD][CELLS]
    // the binary tree (m5): head [1 << bits], links [2 * min(bt_size,
    // n + 1)], size and cycles
    int32_t* bt_head;
    int32_t* bt_nodes;
    int32_t bt_size, bt_cyc;
};

struct Result {
    int32_t tok_cnt, done, err;
};

// a find priced: ret[0] (len, code: 0 a literal, 1-4 a rep, else 4 +
// the distance), rep0len1's ret[1], and lane L's ret[L] for L in [2,
// len] (code 0: none); with the tree, lane l's ret[32 + l] too
struct Found {
    int32_t len, code;
    bool r01;
    uint32_t r01p;
    Lanes code_at, price_at;
    Lanes code_hi, price_hi;
};

template <bool STAGED, bool NOLZ, bool BT, bool RING = false>
struct ApParser {
    k5::Parser<STAGED, NOLZ, RING, BT> f;
    Stream x;
    int32_t state, ctx, lp;  // the model's pack state, context, counter
    int32_t tok;
    bool full;               // a token past the tape's capacity

    // ------------------------------------------------------------- model
    K5_FN uint32_t fprice(int32_t v, int32_t p) const {
        return x.p2b[v ? p >> 3 : (4096 - p) >> 3];
    }

    // one coded bit's adaptation (csc_coder.h:67-81), by lane 0
    K5_FN void bit(uint16_t* a, int32_t i, int32_t v) {
        if (!leader()) return;
        const int32_t p = a[i];
        a[i] = (uint16_t)(v ? p + ((0xFFF - p) >> 5) : p - (p >> 5));
    }

    // the bits of c below its leading 1 (bit `top`), MSB first, each
    // through a[base + its prefix]
    K5_FN void tree(uint16_t* a, int32_t base, int32_t c, int32_t top) {
        for (int32_t k = top - 1; k >= 0; --k)
            bit(a, base + (c >> (k + 1)), (c >> k) & 1);
    }

    // encode_matchlen_1 / _2 (csc_model.cpp:113-159; p_longlen's bits
    // are not kept)
    K5_FN void matchlen1(int32_t len) {
        uint16_t* m = x.small;
        if (len < 8) {
            bit(m, M_SLOT, 0);
            tree(m, M_X1, len | 8, 3);
        } else if (len < 16) {
            bit(m, M_SLOT, 1);
            bit(m, M_SLOT + 1, 0);
            tree(m, M_X2, (len - 8) | 8, 3);
        } else {
            bit(m, M_SLOT, 1);
            bit(m, M_SLOT + 1, 1);
            tree(m, M_X3, (len - 16) | 0x80, 7);
        }
    }

    K5_FN void matchlen(int32_t len) {
        if (len >= 143) {
            matchlen1(143);
            len = (len - 143) % 143;
        }
        matchlen1(len);
    }

    K5_FN void flags(int32_t n, int32_t bits) {
        for (int32_t k = 0; k < n; ++k)
            bit(x.small, M_STATE + state * 3 + k, (bits >> k) & 1);
    }

    // one token (encode_nonlit's coordinates) on the tape and through the
    // model; `last` the byte at its end (a literal's own)
    K5_FN void token(int32_t len, int32_t dist, int32_t last) {
        if (dist == 0) {
            put(k5::K_LIT, 0);
            flags(1, 0);
            state = (state * 4) & 0x3F;
            tree(x.lit, ctx * 256, last | 0x100, 8);
        } else if (dist == 1 && len == 1) {
            put(k5::K_REP0L1, 0);
            flags(3, 1);
            state = (state * 4 + 2) & 0x3F;
        } else if (dist <= 4) {
            put(k5::K_REP | (len - 2) << 3, dist - 1);
            flags(3, 5);
            const int32_t j = ((dist - 1) >> 1) & 1;
            bit(x.small, M_REPD + state * 3, j);
            bit(x.small, M_REPD + state * 3 + 1 + j, (dist - 1) & 1);
            matchlen(len - 2);
            state = (state * 4 + 3) & 0x3F;
        } else {
            put(k5::K_MATCH | (len - 2) << 3, dist - 5);
            match(len - 2);
        }
        ctx = last;
    }

    // EncodeMatch's model part (its distance bits adapt no price)
    K5_FN void match(int32_t lenw) {
        flags(2, 3);
        matchlen(lenw);
        state = (state * 4 + 1) & 0x3F;
    }

    K5_FN void put(int32_t w0, int32_t w1) {
        if (full) return;
        if (tok >= x.s.tcap) {
            full = true;
            return;
        }
        if (leader()) {
            x.s.tape[2 * (int64_t)tok] = w0;
            x.s.tape[2 * (int64_t)tok + 1] = w1;
        }
        ++tok;
    }

    // ------------------------------------------------------------ prices
    // GetLiteralPrice: the flag, then c's tree under context pctx, a
    // level a lane
    K5_FN uint32_t lit_price(int32_t st, int32_t pctx, int32_t c) const {
        const uint16_t* p = x.lit + pctx * 256;
        const int32_t t = k5::sum_all(lanes([&](int l) -> int32_t {
            if (l >= 8) return 0;
            const int32_t node = (c | 0x100) >> (8 - l);
            return (int32_t)fprice((c >> (7 - l)) & 1, p[node]);
        }));
        return fprice(0, x.small[M_STATE + st * 3]) + (uint32_t)t;
    }

    K5_FN uint32_t r01_price(int32_t st) const {
        const uint16_t* s = x.small + M_STATE + st * 3;
        return fprice(1, s[0]) + fprice(0, s[1]) + fprice(0, s[2]);
    }

    // GetRepDistPrice
    K5_FN uint32_t repd_price(int32_t st, int32_t idx) const {
        const uint16_t* s = x.small + M_STATE + st * 3;
        const uint16_t* r = x.small + M_REPD + st * 3;
        const int32_t j = (idx >> 1) & 1;
        return fprice(1, s[0]) + fprice(0, s[1]) + fprice(1, s[2])
             + fprice(j, r[0]) + fprice(idx & 1, r[1 + j]);
    }

    // GetMatchDistPrice of distance code d - 1 (slot-only)
    K5_FN uint32_t matchd_price(int32_t st, int32_t d) const {
        const uint16_t* s = x.small + M_STATE + st * 3;
        const int32_t c = d - 1;
        int32_t slot = c < 2 ? (c < 0 ? 0 : c)
                             : 2 + k5::top32((uint32_t)(c - 1));
        slot = slot > 31 ? 31 : slot;
        return fprice(1, s[0]) + fprice(1, s[1])
             + (uint32_t)((slot > 2 ? slot + 2 : 2) * 128);
    }

    // len_price_rebuild (csc_model.cpp:234-270): lane i's price of
    // length i from the matchlen trees as they stand
    K5_FN Lanes rebuild() const {
        const uint16_t* m = x.small;
        return lanes([&](int l) -> int32_t {
            uint32_t ret;
            if (l < 8) {
                ret = fprice(0, m[M_SLOT]);
                const int32_t c = l | 8;
                for (int32_t k = 2; k >= 0; --k)
                    ret += fprice((c >> k) & 1, m[M_X1 + (c >> (k + 1))]);
            } else if (l < 16) {
                ret = fprice(1, m[M_SLOT]) + fprice(0, m[M_SLOT + 1]);
                const int32_t c = (l - 8) | 8;
                for (int32_t k = 2; k >= 0; --k)
                    ret += fprice((c >> k) & 1, m[M_X2 + (c >> (k + 1))]);
            } else {
                ret = fprice(1, m[M_SLOT]) + fprice(1, m[M_SLOT + 1]);
                const int32_t c = (l - 16) | 0x80;
                for (int32_t k = 6; k >= 0; --k)
                    ret += fprice((c >> k) & 1, m[M_X3 + (c >> (k + 1))]);
            }
            return (int32_t)ret;
        });
    }

    // find_match_with_price at ppos (limit bytes to the piece's end),
    // priced at state st with the rep queue in f.reps
    K5_FN void find_priced(int32_t st, int32_t ppos, int32_t limit,
                           Found& o) {
        K6_COUNT(k5::Q_FINDS);
        if constexpr (BT) {
            find_priced_bt(st, ppos, limit, o);
            return;
        }
        Lanes len, dist;
        uint32_t recs = 0;
        f.find_records(ppos, limit, len, dist, recs);  // no budget to pass
        K6_MARK(k5::Q_FIND);
        const int32_t top = recs ? k5::top32(recs) : 0;
        const int32_t tl = get(len, top), td = get(dist, top);
        o.len = recs ? tl : 1;
        o.code = recs ? (top < 4 ? top + 1 : td + 4) : 0;
        o.r01 = false;
        if (o.len >= f.s.good_len) return;   // ret[0] alone
        o.r01 = recs & 1;
        o.r01p = o.r01 ? r01_price(st) : 0;
        // lane L in [2, len] takes the first record that reaches L
        Lanes rj = lanes([&](int) -> int32_t { return -1; });
        for (uint32_t m = recs; m; m &= m - 1) {
            const int32_t j = k5::ctz32(m);
            const int32_t lj = get(len, j);
            each([&](int l) {
                if (own(rj, l) < 0 && l >= 2 && l <= lj) set(rj, l, j);
            });
        }
        const Lanes dj = gather(dist, lanes([&](int l) -> int32_t {
            return own(rj, l) < 0 ? 0 : own(rj, l);
        }));
        // the distance gate at lengths up to 6 (MF_DIST_BOUND): no price,
        // no call of the length cache
        const Lanes ok = lanes([&](int l) -> int32_t {
            const int32_t j = own(rj, l);
            return j >= 0 && (j < 4 || l > 6
                              || (uint32_t)own(dj, l)
                                  < (uint32_t)k5::dist_bound(l));
        });
        const uint32_t calls = ballot(ok);
        const int32_t total = popc(calls);
        // the cache as the calls find it: the (lp + 1)-th rebuilds it
        Lanes lenp = lanes([&](int l) -> int32_t {
            return own(ok, l) ? x.lenp[l - 2] : 0;
        });
        if (total > lp) {
            const Lanes fresh = rebuild();
            const Lanes fresh2 = gather(fresh, lanes([&](int l) -> int32_t {
                return l >= 2 ? l - 2 : 0;
            }));
            sync();
            each([&](int l) {
                x.lenp[l] = own(fresh, l);
                if (own(ok, l) && popc(calls & ((1u << l) - 1)) >= lp)
                    set(lenp, l, own(fresh2, l));
            });
            sync();
            lp = 4096 - (total - lp - 1);
        } else {
            lp -= total;
        }
        o.code_at = lanes([&](int l) -> int32_t {
            const int32_t j = own(rj, l);
            return !own(ok, l) ? 0 : j < 4 ? j + 1 : own(dj, l) + 4;
        });
        o.price_at = lanes([&](int l) -> int32_t {
            const int32_t j = own(rj, l);
            if (!own(ok, l)) return 0;
            const uint32_t d = j < 4 ? repd_price(st, j)
                                     : matchd_price(st, own(dj, l));
            return (int32_t)(d + (uint32_t)own(lenp, l));
        });
        K6_MARK(k5::Q_PRICE);
    }

    // the distance price of record code c (a rep's or a match's)
    K5_FN uint32_t dist_price(int32_t st, int32_t c) const {
        return c <= 4 ? repd_price(st, c - 1) : matchd_price(st, c - 4);
    }

    // find_priced with the tree: the records in find_match's order
    // (rep0len1's, the lanes', the tree's), the first CAND_SLOTS read;
    // lengths 2 .. len - 1 in two halves, lane l the lengths l and 32 + l
    K5_FN void find_priced_bt(int32_t st, int32_t ppos, int32_t limit,
                              Found& o) {
        Lanes len, dist;
        uint32_t recs = 0;
        f.find_records(ppos, limit, len, dist, recs);
        if (f.bt_bad) return;
        const int32_t r01 = recs & 1;
        const int32_t nl = r01 + popc(recs);
        const int32_t nv = nl + f.bn < CAND_SLOTS ? nl + f.bn : CAND_SLOTS;
        // record e's length and code in lane e
        const Lanes tl = gather(f.bl, lanes([&](int l) -> int32_t {
            return l >= nl ? l - nl : 0;
        }));
        const Lanes td = gather(f.bd, lanes([&](int l) -> int32_t {
            return l >= nl ? l - nl : 0;
        }));
        Lanes ulen = lanes([&](int l) -> int32_t {
            return l >= nl && l < nv ? own(tl, l) : l == 0 && r01;
        });
        Lanes ucode = lanes([&](int l) -> int32_t {
            return l >= nl && l < nv ? own(td, l) + 4 : l == 0 && r01;
        });
        int32_t e = r01;
        for (uint32_t m = recs; m; m &= m - 1, ++e) {
            const int32_t j = k5::ctz32(m);
            const int32_t lj = get(len, j);
            const int32_t cj = j < 4 ? j + 1 : get(dist, j) + 4;
            each([&](int l) {
                if (l == e) {
                    set(ulen, l, lj);
                    set(ucode, l, cj);
                }
            });
        }
        o.len = nv ? get(ulen, nv - 1) : 1;
        o.code = nv ? get(ucode, nv - 1) : 0;
        o.r01 = false;
        if (o.len >= f.s.good_len) return;   // ret[0] alone
        o.r01 = r01;
        o.r01p = r01 ? r01_price(st) : 0;
        // the first record that reaches each length
        Lanes rlo = lanes([&](int) -> int32_t { return -1; });
        Lanes rhi = rlo;
        for (int32_t q = r01; q < nv; ++q) {
            const int32_t lq = get(ulen, q);
            each([&](int l) {
                if (own(rlo, l) < 0 && l >= 2 && l <= lq) set(rlo, l, q);
                if (own(rhi, l) < 0 && 32 + l <= lq) set(rhi, l, q);
            });
        }
        const Lanes clo = gather(ucode, lanes([&](int l) -> int32_t {
            return own(rlo, l) < 0 ? 0 : own(rlo, l);
        }));
        const Lanes chi = gather(ucode, lanes([&](int l) -> int32_t {
            return own(rhi, l) < 0 ? 0 : own(rhi, l);
        }));
        // the distance gate at lengths up to 6; counted calls of the
        // length cache: the low half's, then lengths 32 and 33
        const Lanes ok = lanes([&](int l) -> int32_t {
            const int32_t c = own(clo, l);
            return own(rlo, l) >= 0
                && (c <= 4 || l > 6
                    || (uint32_t)(c - 4) < (uint32_t)k5::dist_bound(l));
        });
        const uint32_t calls = ballot(ok);
        const uint32_t calls_hi = ballot(lanes([&](int l) -> int32_t {
            return l < 2 && own(rhi, l) >= 0;
        }));
        const int32_t nlo = popc(calls);
        const int32_t total = nlo + popc(calls_hi);
        Lanes plo = lanes([&](int l) -> int32_t {
            return own(ok, l) ? x.lenp[l - 2] : 0;
        });
        Lanes phi = lanes([&](int l) -> int32_t {
            return calls_hi >> l & 1 ? x.lenp[30 + l] : 128 * 6;
        });
        if (total > lp) {
            const Lanes fresh = rebuild();
            const Lanes flo = gather(fresh, lanes([&](int l) -> int32_t {
                return l >= 2 ? l - 2 : 0;
            }));
            const Lanes fhi = gather(fresh, lanes([&](int l) -> int32_t {
                return l < 2 ? 30 + l : 0;
            }));
            sync();
            each([&](int l) {
                x.lenp[l] = own(fresh, l);
                if (own(ok, l) && popc(calls & ((1u << l) - 1)) >= lp)
                    set(plo, l, own(flo, l));
                if ((calls_hi >> l & 1)
                    && nlo + popc(calls_hi & ((1u << l) - 1)) >= lp)
                    set(phi, l, own(fhi, l));
            });
            sync();
            lp = 4096 - (total - lp - 1);
        } else {
            lp -= total;
        }
        o.code_at = lanes([&](int l) -> int32_t {
            return own(ok, l) ? own(clo, l) : 0;
        });
        o.price_at = lanes([&](int l) -> int32_t {
            return own(ok, l) ? (int32_t)(dist_price(st, own(clo, l))
                                          + (uint32_t)own(plo, l)) : 0;
        });
        o.code_hi = lanes([&](int l) -> int32_t {
            return own(rhi, l) >= 0 ? own(chi, l) : 0;
        });
        o.price_hi = lanes([&](int l) -> int32_t {
            return own(rhi, l) >= 0 ? (int32_t)(dist_price(st, own(chi, l))
                                                + (uint32_t)own(phi, l))
                                    : 0;
        });
        K6_MARK(k5::Q_PRICE);
    }

    // ------------------------------------------------------------- cells
    K5_FN int32_t* cell(int32_t field) const {
        return x.cells + (int64_t)field * CELLS;
    }

    // ap_backward (csc_lz.cpp:335-362): the stretch at wpos's path from
    // cell `end` back, its tokens coded in order; the rep queue the end
    // cell's
    K5_FN void backward(int32_t wpos, int32_t end) {
        const int32_t* back = cell(C_BACK);
        const int32_t* dist = cell(C_DIST);
        int32_t* nxt = cell(C_NEXT);
        for (int32_t i = end; i;) {
            const int32_t b = back[i];
            if (leader()) nxt[b] = i;
            i = b;
        }
        sync();
        for (int32_t i = 0; i != end;) {
            const int32_t n = nxt[i];
            token(n - i, dist[n], (int32_t)f.byte(wpos + n - 1));
            i = n;
        }
        sync();
        f.reps = lanes([&](int l) -> int32_t {
            return l < 4 ? cell(C_REP + l)[end] : 0;
        });
    }

    // the rep queue after a token of distance code d and length len
    // (encode_nonlit, csc_lz.cpp:127-154), from `r`
    K5_FN Lanes moved(const Lanes& r, int32_t len, int32_t d) const {
        if (d == 0 || (d == 1 && len == 1)) return r;
        if (d <= 4)
            return gather(r, lanes([&](int l) -> int32_t {
                return l == 0 ? d - 1 : l < d ? l - 1 : l;
            }));
        const Lanes down = k5::prev(r);
        return lanes([&](int l) -> int32_t {
            return l == 0 ? d - 4 : own(down, l);
        });
    }

    // the stretch from wpos (avail bytes to the piece's end), its first
    // find fd made at the model's state and rep queue: the DP, its exits
    // and its tokens coded; returns the positions it covered and, in
    // slen, the length of a match coded after the back-walk (0: none)
    K5_FN int32_t stretch(int32_t wpos, int32_t avail, Found& fd,
                          int32_t& slen) {
        const int32_t aplimit = avail < AP_LIMIT ? avail : AP_LIMIT;
        const int32_t good = f.s.good_len;
        uint32_t* price = (uint32_t*)cell(C_PRICE);
        int32_t* back = cell(C_BACK);
        int32_t* dist = cell(C_DIST);
        int32_t* cst = cell(C_STATE);
        if (leader()) {
            price[0] = 0;
            back[0] = 0;
            cst[0] = state;
        }
        each([&](int l) {
            if (l < 4) cell(C_REP + l)[0] = own(f.reps, l);
        });
        sync();
        int32_t apend = 1, apcur = 0, st = state;
        slen = 0;
        K6_COUNT(k5::Q_STRETCHES);
        K6_MARK(k5::Q_CELLS);
        for (;;) {
            const int32_t cur = wpos + apcur;
            if (apcur) {
                const int32_t b = back[apcur], d = dist[apcur];
                const int32_t sb = cst[b];
                const int32_t len = apcur - b;
                st = d == 0 ? (sb * 4) & 0x3F
                   : d == 1 && len == 1 ? (sb * 4 + 2) & 0x3F
                   : d <= 4 ? (sb * 4 + 3) & 0x3F : (sb * 4 + 1) & 0x3F;
                f.reps = moved(lanes([&](int l) -> int32_t {
                    return l < 4 ? cell(C_REP + l)[b] : 0;
                }), len, d);
                if (leader()) cst[apcur] = st;
                each([&](int l) {
                    if (l < 4) cell(C_REP + l)[apcur] = own(f.reps, l);
                });
                K6_MARK(k5::Q_CELLS);
                if (apcur < aplimit)
                    find_priced(st, cur, avail - apcur, fd);
                if constexpr (BT) {
                    if (f.bt_bad) return apcur;   // nothing coded
                }
            }
            if (apcur == aplimit) {  // never: an exit below comes first
                backward(wpos, apcur);
                return apcur;
            }
            if (fd.len == 1 && apcur + 1 == apend) {   // the literal tail
                backward(wpos, apcur);
                token(1, 0, (int32_t)f.byte(cur));
                sync();
                K6_MARK(k5::Q_CODE);
                return apcur + 1;
            }
            const bool init1 = apcur + 1 >= apend;
            if (init1) ++apend;
            if (fd.len >= good || (fd.len > 1 && fd.len + apcur >= aplimit)) {
                backward(wpos, apcur);
                token(fd.len, fd.code,
                      (int32_t)f.byte(cur + fd.len - 1));
                f.reps = moved(f.reps, fd.len, fd.code);
                sync();
                K6_MARK(k5::Q_CODE);
                slen = fd.len;
                return apcur + fd.len;
            }
            const uint32_t here = price[apcur];
            // the next cell: the literal (its price's context the window
            // byte before it, 0 at ring position 0), then rep0len1
            uint32_t p1 = init1 ? INF : price[apcur + 1];
            const int32_t rpos = RING ? cur - f.lap0 : cur;
            const uint32_t cp = lit_price(st, rpos ? (int32_t)f.byte(cur - 1)
                                                   : 0,
                                          (int32_t)f.byte(cur)) + here;
            int32_t d1 = -1;
            if (cp < p1) {
                p1 = cp;
                d1 = 0;
            }
            K6_MARK(k5::Q_LIT);
            if (fd.r01 && fd.r01p + here < p1) {
                p1 = fd.r01p + here;
                d1 = 1;
            }
            if (leader()) {
                if (init1 || d1 >= 0) price[apcur + 1] = p1;
                if (d1 >= 0) {
                    dist[apcur + 1] = d1;
                    back[apcur + 1] = apcur;
                }
            }
            // the cell of each length L in [2, len], lane L
            const int32_t flen = fd.len;
            each([&](int l) {
                if (l < 2 || l > flen) return;
                const int32_t c = apcur + l;
                const uint32_t old = c >= apend ? INF : price[c];
                const uint32_t np = (uint32_t)own(fd.price_at, l) + here;
                if (own(fd.code_at, l) && np < old) {
                    price[c] = np;
                    dist[c] = own(fd.code_at, l);
                    back[c] = apcur;
                } else if (c >= apend) {
                    price[c] = INF;
                }
            });
            if constexpr (BT) {
                // the lengths 32 + l
                each([&](int l) {
                    if (32 + l > flen) return;
                    const int32_t c = apcur + 32 + l;
                    const uint32_t old = c >= apend ? INF : price[c];
                    const uint32_t np = (uint32_t)own(fd.price_hi, l) + here;
                    if (own(fd.code_hi, l) && np < old) {
                        price[c] = np;
                        dist[c] = own(fd.code_hi, l);
                        back[c] = apcur;
                    } else if (c >= apend) {
                        price[c] = INF;
                    }
                });
            }
            if (apcur + flen >= apend) apend = apcur + flen + 1;
            sync();
            K6_MARK(k5::Q_RELAX);
            ++apcur;
        }
    }

    // ------------------------------------------------------------- runs
    // CompressLiterals over [start, end): lane k < 8 adapts level k of
    // each literal's tree (levels share no probability)
    K5_FN void literals(int32_t start, int32_t end) {
        const int32_t c0 = ctx;
        each([&](int l) {
            if (l >= 8) return;
            int32_t c = c0;
            for (int32_t p = start; p < end; ++p) {
                const int32_t b = (int32_t)f.byte(p);
                uint16_t* a = x.lit + c * 256 + ((b | 0x100) >> (8 - l));
                const int32_t pr = *a;
                *a = (uint16_t)((b >> (7 - l)) & 1 ? pr + ((0xFFF - pr) >> 5)
                                                  : pr - (pr >> 5));
                c = b;
            }
        });
        ctx = (int32_t)f.byte(end - 1);
    }

    // byte k of the delta filter of [start, start + n) over chn channels
    // (Forward_Delta, csc_filters.cpp:132-164; the bytes themselves under
    // 512)
    K5_FN int32_t delta(int32_t start, int32_t n, int32_t chn,
                        int32_t k) const {
        if (n < 512) return (int32_t)f.byte(start + k);
        auto src = [&](int32_t q) -> int32_t {
            // channel i holds ceil((n - i) / chn) bytes
            int32_t i = 0, base = 0;
            for (;;) {
                const int32_t cnt = (n - i + chn - 1) / chn;
                if (q < base + cnt) return i + (q - base) * chn;
                base += cnt;
                ++i;
            }
        };
        const int32_t cur = (int32_t)f.byte(start + src(k));
        const int32_t prev = k ? (int32_t)f.byte(start + src(k - 1)) : 0;
        return (cur - prev) & 0xFF;
    }

    // CompressRLE's runs over the delta of [start, end): each stretch of
    // e - s >= 12 equal bytes codes a run of e - s - 1 - 11 through the
    // matchlen trees; 32 bytes a pass, the stretch starts by ballot
    K5_FN void rle(int32_t start, int32_t end, int32_t chn) {
        const int32_t n = end - start;
        int32_t s = 0, last = -1;
        for (int32_t k0 = 0; k0 < n; k0 += k5::WARP) {
            const Lanes d = lanes([&](int l) -> int32_t {
                return k0 + l < n ? delta(start, n, chn, k0 + l) : -2 - l;
            });
            const Lanes before = k5::prev(d);
            uint32_t starts = ballot(lanes([&](int l) -> int32_t {
                const int32_t p = l == 0 ? last : own(before, l);
                return k0 + l < n && (k0 + l == 0 || own(d, l) != p);
            }));
            last = get(d, k5::WARP - 1);
            for (; starts; starts &= starts - 1) {
                const int32_t k = k0 + k5::ctz32(starts);
                if (k - s >= 12) matchlen(k - s - 1 - 11);
                s = k;
            }
        }
        if (n - s >= 12) matchlen(n - s - 1 - 11);
    }

    // a run's model events at its end (golden/encoder.py:28-73)
    K5_FN void run_end(int32_t start, int32_t end, int32_t t) {
        if (t < k5::DT_NO_LZ) {
            match(0);             // the sentinel, EncodeMatch(64, 0)
        } else if (t == DT_ENTROPY) {
            literals(start, end);
        } else if (t >= DT_DLT) {
            // DLT_INDEX (csc_typedef.h:36): 1, 2, 3, 4, 8 channels
            rle(start, end, t == DT_DLT + 4 ? 8 : t - DT_DLT + 1);
        }
        sync();
    }

    K5_FN Result run() {
        f.init();
#if defined(K6_PHASES) && defined(__CUDA_ARCH__)
        f.k6_mark = clock64();
#endif
        f.budget = INT64_MAX;     // no step budget
        if constexpr (BT) {
            f.bt_head = x.bt_head;
            f.bt_nodes = x.bt_nodes;
            f.bt_size = x.bt_size;
            f.bt_cyc = x.bt_cyc;
            f.bt_pos = 0;
            f.bt_bad = false;
        }
        tok = 0;
        full = false;
        state = ctx = lp = 0;
        each([&](int l) {
            for (int32_t i = l; i < M_SMALL; i += k5::WARP)
                x.small[i] = PROB_INIT;
            for (int32_t i = l; i < NLIT; i += k5::WARP)
                x.lit[i] = PROB_INIT;
            x.lenp[l] = 0;
        });
        sync();
        int32_t wpos = 0, run_start = 0;
        bool done = false;
        f.walk(wpos);
        while (!full) {
            if (f.blk_i >= f.blk_len) {
                const int32_t nboff = f.blk_off + f.blk_len;
                f.pf.at = -1;
                f.win = -1;
                if (nboff >= f.run_end && f.blk_len > 0) {
                    run_end(run_start, nboff, f.run_type);
                    put(k5::K_SENT_A, 0);
                    if (full) break;
                    f.blk_off = nboff;
                    f.blk_len = f.blk_i = 0;
                    f.run_type = -1;
                    run_start = wpos;
                    f.walk(wpos);
                    continue;
                }
                if (nboff >= f.s.size) {
                    put(k5::K_END, 0);
                    done = !full;
                    break;
                }
                f.blk_off = nboff;
                f.blk_len = f.run_end - nboff < k5::SUB_BLOCK
                          ? f.run_end - nboff : k5::SUB_BLOCK;
                if constexpr (RING) {
                    // a piece also ends at the ring's end
                    f.lap0 = nboff - nboff % f.wnd;
                    if (f.blk_len > f.lap0 + f.wnd - nboff)
                        f.blk_len = f.lap0 + f.wnd - nboff;
                }
                f.blk_i = 0;
                if constexpr (NOLZ) {
                    if (f.run_type >= k5::DT_NO_LZ) {
                        f.sparse();
                        if (bad()) break;
                        f.blk_i = f.blk_len;
                        wpos += f.blk_len;
                        continue;
                    }
                }
            }
            // compress_advanced's step at wpos: a literal, or a stretch
            const int32_t avail = f.blk_len - f.blk_i;
            Found fd;
            K6_MARK(k5::Q_OTHER);
            find_priced(state, wpos, avail, fd);
            if (bad()) break;
            int32_t used = 1, slen = 0;
            if (fd.code == 0) {
                token(1, 0, (int32_t)f.byte(wpos));
                sync();
                K6_MARK(k5::Q_CODE);
            } else {
                used = stretch(wpos, avail, fd, slen);
                if (bad()) break;
            }
            f.blk_i += used;
            wpos += used;
            if (slen > 1) {
                // the match's slide from its first byte
                const int32_t base = wpos - slen;
                const int32_t i0 = slen > k5::FAST_SLIDE + 1
                    ? 1 + 4 * ((slen - k5::FAST_SLIDE - 1 + 3) / 4) : 1;
                f.ahead(wpos, base + i0);
                K6_MARK(k5::Q_OTHER);
                f.slide(base, slen);
                if (bad()) break;
            }
        }
        K6_MARK(k5::Q_OTHER);
        K6_MARK(k5::Q_MARK);      // a mark's own cost
        Result r;
        r.tok_cnt = tok;
        r.done = done ? 1 : 0;
        r.err = full ? k5::ERR_OVERFLOW : bad() ? ERR_BT : 0;
        return r;
    }

    // the tree faulted (golden's IndexError)
    K5_FN bool bad() const {
        if constexpr (BT) return f.bt_bad;
        return false;
    }
};

template <bool STAGED, bool NOLZ, bool BT, bool RING>
K5_FN Result parse_as(const Stream& x, int32_t* regs) {
    ApParser<STAGED, NOLZ, BT, RING> p;
    p.f.s = x.s;
    p.x = x;
    const Result r = p.run();
    if (regs) {
        regs[0] = p.state;
        regs[1] = p.ctx;
        regs[2] = p.lp;
    }
    return r;
}

// the stream's parse; a stream whose block table holds no BAD / ENTROPY
// / DLT block takes the parse without the probe and the sparse insertion
// (K5's rule).  BT: m5's binary tree (hash_width 0, s.hash_bits the
// tree's bits).  RING: the stream is longer than its dictionary (s.size
// > s.dict_size) and takes the ring's parse (with the probe, as K5's;
// the nvcc build has a kernel for each, the caller picks).  regs, when
// not null, gets the model's state, ctx and length-cache counter at the
// end.
template <bool STAGED, bool BT = false, bool RING = false>
K5_FN Result parse_stream(const Stream& x, int32_t* regs = nullptr) {
    if constexpr (RING) {
        return parse_as<STAGED, true, BT, true>(x, regs);
    } else {
        return k5::has_nolz(x.s) ? parse_as<STAGED, true, BT, false>(x, regs)
                                 : parse_as<STAGED, false, BT, false>(x, regs);
    }
}

}  // namespace k6
