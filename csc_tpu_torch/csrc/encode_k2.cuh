// K2: per-stream lazy parse over precomputed candidates, one warp a
// stream (csc_lz.cpp:156-199 with find_match / FindMatch of
// csc_mf.cpp:243-582, in the candidate-fold form of
// csc_tpu/ops/encode_scan_fast.py).
//
// One call parses one whole stream.  The parse state (rep queue, the
// lazy first-probe pick u1, block / run bookkeeping) is uniform across
// the warp: every lane runs the same control flow on the same values.
// Each lazy step probes wpos and wpos + 1 at once, since nothing is
// emitted between the two probes and both read the same rep queue.  A
// probe takes 16 lanes: 4 rep lanes and up to MAX_CAND candidate lanes
// (candidates dist << 5 | len, parse_pre.pack_candidates).  Each lane
// makes one load round trip: its candidate word, or the first REP_HEAD
// byte pairs of its rep compare.  A rep or candidate that reaches past
// that extends across the warp, 32 byte pairs a step (ballot, find
// first).  Then every lane runs the order-dependent fold of each probe,
// c = 0..C-1 as csc_mf.cpp does, on values gathered by shuffles.
//
// The same source builds with nvcc (the __global__ wrapper in
// encode_k2.cu) and with g++ (the test harness encode_k2_host.cpp), so
// the CPU tests hold this logic against the plain PyTorch version
// (csc_tpu_torch/ops/parse_scan.py) before it runs on a card.  The lane
// operations sit behind `Lanes`: in the nvcc build a lane's own value
// with __ballot_sync / __shfl_sync, in the g++ build all 32 lanes' values
// computed in a loop; both builds share the fold.
//
// Contract with the plain version, for every stream: the same tape words
// (kind | wire_len << 3, dist_code) over the first tok_cnt tokens, the
// same tok_cnt, done and err.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define K2_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define K2_FN inline __attribute__((always_inline))
#endif

namespace k2 {

// parse-tape token kinds (encode_scan.py:36-41)
constexpr int32_t K_LIT = 0;
constexpr int32_t K_MATCH = 1;
constexpr int32_t K_REP = 2;
constexpr int32_t K_REP0L1 = 3;
constexpr int32_t K_SENT_A = 4;
constexpr int32_t K_END = 5;
constexpr int32_t EXT_CAP = 8;       // parse_pre.py:37
constexpr int32_t SUB_BLOCK = 8192;  // csc_lz.cpp:63-67
constexpr int32_t ERR_OVERFLOW = 1;  // the tape is full
constexpr int WARP = 32;
constexpr int PROBE_LANES = 16;      // lanes of one probe
constexpr int MAX_CAND = PROBE_LANES - 4;   // candidate rows K2 takes
constexpr int REP_HEAD = 4;          // byte pairs of a rep lane's first load

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    int64_t n;
    const int32_t* cand;     // [C][n] packed candidates
    int32_t ncand;           // C = 2 + hash_width <= MAX_CAND
    const int32_t* run_ends; // [R] cumulative run ends
    const int32_t* run_skip; // [R] 1 = no parse (BAD / ENTROPY / DLT run)
    int32_t nrun;
    int32_t size, dict_size, good_len;
    int32_t* tape;           // [T][2]
    int64_t tcap;            // T
};

struct Result {
    int32_t tok_cnt, done, err;
};

// One int32 a lane.  nvcc: this lane's value; g++: all 32.
#ifdef __CUDA_ARCH__
struct Lanes {
    int32_t v;
};
K2_FN int lane_id() { return threadIdx.x & (WARP - 1); }
template <class F>
K2_FN Lanes lanes(F f) { return Lanes{f(lane_id())}; }
K2_FN int32_t get(const Lanes& x, int src) {
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
}
K2_FN void set(Lanes& x, int lane, int32_t v) {
    if (lane_id() == lane) x.v = v;
}
K2_FN uint32_t ballot(const Lanes& x) {
    return __ballot_sync(0xFFFFFFFFu, x.v != 0);
}
K2_FN int first_lane(uint32_t m) { return __ffs(m) - 1; }
K2_FN bool leader() { return lane_id() == 0; }
// lane l's own entry, inside a lanes() body run for lane l
K2_FN int32_t own(const Lanes& x, int) { return x.v; }
#else
struct Lanes {
    int32_t v[WARP];
};
template <class F>
K2_FN Lanes lanes(F f) {
    Lanes x;
    for (int l = 0; l < WARP; ++l) x.v[l] = f(l);
    return x;
}
K2_FN int32_t get(const Lanes& x, int src) { return x.v[src]; }
K2_FN void set(Lanes& x, int lane, int32_t v) { x.v[lane] = v; }
K2_FN uint32_t ballot(const Lanes& x) {
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) m |= (uint32_t)(x.v[l] != 0) << l;
    return m;
}
K2_FN int first_lane(uint32_t m) { return __builtin_ffs(m) - 1; }
K2_FN bool leader() { return true; }
K2_FN int32_t own(const Lanes& x, int l) { return x.v[l]; }
#endif

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K2_FN int32_t dist_bound(int32_t l) {
    return l <= 1 ? 0 : l == 2 ? 64 : l == 3 ? 1024 : l == 4 ? 16 * 1024
         : l == 5 ? 256 * 1024 : l == 6 ? 4 * 1024 * 1024 : 0x7FFFFFFF;
}

K2_FN int32_t clampi(int32_t v, int32_t hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// SecondMatchBetter (csc_mf.cpp:570-582)
K2_FN bool second_better(int32_t l1, int32_t d1, int32_t l2, int32_t d2) {
    if (l2 <= 1) return false;
    const int32_t c21 = 4 * clampi(l2 - l1, 3);
    const int32_t c12 = 4 * clampi(l1 - l2, 3);
    return (l2 > l1 + 3) || (l2 > l1 && d2 <= 4) ||
           (l2 + 2 > l1 && d2 <= 4 && d1 > 4) ||
           (l2 >= l1 && (d2 >> c21) <= d1) ||
           (l2 < l1 && l2 + 2 >= l1 && d1 > 4 && (d1 >> c12) > d2);
}

// SecondMatchBetter where l2 > l1, as in every step of find_match's
// fold (a pick is taken only longer than minlen, and the best so far is
// never longer than minlen), without short-circuit branches
K2_FN bool longer_better(int32_t l1, int32_t d1, int32_t l2, int32_t d2) {
    const int32_t gap = l2 - l1;
    return (gap > 3) | (d2 <= 4) | ((d2 >> (4 * (gap < 3 ? gap : 3))) <= d1);
}

// a candidate lane's fact bits above its 16-bit length
constexpr int F_LIVE = 16;           // dist > 0
constexpr int F_VALID = 17;          // under vld_rge, not the HT2 quirk
constexpr int F_NEAR = 18;           // within MF_DIST_BOUND of its length
constexpr int F_GOOD = 19;           // length >= good_len

// common prefix of data[p..] and data[q..] from l, capped at lim, 32
// byte pairs a step across the warp: the first lane whose pair differs
// or lies at lim ends it
K2_FN int32_t extend(const uint8_t* d, int64_t p, int64_t q, int32_t l,
                     int32_t lim) {
    while (l < lim) {
        const uint32_t end = ballot(lanes([&](int k) -> int32_t {
            const int32_t i = l + k;
            return i >= lim || d[p + i] != d[q + i];
        }));
        if (end) return l + first_lane(end);
        l += WARP;
    }
    return l;
}

struct Pick {
    int32_t len, dist;       // u_len, u_dist: dist 0 literal, 1..4 rep
};

// the state of one probe's find_match fold: minlen, the distance gate,
// the good_len exit, the best pick so far
struct Fold {
    int32_t minlen, best_l, best_d;
    uint32_t dist_var;
    bool gl, have;

    // rep0len1 (csc_mf.cpp:281-287): observable iff rep0 extends >= 2
    K2_FN explicit Fold(int32_t rep0_len)
        : minlen(1), best_l(1), best_d(rep0_len >= 2), dist_var(0),
          gl(false), have(rep0_len >= 2) {}

    // rep k of length ln (already at the limit), distance code d
    K2_FN void rep(int32_t ln, int32_t d, int32_t good_len) {
        const bool in = !gl & (ln > minlen);
        const bool take = in & (!have | longer_better(best_l, best_d, ln, d));
        minlen = in ? ln : minlen;
        best_l = take ? ln : best_l;
        best_d = take ? d : best_d;
        have |= in;
        gl |= in & (ln >= good_len);
    }

    // a candidate: f = length | F_* bits, dv its distance
    K2_FN void cand(int32_t f, int32_t dv) {
        const int32_t lv = f & 0xFFFF;
        const bool gate = ((f >> F_LIVE) & 1) & ((uint32_t)dv > dist_var)
                        & !gl;
        dist_var = gate ? (uint32_t)dv : dist_var;
        const bool bet = gate & ((f >> F_VALID) & 1) & (lv > minlen);
        minlen = bet ? lv : minlen;
        const bool in = bet & ((f >> F_NEAR) & 1);
        const bool take = in & (!have | longer_better(best_l, best_d, lv,
                                                      dv + 4));
        best_l = take ? lv : best_l;
        best_d = take ? dv + 4 : best_d;
        have |= in;
        gl |= bet & ((f >> F_GOOD) & 1);
    }

    K2_FN Pick pick() const {
        return Pick{have ? best_l : 1, have ? best_d : 0};
    }
};

struct Parser {
    Stream s;
    int32_t rep0, rep1, rep2, rep3;
    int32_t tok;
    int32_t err;

    // a full tape keeps counting; as in the plain version, a token then
    // rewrites the last entry and a sentinel writes nothing
    K2_FN void put(int32_t w0, int32_t w1, bool token = true) {
        const bool full = tok >= s.tcap;
        if (full) err = ERR_OVERFLOW;
        if (leader() && (token || !full)) {
            const int64_t at = full ? s.tcap - 1 : tok;
            s.tape[2 * at] = w0;
            s.tape[2 * at + 1] = w1;
        }
        ++tok;
    }

    K2_FN int32_t rep(int k) const {
        return k == 0 ? rep0 : k == 1 ? rep1 : k == 2 ? rep2 : rep3;
    }

    // one token of u_len bytes at distance code u_dist (0 literal, 1..4
    // rep, > 4 match at u_dist - 4), with the rep queue update
    K2_FN void emit(int32_t len, int32_t dist) {
        if (dist == 0) {
            put(K_LIT, 0);
        } else if (dist == 1 && len == 1) {
            put(K_REP0L1, 0);
        } else if (dist <= 4) {
            put(K_REP | ((len - 2) << 3), dist - 1);
            const int32_t rd = rep(dist - 1);
            if (dist >= 4) rep3 = rep2;
            if (dist >= 3) rep2 = rep1;
            if (dist >= 2) rep1 = rep0;
            rep0 = rd;
        } else {
            put(K_MATCH | ((len - 2) << 3), dist - 5);
            rep3 = rep2;
            rep2 = rep1;
            rep1 = rep0;
            rep0 = dist - 4;
        }
    }

    // The probes' first round at wpos (lanes 0-15, when `both`) and wpos
    // + 1 (lanes 16-31), limit bytes left in the sub-block at wpos.  Lane
    // 16 pr + r: rep r (r < 4) or candidate r - 4.  Leaves in `len` each
    // rep lane's match length (extended to the limit) and each candidate
    // lane's length (live-extended past EXT_CAP, cut at the limit) with
    // its F_* fact bits, and in `word` each candidate lane's word.
    K2_FN void probe(int64_t wpos, int32_t limit, bool both, Lanes& len,
                     Lanes& word) const {
        const uint8_t* d = s.data;
        word = lanes([&](int l) -> int32_t {
            const int pr = l / PROBE_LANES, c = l % PROBE_LANES - 4;
            if ((pr == 0 && !both) || c < 0 || c >= s.ncand) return 0;
            const int64_t ppos = wpos + pr;
            const int64_t pc = ppos < s.n ? ppos : s.n - 1;
            return s.cand[(int64_t)c * s.n + pc];
        });
        len = lanes([&](int l) -> int32_t {
            const int pr = l / PROBE_LANES, r = l % PROBE_LANES;
            if (pr == 0 && !both) return 0;
            if (r >= 4) return own(word, l) & 31;
            const int64_t ppos = wpos + pr;
            const int32_t lim = limit - pr, rd = rep(r);
            const int64_t q = ppos - rd;
            // a rep reaching before the data start never matches
            if (rd <= 0 || q < 0 || lim <= 0) return 0;
            bool eq[REP_HEAD];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < REP_HEAD; ++k)
                eq[k] = k < lim && d[ppos + k] == d[q + k];
            int32_t h = 0;
            bool same = true;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < REP_HEAD; ++k) {
                same = same && eq[k];
                h += same;
            }
            return h;
        });
        // the lanes whose match reaches past their first round extend one
        // after another, each across the warp
        uint32_t more = ballot(lanes([&](int l) -> int32_t {
            const int pr = l / PROBE_LANES, r = l % PROBE_LANES;
            if ((pr == 0 && !both) || r - 4 >= s.ncand) return 0;
            const int32_t lim = limit - pr;
            if (r < 4) return own(len, l) == REP_HEAD && REP_HEAD < lim;
            const int32_t pk = own(word, l);
            return (pk & 31) >= EXT_CAP && lim > EXT_CAP && (pk >> 5) > 0;
        }));
        while (more) {
            const int l = first_lane(more);
            more &= more - 1;
            const int pr = l / PROBE_LANES, r = l % PROBE_LANES;
            const int64_t ppos = wpos + pr;
            const int32_t dist = r < 4 ? rep(r) : get(word, l) >> 5;
            set(len, l, extend(d, ppos, ppos - dist,
                               r < 4 ? REP_HEAD : EXT_CAP, limit - pr));
        }
        // each candidate lane's facts that do not hang on the fold's
        // state: its length at the limit, and flags (all 0 past ncand)
        const int32_t vld_rge = s.dict_size - 8 * 1024 - 4;
        len = lanes([&](int l) -> int32_t {
            const int pr = l / PROBE_LANES, r = l % PROBE_LANES;
            const int32_t ln = own(len, l);
            if (r < 4) return ln;
            const int32_t lim = limit - pr, dv = own(word, l) >> 5;
            const int32_t lv = ln < lim ? ln : lim;
            // the vld_rge gate and the HT2 wrap quirk (c = 0)
            const bool valid = (uint32_t)dv < (uint32_t)vld_rge
                             && (r != 4 || dv != wpos + pr);
            const bool near = lv > 6 || dv < dist_bound(lv);
            return lv | (int32_t)(dv > 0) << F_LIVE | (int32_t)valid << F_VALID
                 | (int32_t)near << F_NEAR
                 | (int32_t)(lv >= s.good_len) << F_GOOD;
        });
    }

    // find_match + FindMatch (csc_mf.cpp:243-582) of probe pr, folded in
    // order from the lanes' facts (probe's `len`: a rep's length, a
    // candidate's length | F_* bits; `word`: the candidate words);
    // branch-free (Fold).  C candidate rows, unrolled, so that every
    // shuffle issues ahead of the fold's chain; rows past ncand are inert
    // (no F_LIVE).
    template <int C>
    K2_FN Pick fold_rows(int pr, const Lanes& len, const Lanes& word) const {
        const int base = pr * PROBE_LANES;
        Fold f(get(len, base));
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int k = 0; k < 4; ++k)
            f.rep(get(len, base + k), k + 1, s.good_len);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int c = 4; c < 4 + C; ++c)
            f.cand(get(len, base + c), get(word, base + c) >> 5);
        return f.pick();
    }

    // the fold at this stream's candidate rows: m1's 3, m2's 10, or all
    K2_FN Pick fold(int pr, const Lanes& len, const Lanes& word) const {
        return s.ncand == 3 ? fold_rows<3>(pr, len, word)
             : s.ncand == 10 ? fold_rows<10>(pr, len, word)
                             : fold_rows<MAX_CAND>(pr, len, word);
    }

    K2_FN Result run() {
        rep0 = rep1 = rep2 = rep3 = s.dict_size;
        tok = 0;
        err = 0;
        int64_t wpos = 0;
        int32_t run_idx = 0, run_end = s.run_ends[0];
        int32_t blk_off = 0, blk_len = 0;
        Lanes len, word;
        while (true) {
            // ---- sub-block / run bookkeeping (FB_BLOCK)
            const int32_t nboff = blk_off + blk_len;
            if (nboff >= run_end && blk_len > 0) {
                put(K_SENT_A, 0, false);
                ++run_idx;
                run_end = s.run_ends[run_idx < s.nrun ? run_idx : s.nrun - 1];
                blk_off = nboff;
                blk_len = 0;
                continue;
            }
            if (nboff >= s.size) {
                put(K_END, 0, false);
                break;
            }
            blk_off = nboff;
            if (s.run_skip[run_idx < s.nrun ? run_idx : s.nrun - 1]) {
                blk_len = run_end - nboff;
                wpos += blk_len;
                continue;
            }
            blk_len = run_end - nboff < SUB_BLOCK ? run_end - nboff
                                                  : SUB_BLOCK;
            // ---- lazy parse of the sub-block (FB_FIND)
            int32_t blk_i = 0;
            bool have_u1 = false;
            Pick u1 = {0, 0};
            while (blk_i < blk_len) {
                const int32_t limit = blk_len - blk_i;
                Pick u = u1;
                if (!have_u1) {
                    probe(wpos, limit, true, len, word);
                    u = fold(0, len, word);
                }
                if (u.len == 1 || u.len >= s.good_len) {
                    emit(u.len, u.dist);
                    blk_i += u.len;
                    wpos += u.len;
                    // a one-byte token leaves the reps as they were, so
                    // this round's second probe is the next position's
                    // first (same reps, the limit one less)
                    const bool next = u.len == 1 && !have_u1;
                    if (next) u1 = fold(1, len, word);
                    have_u1 = next;
                    continue;
                }
                // the second probe one byte on
                if (have_u1) probe(wpos, limit, false, len, word);
                const Pick v = fold(1, len, word);
                if (second_better(u.len, u.dist, v.len, v.dist)) {
                    emit(1, 0);
                    blk_i += 1;
                    wpos += 1;
                    have_u1 = true;
                    u1 = v;
                } else {
                    emit(u.len, u.dist);
                    blk_i += u.len;
                    wpos += u.len;
                    have_u1 = false;
                }
            }
        }
        return Result{tok, 1, err};
    }
};

K2_FN Result parse_stream(const Stream& s) {
    Parser p;
    p.s = s;
    return p.run();
}

}  // namespace k2
