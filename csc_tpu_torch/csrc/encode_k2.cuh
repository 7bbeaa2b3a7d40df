// K2: straight per-stream lazy parse over precomputed candidates
// (csc_lz.cpp:156-199 with find_match / FindMatch of csc_mf.cpp:243-582,
// in the candidate-fold form of csc_tpu/ops/encode_scan_fast.py).
//
// One call parses one whole stream.  The rep queue, the lazy first-probe
// pick (u1) and the block / run bookkeeping stay in locals; candidates
// (dist << 5 | len, parse_pre.pack_candidates) and data bytes are read
// from memory where they lie.  Live extension compares data bytes.  The
// same source builds with nvcc (the __global__ wrapper in encode_k2.cu)
// and with g++ (the test harness encode_k2_host.cpp), so the CPU tests
// hold this logic against the plain PyTorch version
// (csc_tpu_torch/ops/parse_scan.py) before it runs on a card.
//
// Contract with the plain version, for every stream: the same tape words
// (kind | wire_len << 3, dist_code) over the first tok_cnt tokens, the
// same tok_cnt, done and err.
#pragma once
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define K2_FN __host__ __device__ inline

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

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    int64_t n;
    const int32_t* cand;     // [C][n] packed candidates
    int32_t ncand;           // C = 2 + hash_width
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

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K2_FN int32_t dist_bound(int32_t l) {
    switch (l < 0 ? 0 : l) {
        case 0: case 1: return 0;
        case 2: return 64;
        case 3: return 1024;
        case 4: return 16 * 1024;
        case 5: return 256 * 1024;
        case 6: return 4 * 1024 * 1024;
        default: return 0x7FFFFFFF;
    }
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

// common prefix of data[p..] and data[q..] from l, capped at lim
K2_FN int32_t extend(const uint8_t* d, int64_t p, int64_t q, int32_t l,
                     int32_t lim) {
    while (l < lim && d[p + l] == d[q + l]) ++l;
    return l;
}

struct Parser {
    Stream s;
    int32_t reps[4];
    int32_t tok;
    int32_t err;

    K2_FN void put(int32_t w0, int32_t w1) {
        if (tok < s.tcap) {
            s.tape[2 * (int64_t)tok] = w0;
            s.tape[2 * (int64_t)tok + 1] = w1;
        } else {
            err = ERR_OVERFLOW;
        }
        ++tok;
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
            const int32_t rd = reps[dist - 1];
            for (int k = dist - 1; k > 0; --k) reps[k] = reps[k - 1];
            reps[0] = rd;
        } else {
            put(K_MATCH | ((len - 2) << 3), dist - 5);
            reps[3] = reps[2];
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = dist - 4;
        }
    }

    // find_match + FindMatch at ppos with `limit` bytes left in the
    // sub-block: (u_len, u_dist)
    K2_FN void find(int64_t ppos, int32_t limit, int32_t& u_len,
                    int32_t& u_dist) {
        const int32_t vld_rge = s.dict_size - 8 * 1024 - 4;
        int32_t minlen = 1;
        uint32_t dist_var = 0;
        bool gl = false, have = false;
        int32_t best_l = 1, best_d = 0;
        auto consider = [&](int32_t l2, int32_t d2) {
            if (!have || second_better(best_l, best_d, l2, d2)) {
                best_l = l2;
                best_d = d2;
            }
            have = true;
        };
        // rep lanes: a rep reaching before the data start never matches
        int32_t rep_l[4];
        for (int k = 0; k < 4; ++k) {
            const int64_t q = ppos - reps[k];
            rep_l[k] = (reps[k] > 0 && q >= 0 && limit > 0)
                           ? extend(s.data, ppos, q, 0, limit) : 0;
        }
        // rep0len1 (csc_mf.cpp:281-287): observable iff rep0 extends >= 2
        if (rep_l[0] >= 2) {
            best_l = 1;
            best_d = 1;
            have = true;
        }
        for (int k = 0; k < 4; ++k) {
            const int32_t ln = rep_l[k] < limit ? rep_l[k] : limit;
            if (!gl && ln > minlen) {
                minlen = ln;
                consider(ln, k + 1);
                if (ln >= s.good_len) gl = true;
            }
        }
        const int64_t pc = ppos < s.n ? ppos : s.n - 1;
        for (int c = 0; c < s.ncand; ++c) {
            const int32_t pk = s.cand[(int64_t)c * s.n + pc];
            const int32_t dv = pk >> 5;
            int32_t lv = pk & 31;
            if (lv >= EXT_CAP && limit > EXT_CAP && dv > 0)
                lv = extend(s.data, ppos, ppos - dv, EXT_CAP, limit);
            if (lv > limit) lv = limit;
            const bool gate = dv > 0 && (uint32_t)dv > dist_var && !gl;
            if (gate) dist_var = (uint32_t)dv;
            bool ok = gate && (uint32_t)dv < (uint32_t)vld_rge;
            if (c == 0) ok = ok && dv != ppos;   // HT2 wrap quirk
            const bool bet = ok && lv > minlen;
            if (bet) minlen = lv;
            if (bet && (lv > 6 || dv < dist_bound(lv))) consider(lv, dv + 4);
            if (bet && lv >= s.good_len) gl = true;
        }
        u_len = have ? best_l : 1;
        u_dist = have ? best_d : 0;
    }

    K2_FN Result run() {
        for (int k = 0; k < 4; ++k) reps[k] = s.dict_size;
        tok = 0;
        err = 0;
        int64_t wpos = 0;
        int32_t run_idx = 0, run_end = s.run_ends[0];
        int32_t blk_off = 0, blk_len = 0;
        while (true) {
            // ---- sub-block / run bookkeeping (FB_BLOCK)
            const int32_t nboff = blk_off + blk_len;
            if (nboff >= run_end && blk_len > 0) {
                put(K_SENT_A, 0);
                ++run_idx;
                run_end = s.run_ends[run_idx < s.nrun ? run_idx : s.nrun - 1];
                blk_off = nboff;
                blk_len = 0;
                continue;
            }
            if (nboff >= s.size) {
                put(K_END, 0);
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
            int32_t u1_len = 0, u1_dist = 0;
            while (blk_i < blk_len) {
                int32_t u_len, u_dist;
                if (!have_u1) find(wpos, blk_len - blk_i, u_len, u_dist);
                else {
                    u_len = u1_len;
                    u_dist = u1_dist;
                }
                if (u_len == 1 || u_len >= s.good_len) {
                    emit(u_len, u_dist);
                    blk_i += u_len;
                    wpos += u_len;
                    have_u1 = false;
                    continue;
                }
                // second probe one byte on
                int32_t v_len, v_dist;
                find(wpos + 1, blk_len - blk_i - 1, v_len, v_dist);
                if (second_better(u_len, u_dist, v_len, v_dist)) {
                    emit(1, 0);
                    blk_i += 1;
                    wpos += 1;
                    have_u1 = true;
                    u1_len = v_len;
                    u1_dist = v_dist;
                } else {
                    emit(u_len, u_dist);
                    blk_i += u_len;
                    wpos += u_len;
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
