// K4: per-stream optimal (AP) parse of m3-m5 over precomputed candidates
// and snapshot prices (compress_advanced, csc_lz.cpp:207-333, in the
// candidate-fold form of csc_tpu/ops/parse_ap.py), one thread a stream.
//
// A stream is cut into 8 KB sub-blocks inside its runs (runs with no
// parse are skipped whole, a K_SENT_A ends each run, K_END the stream).
// A sub-block is parsed in stretches.  A stretch is a shortest path over
// cells s0 .. s0 + AP_LIMIT: at each position the node's model state and
// rep queue are rebuilt from its back pointer, the rep and candidate
// lanes are extended, folded in find_match order (csc_mf.cpp:243-495),
// and every length 2..good_len is priced; the stretch ends on a lone
// literal, a match of good_len or one reaching the cap, or the cap
// itself, and otherwise the literal, rep0len1 and match cells are
// relaxed.  At the end the path is marked back to the stretch start and
// walked forward, one token a cell, and the post-stretch literal or match
// follows.  The cells (price, stamp, back, ndist, nstate, nxt, nrep[4])
// live in a per-stream scratch [10][n] that the caller allocates with the
// stamps at -1; a cell is live only while its stamp is the stretch id.
//
// The lockstep plain version (csc_tpu_torch/ops/parse_ap_scan.py) takes
// one FSM action a step and extends lanes at most 8 rounds of 4 bytes a
// step.  This code runs the actions in sequence but counts the same
// steps: one a BLOCK, MARK or WALK action, max(1, ceil(R / 8)) a FIND
// position whose longest lane takes R rounds.  So the step budget cuts
// both at the same token, and a stretch start whose lanes take more than
// one step prices with (state * 4) & 0x3F of its entry state, as the
// plain version's later step rebuilds it.  A match relaxed into the last
// column (n - 1) is not written: csc_tpu's scatter writes it back (see
// parse_ap_scan.py).
//
// The same source builds with nvcc (the __global__ wrapper in
// encode_k4.cu) and with g++ (the test harness encode_k4_host.cpp), so
// the CPU tests hold it against the plain version before it runs on a
// card.  Contract, for every stream: the same tape words (kind | wire_len
// << 3, dist_code) over the first tok_cnt tokens, the same tok_cnt, done
// and err.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define K4_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define K4_FN inline __attribute__((always_inline))
#endif

namespace k4 {

// parse-tape token kinds (encode_scan.py:36-41)
constexpr int32_t K_LIT = 0;
constexpr int32_t K_MATCH = 1;
constexpr int32_t K_REP = 2;
constexpr int32_t K_REP0L1 = 3;
constexpr int32_t K_SENT_A = 4;
constexpr int32_t K_END = 5;
constexpr int32_t EXT_CAP = 8;        // parse_pre.py:37
constexpr int32_t SUB_BLOCK = 8192;   // csc_lz.cpp:63-67
constexpr int32_t AP_LIMIT = 2048;    // csc_lz.h:43
constexpr int32_t INF = 0x3FFFFFFF;
constexpr int32_t POST_NONE = 0, POST_LIT = 1, POST_MATCH = 2;
constexpr int32_t ERR_OVERFLOW = 1;   // the tape is full
constexpr int32_t ERR_STEPS = 2;      // the step budget ran out
constexpr int MAX_CAND = 12;          // candidate rows (2 + hash_width)
constexpr int MAX_GOOD_LEN = 64;      // the length grid's top
constexpr int LANES = 4 + MAX_CAND;
constexpr int CELL_ROWS = 10;         // rows of the per-stream scratch

// the price tables (ops/prices.py TABLES order), 1/128 bit each
struct Prices {
    const int32_t* lit_tree;  // [256]
    const int32_t* flag0;     // [64]
    const int32_t* r01;       // [64]
    const int32_t* repd;      // [64][4]
    const int32_t* matchf;    // [64]
    const int32_t* lenp;      // [32]
};

K4_FN Prices prices_at(const int32_t* packed) {
    return Prices{packed, packed + 256, packed + 320, packed + 384,
                  packed + 640, packed + 704};
}
constexpr int PRICES_LEN = 736;

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    int64_t n;
    const int32_t* cand;     // [C][n] packed candidates (dist << 5 | len)
    int32_t ncand;           // C <= MAX_CAND
    const int32_t* run_ends; // [R] cumulative run ends
    const int32_t* run_skip; // [R] 1 = no parse (BAD / ENTROPY / DLT run)
    int32_t nrun;
    int32_t size, dict_size, good_len;
    int32_t* tape;           // [T][2]
    int64_t tcap;            // T
    int64_t max_steps;       // the step budget
    int32_t* cells;          // [CELL_ROWS][n] scratch, stamps at -1
    Prices pr;
};

struct Result {
    int32_t tok_cnt, done, err;
};

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K4_FN int32_t dist_bound(int32_t l) {
    return l <= 1 ? 0 : l == 2 ? 64 : l == 3 ? 1024 : l == 4 ? 16 * 1024
         : l == 5 ? 256 * 1024 : l == 6 ? 4 * 1024 * 1024 : 0x7FFFFFFF;
}

K4_FN int32_t floor_log2(uint32_t x) {
#ifdef __CUDA_ARCH__
    return 31 - __clz(x);
#else
    return 31 - __builtin_clz(x);
#endif
}

// _dist_slot (csc_model.cpp:331-340): the DIST_TABLE entries past the
// first that are <= d; DIST_TABLE[s] = 2^(s-2) + 1 for s >= 2
K4_FN int32_t dist_slot(int32_t d) {
    return d < 1 ? 0 : d == 1 ? 1 : floor_log2((uint32_t)(d - 1)) + 2;
}

// the model state after a token of u_len bytes at distance code u_dist
K4_FN int32_t next_state(int32_t s, int32_t len, int32_t dist) {
    return dist == 0 ? (s * 4) & 0x3F
         : dist == 1 && len == 1 ? (s * 4 + 2) & 0x3F
         : dist <= 4 ? (s * 4 + 3) & 0x3F : (s * 4 + 1) & 0x3F;
}

struct Parser {
    Stream s;
    int32_t *price, *stamp, *back, *ndist, *nstate, *nxt, *nrep;
    int32_t tok, err;
    int64_t steps;
    int32_t mstate, reps[4];

    // one lockstep step of the budget; false when it has run out
    K4_FN bool step() {
        if (steps >= s.max_steps) return false;
        ++steps;
        return true;
    }

    // a cell index clipped into the arrays, as csc_tpu's gathers clip
    K4_FN int64_t ci(int64_t i) const {
        return i < 0 ? 0 : (i >= s.n ? s.n - 1 : i);
    }

    // a full tape keeps counting; a token then rewrites the last entry
    // and a sentinel writes nothing (parse_ap.py: K_SENT_A / K_END at
    // tok_cnt, tokens at tok_cnt clipped)
    K4_FN void put(int32_t w0, int32_t w1, bool token) {
        const bool full = tok >= s.tcap;
        if (full) err = ERR_OVERFLOW;
        if (token || !full) {
            const int64_t at = full ? s.tcap - 1 : tok;
            s.tape[2 * at] = w0;
            s.tape[2 * at + 1] = w1;
        }
        ++tok;
    }

    // _emit_ap: one token, then the live state and rep queue after it
    K4_FN void emit(int32_t len, int32_t dist) {
        if (dist == 0) {
            put(K_LIT, 0, true);
        } else if (dist == 1 && len == 1) {
            put(K_REP0L1, 0, true);
        } else if (dist <= 4) {
            put(K_REP | ((len - 2) << 3), dist - 1, true);
            const int32_t rd = reps[dist - 1];
            for (int k = dist - 1; k > 0; --k) reps[k] = reps[k - 1];
            reps[0] = rd;
        } else {
            put(K_MATCH | ((len - 2) << 3), dist - 5, true);
            reps[3] = reps[2];
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = dist - 4;
        }
        mstate = next_state(mstate, len, dist);
    }

    // _stretch_reset: stretch `sid` rooted at s0 with the live registers
    K4_FN void reset(int32_t s0, int32_t sid) {
        const int64_t i = ci(s0);
        price[i] = 0;
        stamp[i] = sid;
        back[i] = s0;
        ndist[i] = 0;
        nstate[i] = mstate;
        for (int k = 0; k < 4; ++k) nrep[k * s.n + i] = reps[k];
    }

    // the final length of a lane matching data[p..] against data[q..]
    // from l0, cut at lim, and the plain version's 4-byte rounds for it
    K4_FN int32_t extend(int64_t p, int64_t q, int32_t l0, int32_t lim,
                         int32_t& rounds) const {
        if (q < 0 || l0 >= lim) {
            rounds = 0;
            return l0;
        }
        int32_t l = l0;
        while (l < lim && s.data[p + l] == s.data[q + l]) ++l;
        const int32_t k = l - l0;
        rounds = (l == lim && (k & 3) == 0) ? k >> 2 : (k >> 2) + 1;
        return l;
    }

    // One FIND position of the stretch at s0 (id sid), with `rel` =
    // blk_len - blk_i bytes of the sub-block from s0.  Returns false when
    // the budget ran out; else either relaxes and advances wpos, or ends
    // the stretch (*ended, with end / post / post_len / post_dist).
    K4_FN bool find(int32_t& wpos, int32_t s0, int32_t sid, int32_t rel,
                    int32_t& apend, bool& ended, int32_t& post,
                    int32_t& post_len, int32_t& post_dist) {
        if (!step()) return false;
        const int32_t apcur = wpos - s0;
        const int32_t limit = rel - apcur;
        const int32_t aplimit = rel < AP_LIMIT ? rel : AP_LIMIT;
        const int64_t w = ci(wpos);
        const int64_t n = s.n;
        // node reconstruction (csc_lz.cpp:211-233)
        int32_t node_state, nrp[4];
        if (apcur == 0) {
            node_state = nstate[w];
            for (int k = 0; k < 4; ++k) nrp[k] = nrep[k * n + w];
        } else {
            const int32_t bb = back[w], nd = ndist[w];
            const int64_t b = ci(bb);
            const int32_t bstate = nstate[b];
            int32_t brep[4];
            for (int k = 0; k < 4; ++k) brep[k] = nrep[k * n + b];
            const bool r01n = nd == 1 && wpos - bb == 1;
            const bool repn = nd >= 1 && nd <= 4 && !r01n;
            node_state = nd == 0 ? (bstate * 4) & 0x3F
                       : r01n ? (bstate * 4 + 2) & 0x3F
                       : repn ? (bstate * 4 + 3) & 0x3F
                              : (bstate * 4 + 1) & 0x3F;
            const int32_t di = nd - 1 < 0 ? 0 : (nd - 1 > 3 ? 3 : nd - 1);
            for (int k = 0; k < 4; ++k) {
                nrp[k] = repn ? (k == 0 ? brep[di] : k <= di ? brep[k - 1]
                                                             : brep[k])
                       : nd > 4 ? (k == 0 ? nd - 4 : brep[k - 1])
                                : brep[k];
            }
            nstate[w] = node_state;
            for (int k = 0; k < 4; ++k) nrep[k * n + w] = nrp[k];
        }
        if (apcur >= aplimit) {       // the cap (csc_lz.cpp:239-242)
            ended = true;
            post = POST_NONE;
            post_len = post_dist = 0;
            return true;
        }

        // the lanes: reps 0-3, then the candidate rows
        const int C = s.ncand;
        int32_t len[LANES], cd[MAX_CAND], cl[MAX_CAND];
        int32_t rmax = 0;
        for (int k = 0; k < 4; ++k) {
            const int32_t dk = nrp[k];
            const int64_t q = dk > 0 && wpos - dk >= 0 ? wpos - dk : -1;
            int32_t r;
            len[k] = extend(wpos, q, 0, limit, r);
            rmax = r > rmax ? r : rmax;
        }
        for (int c = 0; c < C; ++c) {
            const int32_t pk = s.cand[(int64_t)c * n + w];
            cd[c] = pk >> 5;
            cl[c] = pk & 31;
            const bool need = cl[c] >= EXT_CAP && limit > EXT_CAP && cd[c] > 0;
            int32_t r = 0;
            len[4 + c] = need ? extend(wpos, wpos - cd[c], EXT_CAP, limit, r)
                              : cl[c];
            rmax = r > rmax ? r : rmax;
        }
        // the steps the plain version's 8-round extensions take here
        const int64_t more = (rmax + 7) / 8 - 1;
        if (more > 0) {
            if (steps + more > s.max_steps) {
                steps = s.max_steps;
                return false;
            }
            steps += more;
        }
        const int32_t st = more > 0 && apcur == 0 ? (node_state * 4) & 0x3F
                                                  : node_state;

        // the fold in find_match order (parse_ap.py:407-463)
        const int32_t good_len = s.good_len;
        int32_t minlen = 1, last_l = 1, last_d = 0;
        uint32_t dist_var = 0;
        bool gl = false;
        bool rec[LANES];
        int32_t ldist[LANES], lbase[LANES], lrd[LANES];
        const bool r01 = len[0] >= 2;
        if (r01) last_d = 1;
        for (int k = 0; k < 4; ++k) {
            const int32_t lk = len[k] < limit ? len[k] : limit;
            len[k] = lk;
            const bool bet = !gl && lk > minlen;
            if (bet) {
                minlen = lk;
                last_l = lk;
                last_d = k + 1;
            }
            gl = gl || (bet && lk >= good_len);
            rec[k] = bet;
            ldist[k] = k + 1;
            lbase[k] = s.pr.repd[st * 4 + k];
            lrd[k] = 0;
        }
        const uint32_t vld = (uint32_t)(s.dict_size - 8 * 1024 - 4);
        const int32_t matchf = s.pr.matchf[st];
        for (int c = 0; c < C; ++c) {
            const int32_t dv = cd[c];
            const int32_t lv = len[4 + c] < limit ? len[4 + c] : limit;
            len[4 + c] = lv;
            const bool gate = dv > 0 && (uint32_t)dv > dist_var && !gl;
            if (gate) dist_var = (uint32_t)dv;
            // the vld_rge gate and the HT2 wrap quirk (c = 0)
            const bool ok = gate && (uint32_t)dv < vld && (c != 0 || dv != wpos);
            const bool bet = ok && lv > minlen;
            if (bet) minlen = lv;
            rec[4 + c] = bet && (lv > 6 || dv < dist_bound(lv));
            if (rec[4 + c]) {
                last_l = lv;
                last_d = dv + 4;
            }
            gl = gl || (bet && lv >= good_len);
            ldist[4 + c] = dv + 4;
            // csc_tpu's distance price (parse_ap.py:460-462)
            const int32_t slot2 = dist_slot(dv - 1) + 2;
            lbase[4 + c] = matchf + 128 * (slot2 > 4 ? slot2 : 4);
            lrd[4 + c] = dv;
        }

        // per-length prices: each length from the first recorded lane
        // past the longest before it (FindMatchWithPrice's sweep)
        int32_t appt_d[MAX_GOOD_LEN + 1], appt_p[MAX_GOOD_LEN + 1];
        for (int L = 2; L <= good_len; ++L) {
            appt_d[L] = 0;
            appt_p[L] = INF;
        }
        int32_t lpos = 1;
        for (int k = 0; k < 4 + C; ++k) {
            if (!rec[k]) continue;
            const int32_t top = len[k] < good_len ? len[k] : good_len;
            for (int L = lpos + 1 > 2 ? lpos + 1 : 2; L <= top; ++L) {
                if (L <= 6 && lrd[k] >= dist_bound(L)) {
                    appt_d[L] = 0;
                } else {
                    appt_d[L] = ldist[k];
                    appt_p[L] = lbase[k] + s.pr.lenp[L - 2 < 31 ? L - 2 : 31];
                }
            }
            lpos = len[k] > lpos ? len[k] : lpos;
        }

        // stretch-end checks (csc_lz.cpp:239-267, in order)
        if (last_l == 1 && apcur + 1 == apend) {
            ended = true;
            post = POST_LIT;
            post_len = 1;
            post_dist = 0;
            return true;
        }
        if (apcur + 1 >= apend) apend = apcur + 2;
        if (last_l >= good_len || (last_l > 1 && last_l + apcur >= aplimit)) {
            ended = true;
            post = POST_MATCH;
            post_len = last_l;
            post_dist = last_d;
            return true;
        }

        // relaxation: the literal, rep0len1 into the same cell, matches
        const int32_t myp = stamp[w] == sid ? price[w] : 0;
        const int32_t litp = s.pr.lit_tree[s.data[w]] + s.pr.flag0[st];
        const int64_t i1 = ci((int64_t)wpos + 1);
        int32_t cp1 = stamp[i1] == sid ? price[i1] : INF;
        if (litp + myp < cp1) {
            cp1 = litp + myp;
            price[i1] = cp1;
            back[i1] = wpos;
            ndist[i1] = 0;
            stamp[i1] = sid;
        }
        if (r01 && s.pr.r01[st] + myp < cp1) {
            price[i1] = s.pr.r01[st] + myp;
            back[i1] = wpos;
            ndist[i1] = 1;
            stamp[i1] = sid;
        }
        const int32_t top = last_l < good_len ? last_l : good_len;
        for (int L = 2; L <= top; ++L) {
            const int64_t t = (int64_t)wpos + L;
            if (appt_d[L] <= 0 || t >= n - 1) continue;
            const int32_t newp = appt_p[L] + myp;
            const int32_t curp = stamp[t] == sid ? price[t] : INF;
            if (newp < curp) {
                price[t] = newp;
                back[t] = wpos;
                ndist[t] = appt_d[L];
                stamp[t] = sid;
            }
        }
        if (last_l > 1 && apcur + last_l + 1 > apend)
            apend = apcur + last_l + 1;
        ++wpos;
        return true;
    }

    K4_FN Result run() {
        price = s.cells;
        stamp = price + s.n;
        back = stamp + s.n;
        ndist = back + s.n;
        nstate = ndist + s.n;
        nxt = nstate + s.n;
        nrep = nxt + s.n;
        for (int k = 0; k < 4; ++k) reps[k] = s.dict_size;
        mstate = 0;
        tok = 0;
        err = 0;
        steps = 0;
        int32_t done = 0;
        int32_t wpos = 0, sid = 0;
        int32_t run_idx = 0, run_end = s.run_ends[0];
        int32_t blk_off = 0, blk_len = 0, blk_i = 0;
        while (step()) {
            // ---- sub-block / run bookkeeping (AP_BLOCK)
            if (blk_i >= blk_len) {
                const int32_t nboff = blk_off + blk_len;
                if (nboff >= run_end && blk_len > 0) {
                    put(K_SENT_A, 0, false);
                    ++run_idx;
                    run_end = s.run_ends[run_idx < s.nrun ? run_idx
                                                          : s.nrun - 1];
                    blk_off = nboff;
                    blk_len = blk_i = 0;
                    continue;
                }
                if (nboff >= s.size) {
                    put(K_END, 0, false);
                    done = 1;
                    break;
                }
                blk_off = nboff;
                blk_i = 0;
                if (s.run_skip[run_idx < s.nrun ? run_idx : s.nrun - 1]) {
                    blk_len = blk_i = run_end - nboff;
                    wpos += blk_len;
                    continue;
                }
                blk_len = run_end - nboff < SUB_BLOCK ? run_end - nboff
                                                      : SUB_BLOCK;
            }
            // ---- stretches of the sub-block (AP_FIND, AP_MARK, AP_WALK)
            reset(wpos, ++sid);
            int32_t s0 = wpos;
            while (true) {
                int32_t apend = 1, post = 0, post_len = 0, post_dist = 0;
                bool ended = false;
                while (!ended) {
                    if (!find(wpos, s0, sid, blk_len - blk_i, apend, ended,
                              post, post_len, post_dist))
                        goto out;
                }
                const int32_t end = wpos;
                // mark the path back to s0
                int32_t wk = end;
                while (true) {
                    if (!step()) goto out;
                    if (wk <= s0) break;
                    const int32_t bk = back[ci(wk)];
                    nxt[ci(bk)] = wk;
                    wk = bk;
                }
                // walk it forward, a token a cell
                wk = s0;
                while (true) {
                    if (!step()) goto out;
                    if (wk >= end) break;
                    const int32_t nx = nxt[ci(wk)];
                    emit(nx - wk, ndist[ci(nx)]);
                    wk = nx;
                }
                // the end node, the post action, the next stretch
                mstate = nstate[ci(end)];
                for (int k = 0; k < 4; ++k) reps[k] = nrep[k * s.n + ci(end)];
                int32_t adv = 0;
                if (post == POST_LIT) {
                    emit(1, 0);
                    adv = 1;
                } else if (post == POST_MATCH) {
                    emit(post_len, post_dist);
                    adv = post_len;
                }
                blk_i += end - s0 + adv;
                wpos = end + adv;
                if (blk_i >= blk_len) break;
                reset(wpos, ++sid);
                s0 = wpos;
            }
        }
    out:
        if (!done && err == 0) err = ERR_STEPS;
        return Result{tok, done, err};
    }
};

K4_FN Result parse_stream(const Stream& s) {
    Parser p;
    p.s = s;
    return p.run();
}

}  // namespace k4
