// K5: per-stream exact m1/m2 parse with live hash tables, one thread a
// stream (csc_mf.cpp's HT2 / HT3 / HT6 finders and csc_lz.cpp's lazy
// parser, compress_normal csc_lz.cpp:156-199, as csc_tpu/ops/
// encode_scan.py emulates them bit for bit).
//
// One call parses one whole stream with the natural loops of the
// reference: per 8 KB sub-block, per position a find (hash the position,
// probe the four reps, HT2, HT3 and the HT6 row, extend each candidate
// that passes its gates, record it, insert the position), FindMatch's
// pick, the lazy decision (a second find at wpos + 1 and
// SecondMatchBetter), the token, then SlidePos over the token's other
// positions.  The hash tables (int32, one slice a stream) and the data
// are read from memory; a candidate's 4-byte words are put together from
// bytes in registers.
//
// The steps.  csc_tpu runs the parse as a lockstep while_loop, one
// micro-op a stream a step, and its pipeline stops a group that is not
// done after 64 * N + 4096 steps.  K5 counts the same micro-ops as it
// goes: one a sub-block / stream visit (E_BLOCK), a find's set-up
// (E_PREP), a probe or the find's finish (E_PROBE), a 4-byte word of
// extension (E_EXT), a decision (E_DECIDE), an insertion (E_INS, four
// positions while 128 remain) and the end of a slide.  A micro-op past
// the budget stops the parse before it writes, so a budget cuts K5 at
// the token where it cuts the lockstep version.
//
// The same source builds with nvcc (the __global__ wrapper in
// encode_k5.cu) and with g++ (the test harness encode_k5_host.cpp), so
// the CPU tests hold this logic against the plain PyTorch version
// (csc_tpu_torch/ops/exact_scan.py) before it runs on a card.
//
// Contract with the plain version, for every stream: the same tape words
// (kind | wire_len << 3, dist_code) over the first tok_cnt tokens, the
// same tok_cnt, done, err and steps.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define K5_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define K5_FN inline
#endif

namespace k5 {

// parse-tape token kinds (encode_scan.py:36-41)
constexpr int32_t K_LIT = 0;
constexpr int32_t K_MATCH = 1;
constexpr int32_t K_REP = 2;
constexpr int32_t K_REP0L1 = 3;
constexpr int32_t K_SENT_A = 4;
constexpr int32_t K_END = 5;
constexpr int32_t HT2_SIZE = 16 * 1024;
constexpr int32_t HT3_SIZE = 64 * 1024;
constexpr int NCAND = 20;            // candidate slots of one find
constexpr int32_t SUB_BLOCK = 8192;  // csc_lz.cpp:63-67
constexpr int32_t FAST_SLIDE = 128;  // stride-4 insertion while i + 128 < len
constexpr int32_t ERR_OVERFLOW = 1;  // the tape is full
constexpr int32_t ERR_STEPS = 2;     // the step budget ran out
constexpr int32_t MAX_WIDTH = 8;     // HT6 row width (m2)

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    int64_t n;
    const int32_t* run_ends; // [R] cumulative run ends
    int32_t nrun;
    int32_t size, dict_size;
    int32_t hash_bits, hash_width, good_len, lazy;
    int32_t* ht2;            // [HT2_SIZE], zeros
    int32_t* ht3;            // [HT3_SIZE], zeros
    int32_t* ht6;            // [hash_width << hash_bits], zeros
    int32_t* tape;           // [T][2]
    int64_t tcap;            // T
    int64_t max_steps;
};

struct Result {
    int32_t tok_cnt, done, err, steps;
};

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K5_FN int32_t dist_bound(int32_t l) {
    return l <= 1 ? 0 : l == 2 ? 64 : l == 3 ? 1024 : l == 4 ? 16 * 1024
         : l == 5 ? 256 * 1024 : l == 6 ? 4 * 1024 * 1024 : 0x7FFFFFFF;
}

K5_FN int32_t clampi(int32_t v, int32_t hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

// SecondMatchBetter (csc_mf.cpp:570-582)
K5_FN bool second_better(int32_t l1, int32_t d1, int32_t l2, int32_t d2) {
    if (l2 <= 1) return false;
    const int32_t c21 = 4 * clampi(l2 - l1, 3);
    const int32_t c12 = 4 * clampi(l1 - l2, 3);
    return (l2 > l1 + 3) || (l2 > l1 && d2 <= 4) ||
           (l2 + 2 > l1 && d2 <= 4 && d1 > 4) ||
           (l2 >= l1 && (d2 >> c21) <= d1) ||
           (l2 < l1 && l2 + 2 >= l1 && d1 > 4 && (d1 >> c12) > d2);
}

// equal low bytes of a 4-byte xor word: 4 when x == 0
K5_FN int32_t eq_bytes(uint32_t x) {
    return x == 0 ? 4 : (x & 0xFF) ? 0 : (x & 0xFFFF) ? 1
         : (x & 0xFFFFFF) ? 2 : 3;
}

struct Hashes {
    int32_t h2, h3, h6;
};

// The stream's parse, one thread.
struct Parser {
    Stream s;
    int64_t steps;
    bool cut;                // a micro-op past the budget
    int64_t tok;             // tokens written (some clipped to the end)
    int32_t pos, vld_rge;    // the finder's position and valid range
    int32_t reps[4];
    int32_t blk_off, blk_len, blk_i, lasth6;
    // one find's candidates
    int32_t cl[NCAND], cd[NCAND];
    int cnt;

    // one lockstep micro-op; false once it is past the budget
    K5_FN bool step(int64_t k = 1) {
        steps += k;
        if (steps > s.max_steps) cut = true;
        return !cut;
    }

    K5_FN int64_t clip(int64_t i) const {
        return i < 0 ? 0 : (i >= s.n ? s.n - 1 : i);
    }

    // the 4-byte little-endian word at clip(i), zeros past the data
    K5_FN uint32_t word(int64_t i) const {
        i = clip(i);
        uint32_t w = 0;
        for (int k = 0; k < 4; ++k)
            if (i + k < s.n) w |= (uint32_t)s.data[i + k] << (8 * k);
        return w;
    }

    // HASH2 / HASH3 / HASH6 of position p, whose sub-block ends rem bytes
    // ahead: bytes at and past the end read as zeros (encode_scan.py
    // `_mask_lookahead`; the reference's window holds only the sub-blocks
    // copied so far)
    K5_FN Hashes hashes(int64_t p, int64_t rem, bool h6) const {
        uint32_t b[6];
        for (int j = 0; j < 6; ++j)
            b[j] = j < rem ? s.data[p + j] : 0;
        const uint32_t v2 = b[0] | b[1] << 8;
        Hashes h;
        h.h2 = (int32_t)((v2 * 65521u) & 0x3FFF);
        h.h3 = (int32_t)(((b[0] << 8) ^ (b[1] << 5) ^ b[2]) & 0xFFFF);
        h.h6 = 0;
        if (h6) {
            const uint32_t v4 = v2 | b[2] << 16 | b[3] << 24;
            const uint32_t v2b = b[4] | b[5] << 8;
            h.h6 = (int32_t)(((v4 ^ (v2b << 13)) * 2654435761u)
                             >> (32 - s.hash_bits));
        }
        return h;
    }

    // candidate slot (csc_mf.cpp's match list): the last slot is
    // rewritten once cnt + 2 reaches NCAND, and never read
    K5_FN void record(int32_t len, int32_t dist) {
        const int slot = cnt < NCAND - 1 ? cnt : NCAND - 1;
        cl[slot] = len;
        cd[slot] = dist;
        if (cnt + 2 < NCAND) ++cnt;
    }

    // the common prefix of ppos and ppos - dist, up to climit, a 4-byte
    // word a step (E_EXT); -1 once past the budget
    K5_FN int32_t extend(int64_t ppos, int32_t dist, int32_t climit) {
        int32_t el = 0;
        for (;;) {
            if (!step()) return -1;
            const int32_t eq = eq_bytes(word(ppos + el)
                                        ^ word(ppos - dist + el));
            const int32_t rem = climit - el;
            const int32_t adv = eq < rem ? eq : rem;
            el += adv;
            if (!(eq == 4 && adv == 4 && el < climit)) return el;
        }
    }

    // precheck (E_PROBE): minlen below the limit, the byte at minlen equal
    K5_FN bool precheck(int64_t ppos, int32_t dist, int32_t minlen,
                        int32_t climit) const {
        return minlen < climit && s.data[clip(ppos + minlen)]
                                  == s.data[clip(ppos - dist + minlen)];
    }

    // one find_match at ppos (limit bytes to the sub-block end): the
    // candidates, then the tables' insertion of ppos and FindMatch's pick
    // into (len, dist); false once past the budget
    K5_FN bool find(int64_t ppos, int32_t limit, int32_t& out_len,
                    int32_t& out_dist) {
        if (!step()) return false;                         // E_PREP
        const Hashes h = hashes(ppos, (int64_t)blk_off + blk_len - ppos,
                                true);
        const uint32_t vld = (uint32_t)vld_rge;
        int32_t minlen = 1;
        uint32_t dist = 0;
        cnt = 0;
        for (int ph = 0; ph < 4; ++ph) {                   // the reps
            if (!step()) return false;
            const int32_t d = reps[ph];
            if ((uint32_t)d < vld && precheck(ppos, d, minlen, limit)) {
                const int32_t len = extend(ppos, d, limit);
                if (len < 0) return false;
                if (ph == 0 && len > 0) record(1, 1);      // rep0len1
                if (len > minlen) {
                    minlen = len;
                    record(len, ph + 1);
                    if (len >= s.good_len) {
                        // on to HT2, whose gate the sentinel fails
                        dist = 0xFFFFFFFFu;
                        break;
                    }
                }
            }
        }
        const int32_t w = s.hash_width;
        int32_t* row = s.ht6 + (int64_t)h.h6 * w;
        for (int k = -2; k < w; ++k) {                     // HT2, HT3, HT6
            if (!step()) return false;
            const int32_t prev = k == -2 ? s.ht2[h.h2]
                               : k == -1 ? s.ht3[h.h3] : row[k];
            const int32_t d = pos - prev;
            if ((uint32_t)d <= dist) continue;             // distance gate
            dist = (uint32_t)d;
            if ((uint32_t)d >= vld) continue;
            // HT2's quirk (csc_mf.cpp:306): distance == position
            const int32_t climit = k == -2 && d == ppos ? 0 : limit;
            if (!precheck(ppos, d, minlen, climit)) continue;
            const int32_t len = extend(ppos, d, climit);
            if (len < 0) return false;
            if (len > minlen) {
                minlen = len;
                if (len > 6 || d < dist_bound(len)) record(len, d + 4);
                if (len >= s.good_len) dist = 0xFFFFFFFFu;
            }
        }
        if (!step()) return false;                         // the finish
        s.ht2[h.h2] = pos;
        s.ht3[h.h3] = pos;
        for (int k = w - 1; k > 0; --k) row[k] = row[k - 1];
        row[0] = pos;
        ++pos;
        int32_t bl = 1, bd = 0;                            // FindMatch
        for (int i = 0; i < cnt; ++i)
            if (i == 0 || second_better(bl, bd, cl[i], cd[i])) {
                bl = cl[i];
                bd = cd[i];
            }
        out_len = bl;
        out_dist = bd;
        return true;
    }

    K5_FN void write(int32_t w0, int32_t w1) {
        const int64_t t = tok < s.tcap ? tok : s.tcap - 1;
        s.tape[2 * t] = w0;
        s.tape[2 * t + 1] = w1;
        ++tok;
    }

    // a run-end or stream-end marker: only inside the tape
    K5_FN void marker(int32_t kind) {
        if (tok < s.tcap) {
            s.tape[2 * tok] = kind;
            s.tape[2 * tok + 1] = 0;
        }
        ++tok;
    }

    // one token (encode_nonlit coords, csc_lz.cpp:127-154) and the rep
    // queue
    K5_FN void emit(int32_t len, int32_t dist) {
        if (dist == 0) {
            write(K_LIT, 0);
        } else if (dist == 1 && len == 1) {
            write(K_REP0L1, 0);
        } else if (dist <= 4) {
            write(K_REP | (len - 2) << 3, dist - 1);
            const int32_t rd = reps[dist - 1];
            for (int k = dist - 1; k > 0; --k) reps[k] = reps[k - 1];
            reps[0] = rd;
        } else {
            write(K_MATCH | (len - 2) << 3, dist - 5);
            reps[3] = reps[2];
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = dist - 4;
        }
    }

    // SlidePos: insert base + i for i in [1, len) (E_INS), four at a time
    // into HT2 / HT3 alone while i + 128 < len; false once past the budget
    K5_FN bool slide(int64_t base, int32_t len) {
        const int32_t w = s.hash_width;
        const int64_t blk_end = (int64_t)blk_off + blk_len;
        lasth6 = 0;
        for (int32_t i = 1;;) {
            if (!step()) return false;
            if (i >= len) return true;
            const int64_t ipos = base + i;
            const bool fast = i + FAST_SLIDE < len;
            const Hashes h = hashes(ipos, blk_end - ipos, !fast);
            s.ht2[h.h2] = pos;
            s.ht3[h.h3] = pos;
            if (fast) {
                i += 4;
                pos += 4;
                continue;
            }
            int32_t* row = s.ht6 + (int64_t)h.h6 * w;
            if (h.h6 != lasth6)
                for (int k = w - 1; k > 0; --k) row[k] = row[k - 1];
            row[0] = pos;
            lasth6 = h.h6;
            ++i;
            ++pos;
        }
    }

    K5_FN Result run() {
        steps = 0;
        cut = false;
        tok = 0;
        vld_rge = s.dict_size - 8 * 1024 - 4;
        pos = vld_rge;
        for (int k = 0; k < 4; ++k) reps[k] = s.dict_size;
        blk_off = blk_len = blk_i = lasth6 = 0;
        int32_t run_idx = 0, run_end = s.run_ends[0];
        int64_t wpos = 0;
        bool have_u1 = false, done = false;
        int32_t u1_len = 0, u1_dist = 0;
        while (!cut) {
            if (!step()) break;                            // E_BLOCK
            if (blk_i >= blk_len) {
                const int32_t nboff = blk_off + blk_len;
                if (nboff >= run_end && blk_len > 0) {
                    marker(K_SENT_A);                      // csc_lz.cpp:97
                    ++run_idx;
                    run_end = s.run_ends[run_idx < s.nrun ? run_idx
                                                          : s.nrun - 1];
                    blk_off = nboff;
                    blk_len = blk_i = 0;
                    have_u1 = false;
                    continue;
                }
                if (nboff >= s.size) {
                    marker(K_END);
                    done = true;
                    break;
                }
                // a pending first pick never spans a sub-block: the find
                // that made it had two bytes or more to the end
                blk_off = nboff;
                blk_len = run_end - nboff < SUB_BLOCK ? run_end - nboff
                                                      : SUB_BLOCK;
                blk_i = 0;
                have_u1 = false;
            }
            int32_t l1 = u1_len, d1 = u1_dist;
            if (!have_u1 && !find(wpos, blk_len - blk_i, l1, d1)) break;
            if (!step()) break;                            // E_DECIDE
            if (l1 == 1 || !s.lazy || l1 >= s.good_len) {
                emit(l1, d1);
                blk_i += l1;
                wpos += l1;
                have_u1 = false;
                if (!slide(wpos - l1, l1)) break;
                continue;
            }
            // the lazy second find at wpos + 1
            u1_len = l1;
            u1_dist = d1;
            int32_t l2, d2;
            if (!find(wpos + 1, blk_len - blk_i - 1, l2, d2)) break;
            if (!step()) break;                            // E_DECIDE
            if (second_better(l1, d1, l2, d2)) {
                emit(1, 0);
                blk_i += 1;
                wpos += 1;
                u1_len = l2;
                u1_dist = d2;
                have_u1 = true;
                continue;
            }
            // u1 after all: wpos + 1 is in the tables already
            emit(l1, d1);
            blk_i += l1;
            wpos += l1;
            have_u1 = false;
            if (!slide(wpos - l1 + 1, l1 - 1)) break;
        }
        Result r;
        r.tok_cnt = (int32_t)tok;
        r.done = done ? 1 : 0;
        r.err = tok > s.tcap ? ERR_OVERFLOW : done ? 0 : ERR_STEPS;
        r.steps = (int32_t)(cut ? s.max_steps : steps);
        return r;
    }
};

K5_FN Result parse_stream(const Stream& s) {
    Parser p;
    p.s = s;
    return p.run();
}

}  // namespace k5
