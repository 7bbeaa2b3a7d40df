// K4: per-stream optimal (AP) parse of m3-m5 over precomputed candidates
// and snapshot prices (compress_advanced, csc_lz.cpp:207-333, in the
// candidate-fold form of csc_tpu/ops/parse_ap.py), one warp a stream.
//
// A stream is cut into 8 KB sub-blocks inside its runs (runs with no
// parse are skipped whole, a K_SENT_A ends each run, K_END the stream).
// A sub-block is parsed in stretches.  A stretch is a shortest path over
// cells s0 .. s0 + aplimit: at each position the node's model state and
// rep queue are rebuilt from its back pointer, the rep and candidate
// lanes are extended, folded in find_match order (csc_mf.cpp:243-495),
// and every length 2..good_len is priced; the stretch ends on a lone
// literal, a match of good_len or one reaching the cap, or the cap
// itself, and otherwise the literal, rep0len1 and match cells are
// relaxed.  At the end the path is marked back to the stretch start and
// walked forward, one token a cell, and the post-stretch literal or match
// follows.
//
// The parse state (rep queue, model state, block / run / stretch
// bookkeeping) is uniform across the warp: every lane runs the same
// control flow on the same values, and lane 0 alone writes the tape, the
// literal's relaxation, MARK and the stretch-start cell.  A FIND position
// is spread:
//   - what does not hang on the node comes from a candidate pass over
//     the next CHUNK positions, one position a lane (fill_chunk): each
//     candidate row's length (extended from EXT_CAP, cut at the
//     sub-block end), its distance gate (the prefix maximum of the
//     earlier rows' distances), whether it is near, and the longest
//     earlier passing row (the rows' prefix maximum of lengths);
//   - lane k < 4 + C owns rep lane k (extended from the node's rep
//     queue, EXT_WORDS words a compare) or candidate row k - 4 (read
//     from the pass);
//   - the fold is then branch-free in each lane: minlen is the larger of
//     the rep lanes' prefix maximum (four shuffles) and the row's own
//     prefix maximum, and two ballots find the good_len exit and the
//     recorded lanes;
//   - the recorded lanes' lengths grow lane by lane and stay below
//     good_len where the grid runs: each recorded lane writes its
//     distance code and base price at its length in a table and sets
//     its length's bit in a 64-bit mask (two warp ORs); length L belongs
//     to lane (L - 2) mod 32, whose pricing lane is the one at the
//     lowest set bit of the mask at or above L, and it relaxes cell
//     wpos + L.  No two lengths share a cell, so no two lanes write one
//     cell;
//   - a winning relaxation also leaves at its target the node its token
//     makes there (model state and rep queue, as the rebuild from the
//     back pointer would give it): the FIND at that cell takes it with
//     one shared load and keeps it in registers.  The stretch's end node
//     is the last FIND's.
//
// The stretch's cells live in shared memory in the nvcc build (Window):
// back, ndist and nxt in a window of WINDOW cells, the cell of position
// p at min(p, n - 1) - s0, as csc_tpu's gathers clip; price and the node
// a relaxation leaves in a ring of RING cells at min(p, n - 1) mod RING,
// live only while its key is (stretch id, position), so no stretch
// clears either.  The stretch-end checks bound every cell a stretch
// touches to offset aplimit - 1 (a match reaching aplimit ends the
// stretch, and at offset aplimit - 1 apend = aplimit, so a lone literal
// ends it there), and the cap's rebuild, were it reached, reads offset
// aplimit: WINDOW = AP_LIMIT + 1.  The reads that take no key (the node
// a relaxation left at wpos, nxt in WALK, back in MARK) read cells this
// stretch wrote: each position the stretch visits was relaxed by one of
// the RING - 1 before it, and each back pointer is a visited position.
// A node (model state and rep queue) is kept in registers from its FIND
// on, so the end node needs no row.  With a non-null `cells` every cell
// write also goes to cells[row][min(p, n - 1)] (rows price, stamp, back,
// ndist, nstate, nxt, nrep[4]; back and nxt absolute; nstate and nrep
// where a FIND or a stretch start sets its node), so that array ends
// equal to the plain version's cells.
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
// card.  The lane operations sit behind `Lanes`: in the nvcc build a
// lane's own value with __shfl_sync / __ballot_sync, in the g++ build all
// 32 lanes' values computed in a loop.  Contract, for every stream: the
// same tape words (kind | wire_len << 3, dist_code) over the first
// tok_cnt tokens, the same tok_cnt, done and err.
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
constexpr int WARP = 32;
constexpr int MAX_CAND = 12;          // candidate rows (2 + hash_width)
constexpr int MAX_GOOD_LEN = 64;      // the length grid's top: 2 lengths a lane
constexpr int CELL_ROWS = 10;         // rows of the debug cells
constexpr int WINDOW = AP_LIMIT + 1;  // cells of a stretch
constexpr int EXT_WORDS = 2;          // words a lane compares at once
// zero words after the staged data: a compare at p < n reads words up
// to (p >> 2) + EXT_WORDS
constexpr int WORDS_PAD = EXT_WORDS;

// the price tables (ops/prices.py TABLES order), 1/128 bit each, at
// fixed offsets from one pointer
struct Prices {
    const int32_t* p;
    K4_FN int32_t lit_tree(int i) const { return p[i]; }         // [256]
    K4_FN int32_t flag0(int i) const { return p[256 + i]; }      // [64]
    K4_FN int32_t r01(int i) const { return p[320 + i]; }        // [64]
    K4_FN int32_t repd(int i) const { return p[384 + i]; }       // [64][4]
    K4_FN int32_t matchf(int i) const { return p[640 + i]; }     // [64]
    K4_FN int32_t lenp(int i) const { return p[704 + i]; }       // [32]
};

K4_FN Prices prices_at(const int32_t* packed) { return Prices{packed}; }
constexpr int PRICES_LEN = 736;

// a node's rep queue, one 16-byte load
struct alignas(16) Rep4 {
    int32_t r0, r1, r2, r3;
};

// The window: the rows MARK and WALK read anywhere in the stretch (back,
// ndist, nxt; WINDOW cells, back and nxt offsets from the stretch start)
// and a ring of RING cells, the cell of position p at p mod RING, for the
// rows only the relaxation frontier reads (price, key, and the node a
// winning relaxation makes there: pstate, prep).  A FIND at wpos relaxes
// cells wpos + 1 .. wpos + RING - 1 (every relaxed length is below
// good_len <= MAX_GOOD_LEN = RING), and no later position reads a cell
// before it, so a ring cell is written for position p only from
// positions p - RING + 1 .. p - 1, and read last at p.  Its key (the
// stretch id and p) says whether this stretch wrote it for p.  Then the
// candidate rows of CHUNK positions (lane_len: length | flags,
// lane_dist: distance; [position][row]) and a position's grid table
// (by_len_*: the distance code and base price of the recorded lane of
// each length).  All at fixed offsets from one 16-byte aligned pointer,
// WINDOW_BYTES in all.
constexpr int RING = MAX_GOOD_LEN;
static_assert((RING & (RING - 1)) == 0, "RING must be a power of two");
constexpr int CHUNK = WARP;           // positions a candidate pass covers
constexpr int OFF_PREP = 0;
constexpr int OFF_KEY = OFF_PREP + RING * 16;
constexpr int OFF_PRICE = OFF_KEY + RING * 8;
constexpr int OFF_PSTATE = OFF_PRICE + RING * 4;
constexpr int OFF_NDIST = OFF_PSTATE + RING;
constexpr int OFF_BACK = OFF_NDIST + WINDOW * 4;
constexpr int OFF_NXT = OFF_BACK + WINDOW * 2;
constexpr int OFF_LANE_LEN = (OFF_NXT + WINDOW * 2 + 15) / 16 * 16;
constexpr int OFF_LANE_DIST = OFF_LANE_LEN + CHUNK * MAX_CAND * 4;
constexpr int OFF_BY_LEN_D = OFF_LANE_DIST + CHUNK * MAX_CAND * 4;
constexpr int OFF_BY_LEN_B = OFF_BY_LEN_D + MAX_GOOD_LEN * 4;
constexpr int WINDOW_BYTES = OFF_BY_LEN_B + MAX_GOOD_LEN * 4;

struct Window {
    uint8_t* base;
    template <class T>
    K4_FN T& at(int off, int i) const { return ((T*)(base + off))[i]; }
    // ring rows, by ring cell
    K4_FN Rep4& prep(int i) const { return at<Rep4>(OFF_PREP, i); }
    K4_FN uint64_t& key(int i) const { return at<uint64_t>(OFF_KEY, i); }
    K4_FN int32_t& price(int i) const { return at<int32_t>(OFF_PRICE, i); }
    K4_FN uint8_t& pstate(int i) const { return at<uint8_t>(OFF_PSTATE, i); }
    // window rows, by window cell
    K4_FN int32_t& ndist(int i) const { return at<int32_t>(OFF_NDIST, i); }
    K4_FN int16_t& back(int i) const { return at<int16_t>(OFF_BACK, i); }
    K4_FN int16_t& nxt(int i) const { return at<int16_t>(OFF_NXT, i); }
    K4_FN int32_t& lane_len(int i) const {
        return at<int32_t>(OFF_LANE_LEN, i);
    }
    K4_FN int32_t& lane_dist(int i) const {
        return at<int32_t>(OFF_LANE_DIST, i);
    }
    K4_FN int32_t& by_len_d(int i) const {
        return at<int32_t>(OFF_BY_LEN_D, i);
    }
    K4_FN int32_t& by_len_b(int i) const {
        return at<int32_t>(OFF_BY_LEN_B, i);
    }
};

K4_FN Window window_at(void* base) { return Window{(uint8_t*)base}; }

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    const uint32_t* words;   // the same staged as words with WORDS_PAD
                             // words of zeros after them, or null
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
    int32_t* cells;          // [CELL_ROWS][n] debug copy of the cells, or null
    Prices pr;
    Window win;              // ring keys at 0 (stretch ids start at 1)
};

struct Result {
    int32_t tok_cnt, done, err, finds;
};

// ------------------------------------------------------------------ lanes
// One int32 a lane.  nvcc: this lane's value; g++: all 32.
#ifdef __CUDA_ARCH__
struct Lanes {
    int32_t v;
};
K4_FN int lane_id() { return threadIdx.x & (WARP - 1); }
template <class F>
K4_FN Lanes lanes(F f) { return Lanes{f(lane_id())}; }
template <class F>
K4_FN void each(F f) { f(lane_id()); }
K4_FN int32_t own(const Lanes& x, int) { return x.v; }
K4_FN int32_t get(const Lanes& x, int src) {
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
}
K4_FN uint32_t ballot(const Lanes& x) {
    return __ballot_sync(0xFFFFFFFFu, x.v != 0);
}
K4_FN int32_t max_all(const Lanes& x) {
    return __reduce_max_sync(0xFFFFFFFFu, x.v);
}
K4_FN uint32_t or_all(const Lanes& x) {
    return __reduce_or_sync(0xFFFFFFFFu, (uint32_t)x.v);
}
K4_FN bool leader() { return lane_id() == 0; }
K4_FN void sync() { __syncwarp(); }
K4_FN int32_t clz32(uint32_t x) { return __clz(x); }
K4_FN int32_t ctz32(uint32_t x) { return __clz(__brev(x)); }  // 32 at 0
K4_FN int32_t ctz64(uint64_t x) { return __ffsll((long long)x) - 1; }
K4_FN uint32_t funnel(uint32_t lo, uint32_t hi, uint32_t sh) {
    return __funnelshift_r(lo, hi, sh);
}
#else
struct Lanes {
    int32_t v[WARP];
};
template <class F>
K4_FN Lanes lanes(F f) {
    Lanes x;
    for (int l = 0; l < WARP; ++l) x.v[l] = f(l);
    return x;
}
template <class F>
K4_FN void each(F f) {
    for (int l = 0; l < WARP; ++l) f(l);
}
K4_FN int32_t own(const Lanes& x, int l) { return x.v[l]; }
K4_FN int32_t get(const Lanes& x, int src) { return x.v[src]; }
K4_FN uint32_t ballot(const Lanes& x) {
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) m |= (uint32_t)(x.v[l] != 0) << l;
    return m;
}
K4_FN int32_t max_all(const Lanes& x) {
    int32_t m = x.v[0];
    for (int l = 1; l < WARP; ++l) m = x.v[l] > m ? x.v[l] : m;
    return m;
}
K4_FN uint32_t or_all(const Lanes& x) {
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) m |= (uint32_t)x.v[l];
    return m;
}
K4_FN bool leader() { return true; }
K4_FN void sync() {}
K4_FN int32_t clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
K4_FN int32_t ctz32(uint32_t x) { return x ? __builtin_ctz(x) : 32; }
K4_FN int32_t ctz64(uint64_t x) { return __builtin_ctzll(x); }
K4_FN uint32_t funnel(uint32_t lo, uint32_t hi, uint32_t sh) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
}
#endif

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K4_FN int32_t dist_bound(int32_t l) {
    return l <= 1 ? 0 : l == 2 ? 64 : l == 3 ? 1024 : l == 4 ? 16 * 1024
         : l == 5 ? 256 * 1024 : l == 6 ? 4 * 1024 * 1024 : 0x7FFFFFFF;
}

// _dist_slot (csc_model.cpp:331-340): the DIST_TABLE entries past the
// first that are <= d; DIST_TABLE[s] = 2^(s-2) + 1 for s >= 2
K4_FN int32_t dist_slot(int32_t d) {
    return d < 1 ? 0 : d == 1 ? 1 : 33 - clz32((uint32_t)(d - 1));
}

// the model state after a token of u_len bytes at distance code u_dist
K4_FN int32_t next_state(int32_t s, int32_t len, int32_t dist) {
    return dist == 0 ? (s * 4) & 0x3F
         : dist == 1 && len == 1 ? (s * 4 + 2) & 0x3F
         : dist <= 4 ? (s * 4 + 3) & 0x3F : (s * 4 + 1) & 0x3F;
}

K4_FN int32_t rep_at(const Rep4& r, int k) {
    return k == 0 ? r.r0 : k == 1 ? r.r1 : k == 2 ? r.r2 : r.r3;
}

// the node after a token of distance code nd from a node (bstate, br):
// its model state and rep queue; `one`: the token is one byte long
K4_FN void node_after(int32_t bstate, const Rep4& br, int32_t nd, bool one,
                      int32_t& state, Rep4& r) {
    const bool r01n = nd == 1 && one;
    const bool repn = nd >= 1 && nd <= 4 && !r01n;
    state = nd == 0 ? (bstate * 4) & 0x3F
          : r01n ? (bstate * 4 + 2) & 0x3F
          : repn ? (bstate * 4 + 3) & 0x3F : (bstate * 4 + 1) & 0x3F;
    const int32_t di = nd - 1 < 0 ? 0 : (nd - 1 > 3 ? 3 : nd - 1);
    r = repn ? Rep4{rep_at(br, di), di >= 1 ? br.r0 : br.r1,
                    di >= 2 ? br.r1 : br.r2, di >= 3 ? br.r2 : br.r3}
      : nd > 4 ? Rep4{nd - 4, br.r0, br.r1, br.r2} : br;
}

// STAGED: the stream's data is s.words (else s.data, read as bytes);
// MIRROR: s.cells takes a copy of every cell write
template <bool STAGED, bool MIRROR>
struct Parser {
    Stream s;
    Window c;
    int32_t s0, sid;         // the stretch in the window
    int32_t tok, err;
    int64_t steps;
    int32_t mstate;
    Rep4 reps;
    int32_t chunk_at, chunk_end;  // the positions lane_len / lane_dist hold
    int32_t node_state;      // the node of the last FIND position
    Rep4 node_rep;
    int32_t finds;           // FIND positions the lanes ran at

    // one lockstep step of the budget; false when it has run out
    K4_FN bool step() {
        if (steps >= s.max_steps) return false;
        ++steps;
        return true;
    }

    // the window cell of position p >= s0, clipped as csc_tpu's gathers
    // clip
    K4_FN int32_t wi(int32_t p) const {
        return guard((p < s.n ? p : (int32_t)s.n - 1) - s0);
    }

    // a window cell; the g++ build stops on one outside the window
    K4_FN static int32_t guard(int32_t i) {
#ifndef __CUDA_ARCH__
        if ((uint32_t)i >= (uint32_t)WINDOW) __builtin_trap();
#endif
        return i;
    }

    // the ring cell of window cell i, and the key it holds when this
    // stretch wrote it for that position
    K4_FN int32_t slot(int32_t i) const { return (s0 + i) & (RING - 1); }
    K4_FN uint64_t key(int32_t i) const {
        return (uint64_t)(uint32_t)sid << 32 | (uint32_t)(s0 + i);
    }
    K4_FN bool live(int32_t i) const { return c.key(slot(i)) == key(i); }

    // the debug copy of a cell write (row, window cell, value)
    K4_FN void mirror(int row, int32_t i, int32_t v) const {
        if constexpr (MIRROR) s.cells[row * s.n + s0 + i] = v;
    }

    K4_FN uint8_t byte(int32_t p) const {
        if constexpr (STAGED)
            return (uint8_t)(s.words[p >> 2] >> (8 * (p & 3)));
        return s.data[p];
    }

    // words k = 0 .. EXT_WORDS - 1 of data[p + 4 k ..], little-endian,
    // zero past n
    K4_FN void chunk(int32_t p, uint32_t (&v)[EXT_WORDS]) const {
        if constexpr (STAGED) {
            const uint32_t* w = s.words + (p >> 2);
            const uint32_t sh = 8 * (p & 3);
            uint32_t lo = w[0];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < EXT_WORDS; ++k) {
                const uint32_t hi = w[k + 1];
                v[k] = funnel(lo, hi, sh);
                lo = hi;
            }
            return;
        }
        for (int k = 0; k < EXT_WORDS; ++k) {
            v[k] = 0;
            for (int j = 0; j < 4; ++j) {
                const int32_t i = p + 4 * k + j;
                if (i < s.n) v[k] |= (uint32_t)s.data[i] << (8 * j);
            }
        }
    }

    // the final length of a lane matching data[p..] against data[q..]
    // from l < lim, cut at lim, EXT_WORDS words a compare
    K4_FN int32_t extend(int32_t p, int32_t q, int32_t l, int32_t lim) const {
        while (true) {
            uint32_t a[EXT_WORDS], b[EXT_WORDS];
            chunk(p + l, a);
            chunk(q + l, b);
            int32_t eq = 0;
            bool same = true;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < EXT_WORDS; ++k) {
                const uint32_t x = a[k] ^ b[k];
                eq += same ? ctz32(x) >> 3 : 0;
                same = same && x == 0;
            }
            const int32_t room = lim - l;
            l += eq < room ? eq : room;
            if (!same || l >= lim) return l;
        }
    }

    // a full tape keeps counting; a token then rewrites the last entry
    // and a sentinel writes nothing (parse_ap.py: K_SENT_A / K_END at
    // tok_cnt, tokens at tok_cnt clipped)
    K4_FN void put(int32_t w0, int32_t w1, bool token) {
        const bool full = tok >= s.tcap;
        if (full) err = ERR_OVERFLOW;
        if (leader() && (token || !full)) {
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
            const Rep4 r = reps;
            reps = Rep4{rep_at(r, dist - 1), dist >= 2 ? r.r0 : r.r1,
                        dist >= 3 ? r.r1 : r.r2, dist >= 4 ? r.r2 : r.r3};
        } else {
            put(K_MATCH | ((len - 2) << 3), dist - 5, true);
            reps = Rep4{dist - 4, reps.r0, reps.r1, reps.r2};
        }
        mstate = next_state(mstate, len, dist);
    }

    // the node at window cell i: its model state and rep queue, kept
    // in registers (and in the debug copy)
    K4_FN void set_node(int32_t i, int32_t state, const Rep4& r) {
        node_state = state;
        node_rep = r;
        if (!MIRROR || !leader()) return;
        mirror(4, i, state);
        mirror(6, i, r.r0);
        mirror(7, i, r.r1);
        mirror(8, i, r.r2);
        mirror(9, i, r.r3);
    }

    // a relaxation into cell i from position `from`
    K4_FN void set_cell(int32_t i, int32_t price, int32_t from, int32_t nd) {
        const int32_t r = slot(i);
        c.price(r) = price;
        c.key(r) = key(i);
        c.back(i) = (int16_t)(from - s0);
        c.ndist(i) = nd;
        mirror(0, i, price);
        mirror(1, i, sid);
        mirror(2, i, from);
        mirror(3, i, nd);
    }

    // a winning relaxation into cell i from position `from` (its node
    // state and reps) by a token of distance code nd, one byte long or
    // not: the cell and the node the token makes there, which the FIND
    // at that cell takes as it is
    K4_FN void relax(int32_t i, int32_t price, int32_t from, int32_t nd,
                     bool one, int32_t state, const Rep4& r) {
        set_cell(i, price, from, nd);
        int32_t ps;
        Rep4 pr4;
        node_after(state, r, nd, one, ps, pr4);
        c.pstate(slot(i)) = (uint8_t)ps;
        c.prep(slot(i)) = pr4;
    }

    // _stretch_reset: stretch `id` rooted at p with the live registers
    K4_FN void reset(int32_t p, int32_t id) {
        s0 = p;
        sid = id;
        if (leader()) set_cell(0, 0, p, 0);
        set_node(0, mstate, reps);
        sync();
    }

    // The candidate rows of positions p0 .. p0 + CHUNK - 1 of the sub-block
    // ending at blk_end, one position a lane: what does not hang on the
    // node.  Row r's length (its packed length, or extended from EXT_CAP
    // when that reaches EXT_CAP, cut at the sub-block end) and flags: it
    // passes the distance gate (beats every earlier row's distance, under
    // vld_rge, not the HT2 wrap quirk at row 0), it is near (within
    // MF_DIST_BOUND of its length), it compared bytes; and the longest
    // earlier passing row (at least 1).  Positions past blk_end are left
    // as they are: no FIND reads them.
    K4_FN void fill_chunk(int32_t p0, int32_t blk_end) {
        const int C = s.ncand;
        const uint32_t vld = (uint32_t)(s.dict_size - 8 * 1024 - 4);
        each([&](int j) {
            const int32_t p = p0 + j;
            if (p >= blk_end) return;
            const int32_t pc = p < s.n ? p : (int32_t)s.n - 1;
            const int32_t limit = blk_end - p;
            int32_t* dist = &c.lane_dist(j * MAX_CAND);
            int32_t dvar = 0, cmax = 1;
            int32_t next = s.cand[pc];
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
            for (int r = 0; r < C; ++r) {
                const int32_t pk = next;
                if (r + 1 < C) next = s.cand[(int64_t)(r + 1) * s.n + pc];
                const int32_t cd = pk >> 5, cl = pk & 31;
                const bool need = cl >= EXT_CAP && limit > EXT_CAP && cd > 0;
                const bool cmp = need && p - cd >= 0;
                const int32_t ln = !need ? cl : !cmp ? EXT_CAP
                                 : extend(p, p - cd, EXT_CAP, limit);
                const int32_t lv = ln < limit ? ln : limit;
                const int32_t dv = cd > 0 ? cd : 0;
                const bool ok = dv > dvar && (uint32_t)dv < vld
                             && (r != 0 || dv != p);
                dvar = dv > dvar ? dv : dvar;
                const bool near = lv > 6 || dv < dist_bound(lv);
                c.lane_len(j * MAX_CAND + r) =
                    lv | ok << 14 | near << 15 | cmax << 16 | cmp << 30;
                dist[r] = dv;
                cmax = ok && lv > cmax ? lv : cmax;
            }
        });
        chunk_at = p0;
        chunk_end = blk_end;
        sync();
    }

    // One FIND position of the stretch, with `rel` = blk_len - blk_i bytes
    // of the sub-block from s0.  Returns false when the budget ran out;
    // else either relaxes and advances wpos, or ends the stretch (*ended,
    // with post / post_len / post_dist).
    K4_FN bool find(int32_t& wpos, int32_t rel, int32_t& apend, bool& ended,
                    int32_t& post, int32_t& post_len, int32_t& post_dist) {
        if (!step()) return false;
        const int32_t apcur = wpos - s0;
        const int32_t limit = rel - apcur;
        const int32_t aplimit = rel < AP_LIMIT ? rel : AP_LIMIT;
        const int32_t blk_end = s0 + rel;
        const int32_t w = wi(wpos);
        const int32_t wc = s0 + w;            // the clipped position
        const int nl = 4 + s.ncand;
        // what does not hang on the node goes out first: the candidate
        // rows (a pass over the next CHUNK positions when this one is not
        // in the last), and the cells and the byte the literal's
        // relaxation reads
        if (wpos - chunk_at >= CHUNK || wpos < chunk_at
            || chunk_end != blk_end)
            fill_chunk(wpos, blk_end);
        const int32_t row = (wpos - chunk_at) * MAX_CAND;
        const Lanes lane_len = lanes([&](int l) -> int32_t {
            return l >= 4 && l < nl ? c.lane_len(row + l - 4) : 0;
        });
        const Lanes dv = lanes([&](int l) -> int32_t {
            return l >= 4 && l < nl ? c.lane_dist(row + l - 4) : 0;
        });
        const int32_t i1 = wi(wpos + 1);
        const int32_t sw = slot(w), s1 = slot(i1);
        const bool live_w = live(w), live_1 = live(i1);
        const int32_t price_w = c.price(sw), price_1 = c.price(s1);
        const int32_t lit = s.pr.lit_tree(byte(wc));
        // node reconstruction (csc_lz.cpp:211-233): a stretch start keeps
        // the node reset() set; a later cell takes its winning
        // relaxation's
        if (apcur > 0) set_node(w, c.pstate(sw), c.prep(sw));
        const Rep4 nr = node_rep;
        if (apcur >= aplimit) {       // the cap (csc_lz.cpp:239-242)
            sync();
            ended = true;
            post = POST_NONE;
            post_len = post_dist = 0;
            return true;
        }

        // the lanes in find_match order (reps 0-3, then the candidate
        // rows): each one's length, cut at the limit, and the plain
        // version's 4-byte rounds for it (R rounds take max(1, ceil(R /
        // 8)) steps of its 8-round extensions)
        const Lanes ext = lanes([&](int l) -> int32_t {
            int32_t ln, k;
            if (l >= 4) {
                const int32_t f = own(lane_len, l);
                ln = f & 0x3FFF;
                k = (f >> 30) & 1 ? ln - EXT_CAP : -1;
            } else {
                const int32_t dk = rep_at(nr, l);
                const bool cmp = dk > 0 && wpos - dk >= 0;
                ln = cmp ? extend(wpos, wpos - dk, 0, limit) : 0;
                k = cmp ? ln : -1;
            }
            const int32_t r = k < 0 ? 0 : ln == limit && (k & 3) == 0
                                        ? k >> 2 : (k >> 2) + 1;
            return ln | r << 16;
        });
        const Lanes len = lanes([&](int l) -> int32_t {
            return own(ext, l) & 0xFFFF;
        });
        const int32_t rmax = max_all(ext) >> 16;
        const int64_t more = (rmax + 7) / 8 - 1;
        if (more > 0) {
            if (steps + more > s.max_steps) {
                steps = s.max_steps;
                return false;
            }
            steps += more;
        }
        ++finds;
        const int32_t st = more > 0 && apcur == 0 ? (node_state * 4) & 0x3F
                                                  : node_state;

        // the fold (parse_ap.py:407-463): a lane raises minlen iff it
        // passes its gate and beats the rep lanes before it and, for a
        // candidate row, the passing rows before it; the first lane to
        // reach good_len ends the fold after itself
        const int32_t good_len = s.good_len;
        const int32_t r0 = get(len, 0), r1 = get(len, 1), r2 = get(len, 2),
                      r3 = get(len, 3);
        const Lanes bet = lanes([&](int l) -> int32_t {
            const int32_t m01 = r0 > 1 ? r0 : 1, m012 = r1 > m01 ? r1 : m01,
                          m0123 = r2 > m012 ? r2 : m012,
                          reps = r3 > m0123 ? r3 : m0123;
            if (l < 4) {
                const int32_t before = l == 0 ? 1 : l == 1 ? m01
                                     : l == 2 ? m012 : m0123;
                return own(len, l) > before;
            }
            const int32_t f = own(lane_len, l), cm = (f >> 16) & 0x3FFF;
            return ((f >> 14) & 1) && own(len, l) > (cm > reps ? cm : reps);
        });
        const uint32_t trig = ballot(lanes([&](int l) -> int32_t {
            return own(bet, l) && own(len, l) >= good_len;
        }));
        const Lanes rec = lanes([&](int l) -> int32_t {
            return own(bet, l) && (trig & ((1u << l) - 1)) == 0
                && (l < 4 || ((own(lane_len, l) >> 15) & 1));
        });
        const Lanes ldist = lanes([&](int l) -> int32_t {
            return l < 4 ? l + 1 : own(dv, l) + 4;
        });
        // the recorded lanes' lengths grow lane by lane: the last one's
        // length and distance are find_match's pick
        const uint32_t recm = ballot(rec);
        const bool r01 = r0 >= 2;
        const int last = 31 - clz32(recm);
        const int32_t last_l = recm ? get(len, last & (WARP - 1)) : 1;
        const int32_t last_d = recm ? get(ldist, last & (WARP - 1)) : r01;

        // stretch-end checks (csc_lz.cpp:239-267, in order)
        if (last_l == 1 && apcur + 1 == apend) {
            sync();
            ended = true;
            post = POST_LIT;
            post_len = 1;
            post_dist = 0;
            return true;
        }
        if (apcur + 1 >= apend) apend = apcur + 2;
        if (last_l >= good_len || (last_l > 1 && last_l + apcur >= aplimit)) {
            sync();
            ended = true;
            post = POST_MATCH;
            post_len = last_l;
            post_dist = last_d;
            return true;
        }

        // relaxation: the literal, then rep0len1 against its price, into
        // the next cell (lane 0 writes the winner); and each length L from
        // the first recorded lane reaching it, unless that lane's distance
        // fails dist_bound there (FindMatchWithPrice's sweep).  Every
        // recorded length is below good_len here: each recorded lane
        // writes its distance code and base price at its length, and L's
        // lane is the one at the shortest recorded length >= L.
        const int32_t myp = live_w ? price_w : 0;
        const int32_t litp = lit + s.pr.flag0(st) + myp;
        const int32_t cp1 = live_1 ? price_1 : INF;
        const int32_t r01p = s.pr.r01(st) + myp;
        const bool win_r = r01 && r01p < (litp < cp1 ? litp : cp1);
        if (leader() && (litp < cp1 || win_r))
            relax(i1, win_r ? r01p : litp, wpos, win_r, true, node_state, nr);
        each([&](int l) {
            if (!own(rec, l)) return;
            const int32_t ln = own(len, l);
            int32_t base;
            if (l < 4) {
                base = s.pr.repd(st * 4 + (l & 3));
            } else {
                const int32_t slot2 = dist_slot(own(dv, l) - 1) + 2;
                base = s.pr.matchf(st) + 128 * (slot2 > 4 ? slot2 : 4);
            }
            c.by_len_d(ln) = own(ldist, l);
            c.by_len_b(ln) = base;
        });
        const uint64_t lens =
            (uint64_t)or_all(lanes([&](int l) -> int32_t {
                return own(rec, l) && own(len, l) < 32 ? 1u << own(len, l)
                                                       : 0;
            }))
            | (uint64_t)or_all(lanes([&](int l) -> int32_t {
                  return own(rec, l) && own(len, l) >= 32
                       ? 1u << (own(len, l) - 32) : 0;
              })) << 32;
        sync();
        const int32_t top = last_l < good_len ? last_l : good_len;
        each([&](int l) {
            for (int32_t L = 2 + l; L <= top; L += WARP) {
                const int32_t t = wpos + L;
                if (t >= s.n - 1) return;
                const int32_t at = L + ctz64(lens >> L);
                const int32_t d = c.by_len_d(at);
                if (L <= 6 && (d > 4 ? d - 4 : 0) >= dist_bound(L)) continue;
                const int32_t newp = c.by_len_b(at)
                                   + s.pr.lenp(L - 2 < 31 ? L - 2 : 31) + myp;
                const int32_t i = guard(t - s0);
                if (newp < (live(i) ? c.price(slot(i)) : INF))
                    relax(i, newp, wpos, d, false, node_state, nr);
            }
        });
        if (last_l > 1 && apcur + last_l + 1 > apend)
            apend = apcur + last_l + 1;
        ++wpos;
        sync();
        return true;
    }

    K4_FN Result run() {
        c = s.win;
        reps = Rep4{s.dict_size, s.dict_size, s.dict_size, s.dict_size};
        mstate = 0;
        tok = 0;
        err = 0;
        steps = 0;
        s0 = 0;
        chunk_at = chunk_end = -1;
        finds = 0;
        int32_t done = 0;
        int32_t wpos = 0, nsid = 0;
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
            reset(wpos, ++nsid);
            while (true) {
                int32_t apend = 1, post = 0, post_len = 0, post_dist = 0;
                bool ended = false;
                while (!ended) {
                    if (!find(wpos, blk_len - blk_i, apend, ended, post,
                              post_len, post_dist))
                        goto out;
                }
                const int32_t end = wpos;
                // mark the path back to s0
                int32_t wk = end;
                while (true) {
                    if (!step()) goto out;
                    if (wk <= s0) break;
                    const int32_t bk = s0 + c.back(wi(wk));
                    if (leader()) {
                        c.nxt(wi(bk)) = (int16_t)(wk - s0);
                        mirror(5, wi(bk), wk);
                    }
                    wk = bk;
                }
                sync();
                // walk it forward, a token a cell
                wk = s0;
                while (true) {
                    if (!step()) goto out;
                    if (wk >= end) break;
                    const int32_t nx = s0 + c.nxt(wi(wk));
                    emit(nx - wk, c.ndist(wi(nx)));
                    wk = nx;
                }
                // the end node, the post action, the next stretch
                mstate = node_state;
                reps = node_rep;
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
                reset(wpos, ++nsid);
            }
        }
    out:
        if (!done && err == 0) err = ERR_STEPS;
        return Result{tok, done, err, finds};
    }
};

template <bool STAGED, bool MIRROR>
K4_FN Result parse_as(const Stream& s) {
    Parser<STAGED, MIRROR> p;
    p.s = s;
    return p.run();
}

K4_FN Result parse_stream(const Stream& s) {
    if (s.words)
        return s.cells ? parse_as<true, true>(s) : parse_as<true, false>(s);
    return s.cells ? parse_as<false, true>(s) : parse_as<false, false>(s);
}

}  // namespace k4
