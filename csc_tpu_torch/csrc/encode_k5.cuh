// K5: per-stream exact m1/m2 parse with live hash tables, one warp a
// stream (csc_mf.cpp's HT2 / HT3 / HT6 finders and csc_lz.cpp's lazy
// parser, compress_normal csc_lz.cpp:156-199, as csc_tpu/ops/
// encode_scan.py emulates them bit for bit).
//
// One call parses one whole stream with the natural loops of the
// reference: per 8 KB sub-block, per position a find, FindMatch's pick,
// the lazy decision (a second find at wpos + 1 and SecondMatchBetter),
// the token, then SlidePos over the token's other positions.  The parse
// state (rep queue, block / run bookkeeping, pos, the step count) is
// uniform across the warp: every lane runs the same control flow on the
// same values, and lane 0 alone writes the tape.
//
// A find is spread over the lanes:
//   - lanes 0-3 take the four reps (the rep queue lives in them), lane 4
//     HT2, lane 5 HT3 and lanes 6 .. 5 + w the HT6 row (w <= 8); each HT
//     lane loads its own entry, a find ahead (Probe, below);
//   - each lane compares its candidate's first SOLO words (32 bytes,
//     good_len or more at m1 / m2) with the position's in one batch of
//     loads, which gives its common prefix capped at its climit (HT2's
//     quirk included); a lane still equal after them is extended by the
//     whole warp, 32 words a compare, and only while it can be the first
//     to reach good_len (later lanes are past the exit);
//   - the order-dependent part is a fold in lane order: the HT lanes'
//     distance gate is the prefix maximum of the earlier HT distances
//     (the running `dist`, a shuffle scan); the good_len exit is the
//     first passing lane whose length reaches good_len (lanes past it add
//     no extension, reps past it are not visited); minlen is the prefix
//     maximum of the earlier passing lanes' lengths; the precheck
//     (csc_mf.cpp's byte at minlen) follows from the lane's common prefix
//     where minlen lies inside it or at its end, else from the two bytes;
//     a lane records when its length beats minlen (and, at an HT slot,
//     passes the distance bound);
//   - FindMatch's pick is SecondMatchBetter folded over the recorded
//     lanes in order, after rep0len1's record (made exactly when rep 0
//     records), so no candidate list is kept;
//   - the finish inserts the position: HT2 / HT3 and the row's head by
//     their lanes, the row's other slots shifted from the values its
//     lanes loaded, then a __syncwarp.
// A find also issues the loads of the next position's entries (a lazy
// second find or the find after a literal lands there), and the finish
// forwards its own insertion into them where the slots coincide; after a
// match, the entries of the position past it are loaded before the
// slide, and the slide forwards its writes into them.  The hashes of 32
// positions sit one a lane (the window, filled by the slide pass that
// hashes them anyway), so a find reads its hashes with shuffles.
// SlidePos inserts 32 positions a pass, one a lane.  HT2 / HT3 (and a
// row of one, m1) keep the highest lane of a hash: an atomicMax, since
// the positions grow with the lane and pass every value the tables hold
// (__match_any_sync when vld_rge < 0: an empty entry's 0 then passes the
// positions).  An HT6
// row that a pass touches several times ends as the pass's operations in
// order would leave it: each run of consecutive equal h6 (the lasth6
// rule: only a run's first position shifts the row, lasth6 = 0 at each
// token) leaves its last position, runs later in the pass above it, and
// the row's old entries shifted down by the number of runs that
// shifted; the lowest lane of a row reads the old entries before the
// pass writes.
//
// The steps.  csc_tpu runs the parse as a lockstep while_loop, one
// micro-op a stream a step, and its pipeline stops a group that is not
// done after 64 * N + 4096 steps.  K5 counts the same micro-ops in
// closed form: one a sub-block / stream visit (E_BLOCK), a decision
// (E_DECIDE); a find costs its set-up (E_PREP), the reps it visits, HT2,
// HT3 and the w HT6 slots (E_PROBE), 1 + min(F, ceil(climit / 4) - 1)
// words (E_EXT) for each lane whose precheck passes (F its fully equal
// 4-byte words), and the finish; a slide one step an insertion (four
// positions a step while i + 128 < len) and one for its end.  A find
// writes nothing before its finish and a slide's token is already on
// the tape, so a budget that runs out inside either ends the parse there
// with steps = the budget, as the lockstep version's cut leaves it.
//
// The blocks.  The input is the analyzer's 8 KB block table (each
// block's end and type, encode_host.plan_stream(..., exact=True)), and the
// parse merges the blocks into runs itself, as CSCEncoder::Compress does
// (golden/encoder.py:75-123): IsDuplicateBlock (golden/lz.py:77-82,
// TestFind mf.py:483-519) re-types a BAD / ENTROPY / DLT block DT_NORMAL
// when one of its positions matches 19 bytes or more at the head of its
// HT6 row, and that reads the live tables.  Golden probes each block while
// the run in front of it is not yet coded, so at a run's start (`walk`)
// the blocks are typed in turn against the tables as they stand (a
// DT_SKIP block takes the previous block's final type), one E_DUP step a
// probe, until a block of another final type or raw chunk ends the run;
// its type waits for the next run.  Each block's final type goes to
// `btypes`.  A probe (`duplicate`) is spread one position a lane, each
// lane walking its positions of the block (the HASH2 filter, the row
// head's load and the 19-byte compare on the 1/16 that pass); the lanes'
// hits are one ballot at the end.  A no-LZ run's sub-blocks take one
// E_SPARSE step each (`sparse`, SlidePosFast, mf.py:198-231): 32
// positions a pass, one a lane; at the 1/16 whose HASH2 passes, the HT6
// row shifts down and takes the position, the passes in order, the lanes
// of one row in a pass as in the slide (the lowest moves the old entries
// down by the row's count, each lane writes its slot counted from the
// row's last).  No token, no other table.  A stream of LZ runs alone never
// probes or slides sparsely, so its steps are csc_tpu's; its parse is the
// Parser without either (NOLZ false, chosen per stream by `has_nolz`), so
// the new code costs such a stream nothing on the card.
//
// The ring.  A stream longer than its dictionary meets golden's ring
// window (LZ.encode_normal, golden/lz.py:28, 51-75): a ring of wnd = the
// dictionary's bytes, a byte's ring position its offset mod wnd.  The
// stream stays linear here (every source lies within the last vld_rge <
// wnd bytes, where the stream holds it); only these follow the ring
// (`RING`, chosen per stream by its size, in a kernel of its own in the
// nvcc build, so a stream its dictionary covers runs the code, and the
// registers, it had before): a sub-block also ends at the
// ring's end (`lap0` the ring's start in the stream), so after the first
// wrap a run's pieces are cut there and then every 8 KB from ring
// position 0; the bytes past a sub-block's end are the previous lap's
// (offset p - wnd; zeros in the first lap and past the ring's end), in
// the hashes and the duplicate probe; and a source may not cross the
// ring's end (each finder's climit = min(limit, wnd - cmp_pos),
// mf.py:256-257, 284-285, 308-309, 418-419, 513-514): a candidate whose
// source lies in the previous lap (distance past the ring position r) is
// limited to distance - r bytes, and HT2's strict `wpos > dist`
// (mf.py:284) refuses distance == r.
//
// The data is staged as words in shared memory (streams of at most 64
// KB: s.words), or read from device memory (longer ones); the hash
// tables (int32, one slice a stream) stay in device memory.
//
// The same source builds with nvcc (the __global__ wrapper in
// encode_k5.cu) and with g++ (the test harness encode_k5_host.cpp): the
// lane operations sit behind `Lanes`, in the nvcc build a lane's own
// value with __shfl_sync / __ballot_sync / __match_any_sync, in the g++
// build all 32 lanes in loops, so the CPU tests hold this logic against
// the plain PyTorch version (csc_tpu_torch/ops/exact_scan.py) before it
// runs on a card.
//
// Contract with the plain version, for every stream: the same tape words
// (kind | wire_len << 3, dist_code) over the first tok_cnt tokens, the
// same tok_cnt, done, err and steps, and the same block types.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define K5_FN __host__ __device__ __forceinline__
#define K5_UNROLL _Pragma("unroll")
#else
#define __host__
#define __device__
#define K5_FN inline
#define K5_UNROLL
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
constexpr int32_t SUB_BLOCK = 8192;  // csc_lz.cpp:63-67
constexpr int32_t FAST_SLIDE = 128;  // stride-4 insertion while i + 128 < len
constexpr int32_t ERR_OVERFLOW = 1;  // the tape is full
constexpr int32_t ERR_STEPS = 2;     // the step budget ran out
constexpr int32_t MAX_WIDTH = 8;     // HT6 row width (m2)
// block types (csc_typedef.h:20-40) and the block table's info word
// (encode_host.BLK_*)
constexpr int32_t DT_NORMAL = 1;
constexpr int32_t DT_NO_LZ = 5;
constexpr int32_t BLK_TYPE = 0xFF;
constexpr int32_t BLK_SKIP = 1 << 8;
constexpr int32_t BLK_CHUNK = 1 << 9;
constexpr int32_t DUP_LEN = 19;      // a probe hits past 18 equal bytes
constexpr int WARP = 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;
// lane roles of a find: reps 0-3, then HT2, HT3, the HT6 row, and the
// lane that writes the row's new head
constexpr int L_HT2 = 4;
constexpr int L_HT3 = 5;
constexpr int L_HT6 = 6;
constexpr int L_ROW0 = L_HT6 + MAX_WIDTH;
// words a lane compares alone, in one batch of loads (4 * SOLO >= the
// m1 / m2 good_len, so a lane still equal after them is the exit lane)
constexpr int SOLO = 8;
// zero words after the staged data: every word read lies below
// ceil(n / 4) + SOLO + 2
constexpr int64_t STAGE_PAD = SOLO + 4;
constexpr int64_t STAGE_MAX = 64 * 1024;  // bytes a staged stream may hold

struct Stream {
    const uint8_t* data;     // LZ input, n bytes (zero past size)
    const uint32_t* words;   // the same staged as words (g++ build), or null
    int64_t n;
    const int32_t* blocks;   // [NB][2] cumulative block ends, info words
    int32_t nblk;
    int32_t* btypes;         // [NB] each block's final type (zeros)
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

#ifdef __CUDACC__
// the staged stream of the nvcc build (encode_k5.cu fills it)
extern __shared__ __align__(16) uint32_t k5_words[];
#endif

// Phase clocks (a build with -DK5_PHASES, csc_tpu_torch/k5_phases.py):
// block 0's SM cycles in each part of the parse, and counts; otherwise
// nothing.
enum Phase {
    P_HASH, P_TABLES, P_SOLO, P_EXIT, P_FOLD, P_FINISH, P_PICK, P_SLIDE,
    P_OTHER, P_MARK, C_FINDS, C_PASSES, C_EXTENDS, C_MISSES,
    NPHASE
};
#if defined(K5_PHASES) && defined(__CUDACC__)
__device__ unsigned long long k5_phases[NPHASE];
#endif
#if defined(K5_PHASES) && defined(__CUDA_ARCH__)
#define K5_PHASE(i) phase(i)
#define K5_COUNT(i)                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&k5_phases[i], 1ull)
#else
#define K5_PHASE(i)
#define K5_COUNT(i)
#endif

// ------------------------------------------------------------------ lanes
// One int32 a lane.  nvcc: this lane's value; g++: all 32.
#ifdef __CUDA_ARCH__
struct Lanes {
    int32_t v;
};
K5_FN int lane_id() { return threadIdx.x & (WARP - 1); }
template <class F>
K5_FN Lanes lanes(F f) { return Lanes{f(lane_id())}; }
template <class F>
K5_FN void each(F f) { f(lane_id()); }
K5_FN int32_t own(const Lanes& x, int) { return x.v; }
K5_FN void set(Lanes& x, int, int32_t v) { x.v = v; }
K5_FN int32_t get(const Lanes& x, int src) {
    return __shfl_sync(FULL, x.v, src);
}
// lane l gets lane l + 1's value (lane 31 its own)
K5_FN Lanes next(const Lanes& x) {
    return Lanes{__shfl_down_sync(FULL, x.v, 1)};
}
// lane l gets lane l - 1's value (lane 0 its own)
K5_FN Lanes prev(const Lanes& x) {
    return Lanes{__shfl_up_sync(FULL, x.v, 1)};
}
K5_FN uint32_t ballot(const Lanes& x) { return __ballot_sync(FULL, x.v != 0); }
// the lanes whose value equals this lane's
K5_FN Lanes match(const Lanes& x) {
    return Lanes{(int32_t)__match_any_sync(FULL, x.v)};
}
K5_FN int32_t sum_all(const Lanes& x) { return __reduce_add_sync(FULL, x.v); }
// lane l gets lane src[l]'s value
K5_FN Lanes gather(const Lanes& x, const Lanes& src) {
    return Lanes{__shfl_sync(FULL, x.v, src.v)};
}
// the unsigned maximum over the lanes below (0 at lane 0), lanes 0-15
K5_FN Lanes umax_below(const Lanes& x) {
    const int l = lane_id();
    uint32_t v = __shfl_up_sync(FULL, (uint32_t)x.v, 1);
    v = l == 0 ? 0u : v;
K5_UNROLL
    for (int o = 1; o < 16; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL, v, o);
        if (l >= o) v = t > v ? t : v;
    }
    return Lanes{(int32_t)v};
}
// *p = max(*p, v), atomically
K5_FN void amax(int32_t* p, int32_t v) { atomicMax(p, v); }
K5_FN bool leader() { return lane_id() == 0; }
K5_FN void sync() { __syncwarp(); }
K5_FN int32_t popc(uint32_t x) { return __popc(x); }
K5_FN int32_t ctz32(uint32_t x) { return __clz(__brev(x)); }  // 32 at 0
K5_FN int32_t top32(uint32_t x) { return 31 - __clz(x); }    // x != 0
K5_FN uint32_t funnel(uint32_t lo, uint32_t hi, uint32_t sh) {
    return __funnelshift_r(lo, hi, sh);
}
K5_FN uint32_t load_word(const uint8_t* p) {
    return __ldg((const unsigned int*)p);
}
// one table pointer a lane
struct LanePtr {
    int32_t* p;
};
K5_FN int32_t* own(const LanePtr& x, int) { return x.p; }
K5_FN void set(LanePtr& x, int, int32_t* p) { x.p = p; }
#else
struct Lanes {
    int32_t v[WARP];
};
template <class F>
K5_FN Lanes lanes(F f) {
    Lanes x;
    for (int l = 0; l < WARP; ++l) x.v[l] = f(l);
    return x;
}
template <class F>
K5_FN void each(F f) {
    for (int l = 0; l < WARP; ++l) f(l);
}
K5_FN int32_t own(const Lanes& x, int l) { return x.v[l]; }
K5_FN void set(Lanes& x, int l, int32_t v) { x.v[l] = v; }
K5_FN int32_t get(const Lanes& x, int src) { return x.v[src]; }
K5_FN Lanes next(const Lanes& x) {
    Lanes y;
    for (int l = 0; l < WARP; ++l) y.v[l] = x.v[l < WARP - 1 ? l + 1 : l];
    return y;
}
K5_FN Lanes prev(const Lanes& x) {
    Lanes y;
    for (int l = 0; l < WARP; ++l) y.v[l] = x.v[l > 0 ? l - 1 : l];
    return y;
}
K5_FN uint32_t ballot(const Lanes& x) {
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) m |= (uint32_t)(x.v[l] != 0) << l;
    return m;
}
K5_FN Lanes match(const Lanes& x) {
    Lanes y;
    for (int l = 0; l < WARP; ++l) {
        uint32_t m = 0;
        for (int k = 0; k < WARP; ++k) m |= (uint32_t)(x.v[k] == x.v[l]) << k;
        y.v[l] = (int32_t)m;
    }
    return y;
}
K5_FN int32_t sum_all(const Lanes& x) {
    int32_t s = 0;
    for (int l = 0; l < WARP; ++l) s += x.v[l];
    return s;
}
K5_FN Lanes gather(const Lanes& x, const Lanes& src) {
    Lanes y;
    for (int l = 0; l < WARP; ++l) y.v[l] = x.v[src.v[l]];
    return y;
}
K5_FN Lanes umax_below(const Lanes& x) {
    Lanes y;
    uint32_t m = 0;
    for (int l = 0; l < WARP; ++l) {
        y.v[l] = (int32_t)m;
        m = (uint32_t)x.v[l] > m ? (uint32_t)x.v[l] : m;
    }
    return y;
}
K5_FN void amax(int32_t* p, int32_t v) {
    if (v > *p) *p = v;
}
K5_FN bool leader() { return true; }
K5_FN void sync() {}
K5_FN int32_t popc(uint32_t x) { return __builtin_popcount(x); }
K5_FN int32_t ctz32(uint32_t x) { return x ? __builtin_ctz(x) : 32; }
K5_FN int32_t top32(uint32_t x) { return 31 - __builtin_clz(x); }
K5_FN uint32_t funnel(uint32_t lo, uint32_t hi, uint32_t sh) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
}
K5_FN uint32_t load_word(const uint8_t* p) {
    uint32_t w;
    memcpy(&w, p, 4);
    return w;
}
struct LanePtr {
    int32_t* p[WARP];
};
K5_FN int32_t* own(const LanePtr& x, int l) { return x.p[l]; }
K5_FN void set(LanePtr& x, int l, int32_t* p) { x.p[l] = p; }
#endif

// distance bound of a candidate of length l (MF_DIST_BOUND,
// csc_mf.cpp:245); lengths >= 7 pass any distance
K5_FN int32_t dist_bound(int32_t l) {
    return l <= 1 ? 0 : l >= 7 ? 0x7FFFFFFF : 1 << (4 * l - 2);
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
    return x == 0 ? 4 : ctz32(x) >> 3;
}

struct Hashes {
    int32_t h2, h3, h6;
};

// What a find reads from the tables at one position: its hashes and, in
// each HT lane, that lane's entry (lane 4: HT2, 5: HT3, 6 + k: slot k of
// the HT6 row).  at < 0: none.
struct Probe {
    int32_t at;
    Hashes h;
    Lanes slot;
};

// The stream's parse, one warp.  STAGED: the data is the staged words
// (shared memory in the nvcc build), else read from s.data.  NOLZ: the
// block table holds a BAD / ENTROPY / DLT block, so the parse may probe
// and insert sparsely; without, neither is compiled in, and the parse of
// LZ runs keeps the code it had before them.  RING (with NOLZ): the
// stream is longer than its dictionary and the window wraps.
template <bool STAGED, bool NOLZ, bool RING>
struct Parser {
    Stream s;
    int64_t steps, budget;   // micro-ops taken, the step budget
    bool cut;                // a micro-op past the budget
    int32_t nfull;           // whole aligned words of s.data (unstaged)
    int32_t n;
    int32_t tok;             // tokens written (some clipped to the end)
    int32_t pos, vld_rge;    // the finder's position and valid range
    int32_t wnd, lap0;       // the ring's size, its start in the stream
    Lanes reps;              // the rep queue, rep k in lane k < 4
    int32_t blk_off, blk_len, blk_i;
    // the walk: the next block, the run's type (-1 before its first
    // block), the final type of block tb when the walk that ended the
    // last run made it (else -1), the last block's final type; the run's
    // end
    int32_t tb, run_type, next_ft, prev_ft, run_end;
    Probe pf;                // the next find's entries, loaded ahead
    LanePtr table;           // HT lane l's table (its slot of a row)
    // the hashes of positions win + l, one a lane (win < 0: none), in
    // the current sub-block
    int32_t win;
    Lanes wh2, wh3, wh6;
#if defined(K5_PHASES) && defined(__CUDA_ARCH__)
    long long mark;

    // the cycles since the last mark go to phase i
    __device__ void phase(int i) {
        const long long t = clock64();
        if (blockIdx.x == 0 && threadIdx.x == 0)
            atomicAdd(&k5_phases[i], (unsigned long long)(t - mark));
        mark = t;
    }
#endif

    // k lockstep micro-ops; false (and the parse cut) if they pass the
    // budget
    K5_FN bool spend(int32_t k) {
        if (k > budget - steps) {
            cut = true;
            return false;
        }
        steps += k;
        return true;
    }

    K5_FN int32_t clip(int32_t i) const {
        return i < 0 ? 0 : (i >= n ? n - 1 : i);
    }

    // aligned word k >= 0 where words k0 .. k lie in the staged data or
    // in s.data's whole words (`whole`)
    K5_FN uint32_t fword(int32_t k) const {
        if constexpr (STAGED) {
#ifdef __CUDA_ARCH__
            return k5_words[k];
#else
            return s.words[k];
#endif
        } else {
            return load_word(s.data + 4 * (int64_t)k);
        }
    }

    // may words k .. k + cnt - 1 be read with fword
    K5_FN bool whole(int32_t k, int32_t cnt) const {
        return STAGED || k + cnt <= nfull;
    }

    // aligned word k >= 0 (bytes 4k .. 4k + 3, zeros past n)
    K5_FN uint32_t aword(int32_t k) const {
        if (whole(k, 1)) return fword(k);
        uint32_t w = 0;
        for (int j = 0; j < 4; ++j)
            if (4 * k + j < n) w |= (uint32_t)s.data[4 * k + j] << (8 * j);
        return w;
    }

    // the 4-byte little-endian word at clip(i), zeros past the data, as
    // the plain version gathers it
    K5_FN uint32_t word(int32_t i) const {
        i = clip(i);
        return funnel(aword(i >> 2), aword((i >> 2) + 1),
                      (uint32_t)(i & 3) * 8);
    }

    K5_FN uint32_t byte(int32_t i) const {
        return (aword(i >> 2) >> ((i & 3) * 8)) & 0xFF;
    }

    // HASH2 / HASH3 / HASH6 of position p < n, whose sub-block ends rem
    // >= 1 bytes ahead: bytes at and past the end read as zeros
    // (encode_scan.py `_mask_lookahead`; the reference's window holds
    // only the sub-blocks copied so far), or, past the ring's first lap,
    // as the previous lap's up to the ring's end
    K5_FN Hashes hashes(int32_t p, int32_t rem, bool h6) const {
        const int32_t k = p >> 2;
        const uint32_t sh = (uint32_t)(p & 3) * 8;
        uint32_t a0, a1, a2;
        if (whole(k, 3)) {
            a0 = fword(k);
            a1 = fword(k + 1);
            a2 = fword(k + 2);
        } else {
            a0 = aword(k);
            a1 = aword(k + 1);
            a2 = aword(k + 2);
        }
        const uint32_t lo = funnel(a0, a1, sh);
        uint32_t v4 = rem >= 4 ? lo : lo & ((1u << (8 * rem)) - 1);
        uint32_t ghost = 0;      // bytes 4-5 from the previous lap
        if constexpr (RING) {
            if (rem < 6 && lap0 > 0) {
                const int32_t to_end = lap0 + wnd - p;
                for (int32_t j = rem; j < 6 && j < to_end; ++j) {
                    const uint32_t b = byte(p + j - wnd);
                    if (j < 4)
                        v4 |= b << (8 * j);
                    else
                        ghost |= b << (8 * (j - 4));
                }
            }
        }
        Hashes h;
        h.h2 = (int32_t)(((v4 & 0xFFFF) * 65521u) & 0x3FFF);
        h.h3 = (int32_t)((((v4 & 0xFF) << 8) ^ (((v4 >> 8) & 0xFF) << 5)
                          ^ ((v4 >> 16) & 0xFF)) & 0xFFFF);
        h.h6 = 0;
        if (h6) {
            const uint32_t hi = funnel(a1, a2, sh);
            const uint32_t v2b = (rem >= 6 ? hi & 0xFFFF
                                : rem == 5 ? hi & 0xFF : 0) | ghost;
            h.h6 = (int32_t)(((v4 ^ (v2b << 13)) * 2654435761u)
                             >> (32 - s.hash_bits));
        }
        return h;
    }

    // the address of HT lane l's entry of hashes h (lanes 4 .. 5 + w;
    // lane L_ROW0: the row's head)
    K5_FN int32_t* entry(const Hashes& h, int l) const {
        return own(table, l) + (l == L_HT2 ? h.h2 : l == L_HT3 ? h.h3
                                : h.h6 * s.hash_width);
    }

    K5_FN bool ht_lane(int l) const {
        return l >= L_HT2 && l < L_HT6 + s.hash_width;
    }

    // the window of hashes at p0 .. p0 + 31 (zeros past the sub-block)
    K5_FN void fill(int32_t p0) {
        if (win == p0) return;
        win = p0;
        const int32_t end = blk_off + blk_len;
        each([&](int l) {
            const int32_t p = p0 + l;
            const Hashes h = p < end ? hashes(p, end - p, true)
                                     : Hashes{0, 0, 0};
            set(wh2, l, h.h2);
            set(wh3, l, h.h3);
            set(wh6, l, h.h6);
        });
    }

    // the hashes of p < the sub-block end, from the window
    K5_FN Hashes hash_at(int32_t p) {
        if (win < 0 || p < win || p >= win + WARP) fill(p);
        return Hashes{get(wh2, p - win), get(wh3, p - win),
                      get(wh6, p - win)};
    }

    // the table entries of a find at p (< the sub-block end)
    K5_FN Probe probe(int32_t p) {
        Probe q;
        q.at = p;
        q.h = hash_at(p);
        q.slot = lanes([&](int l) -> int32_t {
            return ht_lane(l) ? *entry(q.h, l) : 0;
        });
        return q;
    }

    // the first SOLO words of ppos and of c = ppos - dist compared, up to
    // climit > 0: len = min(common prefix, climit) and its E_EXT words,
    // or words = 0 (len = 4 * SOLO) when all SOLO agree and climit lies
    // past them
    K5_FN void solo(int32_t ppos, int32_t dist, int32_t climit,
                    int32_t& len, int32_t& words) const {
        const int32_t c = ppos - dist;
        const int32_t ka = ppos >> 2, kb = c >> 2;
        uint32_t x[SOLO];
        if (c >= 0 && whole(ka, SOLO + 1)) {
            // one batch of aligned loads for each side
            uint32_t a[SOLO + 1], b[SOLO + 1];
            K5_UNROLL
            for (int j = 0; j <= SOLO; ++j) {
                a[j] = fword(ka + j);
                b[j] = fword(kb + j);
            }
            const uint32_t sa = (uint32_t)(ppos & 3) * 8;
            const uint32_t sb = (uint32_t)(c & 3) * 8;
            K5_UNROLL
            for (int j = 0; j < SOLO; ++j)
                x[j] = funnel(a[j], a[j + 1], sa) ^ funnel(b[j], b[j + 1], sb);
        } else {
            K5_UNROLL
            for (int j = 0; j < SOLO; ++j)
                x[j] = word(ppos + 4 * j) ^ word(c + 4 * j);
        }
        int32_t f = SOLO;
        uint32_t xf = 0;
        K5_UNROLL
        for (int j = SOLO - 1; j >= 0; --j)
            if (x[j]) {
                f = j;
                xf = x[j];
            }
        const int32_t nw = (climit + 3) >> 2;
        if (f < nw && f < SOLO) {  // a word that differs, below climit
            const int32_t cp = 4 * f + eq_bytes(xf);
            len = cp < climit ? cp : climit;
            words = f + 1;
        } else if (nw <= SOLO) {   // equal up to climit
            len = climit;
            words = nw;
        } else {
            len = 4 * SOLO;
            words = 0;
        }
    }

    // the candidate at ppos - dist extended by the whole warp from word
    // SOLO on, 32 words a compare, up to climit: (len, E_EXT words)
    K5_FN void extend(int32_t ppos, int32_t dist, int32_t climit,
                      int32_t& len, int32_t& words) const {
        const int32_t nw = (climit + 3) >> 2;
        for (int32_t j0 = SOLO;; j0 += WARP) {
            K5_COUNT(C_EXTENDS);
            const Lanes x = lanes([&](int l) -> int32_t {
                const int32_t j = j0 + l;
                return j < nw ? (int32_t)(word(ppos + 4 * j)
                                          ^ word(ppos - dist + 4 * j)) : 0;
            });
            const uint32_t mm = ballot(x);
            if (mm) {
                const int32_t l = ctz32(mm);
                const int32_t f = j0 + l;
                const int32_t cp = 4 * f + eq_bytes((uint32_t)get(x, l));
                len = cp < climit ? cp : climit;
                words = f + 1;
                return;
            }
            if (j0 + WARP >= nw) {
                len = climit;
                words = nw;
                return;
            }
        }
    }

    // one find_match at ppos (limit bytes to the sub-block end): the
    // candidates and the tables' insertion of ppos.  The records, in
    // find_match's order (csc_mf.cpp:243-495): rep0len1's when rep 0
    // records (bit 0 of recs, below), then each lane of recs in lane
    // order, with its length in `len` and its distance in `dist` (a rep
    // lane's rep, an HT lane's distance); their lengths grow.  False once
    // past the budget.
    K5_FN bool find_records(int32_t ppos, int32_t limit, Lanes& len,
                            Lanes& dist, uint32_t& recs) {
        K5_COUNT(C_FINDS);
        const int32_t w = s.hash_width;
        if (pf.at != ppos) K5_COUNT(C_MISSES);
        const Probe cur = pf.at == ppos ? pf : probe(ppos);
        K5_PHASE(P_HASH);
        const uint32_t vld = (uint32_t)vld_rge;
        const int32_t good = s.good_len;
        // each lane's candidate: reps 0-3, then HT2, HT3 and the row
        dist = lanes([&](int l) -> int32_t {
            return l < 4 ? own(reps, l)
                 : l < L_HT6 + w ? pos - own(cur.slot, l) : 0;
        });
        // an HT lane's gate: above the running dist, the prefix maximum
        // of the earlier HT distances (valid or not)
        const Lanes run = umax_below(lanes([&](int l) -> int32_t {
            return l >= L_HT2 ? own(dist, l) : 0;
        }));
        K5_PHASE(P_TABLES);
        // its climit (HT2's quirk, csc_mf.cpp:306: distance == position)
        // and whether it passes its gates and the valid range; in the
        // ring, positions are ring positions, and a source in the previous
        // lap ends at the ring's end
        const Lanes climit = lanes([&](int l) -> int32_t {
            if constexpr (RING) {
                const int32_t d = own(dist, l), r = ppos - lap0;
                const bool wrap = d > r || (l == L_HT2 && d == r);
                return wrap && d - r < limit ? d - r : limit;
            }
            return l == L_HT2 && own(dist, l) == ppos ? 0 : limit;
        });
        const Lanes cand = lanes([&](int l) -> int32_t {
            const uint32_t d = (uint32_t)own(dist, l);
            return (l < 4 || (l < L_HT6 + w && d > (uint32_t)own(run, l)))
                && d < vld && own(climit, l) > 0;
        });
        // the next position's entries, loaded while this find compares
        // (issued earlier, the loads stall the gate's shuffles; later,
        // the finish waits for them)
        Probe nxt;
        nxt.at = -1;
        if (ppos + 1 < blk_off + blk_len) nxt = probe(ppos + 1);
        // every lane compares (a lane without a candidate at distance 1,
        // its result unused), so that the lanes do not diverge
        Lanes words;
        each([&](int l) {
            int32_t ln, wd;
            const bool c = own(cand, l);
            solo(ppos, c ? own(dist, l) : 1, c ? own(climit, l) : 1, ln, wd);
            set(len, l, c ? ln : 0);
            set(words, l, c ? wd : 0);
        });
        uint32_t open = ballot(lanes([&](int l) -> int32_t {
            return own(cand, l) && own(words, l) == 0;
        }));
        K5_PHASE(P_SOLO);
        // the good_len exit: the first passing lane that reaches good_len;
        // an open lane below it is extended to its end first
        int32_t xl;
        for (;;) {
            xl = ctz32(ballot(lanes([&](int l) -> int32_t {
                return own(cand, l) && !(open >> l & 1)
                    && own(len, l) >= good;
            })));
            const int32_t u = ctz32(open);
            if (u >= xl) break;
            int32_t ul, uw;
            extend(ppos, get(dist, u), get(climit, u), ul, uw);
            each([&](int l) {
                if (l == u) {
                    set(len, l, ul);
                    set(words, l, uw);
                }
            });
            open &= ~(1u << u);
        }
        K5_PHASE(P_EXIT);
        // minlen: the prefix maximum of the passing lanes' lengths (lanes
        // past the exit take no part)
        const Lanes minlen = umax_below(lanes([&](int l) -> int32_t {
            return own(cand, l) && l <= xl ? own(len, l) : 0;
        }));
        // the precheck (minlen below climit, the byte at minlen equal):
        // inside the common prefix, or at its first differing byte, from
        // the lengths; past it (or before position 0), from the bytes
        const Lanes pre = lanes([&](int l) -> int32_t {
            const int32_t ln = own(len, l);
            const int32_t ml = own(minlen, l) > 1 ? own(minlen, l) : 1;
            const int32_t c = ppos - own(dist, l);
            const bool eq = byte(clip(ppos + ml)) == byte(clip(c + ml));
            if (!own(cand, l) || l > xl || ml >= own(climit, l)) return 0;
            return c >= 0 && ml <= ln ? ml < ln : eq;
        });
        const int32_t ext = sum_all(lanes([&](int l) -> int32_t {
            return own(pre, l) ? own(words, l) : 0;
        }));
        const int32_t reps_seen = xl < 4 ? xl + 1 : 4;
        K5_PHASE(P_FOLD);
        if (!spend(1 + reps_seen + 2 + w + ext + 1)) return false;
        // the finish (csc_mf.cpp:365,487-491): insert ppos, the row
        // shifted down from the slots its lanes loaded
        each([&](int l) {
            const bool shift = l >= L_HT6 && l < L_HT6 + w - 1;
            if (l == L_HT2 || l == L_HT3 || l == L_ROW0 || shift)
                entry(cur.h, l)[shift] = shift ? own(cur.slot, l) : pos;
        });
        sync();
        // the next position's entries, as the insertion leaves them
        if (nxt.at >= 0) {
            const Lanes above = prev(cur.slot);
            each([&](int l) {
                const bool row = l >= L_HT6 && nxt.h.h6 == cur.h.h6;
                if ((l == L_HT2 && nxt.h.h2 == cur.h.h2)
                    || (l == L_HT3 && nxt.h.h3 == cur.h.h3)
                    || (row && l == L_HT6))
                    set(nxt.slot, l, pos);
                else if (row)
                    set(nxt.slot, l, own(above, l));
            });
        }
        pf = nxt;
        ++pos;
        K5_PHASE(P_FINISH);
        // a record: a length past minlen, at an HT slot within the
        // distance bound
        recs = ballot(lanes([&](int l) -> int32_t {
            const int32_t ln = own(len, l), d = own(dist, l);
            const int32_t ml = own(minlen, l) > 1 ? own(minlen, l) : 1;
            return own(pre, l) && ln > ml
                && (l < 4 || ln > 6 || d < dist_bound(ln));
        }));
        return true;
    }

    // one find_match at ppos (limit bytes to the sub-block end), the
    // tables' insertion of ppos and FindMatch's pick into (len, dist);
    // false once past the budget
    K5_FN bool find(int32_t ppos, int32_t limit, int32_t& out_len,
                    int32_t& out_dist) {
        Lanes len, dist;
        uint32_t recs;
        if (!find_records(ppos, limit, len, dist, recs)) return false;
        // FindMatch's pick: SecondMatchBetter over the records in lane
        // order, after rep0len1's (csc_mf.cpp:281-287)
        // rep0len1 (precheck at rep 0 passed, a byte or more equal) is
        // recorded exactly when rep 0 records: the precheck at minlen 1
        // makes rep 0's match 2 bytes or more
        int32_t bl = 1, bd = 0;
        bool have = false;
        if (recs & 1) {
            bd = 1;
            have = true;
        }
        for (uint32_t m = recs; m; m &= m - 1) {
            const int32_t j = ctz32(m);
            const int32_t l2 = get(len, j);
            const int32_t d2 = j < 4 ? j + 1 : get(dist, j) + 4;
            if (!have || second_better(bl, bd, l2, d2)) {
                bl = l2;
                bd = d2;
            }
            have = true;
        }
        out_len = bl;
        out_dist = bd;
        K5_PHASE(P_PICK);
        K5_PHASE(P_MARK);        // a mark's own cost
        return true;
    }

    K5_FN void write(int32_t w0, int32_t w1) {
        const int64_t t = tok < s.tcap ? tok : s.tcap - 1;
        if (leader()) {
            s.tape[2 * t] = w0;
            s.tape[2 * t + 1] = w1;
        }
        ++tok;
    }

    // a run-end or stream-end marker: only inside the tape
    K5_FN void marker(int32_t kind) {
        if (tok < s.tcap && leader()) {
            s.tape[2 * (int64_t)tok] = kind;
            s.tape[2 * (int64_t)tok + 1] = 0;
        }
        ++tok;
    }

    // one token (encode_nonlit coords, csc_lz.cpp:127-154) and the rep
    // queue (one shuffle of the rep lanes)
    K5_FN void emit(int32_t len, int32_t dist) {
        if (dist == 0) {
            write(K_LIT, 0);
        } else if (dist == 1 && len == 1) {
            write(K_REP0L1, 0);
        } else if (dist <= 4) {
            // rep dist - 1 to the front, the ones before it down one
            write(K_REP | (len - 2) << 3, dist - 1);
            reps = gather(reps, lanes([&](int l) -> int32_t {
                return l == 0 ? dist - 1 : l < dist ? l - 1 : l;
            }));
        } else {
            write(K_MATCH | (len - 2) << 3, dist - 5);
            const Lanes down = prev(reps);
            each([&](int l) { set(reps, l, l == 0 ? dist - 4 : own(down, l)); });
        }
    }

    // of the lanes that share a key, the highest writes its value (by
    // atomicMax when the values grow with the lane and pass what the
    // table holds)
    K5_FN void put_last(int32_t* tbl, const Lanes& key, const Lanes& ok,
                        const Lanes& val, bool grow) {
        if (grow) {
            each([&](int l) {
                if (own(ok, l)) amax(tbl + own(key, l), own(val, l));
            });
            return;
        }
        const Lanes same = match(key);
        each([&](int l) {
            if (own(ok, l) && ((uint32_t)own(same, l) >> l) == 1)
                tbl[own(key, l)] = own(val, l);
        });
    }

    // the last value a pass writes at HT lane `lane`'s slot of pf
    K5_FN void forward(const Lanes& key, const Lanes& ok, const Lanes& val,
                       int32_t slot, int lane) {
        const uint32_t m = ballot(lanes([&](int l) -> int32_t {
            return own(ok, l) && own(key, l) == slot;
        }));
        if (m) {
            const int32_t v = get(val, top32(m));
            each([&](int l) {
                if (l == lane) set(pf.slot, l, v);
            });
        }
    }

    // SlidePos: insert base + i for i in [1, len) (E_INS), four at a time
    // into HT2 / HT3 alone while i + 128 < len, 32 insertions a pass;
    // the next find's entries (pf) follow the writes.  False once past
    // the budget.
    K5_FN bool slide(int32_t base, int32_t len) {
        const int32_t nfast = len > FAST_SLIDE + 1
                            ? (len - FAST_SLIDE - 1 + 3) / 4 : 0;
        const int32_t i0 = 1 + 4 * nfast;
        const int32_t nslow = len > i0 ? len - i0 : 0;
        if (!spend(nfast + nslow + 1)) return false;
        const int32_t w = s.hash_width;
        const int32_t blk_end = blk_off + blk_len;
        const bool ahead = pf.at >= 0;
        // every value the tables hold is an earlier position, at least
        // vld_rge, or 0
        const bool grow = vld_rge >= 0;
        bool reload = false;     // a pass touched pf's HT6 row (w > 1)
        // insertion i writes pos + i - 1
        for (int32_t t0 = 0; t0 < nfast; t0 += WARP) {
            Lanes k2, k3, ok, val;
            each([&](int l) {
                const int32_t i = 1 + 4 * (t0 + l);
                const bool in = t0 + l < nfast;
                const Hashes h = in ? hashes(base + i, blk_end - base - i,
                                             false) : Hashes{0, 0, 0};
                set(ok, l, in);
                set(k2, l, in ? h.h2 : -1 - l);
                set(k3, l, in ? h.h3 : -1 - l);
                set(val, l, pos + i - 1);
            });
            put_last(s.ht2, k2, ok, val, grow);
            put_last(s.ht3, k3, ok, val, grow);
            if (ahead) {
                forward(k2, ok, val, pf.h.h2, L_HT2);
                forward(k3, ok, val, pf.h.h3, L_HT3);
            }
            sync();
            K5_COUNT(C_PASSES);
        }
        int32_t lasth6 = 0;
        for (int32_t q0 = i0; q0 < len; q0 += WARP) {
            Lanes k2, k3, k6, ok, val;
            fill(base + q0);
            each([&](int l) {
                const int32_t i = q0 + l;
                const bool in = i < len;
                set(ok, l, in);
                set(k2, l, in ? own(wh2, l) : -1 - l);
                set(k3, l, in ? own(wh3, l) : -1 - l);
                set(k6, l, in ? own(wh6, l) : -1 - l);
                set(val, l, pos + i - 1);
            });
            put_last(s.ht2, k2, ok, val, grow);
            put_last(s.ht3, k3, ok, val, grow);
            if (ahead) {
                forward(k2, ok, val, pf.h.h2, L_HT2);
                forward(k3, ok, val, pf.h.h3, L_HT3);
            }
            if (w == 1) {        // a row of one: its last writer
                put_last(s.ht6, k6, ok, val, grow);
                if (ahead) forward(k6, ok, val, pf.h.h6, L_HT6);
                sync();
                K5_COUNT(C_PASSES);
                continue;
            }
            if (ahead)
                reload |= ballot(lanes([&](int l) -> int32_t {
                    return own(ok, l) && own(k6, l) == pf.h.h6;
                })) != 0;
            // the row shifts where h6 differs from the last one inserted
            const Lanes before = prev(k6);
            const Lanes after = next(k6);
            const Lanes shift = lanes([&](int l) -> int32_t {
                return own(ok, l)
                    && own(k6, l) != (l == 0 ? lasth6 : own(before, l));
            });
            const uint32_t shifts = ballot(shift);
            const Lanes same = match(k6);
            // the lowest lane of a row moves its old entries down by the
            // row's shifts in this pass (its first operation, when it
            // does not shift, rewrites entry 0 instead)
            Lanes old[MAX_WIDTH];
            Lanes lo, nsh;
            each([&](int l) {
                const uint32_t m = (uint32_t)own(same, l);
                const int32_t sh = popc(m & shifts);
                const int32_t from = own(shift, l) ? 0 : 1;
                const bool owner = own(ok, l) && ctz32(m) == l && sh > 0;
                set(nsh, l, sh);
                set(lo, l, owner ? from : MAX_WIDTH);
                const int32_t* r = s.ht6 + own(k6, l) * w;
                K5_UNROLL
                for (int j = 0; j < MAX_WIDTH; ++j)
                    set(old[j], l, owner && j >= from && j + sh < w
                                   ? r[j] : 0);
            });
            sync();
            each([&](int l) {
                if (!own(ok, l)) return;
                int32_t* r = s.ht6 + own(k6, l) * w;
                const int32_t sh = own(nsh, l);
                K5_UNROLL
                for (int j = 0; j < MAX_WIDTH; ++j)
                    if (j >= own(lo, l) && j + sh < w) r[j + sh] = own(old[j], l);
                // a run's last position stays, under the later runs'
                // shifts of its row
                const bool end = l == WARP - 1 || own(after, l) != own(k6, l);
                const uint32_t above = l == WARP - 1 ? 0u : FULL << (l + 1);
                const int32_t k = popc((uint32_t)own(same, l) & shifts & above);
                if (end && k < w) r[k] = own(val, l);
            });
            lasth6 = get(k6, WARP - 1);
            sync();
            K5_COUNT(C_PASSES);
        }
        if (reload)              // the row as the slide left it
            each([&](int l) {
                if (l >= L_HT6)
                    set(pf.slot, l, ht_lane(l) ? *entry(pf.h, l) : 0);
            });
        pos += len - 1;
        K5_PHASE(P_SLIDE);
        return true;
    }

    // after a match ending at wpos, whose slide inserts from `first`:
    // the next find's entries, loaded ahead of the slide (none past the
    // sub-block), the window placed for the slide's first pass when it
    // also holds wpos
    K5_FN void ahead(int32_t wpos, int32_t first) {
        if (pf.at == wpos) return;
        if (wpos < blk_off + blk_len) {
            if (win < 0 || wpos < win || wpos >= win + WARP)
                fill(wpos - first < WARP ? first : wpos);
            pf = probe(wpos);
        } else {
            pf.at = -1;
        }
    }

    K5_FN int32_t blk_end(int32_t j) const {
        return s.blocks[2 * (int64_t)j];
    }

    // IsDuplicateBlock of block j against the tables as they stand, the
    // window's frontier at wpos (the run in front is not coded yet, so
    // the window holds zeros from there, or in the ring past its first
    // lap the previous lap's bytes): a position i whose HASH2 is a
    // multiple of 16 and whose HT6 row head lies below vld_rge, where the
    // window's next 19 bytes, before the ring's end, equal the block's.
    // A hit needs 19 bytes before the block's end, so the hashed bytes
    // lie inside the block.
    K5_FN bool duplicate(int32_t j, int32_t wpos) const {
        const int32_t s0 = j == 0 ? 0 : blk_end(j - 1);
        const int32_t last = blk_end(j) - s0 - DUP_LEN;  // last position
        const uint32_t vld = (uint32_t)vld_rge;
        const int64_t w = s.hash_width;
        const int32_t r = RING ? wpos % wnd : wpos;  // the ring position
        const uint32_t hits = ballot(lanes([&](int l) -> int32_t {
            for (int32_t i = l; i <= last; i += WARP) {
                const int32_t p = s0 + i;
                const uint32_t v4 = word(p);
                if (((v4 & 0xFFFF) * 65521u) & 0x3FFF & 15) continue;
                const uint32_t v2 = word(p + 4) & 0xFFFF;
                const int64_t h6 = ((v4 ^ (v2 << 13)) * 2654435761u)
                                 >> (32 - s.hash_bits);
                const uint32_t dist = (uint32_t)(pos - s.ht6[h6 * w]);
                if (dist >= vld) continue;
                if constexpr (RING) {
                    // a source in the previous lap ends at the ring's
                    // end, one in this lap at the ring's end too
                    const int32_t d = (int32_t)dist;
                    if ((d > r ? d - r : wnd - r + d) < DUP_LEN) continue;
                } else if (dist > (uint32_t)wpos) {
                    continue;
                }
                const int32_t c = wpos - (int32_t)dist;
                bool eq = true;
                for (int32_t k = 0; k < DUP_LEN && eq; k += 4) {
                    uint32_t x = word(p + k) ^ word(c + k);
                    // the window's bytes from wpos on are zeros, or the
                    // previous lap's
                    const int32_t below = wpos - c - k;
                    if (below < 4) {
                        const uint32_t keep = below <= 0 ? 0u
                                            : (1u << (8 * below)) - 1;
                        uint32_t v = word(c + k) & keep;
                        const int32_t g = c + k - wnd;  // >= -3
                        if (RING && wpos >= wnd)
                            v |= (g >= 0 ? word(g) : word(0) << (-8 * g))
                                 & ~keep;
                        x = word(p + k) ^ v;
                    }
                    const int32_t nb = DUP_LEN - k < 4 ? DUP_LEN - k : 4;
                    eq = (nb == 4 ? x : x & ((1u << (8 * nb)) - 1)) == 0;
                }
                if (eq) return 1;
            }
            return 0;
        }));
        return hits != 0;
    }

    // the walk at a run's start (wpos there): blocks tb, tb + 1, ... are
    // typed, a no-LZ one after its probe (E_DUP), and merged into the run
    // until a block of another final type (kept in next_ft), another raw
    // chunk or the stream's end; run_end is set.  False once past the
    // budget.
    K5_FN bool walk(int32_t wpos) {
        for (;;) {
            const int32_t j = tb;
            const int32_t jc = j < s.nblk ? j : s.nblk - 1;
            const int32_t end_prev = blk_end(j > 0 ? j - 1 : 0);
            const int32_t start = j == 0 ? 0 : end_prev;
            const int32_t info = s.blocks[2 * (int64_t)jc + 1];
            const bool cs = j == 0 || (info & BLK_CHUNK);
            const bool taken = run_type >= 0;
            if (j >= s.nblk || start >= s.size) {
                // past the last run: csc_tpu's clipped gather of run_ends
                run_end = taken ? end_prev : blk_end(jc);
                return true;
            }
            if (taken && cs) {
                run_end = end_prev;
                return true;
            }
            int32_t f;
            if (next_ft >= 0) {
                f = next_ft;
                next_ft = -1;
            } else {
                f = info & BLK_TYPE;
                if ((info & BLK_SKIP) && (cs || prev_ft == DT_NORMAL))
                    f = DT_NORMAL;
                if constexpr (NOLZ) {
                    if (f >= DT_NO_LZ) {
                        if (!spend(1)) return false;       // E_DUP
                        if (duplicate(j, wpos)) f = DT_NORMAL;
                    }
                }
            }
            if (leader()) s.btypes[j] = f;
            prev_ft = f;
            if (!taken) {
                run_type = f;
            } else if (f != run_type) {
                next_ft = f;
                run_end = end_prev;
                return true;
            }
            tb = j + 1;
        }
    }

    // SlidePosFast over the sub-block [blk_off, blk_off + blk_len): at
    // each position whose HASH2 (the window read as zeros past the
    // sub-block) is a multiple of 16, the HT6 row shifts down and takes
    // the position's pos; 32 positions a pass, one a lane
    K5_FN void sparse() {
        const int32_t w = s.hash_width;
        for (int32_t q0 = 0; q0 < blk_len; q0 += WARP) {
            fill(blk_off + q0);
            const Lanes k6 = lanes([&](int l) -> int32_t {
                return q0 + l < blk_len && !(own(wh2, l) & 15)
                    ? own(wh6, l) : -1 - l;
            });
            const uint32_t ins = ballot(lanes([&](int l) -> int32_t {
                return own(k6, l) >= 0;
            }));
            if (!ins) continue;
            const Lanes same = match(k6);
            // the lowest lane of a row reads the entries that stay
            Lanes old[MAX_WIDTH];
            each([&](int l) {
                const uint32_t m = (uint32_t)own(same, l);
                const int32_t c = popc(m);
                const bool owner = (ins >> l & 1) && ctz32(m) == l;
                const int32_t* r = s.ht6 + (int64_t)own(k6, l) * w;
                K5_UNROLL
                for (int j = 0; j < MAX_WIDTH; ++j)
                    set(old[j], l, owner && j + c < w ? r[j] : 0);
            });
            sync();
            each([&](int l) {
                if (!(ins >> l & 1)) return;
                const uint32_t m = (uint32_t)own(same, l);
                const int32_t c = popc(m);
                int32_t* r = s.ht6 + (int64_t)own(k6, l) * w;
                if (ctz32(m) == l) {
                    K5_UNROLL
                    for (int j = 0; j < MAX_WIDTH; ++j)
                        if (j + c < w) r[j + c] = own(old[j], l);
                }
                // its slot: the row's later insertions in this pass above
                const uint32_t above = l == WARP - 1 ? 0u : FULL << (l + 1);
                const int32_t k = popc(m & above);
                if (k < w) r[k] = pos + q0 + l;
            });
            sync();
        }
        pos += blk_len;
    }

    // the parse's start: registers, the rep queue, the lanes' tables
    K5_FN void init() {
        steps = 0;
        budget = s.max_steps;
        cut = false;
        tok = 0;
        n = (int32_t)s.n;
        nfull = ((uintptr_t)s.data & 3) == 0 ? n >> 2 : 0;
        vld_rge = s.dict_size - 8 * 1024 - 4;
        pos = vld_rge;
        wnd = s.dict_size;
        lap0 = 0;
        each([&](int l) { set(reps, l, s.dict_size); });
        blk_off = blk_len = blk_i = 0;
        pf.at = -1;
        win = -1;
        each([&](int l) {
            set(table, l, l == L_HT2 ? s.ht2 : l == L_HT3 ? s.ht3
                          : s.ht6 + (l >= L_HT6 && l < L_ROW0 ? l - L_HT6
                                                               : 0));
        });
        tb = 0;
        run_type = next_ft = -1;
        prev_ft = DT_NORMAL;
    }

    K5_FN Result run() {
        init();
        int32_t wpos = 0;
        int32_t probe2 = 0;      // the lazy second find is next
        bool have_u1 = false, done = false;
        int32_t u1_len = 0, u1_dist = 0;
#if defined(K5_PHASES) && defined(__CUDA_ARCH__)
        mark = clock64();
#endif
        walk(wpos);
        while (!cut) {
            if (!probe2) {
                if (!spend(1)) break;                      // E_BLOCK
                if (blk_i >= blk_len) {
                    const int32_t nboff = blk_off + blk_len;
                    pf.at = -1;
                    win = -1;
                    if (nboff >= run_end && blk_len > 0) {
                        marker(K_SENT_A);                  // csc_lz.cpp:97
                        blk_off = nboff;
                        blk_len = blk_i = 0;
                        have_u1 = false;
                        run_type = -1;
                        if (!walk(wpos)) break;
                        continue;
                    }
                    if (nboff >= s.size) {
                        marker(K_END);
                        done = true;
                        break;
                    }
                    // a pending first pick never spans a sub-block: the
                    // find that made it had two bytes or more to the end
                    blk_off = nboff;
                    blk_len = run_end - nboff < SUB_BLOCK ? run_end - nboff
                                                          : SUB_BLOCK;
                    if constexpr (RING) {
                        // a piece also ends at the ring's end
                        lap0 = nboff - nboff % wnd;
                        if (blk_len > lap0 + wnd - nboff)
                            blk_len = lap0 + wnd - nboff;
                    }
                    blk_i = 0;
                    have_u1 = false;
                    if constexpr (NOLZ) {
                        if (run_type >= DT_NO_LZ) {
                            if (!spend(1)) break;          // E_SPARSE
                            sparse();
                            blk_i = blk_len;
                            wpos += blk_len;
                            continue;
                        }
                    }
                }
            }
            // a find at wpos (unless a first pick is pending) or the lazy
            // second find at wpos + 1
            int32_t l = u1_len, d = u1_dist;
            K5_PHASE(P_OTHER);
            if ((probe2 || !have_u1)
                && !find(wpos + probe2, blk_len - blk_i - probe2, l, d))
                break;
            if (!spend(1)) break;                          // E_DECIDE
            // the token, and the slide after it (slen < 0: none)
            int32_t tl, td, base = 0, slen;
            if (!probe2) {
                if (!(l == 1 || !s.lazy || l >= s.good_len)) {
                    u1_len = l;
                    u1_dist = d;
                    probe2 = 1;
                    continue;
                }
                tl = l;
                td = d;
                base = wpos;
                slen = l;
            } else if (second_better(u1_len, u1_dist, l, d)) {
                tl = 1;                                    // a literal
                td = 0;
                slen = -1;
            } else {
                tl = u1_len;     // u1 after all: wpos + 1 is in already
                td = u1_dist;
                base = wpos + 1;
                slen = u1_len - 1;
            }
            emit(tl, td);
            blk_i += tl;
            wpos += tl;
            probe2 = 0;
            if (slen < 0) {      // the second pick is pending
                u1_len = l;
                u1_dist = d;
                have_u1 = true;
                continue;
            }
            have_u1 = false;
            if (tl > 1) {
                // the slide's first insertion past its stride-4 part
                const int32_t i0 = slen > FAST_SLIDE + 1
                                 ? 1 + 4 * ((slen - FAST_SLIDE - 1 + 3) / 4)
                                 : 1;
                ahead(wpos, base + i0);
            }
            K5_PHASE(P_OTHER);
            if (!slide(base, slen)) break;
        }
        Result r;
        r.tok_cnt = tok;
        r.done = done ? 1 : 0;
        r.err = tok > s.tcap ? ERR_OVERFLOW : done ? 0 : ERR_STEPS;
        // steps past int32's range read as its maximum
        const int64_t taken = cut ? budget : steps;
        r.steps = taken < INT32_MAX ? (int32_t)taken : INT32_MAX;
        return r;
    }
};

// whether a block of the stream's table is typed BAD / ENTROPY / DLT
// (before the probe), one block a lane
K5_FN bool has_nolz(const Stream& s) {
    return ballot(lanes([&](int l) -> int32_t {
        for (int32_t j = l; j < s.nblk; j += WARP)
            if ((s.blocks[2 * (int64_t)j + 1] & BLK_TYPE) >= DT_NO_LZ)
                return 1;
        return 0;
    })) != 0;
}

// the stream's parse; STAGED: s.words (g++) or k5_words (nvcc) hold its
// data as words, STAGE_PAD zero words after it.  RING: the stream is
// longer than its dictionary (s.size > s.dict_size) and takes the ring's
// parse (the nvcc build has a kernel for each, the caller picks); of the
// others, a stream of LZ runs alone takes the parse without the probe and
// the sparse insertion.
template <bool STAGED, bool RING>
K5_FN Result parse_stream(const Stream& s) {
    if constexpr (RING) {
        Parser<STAGED, true, true> p;
        p.s = s;
        return p.run();
    } else {
        if (has_nolz(s)) {
            Parser<STAGED, true, false> p;
            p.s = s;
            return p.run();
        }
        Parser<STAGED, false, false> p;
        p.s = s;
        return p.run();
    }
}

}  // namespace k5
