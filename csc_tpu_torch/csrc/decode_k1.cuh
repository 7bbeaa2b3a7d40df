// K1: straight per-stream CSC decoder (csc_dec.cpp:476-682 semantics, in
// the linear-window form of csc_tpu/ops/decode_scan.py).
//
// One call decodes one whole stream.  The same source builds with nvcc
// (the __global__ wrapper in decode_k1.cu) and with g++ (the test harness
// decode_k1_host.cpp), so the CPU tests hold this logic against the plain
// PyTorch version (csc_tpu_torch/ops/decode_scan.py) before it runs on a
// card.
//
// Contract with the plain version, for every stream: the same window
// bytes, typed-block log, wnd_pos, done and err.  Micro-ops are counted
// as the lockstep version counts its steps (one per range-coder bit, one
// per direct read of <= 16 bits, one per copy chunk of <= 16 bytes, one
// per RLE run byte), so a step cap stops both at the same point.  A
// halting micro-op (corrupt stream, window overflow) writes nothing.
//
// The design keeps each coded bit's dependent chain short:
// * every helper is force-inlined into one decode loop, so the coder
//   state, the rep queue and the reader words live in registers (no
//   array is indexed at run time);
// * while a tree bit decodes, both children's probabilities are loaded
//   (their nodes 2n, 2n+1 are adjacent), and the next bit picks one with
//   a select: the probability read is off the chain;
// * the rc and bc bytes come from register words that are loaded a word
//   ahead of use, and each block end sits in a register;
// * LZ copies load a whole 16-byte chunk before storing any of it, from
//   a shared-memory ring of the last RING output bytes when the distance
//   is within its reach; every byte is also written to the window;
// * an LZ symbol whose micro-ops (FAST_BITS) fit the step budget and
//   whose range-coder bits fit the rc bytes left runs without per-bit
//   halting checks (lz_symbol<false>); a literal likewise;
// * tree loops are not unrolled: fully unrolled, the kernel grew to 63K
//   instructions and ran slower (PERF.md).
// p_lit holds 12-bit probabilities as a low byte per node plus a nibble
// per node, two nodes a byte (98,304 B), so two streams fit one SM.
#pragma once
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define K1_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define K1_FN inline __attribute__((always_inline))
#endif

namespace k1 {

// probability layout (decode_scan.py:38-50): the small trees as uint16,
// p_lit packed (plo, phi), p_delta apart
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
constexpr int NPROB_SMALL = 2048;          // small trees, uint16
constexpr int NPROB_LIT = 65536;           // p_lit: 256 contexts x 256 nodes
constexpr int NPROB_DELTA = 65536;         // p_delta (DT_DLT blocks)
constexpr int RING = 8192;                 // recent output kept in shared
constexpr int RING_MASK = RING - 1;
// shared-memory layout of one stream: small trees, p_lit low bytes, p_lit
// high nibbles, output ring (110,592 B: two streams an SM)
constexpr int OFF_PLO = 2 * NPROB_SMALL;
constexpr int OFF_PHI = OFF_PLO + NPROB_LIT;
constexpr int OFF_RING = OFF_PHI + NPROB_LIT / 2;
constexpr int BLOCKS_PER_SM = 2;
constexpr int SMEM_BYTES = OFF_RING + RING;
// an LZ symbol's micro-ops but for a long length's tail: 2 flags, length
// 9, slot 5, 2 direct reads, extra nibble 4 (a rep match: 3 flags, 2, 9)
constexpr int FAST_BITS = 22;
// and those of a match's distance alone
constexpr int DIST_BITS = 11;

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
    uint8_t* smem;           // SMEM_BYTES, 4-byte aligned, init_word() set
    uint16_t* pdelta;        // NPROB_DELTA entries, all 2048
    int32_t* blk_log;        // [max_blocks][2]: (block type, start)
    int32_t max_blocks;
    int64_t max_steps;
};

struct Result {
    int32_t wnd_pos, done, err, blk_cnt;
};

// the initial model of a stream's shared memory, as 32-bit words: the
// small trees at 2048, p_lit's low bytes 0 and nibbles 8 (2048 = 0x800);
// the ring needs none
K1_FN uint32_t init_word(int i) {
    return i < OFF_PLO / 4 ? 0x08000800u : (i < OFF_PHI / 4 ? 0u
                                                            : 0x88888888u);
}
constexpr int INIT_WORDS = OFF_RING / 4;

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

// two adjacent uint16 values at an address that is 4-byte aligned
K1_FN uint32_t ld_pair(const uint16_t* p) {
#ifdef __CUDA_ARCH__
    return *(const uint32_t*)p;
#else
    return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
#endif
}

// a 2-byte aligned uint16
K1_FN uint32_t ld_u16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
    return *(const uint16_t*)p;
#else
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
#endif
}

// A byte stream read through registers: `buf` holds the rest of the
// current 4-byte word (the next byte in bits 31..24), `nxt` the word after
// it, loaded a word ahead of use.  Words are aligned in memory; bytes
// outside [0, len) read as 0 (a read there halts first).
struct Reader {
    const uint8_t* row;
    int32_t len;
    int32_t shift;           // row's offset in its aligned word
    uint32_t buf, nxt;
    int32_t cnt;             // bytes left in buf
    int32_t nj;              // the word to load into nxt next
    int32_t ptr;             // stream position of the next byte

    K1_FN void open(const uint8_t* r, int64_t n) {
        row = r;
        len = (int32_t)(n < 0x7FFFFFF0 ? n : 0x7FFFFFF0);
        shift = (int32_t)((uintptr_t)r & 3);
    }

    // the bytes at positions 4j - shift .. +3, first byte highest
    K1_FN uint32_t word(int32_t j) const {
        const int64_t s = 4 * (int64_t)j - shift;
        if (s >= 0 && s + 4 <= len) {
#ifdef __CUDA_ARCH__
            const uint32_t w = __ldg((const uint32_t*)(row + s));
            return __byte_perm(w, 0, 0x0123);
#else
            return ((uint32_t)row[s] << 24) | ((uint32_t)row[s + 1] << 16)
                 | ((uint32_t)row[s + 2] << 8) | row[s + 3];
#endif
        }
        uint32_t w = 0;
        for (int k = 0; k < 4; ++k)
            w = (w << 8) | ((s + k >= 0 && s + k < len) ? row[s + k] : 0u);
        return w;
    }

    K1_FN void seek(int32_t p) {
        ptr = p;
        const int64_t a = (int64_t)p + shift;
        const int32_t j = (int32_t)(a >> 2), k = (int32_t)(a & 3);
        buf = word(j) << (8 * k);
        cnt = 4 - k;
        nxt = word(j + 1);
        nj = j + 2;
    }

    // the byte at ptr (the caller checked ptr < len)
    K1_FN uint32_t next() {
        const uint32_t b = buf >> 24;
        buf <<= 8;
        ++ptr;
        if (--cnt == 0) {
            buf = nxt;
            nxt = word(nj++);
            cnt = 4;
        }
        return b;
    }
};

K1_FN bool valid_type(int64_t t) {
    return t == DT_NORMAL || t == DT_EXE || t == DT_ENGTXT || t == DT_BAD
        || t == DT_ENTROPY || t == SIG_EOF || (t >= DT_DLT && t < DT_DLT + 5);
}

struct Dec {
    Stream s;
    uint16_t* ps;            // small trees (shared)
    uint8_t* plo;            // p_lit low bytes (shared)
    uint8_t* phi;            // p_lit high nibbles (shared)
    uint8_t* ring;           // the last RING output bytes (shared)
    Reader rc, bc;
    int32_t rc_blk, rc_end, bc_blk, bc_end;   // *_end = *_ends[clamp(blk)]
    uint32_t code, range, bc_val;
    int32_t bc_bits;
    int32_t budget;          // micro-ops left before the step cap: budget
    int64_t reserve;         // + reserve, moved over in chunks of 2^30
    int32_t wnd_pos, wnd_size;
    int32_t mstate, ctx;
    int32_t rep0, rep1, rep2, rep3;
    int32_t blk_cnt, done, err;
    bool stop;

    // move up to 2^30 micro-ops from the reserve to the budget
    K1_FN void refill_budget() {
        const int64_t t = reserve < (1 << 30) ? reserve : (1 << 30);
        budget += (int32_t)t;
        reserve -= t;
    }

    // take one micro-op; false (and stop) at the step cap
    K1_FN bool take() {
        if (budget <= 0) {
            refill_budget();
            if (budget <= 0) {
                stop = true;
                return false;
            }
        }
        --budget;
        return true;
    }

    K1_FN void corrupt() {
        err = ERR_CORRUPT;
        done = 1;
        stop = true;
    }

    // a write past the window: report where the stream would have got to
    K1_FN void overflow(int64_t would) {
        corrupt();
        wnd_pos = (int32_t)(would < MAX_WINDOW + 1 ? would : MAX_WINDOW + 1);
    }

    // DecodeBit (csc_dec.cpp:10-35) on probability pv: a micro-op, the
    // refill (halting on an rc read past the array), the shift-5 adapt
    // into np.  Without CHK the caller has checked that the budget and
    // the rc bytes left hold this bit (fast()).
    template <bool CHK = true>
    K1_FN int bit(uint32_t pv, uint32_t& np) {
        np = pv;
        if (!CHK) {
            --budget;
        } else if (!take()) {
            return 0;
        }
        if (range < (1u << 24)) {
            if (CHK && rc.ptr >= rc.len) {
                corrupt();
                return 0;
            }
            range <<= 8;
            code = (code << 8) | rc.next();
            if (rc.ptr >= rc_end) {
                ++rc_blk;
                rc_end = s.rc_ends[clampi(rc_blk, 0, s.nb_rc - 1)];
            }
        }
        const uint32_t bound = (range >> 12) * pv;
        const bool one = code < bound;
        range = one ? bound : range - bound;
        code = one ? code : code - bound;
        np = one ? pv + ((0xFFFu - pv) >> 5) : pv - (pv >> 5);
        return one;
    }

    // one bit on a uint16 probability in place
    template <bool CHK = true>
    K1_FN int bit_at(uint16_t* p) {
        uint32_t np;
        const int b = bit<CHK>(*p, np);
        if (!CHK || !stop) *p = (uint16_t)np;
        return b;
    }

    // the next `bits` micro-ops fit the budget and the next `bits` range-
    // coder bits the rc bytes left (a bit refills at most one byte): they
    // may skip the per-bit halting checks
    K1_FN bool fast(int bits) {
        if (budget < bits) refill_budget();
        return budget >= bits && rc.ptr + bits <= rc.len;
    }

    // binary tree of nbits bits rooted at base[1]; returns the final
    // node.  Both children of a node load while its bit decodes; PAIR:
    // base is 4-byte aligned, so they load as one word.  A loop, not
    // unrolled (unrolled trees made K1 larger and slower: PERF.md).
    template <bool PAIR, bool CHK = true>
    K1_FN int tree(uint16_t* base, int nbits) {
        int n = 1;
        uint32_t p = base[1], np;
        for (int i = 1; i < nbits; ++i) {
            uint32_t c0, c1;
            if (PAIR) {
                const uint32_t w = ld_pair(base + 2 * n);
                c0 = w & 0xFFFF;
                c1 = w >> 16;
            } else {
                c0 = base[2 * n];
                c1 = base[2 * n + 1];
            }
            const int b = bit<CHK>(p, np);
            if (CHK && stop) return 0;
            base[n] = (uint16_t)np;
            n = 2 * n + b;
            p = b ? c1 : c0;
        }
        const int b = bit<CHK>(p, np);    // the last bit: no children
        if (CHK && stop) return 0;
        base[n] = (uint16_t)np;
        return 2 * n + b;
    }

    // p_lit's root probability of context c
    K1_FN uint32_t lit_root(int c) const {
        return plo[c * 256 + 1] | ((uint32_t)(phi[c * 128] & 0xF0) << 4);
    }

    // the 8-bit literal tree of context c from its root probability p;
    // returns the final node (256..511).  Node n's probability is
    // plo[n] | (nibble n of phi) << 8; the children pair loads as one
    // 16-bit low-byte pair and one nibble byte.  A node's adapt rewrites
    // its nibble byte from registers (its sibling's nibble was loaded
    // with it and is unchanged).
    template <bool CHK>
    K1_FN int literal(int c, uint32_t p) {
        uint8_t* lo = plo + c * 256;
        uint8_t* hi = phi + c * 128;
        uint32_t nib = 0;                 // the byte of node n's nibble
        int n = 1;
        uint32_t np;
        for (int i = 1; i < 8; ++i) {
            const uint32_t c_lo = ld_u16(lo + 2 * n), c_hi = hi[n];
            const int b = bit<CHK>(p, np);
            if (CHK && stop) return 0;
            lit_store(lo, hi, n, np, nib);
            n = 2 * n + b;
            p = b ? (c_lo >> 8) | ((c_hi & 0xF0) << 4)
                  : (c_lo & 0xFF) | ((c_hi & 0x0F) << 8);
            nib = c_hi;
        }
        const int b = bit<CHK>(p, np);    // the last bit: no children
        if (CHK && stop) return 0;
        lit_store(lo, hi, n, np, nib);
        return 2 * n + b;
    }

    // node n's adapted probability np: its low byte, and its nibble into
    // the byte it shares with its sibling (nib, as loaded)
    K1_FN void lit_store(uint8_t* lo, uint8_t* hi, int n, uint32_t np,
                         uint32_t nib) const {
        lo[n] = (uint8_t)np;
        hi[n >> 1] = (uint8_t)((n & 1) ? (nib & 0x0F) | ((np >> 4) & 0xF0)
                                       : (nib & 0xF0) | (np >> 8));
    }

    // a literal, without per-bit halting checks when its 8 micro-ops fit
    // the budget and its bits the rc bytes left
    K1_FN int lit(int c, uint32_t p) {
        return fast(8) ? literal<false>(c, p) : literal<true>(c, p);
    }

    // coder_decode_direct (csc_dec.cpp:65-87): one micro-op, nbits <= 16
    K1_FN uint32_t direct(int nbits) {
        if (!take()) return 0;
        while (bc_bits < nbits) {
            if (bc.ptr >= bc.len) {
                corrupt();
                return 0;
            }
            bc_val = (bc_val << 8) | bc.next();
            if (bc.ptr >= bc_end) {
                ++bc_blk;
                bc_end = s.bc_ends[clampi(bc_blk, 0, s.nb_bc - 1)];
            }
            bc_bits += 8;
        }
        const uint32_t v = (bc_val >> (bc_bits - nbits)) & ((1u << nbits) - 1u);
        bc_bits -= nbits;
        return v;
    }

    // DecodeDirect (csc_dec.cpp:37-42): > 16 bits take two micro-ops
    K1_FN uint32_t direct_long(int nbits) {
        if (nbits <= 16) return direct(nbits);
        const uint32_t hi = direct(nbits - 16);
        if (stop) return 0;
        const uint32_t lo = direct(16);
        return (hi << 16) | lo;
    }

    // decode_int (csc_dec.cpp:89-96); the slot shift saturates at 30 as
    // in decode_scan
    K1_FN int64_t read_int() {
        const int slot = (int)direct(5);
        if (stop) return 0;
        const uint32_t v = direct_long(slot > 1 ? slot : 1);
        if (stop) return 0;
        return (int64_t)v + (slot > 0 ? (int64_t(1) << (slot < 30 ? slot : 30))
                                      : 0);
    }

    // decode_matchlen_1 (csc_dec.cpp:187-218): two slot bits, then one
    // tree of 3, 3 or 7 bits
    template <bool CHK = true>
    K1_FN int64_t len1() {
        const int b0 = bit_at<CHK>(ps + P_MLSLOT);
        if (CHK && stop) return 0;
        int b1 = 0;
        if (b0) {
            b1 = bit_at<CHK>(ps + P_MLSLOT + 1);
            if (CHK && stop) return 0;
        }
        const int nbits = b1 ? 7 : 3;
        const int node = tree<true, CHK>(
            ps + (b1 ? P_MLEX3 : b0 ? P_MLEX2 : P_MLEX1), nbits);
        return (b1 ? 16 : b0 ? 8 : 0) + (node & ((1 << nbits) - 1));
    }

    // decode_matchlen_2 (csc_dec.cpp:220-232); the long-length bits past
    // 143 are always checked: their count has no bound
    template <bool CHK = true>
    K1_FN int64_t match_len() {
        const int64_t l = len1<CHK>();
        if (stop || l != 143) return l;
        int64_t acc = 143;
        for (;;) {
            const int b = bit_at(ps + P_LONGLEN);
            if (stop) return 0;
            if (b) break;
            acc += 143;
        }
        return acc + len1();
    }

    // one output byte at wnd_pos (the window bound checked)
    K1_FN void put(uint32_t v) {
        ring[wnd_pos & RING_MASK] = (uint8_t)v;
        s.wnd[wnd_pos++] = (uint8_t)v;
    }

    // overlap-safe LZ copy, 16 bytes per micro-op (csc_dec.cpp:497-507);
    // dist in [1, wnd_pos], len >= 1, the window bound checked.  Each
    // chunk loads all its bytes before storing any.  A distance under 16
    // repeats the last dist bytes: the first chunk reads them by index
    // modulo dist, later ones copy at dd, the smallest multiple of dist
    // >= 16.  Sources within RING bytes read the ring: a chunk's stores
    // reach its sources' slots only after its loads.
    K1_FN void copy(int32_t dist, int32_t len) {
        int32_t dd = dist;
        while (dd < COPY_CHUNK) dd += dist;
        const bool near = dd <= RING;
        const int32_t start = wnd_pos;
        while (len > 0) {
            if (!take()) return;
            const int32_t chunk = len < COPY_CHUNK ? len : COPY_CHUNK;
            const bool pattern = dist < COPY_CHUNK && wnd_pos == start;
            uint32_t v[COPY_CHUNK];
            int32_t j = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < COPY_CHUNK; ++k) {
                const int32_t q = pattern ? start - dist + j
                                          : wnd_pos - dd + k;
                v[k] = near ? ring[q & RING_MASK] : s.wnd[q];
                j = j + 1 == dist ? 0 : j + 1;
            }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
            for (int k = 0; k < COPY_CHUNK; ++k) {
                if (k < chunk) {
                    ring[(wnd_pos + k) & RING_MASK] = (uint8_t)v[k];
                    s.wnd[wnd_pos + k] = (uint8_t)v[k];
                }
            }
            wnd_pos += chunk;
            len -= chunk;
        }
        // the last byte from the ring: v[chunk - 1] would index v at run
        // time and put it in local memory
        ctx = ring[(wnd_pos - 1) & RING_MASK];
    }

    // one symbol of lz_decode (csc_dec.cpp:476-571): a literal, a match,
    // rep0len1 or a rep match; false at the block end or a halt.  pf: the
    // flag probability, loaded ahead (and the next symbol's, on return);
    // proot: the literal root of ctx, loaded ahead.  Without CHK the
    // caller has checked that the symbol's micro-ops fit (FAST_BITS); past
    // a long length's checked bits, the distance's are checked again.
    template <bool CHK>
    K1_FN bool lz_symbol(uint32_t& pf, uint32_t proot) {
        const int m3 = mstate * 3;
        uint32_t np;
        int f = bit<CHK>(pf, np);
        if (CHK && stop) return false;
        ps[P_STATE + m3] = (uint16_t)np;
        if (!f) {                                          // literal
            mstate = (mstate * 4) & 0x3F;
            pf = ps[P_STATE + mstate * 3];     // the next symbol's flag
            const int node = CHK ? lit(ctx, proot)
                                 : literal<false>(ctx, proot);
            if (CHK && stop) return false;
            if (wnd_pos + 1 > wnd_size) {
                overflow(wnd_pos + 1);
                return false;
            }
            ctx = node & 0xFF;
            put(ctx);
            return true;
        }
        f = bit_at<CHK>(ps + P_STATE + m3 + 1);
        if (CHK && stop) return false;
        int64_t len, dist;
        if (f) {                                           // match
            len = match_len<CHK>();
            if (stop) return false;
            const int64_t dist_raw = CHK || (len >= 143 && !fast(DIST_BITS))
                                   ? match_dist<true>(len)
                                   : match_dist<false>(len);
            if (stop) return false;
            mstate = (mstate * 4 + 1) & 0x3F;
            if (len == 0 && dist_raw == 64) return false;  // block end
            dist = dist_raw + 1;
            rep3 = rep2;
            rep2 = rep1;
            rep1 = rep0;
            rep0 = (int32_t)dist;
        } else {
            f = bit_at<CHK>(ps + P_STATE + m3 + 2);
            if (CHK && stop) return false;
            if (!f) {                                      // rep0len1
                mstate = (mstate * 4 + 2) & 0x3F;
                // the reference wraps its ring when wnd_pos <= rep0
                // (csc_dec.cpp:525); a linear window holds no such byte
                if (rep0 <= 0 || wnd_pos <= rep0) {
                    corrupt();
                    return false;
                }
                if (wnd_pos + 1 > wnd_size) {
                    overflow(wnd_pos + 1);
                    return false;
                }
                copy(rep0, 1);
                pf = ps[P_STATE + mstate * 3];
                return !stop;
            }
            const int rep_idx = tree<false, CHK>(ps + P_REPDIST + m3 - 1, 2)
                              & 3;                         // rep match
            if (CHK && stop) return false;
            len = match_len<CHK>();
            if (stop) return false;
            mstate = (mstate * 4 + 3) & 0x3F;
            // rotate reps[0..rep_idx] (csc_dec.cpp:538-541)
            const int32_t o0 = rep0, o1 = rep1, o2 = rep2;
            const int32_t rdist = rep_idx == 0 ? o0 : rep_idx == 1 ? o1
                                : rep_idx == 2 ? o2 : rep3;
            if (rep_idx >= 1) rep1 = o0;
            if (rep_idx >= 2) rep2 = o1;
            if (rep_idx >= 3) rep3 = o2;
            rep0 = rdist;
            dist = rdist;
        }
        if (dist <= 0 || dist > wnd_pos) {
            corrupt();
            return false;
        }
        if (wnd_pos + len + 2 > wnd_size) {
            overflow(wnd_pos + len + 2);
            return false;
        }
        copy((int32_t)dist, (int32_t)len + 2);
        pf = ps[P_STATE + mstate * 3];
        return !stop;
    }

    // a match's raw distance after its length: the slot tree, the direct
    // bits of a long distance, the extra nibble tree
    template <bool CHK>
    K1_FN int64_t match_dist(int64_t len) {
        const int lc = len < 6 ? (int)len : 6;
        const int pos = lc == 0 ? 0 : (lc <= 2 ? 16 * (lc - 1) + 8
                                               : (lc <= 5 ? 32 * (lc - 3) + 40
                                                          : 136));
        const int sbits = lc == 0 ? 3 : (lc <= 2 ? 4 : 5);
        const int slot = tree<true, CHK>(ps + P_DIST + pos, sbits)
                       & ((1 << sbits) - 1);
        if ((CHK && stop) || slot <= 2) return slot;
        const int ebits = slot - 2;
        uint32_t elen = 0;
        if (ebits > 4) {
            elen = direct_long(ebits - 4);
            if (stop) return 0;
        }
        const int nib = tree<true, CHK>(ps + P_MDEXTRA + (ebits - 1) * 16, 4);
        return dist_table(slot) + ((int64_t)elen << 4) + rev4(nib & 0xF);
    }

    // lz_decode (csc_dec.cpp:476-571) up to the block-end sentinel, one
    // symbol an iteration; a symbol whose tree bits fit the budget and
    // the rc bytes left runs without per-bit halting checks
    K1_FN void lz_block() {
        uint32_t pf = ps[P_STATE + mstate * 3];
        for (;;) {
            const uint32_t proot = lit_root(ctx);
            if (fast(FAST_BITS) ? !lz_symbol<false>(pf, proot)
                                : !lz_symbol<true>(pf, proot))
                return;
        }
    }

    // decode_literals (csc_dec.cpp:169-185): order-1 bytes sharing p_lit
    K1_FN void entropy_block() {
        const int64_t size = read_int();
        if (stop) return;
        if (wnd_pos + size > wnd_size) return overflow(wnd_pos + size);
        for (int64_t i = 0; i < size; ++i) {
            const int node = lit(ctx, lit_root(ctx));
            if (stop) return;
            ctx = node & 0xFF;
            put(ctx);
        }
    }

    // decode_bad (csc_dec.cpp:98-108): raw bytes, two per micro-op
    K1_FN void bad_block() {
        int64_t rem = read_int();
        if (stop) return;
        if (wnd_pos + rem > wnd_size) return overflow(wnd_pos + rem);
        while (rem > 0) {
            if (rem >= 2) {
                const uint32_t v = direct(16);
                if (stop) return;
                put(v >> 8);
                put(v);
                rem -= 2;
            } else {
                const uint32_t v = direct(8);
                if (stop) return;
                put(v);
                rem -= 1;
            }
        }
    }

    // decode_rle (csc_dec.cpp:110-153) with the inverse delta of
    // csc_dec.cpp:644-651 fused in: each delta byte is added to the
    // previous original byte of its channel and written at its
    // interleaved position (RLE decode order is the inverse delta's
    // channel-major order).  The ring takes the block's last bytes from
    // the window once it is whole.
    K1_FN void dlt_block(int32_t chn) {
        const int64_t size = read_int();
        if (stop) return;
        if (wnd_pos + size > wnd_size) return overflow(wnd_pos + size);
        uint8_t* w = s.wnd + wnd_pos;
        int prev = 0, last_delta = 0, sctx = 0;
        int32_t rel = 0, lane = 0;
        int64_t rem = size;
        while (rem > 0) {
            const int f = bit_at(ps + P_RLEFLAG);
            if (stop) return;
            int64_t run = 1;
            if (!f) {
                const int delta = tree<true>(s.pdelta + sctx * 256, 8) & 0xFF;
                if (stop) return;
                last_delta = sctx = delta;
            } else {
                run = match_len() + 11;
                if (stop) return;
            }
            // a literal writes its byte in the micro-op of its last bit; a
            // run writes one byte per micro-op
            do {
                if (f && !take()) return;
                prev = (last_delta + prev) & 0xFF;
                w[rel] = (uint8_t)prev;
                rel += chn;
                if (rel >= size) rel = ++lane;
                --run;
                --rem;
                sctx = last_delta;
            } while (run != 0 && rem != 0);
        }
        const int32_t end = wnd_pos + (int32_t)size;
        for (int32_t x = size > RING ? end - RING : wnd_pos; x < end; ++x)
            ring[x & RING_MASK] = s.wnd[x];
        wnd_pos = end;
    }

    // per-chunk coder re-init (csc_dec.cpp:657-680): rc primes from bytes
    // 1..4 of its next block, bc restarts at its next block
    K1_FN void chunk_reset() {
        const int32_t r = rc_end;
        if ((int64_t)r + 5 > rc.len) return corrupt();
        const uint8_t* b = rc.row;
        code = ((uint32_t)b[r + 1] << 24) | ((uint32_t)b[r + 2] << 16)
             | ((uint32_t)b[r + 3] << 8) | b[r + 4];
        range = 0xFFFFFFFFu;
        rc.seek(r + 5);
        ++rc_blk;
        rc_end = s.rc_ends[clampi(rc_blk, 0, s.nb_rc - 1)];
        bc.seek(bc_end);
        ++bc_blk;
        bc_end = s.bc_ends[clampi(bc_blk, 0, s.nb_bc - 1)];
        bc_val = 0;
        bc_bits = 0;
    }

    // Decoder::Decompress loop (csc_dec.cpp:586-682) over the whole stream
    K1_FN Result run() {
        ps = (uint16_t*)s.smem;
        plo = s.smem + OFF_PLO;
        phi = s.smem + OFF_PHI;
        ring = s.smem + OFF_RING;
        rc.open(s.rc, s.rcl);
        bc.open(s.bc, s.bcl);
        const uint8_t* b = s.rc;
        code = ((uint32_t)b[1] << 24) | ((uint32_t)b[2] << 16)
             | ((uint32_t)b[3] << 8) | b[4];
        range = 0xFFFFFFFFu;
        rc.seek(5);
        bc.seek(0);
        rc_blk = bc_blk = 0;
        rc_end = s.rc_ends[0];
        bc_end = s.bc_ends[0];
        bc_val = 0;
        bc_bits = 0;
        budget = 0;
        reserve = s.max_steps > 0 ? s.max_steps : 0;
        wnd_pos = 0;
        wnd_size = (int32_t)(s.wnd_size < 0x7FFFFFF0 ? s.wnd_size
                                                     : 0x7FFFFFF0);
        mstate = ctx = 0;
        rep0 = rep1 = rep2 = rep3 = 0;
        blk_cnt = done = err = 0;
        stop = false;
        for (;;) {
            const int64_t type = read_int();
            if (stop) break;
            if (!valid_type(type)) {
                corrupt();
                break;
            }
            const int32_t at = blk_cnt < s.max_blocks ? blk_cnt
                                                      : s.max_blocks - 1;
            s.blk_log[2 * at] = (int32_t)type;
            s.blk_log[2 * at + 1] = wnd_pos;
            ++blk_cnt;
            if (type == DT_NORMAL || type == DT_EXE) {
                lz_block();
            } else if (type == DT_ENGTXT) {
                read_int();         // declared size, unused (csc_dec.cpp:603)
                if (!stop) lz_block();
            } else if (type == DT_BAD) {
                bad_block();
            } else if (type == DT_ENTROPY) {
                entropy_block();
            } else if (type >= DT_DLT) {
                const int64_t t = type - DT_DLT;          // DLT_INDEX
                dlt_block(t == 4 ? 8 : (int32_t)t + 1);
            }
            if (stop) break;
            const int64_t cont = read_int();
            if (stop) break;
            if (cont == 1) {
                chunk_reset();
                if (stop) break;
            }
            if (type == SIG_EOF) {
                done = 1;
                break;
            }
        }
        return Result{wnd_pos, done, err, blk_cnt};
    }
};

K1_FN Result decode_stream(const Stream& s) {
    Dec d;
    d.s = s;
    return d.run();
}

}  // namespace k1
