// Step code of the spike probes: the card's counterparts of the TPU
// measurement spikes in tools/spike_*.py, one struct per kind of step.
//
// Each spike kernel timed one ingredient of a serial coder step on the
// TPU (a bit-model read and adapt, a window byte read, a match copy, a
// context-row fetch, chains of register ops, the scalar service sweep,
// the loop and streaming floor).  A probe here computes what its spike
// kernel computes (same inputs, step rule, step count and output) with
// the card's primitives: an indexed load for a one-hot sum, shared memory
// for VMEM, a copy by the thread for a DMA, index arithmetic for
// pltpu.roll, shared memory and __syncthreads for the SMEM sweep.
//
// What bounds a probe on the card: each stream is one chain of dependent
// steps, so a step costs the latency of its loads and ops, not the card's
// memory or instruction rates (PERF.md holds the bounds beside the times).
//
// One templated loop kernel (spike_kernel below) runs any probe in one of
// two layouts, on the same inputs:
//   layout 0 ("a", as K1-K3): one stream per block, one thread;
//   layout 1 ("b", packed):   one stream per thread, 128 to a block.
// A probe's per-stream state (its table or window) lives in shared memory
// when the block's streams' share fits (Ctx::staged), interleaved so that
// element i of the block's stream t sits at i * per + t; otherwise it is
// worked on in device memory in place.
//
// The structs are __host__ __device__ so that csrc/spike_host.cpp builds
// them with g++ and the CPU tests hold them to the plain versions
// (csc_tpu_torch/spikes/); there SYNC is a no-op and each stream runs
// alone (layout "a").
#pragma once
#include <stdint.h>

#include <type_traits>

#ifdef __CUDACC__
#define SPK_UNROLL _Pragma("unroll")
#define HD __host__ __device__ __forceinline__
#define HDS __host__ __device__
#ifdef __CUDA_ARCH__
#define SYNC() __syncthreads()
#define ATOMIC_ADD(p, v) atomicAdd((p), (v))
#else
#define SYNC() ((void)0)
#define ATOMIC_ADD(p, v) (*(p) += (v))
#endif
#else
#define SPK_UNROLL
#define HD inline
#define HDS
#define SYNC() ((void)0)
#define ATOMIC_ADD(p, v) (*(p) += (v))
#endif

namespace spk {

constexpr int PACK = 128;                  // streams per block, layout b
constexpr int64_t STAGE_CAP = 200 * 1024;  // shared memory for staged state

struct Args {
    const int32_t* steps;  // device scalar: the step count, as SMEM held it
    void* p[8];            // inputs, then outputs
    int64_t q[6];          // the probe's shape parameters
    int32_t n;             // streams
    int32_t layout;        // 0 = a, 1 = b
};

struct Ctx {
    int32_t b;       // this thread's stream
    int32_t t;       // its slot in the block
    int32_t per;     // stream slots per block
    int32_t first;   // the block's first stream
    int32_t cnt;     // streams the block holds
    bool live;       // b < n
    bool staged;     // per-stream state in shared memory
    unsigned char* stage;  // per * stage_bytes, interleaved
    int32_t* pub;          // per * pub_words: the block's published words
};

// --- helpers ------------------------------------------------------------
HD int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
HD int32_t sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
HD int32_t mul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
// a non-negative remainder, as jnp's % for a positive divisor
HD int32_t pmod(int32_t a, int32_t m) { int32_t r = a % m; return r < 0 ? r + m : r; }
// keep x live and unknown to the compiler: no step folds into a product
HD void opaque(int32_t& x) { asm volatile("" : "+r"(x)); }
HD void sink(int32_t x) { asm volatile("" : : "r"(x)); }
template <class T> HD T vload(const T* p) { return *(const volatile T*)p; }
template <class T> HD void vstore(T* p, T v) { *(volatile T*)p = v; }

struct alignas(16) V16 { uint32_t x, y, z, w; };

// A stream's array: element i at p[i * s] (s = 1 in device memory, the
// block's slots when staged).
template <class T> struct View {
    T* p;
    int32_t s;
    HD T& operator[](int64_t i) const { return p[i * s]; }
    HD T get(int64_t i) const { return vload(p + i * s); }
};

// Place `count` elements of this stream's row in its stage slot (at byte
// offset off of the per-stream stage) when staged, else use the row.
template <class T>
HD View<T> place(const Ctx& c, T* row, int64_t off, int64_t count) {
    if (!c.staged) return View<T>{row, 1};
    View<T> v{(T*)(c.stage + off * c.per) + c.t, c.per};
    for (int64_t i = 0; i < count; ++i) v[i] = row[i];
    return v;
}
template <class T>
HD void unplace(const Ctx& c, View<T> v, T* row, int64_t count) {
    if (!c.staged) return;
    for (int64_t i = 0; i < count; ++i) row[i] = v[i];
}

// memmove of n bytes inside one view, as a DMA moves a snapshot of its
// source: 16 bytes at a time where both ends allow it, else by bytes.
HD void move(View<uint8_t> v, int64_t dst, int64_t src, int64_t n) {
    if (dst == src || n <= 0) return;
    const bool overlap = dst < src + n && src < dst + n;
    if (v.s == 1 && !overlap && ((uintptr_t)(v.p + dst) % 16) == 0 &&
        ((uintptr_t)(v.p + src) % 16) == 0 && n % 16 == 0) {
        V16* d = (V16*)(v.p + dst);
        const V16* s = (const V16*)(v.p + src);
        for (int64_t i = 0; i < n / 16; ++i) d[i] = s[i];
    } else if (dst < src || !overlap) {
        for (int64_t i = 0; i < n; ++i) v[dst + i] = v[src + i];
    } else {
        for (int64_t i = n - 1; i >= 0; --i) v[dst + i] = v[src + i];
    }
}

// The block's sweep: every thread publishes one word, thread 0 reads
// them one at a time (the TPU's scalar core over SMEM) and returns their
// sum; every thread of the block calls it.
HD int32_t sweep_sum(const Ctx& c, int32_t v) {
    c.pub[c.t] = v;
    SYNC();
    int32_t s = 0;
    if (c.t == 0)
        for (int32_t j = 0; j < c.cnt; ++j) s = add(s, vload(c.pub + j));
    SYNC();
    return s;
}

HD int32_t adapt(int32_t p) {  // the bit model's update after bit p & 1
    return (p & 1) ? p + ((4095 - p) >> 5) : p - (p >> 5);
}

// Defaults of the probe interface.
struct Base {
    static HDS int64_t stage_bytes(const Args&) { return 0; }
    static HDS int64_t pub_words(const Args&) { return 0; }
    static HDS int64_t extra_words() { return 0; }
};

// --- bit-model steps (m1, m1b, onehot_step_cost, p8, r3) ----------------
// p0 pidx [n] i32, p1 tbl [n, NP] T, p2 out [n] i32; q0 NP, q1 reps a
// step, q2 1 = add only the last rep's p (r3).
template <class T> struct BitStep : Base {
    struct S { int32_t acc, pidx; View<T> tbl; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] * (int64_t)sizeof(T) + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.pidx = ((const int32_t*)a.p[0])[c.b];
        s.tbl = place(c, (T*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t np = (int32_t)a.q[0], reps = (int32_t)a.q[1];
        int32_t p = 0;
        for (int32_t r = 0; r < reps; ++r) {
            p = (int32_t)s.tbl[s.pidx];
            const int32_t bit = p & 1;
            s.tbl[s.pidx] = (T)adapt(p);
            if (!a.q[2]) s.acc = add(s.acc, p);
            s.pidx = (s.pidx * 5 + 1 + bit) % np;
        }
        if (a.q[2]) s.acc = add(s.acc, p);
        opaque(s.acc);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[2])[c.b] = s.acc;
        unplace(c, s.tbl, (T*)a.p[1] + c.b * a.q[0], a.q[0]);
    }
};

// --- window reads (m2, m8, p7, s7): acc += wnd[pos] ---------------------
// p0 pos [n] i32, p1 wnd [n, W] T, p2 out [n] i32; q0 W.
template <class T> struct WndRead : Base {
    struct S { int32_t acc, pos; View<T> w; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] * (int64_t)sizeof(T) + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.pos = ((const int32_t*)a.p[0])[c.b];
        s.w = place(c, (T*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        s.acc = add(s.acc, (int32_t)s.w[s.pos]);
        s.pos = (s.pos * 5 + 3) % (int32_t)a.q[0];
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.live) ((int32_t*)a.p[2])[c.b] = s.acc;
    }
};

// --- m7: p = tbl[pidx], the next index from p ---------------------------
// p0 pidx, p1 tbl [n, NP] i32, p2 out; q0 NP.
struct Gather32 : Base {
    struct S { int32_t acc, pidx; View<int32_t> tbl; };
    static HDS int64_t stage_bytes(const Args& a) { return a.q[0] * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.pidx = ((const int32_t*)a.p[0])[c.b];
        s.tbl = place(c, (int32_t*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t p = s.tbl[s.pidx];
        s.acc = add(s.acc, p);
        s.pidx = pmod(add(add(mul(s.pidx, 5), 1), p & 1), (int32_t)a.q[0]);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.live) ((int32_t*)a.p[2])[c.b] = s.acc;
    }
};

// --- s1: window byte read, then a byte write 7 further ------------------
// p0 pos, p1 wnd [n, W] u8, p2 out; q0 W.
struct ByteRmw : Base {
    struct S { int32_t acc, pos; View<uint8_t> w; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.pos = ((const int32_t*)a.p[0])[c.b];
        s.w = place(c, (uint8_t*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t w = (int32_t)a.q[0];
        const int32_t byte = s.w[s.pos];
        s.w[(s.pos + 7) % w] = (uint8_t)((byte + 1) & 0xFF);
        s.acc = add(s.acc, byte);
        s.pos = (s.pos * 5 + 3) % w;
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[2])[c.b] = s.acc;
        unplace(c, s.w, (uint8_t*)a.p[1] + c.b * a.q[0], a.q[0]);
    }
};

// --- m3: a CH-byte (<= 16) match copy at per-stream offsets -------------
// p0 pos, p1 wnd [n, W] u8, p2 out; q0 W, q1 CH.
struct Copy16 : Base {
    struct S { int32_t acc, pos; View<uint8_t> w; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.pos = ((const int32_t*)a.p[0])[c.b];
        s.w = place(c, (uint8_t*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t ch = (int32_t)a.q[1], lim = (int32_t)a.q[0] - 2 * ch;
        const int32_t src = (s.pos * 7 + 11) % lim;
        uint8_t got[16];
        for (int32_t k = 0; k < 16; ++k) got[k] = k < ch ? s.w[src + k] : 0;
        for (int32_t k = 0; k < 16; ++k) if (k < ch) s.w[s.pos + k] = got[k];
        s.acc = add(s.acc, got[0]);
        s.pos = (s.pos * 5 + 3) % lim;
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[2])[c.b] = s.acc;
        unplace(c, s.w, (uint8_t*)a.p[1] + c.b * a.q[0], a.q[0]);
    }
};

// --- m6, m6b, transition_cost: 300 chained select / arith ops -----------
// p0 x [n] i32, p1 out [n]; q0 reps a step (the unroll).
struct Chain : Base {
    struct S { int32_t a, b, c; };
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.a = ((const int32_t*)a.p[0])[c.b];
        s.b = add(s.a, 1);
        s.c = add(s.a, 2);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        for (int64_t u = 0; u < a.q[0]; ++u) {
SPK_UNROLL
            for (int k = 0; k < 300 / 6; ++k) {
                const bool m = s.a > s.b;
                s.a = m ? add(s.a, 1) : sub(s.a, s.c);
                s.b = m ? add(mul(s.b, 2), 1) : s.b;
                s.c = ((s.c & 3) == 1 ? add(s.c, s.a) : add(s.c, 1)) & 0xFFFF;
            }
        }
        opaque(s.a);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.live) ((int32_t*)a.p[1])[c.b] = add(add(s.a, s.b), s.c);
    }
};

// --- w4, m9: cache = tbl[ctx] (a 256-int32 context row) -----------------
// p0 ctx, p1 tbl [n, NROW, 256] i32, p2 cache [n, 256] i32, p3 out; q0 NROW.
struct RowGather : Base {
    struct S { int32_t acc, ctx; View<int32_t> tbl, cache; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] + 1) * 1024; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.ctx = ((const int32_t*)a.p[0])[c.b];
        s.tbl = place(c, (int32_t*)a.p[1] + c.b * a.q[0] * 256, 0, a.q[0] * 256);
        s.cache = place(c, (int32_t*)a.p[2] + c.b * 256, a.q[0] * 1024, 256);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        for (int32_t j = 0; j < 256; ++j) s.cache[j] = s.tbl[s.ctx * 256 + j];
        s.acc = add(s.acc, s.cache[0]);
        s.ctx = (s.ctx * 3 + 1) % (int32_t)a.q[0];
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[3])[c.b] = s.acc;
        unplace(c, s.cache, (int32_t*)a.p[2] + c.b * 256, 256);
    }
};

// --- S1: N carried registers through add / shift / select / xor ---------
// p0 init [npad, n] i32, p1 out [npad, n] i32; q0 N, q1 npad.  Carry<N,0>
// keeps them in registers (run_tuple); Carry<N,1> keeps them in memory,
// read and written back every step (run_packed's carried array).
template <int N> HD void carry_work(const int32_t* r, int32_t* nx) {
SPK_UNROLL
    for (int i = 0; i < N; ++i) {
        const int32_t a = r[(i + 1) % N], b = r[(i + 7) % N];
        const int32_t v = add(r[i], a >> 3);
        nx[i] = b > r[i] ? (v ^ a) : add(v, 1);
    }
}
template <int N, int MEM> struct Carry : Base {
    struct S { int32_t r[MEM ? 1 : N]; View<int32_t> m; };
    static HDS int64_t stage_bytes(const Args&) { return MEM ? N * 4 : 0; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        const int32_t* in = (const int32_t*)a.p[0];
        int32_t* out = (int32_t*)a.p[1];
        for (int64_t i = N; i < a.q[1]; ++i) out[i * a.n + c.b] = in[i * a.n + c.b];
        if (MEM) {
            for (int i = 0; i < N; ++i) out[i * a.n + c.b] = in[i * a.n + c.b];
            s.m = c.staged ? place(c, (int32_t*)nullptr, 0, 0) : View<int32_t>{out + c.b, a.n};
            if (c.staged) for (int i = 0; i < N; ++i) s.m[i] = in[i * a.n + c.b];
        } else {
SPK_UNROLL
            for (int i = 0; i < N; ++i) s.r[MEM ? 0 : i] = in[i * a.n + c.b];
        }
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        int32_t cur[N], nx[N];
        if (MEM) {
            for (int i = 0; i < N; ++i) cur[i] = s.m.get(i);
            carry_work<N>(cur, nx);
            for (int i = 0; i < N; ++i) vstore(&s.m[i], nx[i]);
        } else {
SPK_UNROLL
            for (int i = 0; i < N; ++i) cur[i] = s.r[MEM ? 0 : i];
            carry_work<N>(cur, nx);
SPK_UNROLL
            for (int i = 0; i < N; ++i) { s.r[MEM ? 0 : i] = nx[i]; opaque(s.r[MEM ? 0 : i]); }
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        int32_t* out = (int32_t*)a.p[1];
        if (MEM) {
            if (c.staged) for (int i = 0; i < N; ++i) out[i * a.n + c.b] = s.m[i];
        } else {
SPK_UNROLL
            for (int i = 0; i < N; ++i) out[i * a.n + c.b] = s.r[MEM ? 0 : i];
        }
    }
};

// --- S3: REPS = 16 reads or writes of a 256-int32 per-stream table ------
// p0 x [n, 256] i32 (the carried table, written back), p1 out [n] i32.
// MODE 0 base, 1 onehot256, 2 onehot128, 3 statlane, 4 condroll,
// 5 adaptwrite, 6 logrot.  condroll keeps its rotation as an offset.
template <int MODE> struct Lanes : Base {
    struct S { int32_t acc, rot; View<int32_t> arr; };
    static HDS int64_t stage_bytes(const Args&) { return 1024; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.rot = 0;
        s.arr = place(c, (int32_t*)a.p[0] + c.b * 256, 0, 256);
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t idx = s.acc & 0xFF;
SPK_UNROLL
        for (int r = 0; r < 16; ++r) {
            if (MODE == 0) {
                s.acc = add(s.acc, 1);
            } else if (MODE == 1) {
                s.acc = add(s.acc, s.arr[(idx + r) & 0xFF]);
            } else if (MODE == 2) {
                s.acc = add(s.acc, s.arr[(idx + r) & 0x7F]);
            } else if (MODE == 3) {
                s.acc = add(s.acc, s.arr[(r * 37) % 256]);
            } else if (MODE == 4) {
                const int32_t sh = 1 << (r % 8);
                if (s.acc & sh) s.rot = (s.rot + sh) & 0xFF;
                s.acc = add(s.acc, s.arr[s.rot]);
            } else if (MODE == 5) {
                if ((s.acc & 1) == 0) s.arr[(r * 37) % 256] = add(s.acc, r);
                s.acc = add(s.acc, s.arr[0]);
            } else {
                s.acc = add(s.acc, s.arr[s.acc & 0xFF]);
            }
        }
        opaque(s.acc);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        int32_t* row = (int32_t*)a.p[0] + c.b * 256;
        ((int32_t*)a.p[1])[c.b] = add(s.acc, s.arr[s.rot]);
        if (c.staged) {
            for (int32_t i = 0; i < 256; ++i) row[i] = s.arr[(i + s.rot) & 0xFF];
        } else if (s.rot) {  // rotate the row left by rot, in place
            for (int32_t lo = 0, hi = s.rot - 1; lo < hi; ++lo, --hi) { int32_t x = row[lo]; row[lo] = row[hi]; row[hi] = x; }
            for (int32_t lo = s.rot, hi = 255; lo < hi; ++lo, --hi) { int32_t x = row[lo]; row[lo] = row[hi]; row[hi] = x; }
            for (int32_t lo = 0, hi = 255; lo < hi; ++lo, --hi) { int32_t x = row[lo]; row[lo] = row[hi]; row[hi] = x; }
        }
    }
};

// --- S5: stage a pair of 128-wide rows from a [16, 128] tile, or write
// one back.  p0 tile [n, 16, 128] (i32 for KIND 0/2, f32 for 1/3), p1 sub
// [n] i32, p2 out [n] i32.  KIND 0 sel_i32, 1 mxu_f32 (a direct row read
// in place of the one-hot product), 2 wb_sel, 3 wb_mxu (a row add).
template <int KIND> struct Stage : Base {
    typedef typename std::conditional<(KIND & 1) != 0, float, int32_t>::type T;
    struct S { int32_t acc, sub; View<T> tile; };
    static HDS int64_t stage_bytes(const Args&) { return 16 * 128 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.sub = ((const int32_t*)a.p[1])[c.b];
        s.tile = place(c, (T*)a.p[0] + c.b * 2048, 0, 2048);
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t i) {
        if (!c.live) return;
        const int32_t sub = s.sub + (i & 3);
        const int32_t r0 = sub & 15, r1 = (sub + 1) & 15;
        if (KIND == 0 || KIND == 1) {
            s.acc = add(s.acc, add((int32_t)s.tile[r0 * 128], (int32_t)s.tile[r1 * 128]));
        } else {
            for (int32_t j = 0; j < 128; ++j) {
                if (KIND == 2) s.tile[r0 * 128 + j] = (T)s.acc;
                else s.tile[r0 * 128 + j] = s.tile[r0 * 128 + j] + (T)s.acc;
            }
            s.acc = add(s.acc, 1);
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[2])[c.b] = s.acc;
        unplace(c, s.tile, (T*)a.p[0] + c.b * 2048, 2048);
    }
};

// --- S9: [B] register-op chains and a 35-entry transition table ---------
// p0 x [n] i32, p1 out [n]; KIND 0 base, 1 reg100, 2 reg400, 3 lut35 (the
// tables in shared memory: one indexed load each in place of 35 selects).
template <int KIND> struct RegOps : Base {
    struct S { int32_t a, b, d; };
    static HDS int64_t extra_words() { return KIND == 3 ? 16 + 128 : 0; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (KIND == 3 && c.t == 0) {  // the tables, in the block's shared words
            int32_t* nxt = c.pub;
            int32_t* prm = nxt + 16;
            for (int32_t ph = 0; ph < 16; ++ph) {
                int32_t v = 0;
                for (int32_t i = 0; i < 24; ++i) if (ph == i % 12) v = i * 3 + 1;
                nxt[ph] = v;
            }
            for (int32_t x = 0; x < 128; ++x) {
                int32_t v = 0;
                for (int32_t i = 0; i < 11; ++i) if (x == i) v = i * 257;
                prm[x] = v;
            }
        }
        if (!c.live) return;
        s.a = ((const int32_t*)a.p[0])[c.b];
        s.b = add(s.a, 1);
        s.d = add(s.a, 2);
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        if (KIND == 0) {
            s.a = add(s.a, 1);
        } else if (KIND == 3) {
            const int32_t* nxt = c.pub;
            const int32_t n = nxt[s.a & 15];
            s.a = add(s.a, add(n, nxt[16 + n] >> 4));
        } else {
SPK_UNROLL
            for (int i = 0; i < (KIND == 1 ? 100 : 400) / 4; ++i) {
                s.a = add(s.a, s.b);
                s.b = s.b ^ s.d;
                s.d = s.a > s.b ? add(s.d, 1) : s.d;
                s.a = s.a & 0xFFFF;
            }
        }
        opaque(s.a);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.live) ((int32_t*)a.p[1])[c.b] = add(add(s.a, s.b), s.d);
    }
};

// --- S10: the streaming floor and the loop floor ------------------------
// r1 / r2 / r4: every step, `passes` read-modify-write passes of +1 over
// the stream's row.  p0 tbl [n, NP] i32, p1 out; q0 NP (a multiple of 4),
// q1 passes a step, q2 1 = out[b] = row[0] for every stream, 0 = out[0]
// only (r4's [1, 1]).  16-byte loads and stores that bypass L1.
HD V16 ld_cg(const V16* p) {
#ifdef __CUDA_ARCH__
    V16 v;
    asm volatile("ld.global.cg.v4.u32 {%0,%1,%2,%3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p) : "memory");
    return v;
#else
    const volatile uint32_t* q = (const volatile uint32_t*)p;
    return V16{q[0], q[1], q[2], q[3]};
#endif
}
HD void st_cg(V16* p, V16 v) {
#ifdef __CUDA_ARCH__
    asm volatile("st.global.cg.v4.u32 [%0], {%1,%2,%3,%4};"
                 : : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
#else
    volatile uint32_t* q = (volatile uint32_t*)p;
    q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
#endif
}
struct Rmw : Base {
    struct S { int32_t unused; };
    static HD void init(const Args&, const Ctx&, S&) {}
    static HD void step(const Args& a, const Ctx& c, S&, int32_t) {
        if (!c.live) return;
        V16* row = (V16*)((int32_t*)a.p[0] + c.b * a.q[0]);
        for (int64_t u = 0; u < a.q[1]; ++u)
            for (int64_t j = 0; j < a.q[0] / 4; ++j) {
                V16 v = ld_cg(row + j);
                v.x += 1; v.y += 1; v.z += 1; v.w += 1;
                st_cg(row + j, v);
            }
    }
    static HD void fini(const Args& a, const Ctx& c, S&) {
        if (c.live && (a.q[2] || c.b == 0))
            ((int32_t*)a.p[1])[c.b] = ((int32_t*)a.p[0])[c.b * a.q[0]];
    }
};
// r5: acc += x each step, x read from shared memory.  p0 x [n], p1 out.
struct Floor : Base {
    struct S { int32_t acc; View<int32_t> x; };
    static HDS int64_t stage_bytes(const Args&) { return 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.x = place(c, (int32_t*)a.p[0] + c.b, 0, 1);
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t) {
        if (c.live) s.acc = add(s.acc, s.x.get(0));
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.live) ((int32_t*)a.p[1])[c.b] = s.acc;
    }
};

// --- sweeps: the TPU's scalar loop over the streams' SMEM words ---------
// On the card each stream's thread publishes its word in shared memory,
// the block synchronises, and thread 0 reads the block's words one at a
// time.  The block's part of the result is added to out at the end.
//
// SweepFlag (m4, s6, p1): p0 flag [n], p1 out [1] (zeroed); q0 active:
//   every step adds flag where flag < active.
// SweepArith (p2): p0 unused, p1 out [1]: every step adds b * 3 + 1 over
//   the block's streams, with no word read.
// SweepRead (p5): p0 x [n], p1 out [1]: every step reads x, staged once.
template <int KIND> struct Sweep : Base {
    struct S { int32_t acc, v; };
    static HDS int64_t pub_words(const Args&) { return 1; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        s.acc = 0;
        s.v = 0;
        if (c.live && KIND != 1) {
            const int32_t f = ((const int32_t*)a.p[0])[c.b];
            s.v = KIND == 0 ? (f < a.q[0] ? f : 0) : f;
        }
        if (KIND == 2) c.pub[c.t] = s.v;
    }
    static HD void step(const Args&, const Ctx& c, S& s, int32_t) {
        if (KIND == 0) {
            s.acc = add(s.acc, sweep_sum(c, s.v));
        } else {
            if (c.t == 0)
                for (int32_t j = 0; j < c.cnt; ++j)
                    s.acc = KIND == 1 ? add(s.acc, (c.first + j) * 3 + 1)
                                      : add(s.acc, vload(c.pub + j));
            opaque(s.acc);
            SYNC();
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.t == 0) ATOMIC_ADD((int32_t*)a.p[1], s.acc);
    }
};

// Request blocks (m5, p3, p3b, s3, vmem_to_smem, vmem_to_smem_latency):
// every step each stream copies its column of the [K, n] request block
// into the block's shared words; q1 = 1 waits (synchronises) every step,
// 0 only once at the end (p3, "start only").  p0 req [K, n], p1 out [1]
// (zeroed); q0 K.  MODE 0: out = steps + req[0, 0] (m5, p3, p3b);
// 1: out = steps * (req[0, 0] + req[K-1, n-1]) (s3); 2: out = steps *
// req[0, 0] (vmem_to_smem_latency); 3: out = sum of req[0, :], one step
// (vmem_to_smem).
template <int MODE> struct ReqBlock : Base {
    struct S { int32_t acc; };
    static HDS int64_t pub_words(const Args& a) { return a.q[0]; }
    static HD void init(const Args&, const Ctx&, S& s) { s.acc = 0; }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        const int32_t k = (int32_t)a.q[0];
        const int32_t* req = (const int32_t*)a.p[0];
        if (c.live)
            for (int32_t r = 0; r < k; ++r)
                vstore(c.pub + r * c.per + c.t, vload(req + r * a.n + c.b));
        if (a.q[1]) SYNC();
        if (c.t == 0) {
            if (MODE == 0) {
                s.acc = add(s.acc, 1);
            } else if (MODE == 3) {
                for (int32_t j = 0; j < c.cnt; ++j) s.acc = add(s.acc, vload(c.pub + j));
            } else {
                if (c.first == 0) s.acc = add(s.acc, vload(c.pub));
                if (MODE == 1 && c.first + c.cnt == a.n)
                    s.acc = add(s.acc, vload(c.pub + (k - 1) * c.per + c.cnt - 1));
            }
        }
        opaque(s.acc);
        if (a.q[1]) SYNC();
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.t != 0) return;
        if (MODE == 0) {
            if (c.first == 0) ATOMIC_ADD((int32_t*)a.p[1], add(s.acc, vload(c.pub)));
        } else {
            ATOMIC_ADD((int32_t*)a.p[1], s.acc);
        }
    }
};

// scalar_loop_cost: the sweep counts the streams whose act < limit, and
// each of them writes 16 ints of its row at (act * 8) % 240 from the 16
// after them, plus 1.
// p0 act [n], p1 wnd [n, 256] i32, p2 out [1, 256] (row 0), p3 issued [1]
// (zeroed); q0 limit.
struct SweepWork : Base {
    struct S { int32_t issued, act; View<int32_t> w; };
    static HDS int64_t stage_bytes(const Args&) { return 1024; }
    static HDS int64_t pub_words(const Args&) { return 1; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        s.issued = 0;
        s.act = c.live ? ((const int32_t*)a.p[0])[c.b] : 0;
        if (c.live) s.w = place(c, (int32_t*)a.p[1] + c.b * 256, 0, 256);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        const bool on = c.live && s.act < a.q[0];
        s.issued = add(s.issued, sweep_sum(c, on ? 1 : 0));
        if (!on) return;
        const int32_t off = (s.act * 8) % (256 - 16);
        // the read starts 16 further on, clamped to 240 as a dynamic
        // slice is
        const int32_t src = off + 16 < 240 ? off + 16 : 240;
        int32_t v[16];
        for (int k = 0; k < 16; ++k) v[k] = add(s.w[src + k], 1);
        for (int k = 0; k < 16; ++k) s.w[off + k] = v[k];
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.t == 0) ATOMIC_ADD((int32_t*)a.p[3], s.issued);
        if (!c.live) return;
        int32_t* row = (int32_t*)a.p[1] + c.b * 256;
        unplace(c, s.w, row, 256);
        if (c.b == 0) for (int j = 0; j < 256; ++j) ((int32_t*)a.p[2])[j] = row[j];
    }
};

// w5, the projected service sweep: the request block in, the sweep counts
// the streams whose req[2] < N, each of them copies CH bytes inside buf at
// 1024-aligned offsets from its req[0] / req[1].  p0 req [3, n], p1 buf
// [L] u8, p2 out [1] = req[0, 0], p3 issued [1] (zeroed); q0 N, q1 CH, q2 L.
struct Service : Base {
    struct S { int32_t issued; };
    static HDS int64_t pub_words(const Args&) { return 3; }
    static HD void init(const Args&, const Ctx&, S& s) { s.issued = 0; }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t i) {
        const int32_t* req = (const int32_t*)a.p[0];
        int32_t r0 = 0, r1 = 0, r2 = 0x7FFFFFFF;
        if (c.live) {
            r0 = vload(req + c.b);
            r1 = vload(req + a.n + c.b);
            r2 = vload(req + 2 * a.n + c.b);
            c.pub[c.per + c.t] = r0;
            c.pub[2 * c.per + c.t] = r1;
        }
        const bool on = r2 < a.q[0];
        s.issued = add(s.issued, sweep_sum(c, on ? 1 : 0));
        if (!on) return;
        const int64_t half = a.q[2] / 2, ch = a.q[1];
        const int64_t so = (((int64_t)r0 + i) % half) / 1024 * 1024;
        const int64_t dst = half + (((int64_t)r1 + i) % (half - ch)) / 1024 * 1024;
        move(View<uint8_t>{(uint8_t*)a.p[1], 1}, dst, so, ch);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (c.t == 0) ATOMIC_ADD((int32_t*)a.p[3], s.issued);
        if (c.live && c.b == 0) ((int32_t*)a.p[2])[0] = ((const int32_t*)a.p[0])[0];
    }
};

// --- copies: the spikes' DMAs, each done by the stream's own thread -----
// An active stream is one of the spike's N channels, c = b / (n / N).
HD bool channel(const Ctx& c, int64_t n, int64_t nch, int32_t* ch) {
    if (!c.live || c.b % (n / nch) != 0) return false;
    *ch = (int32_t)(c.b / (n / nch));
    return true;
}

// w1: N channels copy CH bytes inside one buffer, from its first half to
// its second at 1024-aligned offsets.  p0 buf [L] u8, p1 out [1] = buf[0];
// q0 CH, q1 L; the streams are the channels.
struct DmaFlat : Base {
    struct S { int32_t unused; };
    static HD void init(const Args&, const Ctx&, S&) {}
    static HD void step(const Args& a, const Ctx& c, S&, int32_t i) {
        if (!c.live) return;
        const int64_t ch = a.q[0], half = a.q[1] / 2;
        const int64_t so = ((int64_t)i * 131 + c.b * 977) % half / 1024 * 1024;
        const int64_t dst = half + ((int64_t)i * 57 + c.b * 389) % (half - ch) / 1024 * 1024;
        move(View<uint8_t>{(uint8_t*)a.p[0], 1}, dst, so, ch);
    }
    static HD void fini(const Args& a, const Ctx& c, S&) {
        if (c.live && c.b == 0) ((int32_t*)a.p[1])[0] = ((uint8_t*)a.p[0])[0];
    }
};

// w1's check kernel: one copy of buf[1024:2048] to buf[4096:5120], then
// out = buf[0:2048].  p0 buf [L] u8, p1 out [2048] u8; one stream.
struct DmaCheck : Base {
    struct S { int32_t unused; };
    static HD void init(const Args&, const Ctx&, S&) {}
    static HD void step(const Args& a, const Ctx& c, S&, int32_t) {
        if (c.live) move(View<uint8_t>{(uint8_t*)a.p[0], 1}, 4096, 1024, 1024);
    }
    static HD void fini(const Args& a, const Ctx& c, S&) {
        if (!c.live) return;
        for (int j = 0; j < 2048; ++j) ((uint8_t*)a.p[1])[j] = ((uint8_t*)a.p[0])[j];
    }
};

// w1b: channel c copies CH bytes from device memory at a 1024-aligned
// offset into its CH-byte stage (shared memory when it fits), written back
// at the end.  p0 hbm [L] u8, p1 stage [N, CH] u8, p2 out [1] = 1; q0 CH,
// q1 L; the streams are the channels.
struct DmaStage : Base {
    struct S { View<uint8_t> st; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (c.live) s.st = place(c, (uint8_t*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t i) {
        if (!c.live) return;
        const int64_t ch = a.q[0];
        const int64_t so = ((int64_t)i * 131 + c.b * 977) % (a.q[1] - ch) / 1024 * 1024;
        const uint8_t* src = (const uint8_t*)a.p[0] + so;
        if (s.st.s == 1 && ch % 16 == 0 && (uintptr_t)src % 16 == 0 &&
            (uintptr_t)s.st.p % 16 == 0) {
            const V16* s16 = (const V16*)src;
            V16* d16 = (V16*)s.st.p;
            for (int64_t j = 0; j < ch / 16; ++j) d16[j] = s16[j];
        } else {
            for (int64_t j = 0; j < ch; ++j) vstore(&s.st[j], src[j]);
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        unplace(c, s.st, (uint8_t*)a.p[1] + c.b * a.q[0], a.q[0]);
        if (c.b == 0) ((int32_t*)a.p[2])[0] = 1;
    }
};

// w2, m5b: channel c's stream copies 8 rows of 128 bytes to the 8 rows
// after them, from row r0 = (step * 7 + c * 13) % (R - 16) (q2 = 1: cut to
// a multiple of 8, w2).  p0 wnd [n, R, 128] u8, p1 out [128] i32 =
// wnd[0, 0, :]; q0 N, q1 R, q2 align.
struct RowsDma : Base {
    struct S { View<uint8_t> w; };
    static HDS int64_t stage_bytes(const Args& a) { return a.q[1] * 128; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (c.live) s.w = place(c, (uint8_t*)a.p[0] + c.b * a.q[1] * 128, 0, a.q[1] * 128);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t i) {
        int32_t ch;
        if (!channel(c, a.n, a.q[0], &ch)) return;
        int64_t r0 = ((int64_t)i * 7 + ch * 13) % (a.q[1] - 16);
        if (a.q[2]) r0 = r0 / 8 * 8;
        move(s.w, (r0 + 8) * 128, r0 * 128, 1024);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        uint8_t* row = (uint8_t*)a.p[0] + c.b * a.q[1] * 128;
        unplace(c, s.w, row, a.q[1] * 128);
        if (c.b == 0) for (int j = 0; j < 128; ++j) ((int32_t*)a.p[1])[j] = row[j];
    }
};

// s2 (q3 = 0): the active streams copy CH bytes of their window from
// src[b] to dst[b] (odd offsets); p0 src [n], p1 dst [n], p2 wnd [n, W]
// u8, p3 out [W] u8 = wnd[0].  p4 (q3 = 1): channel c copies CH bytes from
// (step * 131 + c * 977) % (W/2) to W/2 + (step * 57 + c * 389) % (W/2 -
// 256); p0 wnd, p1 out.  q0 CH, q1 W, q2 active streams.
struct WndDma : Base {
    struct S { int32_t so, dst; View<uint8_t> w; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[1] + 3) / 4 * 4; }
    static HD uint8_t* wnd(const Args& a) { return (uint8_t*)a.p[a.q[3] ? 0 : 2]; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.so = s.dst = 0;
        if (!a.q[3]) {
            s.so = ((const int32_t*)a.p[0])[c.b];
            s.dst = ((const int32_t*)a.p[1])[c.b];
        }
        s.w = place(c, wnd(a) + c.b * a.q[1], 0, a.q[1]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t i) {
        int32_t ch;
        if (!channel(c, a.n, a.q[2], &ch)) return;
        const int32_t half = (int32_t)(a.q[1] / 2);
        if (a.q[3]) {
            s.so = (i * 131 + ch * 977) % half;
            s.dst = half + (i * 57 + ch * 389) % (half - 256);
        }
        move(s.w, s.dst, s.so, a.q[0]);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        uint8_t* row = wnd(a) + c.b * a.q[1];
        unplace(c, s.w, row, a.q[1]);
        uint8_t* out = (uint8_t*)a.p[a.q[3] ? 1 : 3];
        if (c.b == 0) for (int64_t j = 0; j < a.q[1]; ++j) out[j] = row[j];
    }
};

// p0 ctx [n], p1 big [n, ROWS * 256] i32, p2 cache [n, 256] i32, p3 out
// [256] = cache[0]; q1 ROWS, q3 the spike.
// q3 = 0, s4: the active streams (q0 of them) write their cache row back
// to device memory at row ctx, then fetch row (ctx * 3 + 1) % ROWS.
// q3 = 1, row_swap_cost / hbm_row_dma_cost (q2 = 1 / 0): the streams
// b < q0 fetch row ctx of their table (staged with the cache when q2 = 1
// and it fits: the TPU's VMEM table; q2 = 0: device memory) into the cache.
struct RowSwap : Base {
    struct S { int32_t ctx; View<int32_t> big, cache; };
    static HDS int64_t stage_bytes(const Args& a) { return 1024 + (a.q[3] == 1 && a.q[2] ? a.q[1] * 1024 : 0); }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.ctx = ((const int32_t*)a.p[0])[c.b];
        s.cache = place(c, (int32_t*)a.p[2] + c.b * 256, 0, 256);
        int32_t* big = (int32_t*)a.p[1] + c.b * a.q[1] * 256;
        s.big = a.q[3] == 1 && a.q[2] ? place(c, big, 1024, a.q[1] * 256) : View<int32_t>{big, 1};
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        if (a.q[3] == 0) {  // s4
            int32_t ch;
            if (!channel(c, a.n, a.q[0], &ch)) return;
            for (int j = 0; j < 256; ++j) s.big[s.ctx * 256 + j] = s.cache[j];
            const int32_t ct2 = (s.ctx * 3 + 1) % (int32_t)a.q[1];
            for (int j = 0; j < 256; ++j) s.cache[j] = s.big.get(ct2 * 256 + j);
        } else {
            if (c.b >= a.q[0]) return;
            for (int j = 0; j < 256; ++j) vstore(&s.cache[j], s.big.get(s.ctx * 256 + j));
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        int32_t* row = (int32_t*)a.p[2] + c.b * 256;
        unplace(c, s.cache, row, 256);
        if (c.b == 0) for (int j = 0; j < 256; ++j) ((int32_t*)a.p[3])[j] = row[j];
    }
};

// p6: at step s the streams (s + c * 37) % n, c < q1, store their 256-byte
// tile at the 256-aligned offset off[b] * 256 of their window.  p0 off [n],
// p1 tile [n, 256] u8, p2 wnd [n, W] u8, p3 out [W] u8 = wnd[0]; q0 W,
// q1 nflush.
struct Store : Base {
    struct S { int32_t off; View<uint8_t> w; };
    static HDS int64_t stage_bytes(const Args& a) { return (a.q[0] + 3) / 4 * 4; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.off = ((const int32_t*)a.p[0])[c.b] * 256;
        s.w = place(c, (uint8_t*)a.p[2] + c.b * a.q[0], 0, a.q[0]);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t i) {
        if (!c.live) return;
        for (int64_t k = 0; k < a.q[1]; ++k) {
            if ((i + k * 37) % a.n != c.b) continue;
            const uint8_t* tile = (const uint8_t*)a.p[1] + c.b * 256;
            if (s.w.s == 1) {
                const V16* s16 = (const V16*)tile;
                V16* d16 = (V16*)(s.w.p + s.off);
                for (int j = 0; j < 16; ++j) d16[j] = s16[j];
            } else {
                for (int j = 0; j < 256; ++j) s.w[s.off + j] = tile[j];
            }
        }
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        uint8_t* row = (uint8_t*)a.p[2] + c.b * a.q[0];
        unplace(c, s.w, row, a.q[0]);
        if (c.b == 0) for (int64_t j = 0; j < a.q[0]; ++j) ((uint8_t*)a.p[3])[j] = row[j];
    }
};

// --- s5: the full projected bit step ------------------------------------
// A bit model in the small table or, for pidx >= NP, in the 256-entry
// cache at node; its adapt; ~60 register-transition selects (their result
// is unused, as in the spike, and kept alive by sink).  p0 pidx [n], p1 tbl
// [n, NP] i32, p2 cache [n, 256] i32, p3 out [n]; q0 NP.
struct BitFull : Base {
    struct S { int32_t acc, pidx, node; View<int32_t> tbl, cache; };
    static HDS int64_t stage_bytes(const Args& a) { return a.q[0] * 4 + 1024; }
    static HD void init(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        s.acc = 0;
        s.node = 0;
        s.pidx = ((const int32_t*)a.p[0])[c.b];
        s.tbl = place(c, (int32_t*)a.p[1] + c.b * a.q[0], 0, a.q[0]);
        s.cache = place(c, (int32_t*)a.p[2] + c.b * 256, a.q[0] * 4, 256);
    }
    static HD void step(const Args& a, const Ctx& c, S& s, int32_t) {
        if (!c.live) return;
        const int32_t np = (int32_t)a.q[0];
        const bool in_cache = s.pidx >= np;
        const int32_t p = in_cache ? s.cache[s.node] : s.tbl[s.pidx];
        const int32_t bit = p & 1;
        if (in_cache) s.cache[s.node] = adapt(p);
        else s.tbl[s.pidx] = adapt(p);
        int32_t x = s.pidx, bb = s.node, cc = s.acc;
SPK_UNROLL
        for (int k = 0; k < 20; ++k) {
            const bool m = x > bb;
            x = (m ? add(x, 1) : sub(x, cc)) & 0xFFFF;
            bb = (m ? add(mul(bb, 2), 1) : bb) & 0xFF;
            cc = ((cc & 3) == 1 ? add(cc, x) : add(cc, 1)) & 0xFFFF;
        }
        sink(x ^ bb ^ cc);
        s.pidx = (s.pidx * 5 + 1 + bit) % (np + 256);
        s.node = (s.node * 2 + bit) & 0xFF;
        s.acc = add(s.acc, p);
    }
    static HD void fini(const Args& a, const Ctx& c, S& s) {
        if (!c.live) return;
        ((int32_t*)a.p[3])[c.b] = s.acc;
        unplace(c, s.tbl, (int32_t*)a.p[1] + c.b * a.q[0], a.q[0]);
        unplace(c, s.cache, (int32_t*)a.p[2] + c.b * 256, 256);
    }
};

// --- the probe tables: probe id -> step struct, one table per spike file
#define SPK_PICK(file, k, ...) \
    template <> struct file::Pick<k> { typedef __VA_ARGS__ type; };
#define SPK_FILE(file, count)                \
    namespace file {                         \
    constexpr int COUNT = count;             \
    template <int K> struct Pick;            \
    }
SPK_FILE(carry, 10)
SPK_PICK(carry, 0, Carry<8, 0>) SPK_PICK(carry, 1, Carry<24, 0>)
SPK_PICK(carry, 2, Carry<48, 0>) SPK_PICK(carry, 3, Carry<96, 0>)
SPK_PICK(carry, 4, Carry<192, 0>)
SPK_PICK(carry, 5, Carry<8, 1>) SPK_PICK(carry, 6, Carry<24, 1>)
SPK_PICK(carry, 7, Carry<48, 1>) SPK_PICK(carry, 8, Carry<96, 1>)
SPK_PICK(carry, 9, Carry<192, 1>)
SPK_FILE(dma, 7)
SPK_PICK(dma, 0, DmaFlat) SPK_PICK(dma, 1, DmaCheck) SPK_PICK(dma, 2, DmaStage)
SPK_PICK(dma, 3, RowsDma) SPK_PICK(dma, 4, WndRead<int32_t>)
SPK_PICK(dma, 5, RowGather) SPK_PICK(dma, 6, Service)
SPK_FILE(gather, 7)
SPK_PICK(gather, 0, Lanes<0>) SPK_PICK(gather, 1, Lanes<1>)
SPK_PICK(gather, 2, Lanes<2>) SPK_PICK(gather, 3, Lanes<3>)
SPK_PICK(gather, 4, Lanes<4>) SPK_PICK(gather, 5, Lanes<5>)
SPK_PICK(gather, 6, Lanes<6>)
SPK_FILE(marginal, 12)
SPK_PICK(marginal, 0, BitStep<int32_t>) SPK_PICK(marginal, 1, BitStep<uint16_t>)
SPK_PICK(marginal, 2, WndRead<uint8_t>) SPK_PICK(marginal, 3, Copy16)
SPK_PICK(marginal, 4, Sweep<0>) SPK_PICK(marginal, 5, ReqBlock<0>)
SPK_PICK(marginal, 6, RowsDma) SPK_PICK(marginal, 7, Chain)
SPK_PICK(marginal, 8, Chain) SPK_PICK(marginal, 9, Gather32)
SPK_PICK(marginal, 10, WndRead<uint8_t>) SPK_PICK(marginal, 11, RowGather)
SPK_FILE(mxu_stage, 4)
SPK_PICK(mxu_stage, 0, Stage<0>) SPK_PICK(mxu_stage, 1, Stage<1>)
SPK_PICK(mxu_stage, 2, Stage<2>) SPK_PICK(mxu_stage, 3, Stage<3>)
SPK_FILE(pallas, 7)
SPK_PICK(pallas, 0, BitStep<int32_t>) SPK_PICK(pallas, 1, Chain)
SPK_PICK(pallas, 2, SweepWork) SPK_PICK(pallas, 3, RowSwap)
SPK_PICK(pallas, 4, ReqBlock<3>) SPK_PICK(pallas, 5, ReqBlock<2>)
SPK_PICK(pallas, 6, RowSwap)
SPK_FILE(pallas2, 7)
SPK_PICK(pallas2, 0, ByteRmw) SPK_PICK(pallas2, 1, WndDma)
SPK_PICK(pallas2, 2, ReqBlock<1>) SPK_PICK(pallas2, 3, RowSwap)
SPK_PICK(pallas2, 4, BitFull) SPK_PICK(pallas2, 5, Sweep<0>)
SPK_PICK(pallas2, 6, WndRead<int32_t>)
SPK_FILE(pallas3, 9)
SPK_PICK(pallas3, 0, Sweep<0>) SPK_PICK(pallas3, 1, Sweep<1>)
SPK_PICK(pallas3, 2, ReqBlock<0>) SPK_PICK(pallas3, 3, ReqBlock<0>)
SPK_PICK(pallas3, 4, WndDma) SPK_PICK(pallas3, 5, Sweep<2>)
SPK_PICK(pallas3, 6, Store) SPK_PICK(pallas3, 7, WndRead<uint8_t>)
SPK_PICK(pallas3, 8, BitStep<uint16_t>)
SPK_FILE(regops, 4)
SPK_PICK(regops, 0, RegOps<0>) SPK_PICK(regops, 1, RegOps<1>)
SPK_PICK(regops, 2, RegOps<2>) SPK_PICK(regops, 3, RegOps<3>)
SPK_FILE(roofline, 5)
SPK_PICK(roofline, 0, Rmw) SPK_PICK(roofline, 1, Rmw)
SPK_PICK(roofline, 2, BitStep<int32_t>) SPK_PICK(roofline, 3, Rmw)
SPK_PICK(roofline, 4, Floor)

// Whether a probe's per-stream state is staged for `per` streams a block,
// and the block's shared memory.
template <class P> HDS bool staged(const Args& a, int32_t per) {
    const int64_t sb = P::stage_bytes(a);
    return sb > 0 && sb * per <= STAGE_CAP;
}
template <class P> HDS int64_t smem_bytes(const Args& a, int32_t per) {
    return (staged<P>(a, per) ? P::stage_bytes(a) * per : 0) +
           (P::pub_words(a) * per + P::extra_words()) * 4;
}
template <class P> HDS Ctx make_ctx(const Args& a, int32_t block, int32_t t,
                                    int32_t per, unsigned char* smem) {
    Ctx c;
    c.t = t;
    c.per = per;
    c.first = block * per;
    c.b = c.first + t;
    c.cnt = a.n - c.first < per ? a.n - c.first : per;
    c.live = c.b < a.n;
    c.staged = staged<P>(a, per);
    c.stage = smem;
    c.pub = (int32_t*)(smem + (c.staged ? P::stage_bytes(a) * per : 0));
    return c;
}

#ifdef __CUDACC__
// The one loop kernel: init, the step count read from device memory, the
// steps, fini (which writes the final state out).
template <class P, int K>
__global__ void __launch_bounds__(PACK) spike_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int32_t per = a.layout ? (int32_t)blockDim.x : 1;
    const Ctx c = make_ctx<P>(a, blockIdx.x, a.layout ? threadIdx.x : 0, per, smem);
    typename P::S s;
    P::init(a, c, s);
    __syncthreads();
    const int32_t n = *a.steps;
    for (int32_t i = 0; i < n; ++i) P::step(a, c, s, i);
    __syncthreads();
    P::fini(a, c, s);
}

HDS inline int32_t block_streams(const Args& a) {
    return a.layout ? (a.n >= PACK ? PACK : (a.n + 31) / 32 * 32) : 1;
}

template <class P, int K> int launch_one(const Args& a, cudaStream_t st) {
    const int32_t per = block_streams(a);
    const int32_t blocks = (a.n + per - 1) / per;
    const int64_t smem = smem_bytes<P>(a, per);
    cudaError_t e = cudaFuncSetAttribute(
        spike_kernel<P, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    spike_kernel<P, K><<<blocks, per, smem, st>>>(a);
    return (int)cudaGetLastError();
}

#define SPK_LAUNCH(file)                                                      \
    namespace spk { namespace file {                                          \
    template <int K> int dispatch(int kid, const Args& a, cudaStream_t st) {  \
        if constexpr (K == COUNT) {                                           \
            return (int)cudaErrorInvalidValue;                                \
        } else {                                                              \
            if (kid == K) return launch_one<typename Pick<K>::type, K>(a, st); \
            return dispatch<K + 1>(kid, a, st);                               \
        }                                                                     \
    }                                                                         \
    template <int K> int64_t smem_of(int kid, const Args& a) {                \
        if constexpr (K == COUNT) {                                           \
            return -1;                                                        \
        } else {                                                              \
            typedef typename Pick<K>::type P;                                 \
            const int32_t per = block_streams(a);                              \
            if (kid == K) return smem_bytes<P>(a, per) * 2 + staged<P>(a, per); \
            return smem_of<K + 1>(kid, a);                                    \
        }                                                                     \
    }                                                                         \
    } }                                                                       \
    /* the block's shared memory * 2 + 1 if the state is staged there */     \
    extern "C" int64_t spike_##file##_smem(                                   \
        int kid, int layout, int n, int64_t q0, int64_t q1, int64_t q2,      \
        int64_t q3, int64_t q4, int64_t q5) {                                 \
        spk::Args a{nullptr, {}, {q0, q1, q2, q3, q4, q5}, n, layout};      \
        return spk::file::smem_of<0>(kid, a);                                 \
    }                                                                         \
    extern "C" int spike_##file##_launch(                                     \
        int kid, int layout, int n, const void* steps, void* p0, void* p1,   \
        void* p2, void* p3, void* p4, void* p5, void* p6, void* p7,          \
        int64_t q0, int64_t q1, int64_t q2, int64_t q3, int64_t q4,           \
        int64_t q5, void* stream) {                                           \
        spk::Args a{(const int32_t*)steps, {p0, p1, p2, p3, p4, p5, p6, p7}, \
                    {q0, q1, q2, q3, q4, q5}, n, layout};                    \
        return spk::file::dispatch<0>(kid, a, (cudaStream_t)stream);          \
    }
#endif

}  // namespace spk
