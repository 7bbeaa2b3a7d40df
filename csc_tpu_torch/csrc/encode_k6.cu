// K6 on Hopper: the batched exact optimal parse of m3-m5, priced by the
// live model, one warp a stream.
//
// Replaces nothing on the TPU: csc_tpu codes these streams with its
// golden host encoder (csc_tpu/ops/pipeline.py:248-262: m3-m5 under
// CSC_ENCODE_PARSE=exact, and every m3-m5 stream over its 1 MB device
// cap).  m5's binary tree is a kernel of its own (k6_parse_kernel<true,
// RING>, csc_k6_bt_launch), so the parse of m3 / m4 keeps its code and
// its registers; its head and links are a slice a stream of device
// memory.  A stream longer than its dictionary (golden's ring window)
// takes the ring's kernel (k6_parse_kernel<BT, true>) beside the covered
// streams' (<BT, false>): each launcher launches both, each block of the
// other kind returning at once, so the ring's registers cost the covered
// streams nothing (K5's design, encode_k5.cu).
// Each block is one warp that runs its stream's whole parse
// (encode_k6.cuh): K5's finder, slide, walk and probe, the stretch DP
// a length a lane, the back-walk's tokens and the shadow model's
// updates by lane 0.  A stream of at most 64 KB is staged as words in
// shared memory, as K5 stages it; after the words sit the model's small
// trees, the length-price cache and the p_2_bits table (2 216 bytes).
// p_lit (128 KB) and the stretch's cells (74 KB) are a slice a stream of
// device memory, as are the hash tables; the wrapper allocates them, the
// kernel sets them up.  A launch takes the shared memory its batch needs
// and leaves the rest of the SM to L1 (k6_carve).
//
// The bound: the data read once and the tape written once, over the
// card's 3.35 TB/s, microseconds for the encode path's groups.  Each
// position's find is K5's chain of dependent table loads and compares,
// and its DP step a chain of dependent cell and probability loads (at
// m5 the tree's walk a chain of dependent link loads too): K6 is bound
// by load latency, not by bytes.
//
// The build (csc_tpu_torch/_build.py, PARTS) compiles this file in five
// parts, one nvcc each, all started together, and links them: with
// -DK6_PART=i for i < 4 the kernel k6_parse_kernel<i / 2, i % 2> and its
// attribute, launch, occupancy (and phase-clock) functions, with
// -DK6_PART=4 the C interface that calls them.  Without K6_PART it is
// all one.  Each kernel's nvcc thus runs beside the others'.
#include <cuda_runtime.h>

#if defined(K6_PART) && defined(K6_PHASES)
// a __device__ variable is a host symbol too: each part's phase clocks
// under a name of its own, so the parts link
#define K6_CLOCKS_NAME(p) k6_phases_##p
#define K6_CLOCKS(p) K6_CLOCKS_NAME(p)
#define k6_phases K6_CLOCKS(K6_PART)
#endif
#include "encode_k6.cuh"

#ifndef K6_PART
#define K6_KERNELS 1
#define K6_GLUE 1
#else
#define K6_KERNELS (K6_PART < 4)
#define K6_GLUE (K6_PART == 4)
#endif

// the model's part of a block's shared memory: the length cache, the
// small trees, the p_2_bits table
constexpr size_t K6_MODEL = 32 * 4 + k6::M_SMALL * 2 + k6::NP2B * 2;

static size_t k6_words(int64_t n) {
    return n <= k5::STAGE_MAX
               ? (size_t)(((n + 3) / 4 + k5::STAGE_PAD) * 4) : 0;
}

static size_t k6_smem(int64_t n) { return k6_words(n) + K6_MODEL; }

// the tree's arguments of a launch (BT): bits, cycles, each stream's
// size, the head and links, the links' words a stream
struct K6Tree {
    int32_t bits, cyc;
    const int32_t* sizes;
    int32_t* head;
    int32_t* nodes;
    int64_t stride;
};

// a launch's arguments (the kernel's, after the batch and the stream)
struct K6Args {
    const uint8_t* data;
    int64_t n;
    const int32_t* blocks;
    int32_t nblk;
    const int32_t* sizes;
    const int32_t* dict_sizes;
    int32_t hash_bits, hash_width, good_len;
    const uint16_t* p2b;
    int32_t *ht2, *ht3, *ht6;
    uint16_t* lit;
    int32_t *cells, *tape;
    int64_t tcap;
    int32_t *out, *btypes;
    K6Tree tree;
};

constexpr int K6_MAX_DEVICES = 64;

// each kernel's functions, defined in its part (they keep no state: a
// function-local static of a template the parts share would be one
// object in every library of the process that defines it)
template <bool BT, bool RING>
cudaError_t k6_carve_one(int pct, bool size);
template <bool BT, bool RING>
cudaError_t k6_launch_one(int32_t batch, cudaStream_t stream,
                          const K6Args& a);
template <bool BT, bool RING>
int k6_occupancy(int64_t n, int* blocks);
#ifdef K6_PHASES
template <bool BT, bool RING>
cudaError_t k6_phases_take(unsigned long long* acc);
#endif

#if K6_KERNELS
// one block a stream, one warp a block; the whole register file allowed
// one block, as K5's (K5's parse is K6's finder).  RING: the streams
// longer than their dictionary, the others returning at once (and the
// ring's blocks at once in the covered kernel)
template <bool BT, bool RING>
__global__ void __launch_bounds__(k5::WARP, 1) k6_parse_kernel(
    const uint8_t* __restrict__ data, int64_t n,
    const int32_t* __restrict__ blocks, int32_t nblk,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t hash_bits, int32_t hash_width, int32_t good_len,
    const uint16_t* __restrict__ p2b, int32_t* __restrict__ ht2,
    int32_t* __restrict__ ht3, int32_t* __restrict__ ht6,
    uint16_t* __restrict__ lit, int32_t* __restrict__ cells,
    int32_t* __restrict__ tape, int64_t tcap, int32_t* __restrict__ out,
    int32_t* __restrict__ btypes, K6Tree tree) {
    const int64_t b = blockIdx.x;
    if ((sizes[b] > dict_sizes[b]) != RING) return;
    const uint8_t* row = data + b * n;
    const bool staged = n <= k5::STAGE_MAX;
    const int64_t nw = staged ? (n + 3) / 4 + k5::STAGE_PAD : 0;
    if (staged) {
        // whole words only where every row starts on a word
        const bool whole = (n & 3) == 0 && ((uintptr_t)row & 3) == 0;
        for (int64_t i = threadIdx.x; i < nw; i += blockDim.x) {
            uint32_t v = 0;
            if (whole && 4 * i + 4 <= n) {
                v = __ldg((const unsigned int*)(row + 4 * i));
            } else {
                for (int k = 0; k < 4; ++k)
                    if (4 * i + k < n) v |= (uint32_t)row[4 * i + k] << (8 * k);
            }
            k5::k5_words[i] = v;
        }
    }
    int32_t* lenp = (int32_t*)(k5::k5_words + nw);
    uint16_t* small = (uint16_t*)(lenp + 32);
    uint16_t* table = small + k6::M_SMALL;
    for (int i = threadIdx.x; i < k6::NP2B; i += blockDim.x) table[i] = p2b[i];
    __syncwarp();
    k6::Stream x;
    k5::Stream& s = x.s;
    s.data = row;
    s.words = nullptr;
    s.n = n;
    s.blocks = blocks + b * 2 * nblk;
    s.nblk = nblk;
    s.btypes = btypes + b * nblk;
    s.size = sizes[b];
    s.dict_size = dict_sizes[b];
    s.hash_bits = hash_bits;
    s.hash_width = hash_width;
    s.good_len = good_len;
    s.lazy = 0;
    s.ht2 = ht2 + b * k5::HT2_SIZE;
    s.ht3 = ht3 + b * k5::HT3_SIZE;
    s.ht6 = ht6 + b * ((int64_t)hash_width << hash_bits);
    s.tape = tape + b * 2 * tcap;
    s.tcap = tcap;
    s.max_steps = 0;
    x.small = small;
    x.lenp = lenp;
    x.p2b = table;
    x.lit = lit + b * k6::NLIT;
    x.cells = cells + b * (int64_t)k6::NFIELD * k6::CELLS;
    if constexpr (BT) {
        s.hash_bits = tree.bits;
        x.bt_head = tree.head + (b << tree.bits);
        x.bt_nodes = tree.nodes + b * tree.stride;
        x.bt_size = tree.sizes[b];
        x.bt_cyc = tree.cyc;
    }
    const k6::Result r = staged ? k6::parse_stream<true, BT, RING>(x)
                                : k6::parse_stream<false, BT, RING>(x);
    if (threadIdx.x == 0) {
        const int64_t B = gridDim.x;
        out[0 * B + b] = r.tok_cnt;
        out[1 * B + b] = r.done;
        out[2 * B + b] = r.err;
    }
}

// a kernel's shared memory: the most a block may take (if `size`), and
// the share of the SM's 256 KB that is shared memory (pct, the rest L1)
template <bool BT, bool RING>
cudaError_t k6_carve_one(int pct, bool size) {
    if (size) {
        cudaError_t e = cudaFuncSetAttribute(
            k6_parse_kernel<BT, RING>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)k6_smem(k5::STAGE_MAX));
        if (e != cudaSuccess) return e;
    }
    return cudaFuncSetAttribute(k6_parse_kernel<BT, RING>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                pct);
}

// one launch of the kernel
template <bool BT, bool RING>
cudaError_t k6_launch_one(int32_t batch, cudaStream_t stream,
                          const K6Args& a) {
    k6_parse_kernel<BT, RING><<<batch, k5::WARP, k6_smem(a.n), stream>>>(
        a.data, a.n, a.blocks, a.nblk, a.sizes, a.dict_sizes, a.hash_bits,
        a.hash_width, a.good_len, a.p2b, a.ht2, a.ht3, a.ht6, a.lit, a.cells,
        a.tape, a.tcap, a.out, a.btypes, a.tree);
    return cudaGetLastError();
}

// the occupancy of a launch's kernel, its shared memory taken first for
// a staged stream, L1 for another
template <bool BT, bool RING>
int k6_occupancy(int64_t n, int* blocks) {
    cudaError_t e = k6_carve_one<BT, RING>(
        n <= k5::STAGE_MAX ? cudaSharedmemCarveoutMaxShared
                           : cudaSharedmemCarveoutMaxL1, true);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k6_parse_kernel<BT, RING>, k5::WARP, k6_smem(n));
}

#ifdef K6_PHASES
// the kernel's phase clocks and counts added into acc [k5::K6_NPHASE],
// and zeroed
template <bool BT, bool RING>
cudaError_t k6_phases_take(unsigned long long* acc) {
    unsigned long long v[k5::K6_NPHASE];
    cudaError_t e = cudaMemcpyFromSymbol(v, k5::k6_phases, sizeof(v));
    if (e != cudaSuccess) return e;
    for (int i = 0; i < k5::K6_NPHASE; ++i) acc[i] += v[i];
    const unsigned long long zero[k5::K6_NPHASE] = {};
    return cudaMemcpyToSymbol(k5::k6_phases, zero, sizeof(zero));
}
#endif

#ifdef K6_PART
// this part's kernel
constexpr bool K6_BT = K6_PART / 2 == 1, K6_RING = K6_PART % 2 == 1;
template cudaError_t k6_carve_one<K6_BT, K6_RING>(int, bool);
template cudaError_t k6_launch_one<K6_BT, K6_RING>(int32_t, cudaStream_t,
                                                   const K6Args&);
template int k6_occupancy<K6_BT, K6_RING>(int64_t, int*);
#ifdef K6_PHASES
template cudaError_t k6_phases_take<K6_BT, K6_RING>(unsigned long long*);
#endif
#endif
#endif  // K6_KERNELS

#if K6_GLUE
// a staged launch of `batch` blocks takes as much shared memory as the
// blocks that one SM holds of the batch need (and the 1 KB a block that
// CUDA reserves), the rest of the SM's 256 KB as L1, which caches the
// tree's links, p_lit and the cells: a group of fewer streams than SMs
// keeps most of it (4-7 % off the 96 and 1 024 x 16 KB cells on the
// H100); a group that fills the SMs takes the shared memory it needs.
// An unstaged launch takes L1 first.  The device's SM count and shared
// memory are read once, the most a block may take set once.
template <bool BT>
static cudaError_t k6_carve(int64_t n, int32_t batch) {
    static int sms[K6_MAX_DEVICES], maxsm[K6_MAX_DEVICES];
    static bool sized[K6_MAX_DEVICES];
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= K6_MAX_DEVICES) return cudaErrorInvalidDevice;
    int pct = cudaSharedmemCarveoutMaxL1;
    if (n <= k5::STAGE_MAX) {
        int count = sms[dev], bytes = maxsm[dev];
        if (count == 0 || bytes == 0) {
            e = cudaDeviceGetAttribute(
                &bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(
                    &count, cudaDevAttrMultiProcessorCount, dev);
            if (e != cudaSuccess) return e;
            sms[dev] = count;
            maxsm[dev] = bytes;
        }
        const int64_t per_sm = (batch + count - 1) / count;
        const int64_t need = per_sm * (int64_t)(k6_smem(n) + 1024);
        pct = (int)((need * 100 + bytes - 1) / bytes);
        pct = pct > 100 ? 100 : pct < 1 ? 1 : pct;
    }
    e = k6_carve_one<BT, false>(pct, !sized[dev]);
    if (e == cudaSuccess) e = k6_carve_one<BT, true>(pct, !sized[dev]);
    if (e == cudaSuccess) sized[dev] = true;
    return e;
}

// the covered streams' kernel, then the ring's, on the same arguments
template <bool BT>
static cudaError_t k6_launch_both(int32_t batch, cudaStream_t stream,
                                  const K6Args& a) {
    cudaError_t e = k6_carve<BT>(a.n, batch);
    if (e != cudaSuccess) return e;
    e = k6_launch_one<BT, false>(batch, stream, a);
    return e == cudaSuccess ? k6_launch_one<BT, true>(batch, stream, a) : e;
}

// Launch on `stream` (the covered streams' kernel, then the ring's);
// returns the launches' cudaError_t (0 = queued).
// blocks: [B, nblk, 2] int32 (each block's cumulative end and info word);
// p2b: [512] uint16, the p_2_bits table; ht2 / ht3 / ht6: [B, 16384],
// [B, 65536], [B, hash_width << hash_bits] int32 zeros; lit: [B, 65536]
// uint16 and cells [B, NFIELD * CELLS] int32, scratch the kernel sets up;
// tape: [B, tcap, 2] int32; out: [3, B] int32 rows tok_cnt, done and err;
// btypes: [B, nblk] int32 zeros, each block's final type.  1 <=
// hash_width <= 8, 1 <= hash_bits <= 24, 2 <= good_len <= 32.
extern "C" int csc_k6_launch(
    const void* data, int64_t n, const void* blocks, int32_t nblk,
    const void* sizes, const void* dict_sizes, int32_t hash_bits,
    int32_t hash_width, int32_t good_len, const void* p2b, void* ht2,
    void* ht3, void* ht6, void* lit, void* cells, void* tape, int64_t tcap,
    void* out, void* btypes, int32_t batch, void* stream) {
    if (hash_width < 1 || hash_width > k5::MAX_WIDTH || hash_bits < 1
        || hash_bits > 24 || good_len < 2 || good_len > k6::MAX_GOOD
        || tcap < 1 || nblk < 1)
        return (int)cudaErrorInvalidValue;
    return (int)k6_launch_both<false>(
        batch, (cudaStream_t)stream,
        K6Args{(const uint8_t*)data, n, (const int32_t*)blocks, nblk,
               (const int32_t*)sizes, (const int32_t*)dict_sizes, hash_bits,
               hash_width, good_len, (const uint16_t*)p2b, (int32_t*)ht2,
               (int32_t*)ht3, (int32_t*)ht6, (uint16_t*)lit, (int32_t*)cells,
               (int32_t*)tape, tcap, (int32_t*)out, (int32_t*)btypes,
               K6Tree{}});
}

// csc_k6_launch of m5's parse, with the binary tree (hash_width 0, no
// HT6: ht6 may be null): bt_bits in [1, 25], bt_cyc >= 1, bt_sizes [B]
// int32 (each at least 32), bt_head [B, 1 << bt_bits] and bt_nodes [B,
// stride] int32 zeros, stride >= 2 * min(bt_size, n + 1); 2 <= good_len
// <= 48.
extern "C" int csc_k6_bt_launch(
    const void* data, int64_t n, const void* blocks, int32_t nblk,
    const void* sizes, const void* dict_sizes, int32_t bt_bits,
    int32_t bt_cyc, const void* bt_sizes, int32_t good_len, const void* p2b,
    void* ht2, void* ht3, void* bt_head, void* bt_nodes, int64_t stride,
    void* lit, void* cells, void* tape, int64_t tcap, void* out,
    void* btypes, int32_t batch, void* stream) {
    if (bt_bits < 1 || bt_bits > 25 || bt_cyc < 1 || good_len < 2
        || good_len > k6::MAX_GOOD_BT || tcap < 1 || nblk < 1 || stride < 2)
        return (int)cudaErrorInvalidValue;
    return (int)k6_launch_both<true>(
        batch, (cudaStream_t)stream,
        K6Args{(const uint8_t*)data, n, (const int32_t*)blocks, nblk,
               (const int32_t*)sizes, (const int32_t*)dict_sizes, bt_bits, 0,
               good_len, (const uint16_t*)p2b, (int32_t*)ht2, (int32_t*)ht3,
               nullptr, (uint16_t*)lit, (int32_t*)cells, (int32_t*)tape, tcap,
               (int32_t*)out, (int32_t*)btypes,
               K6Tree{bt_bits, bt_cyc, (const int32_t*)bt_sizes,
                      (int32_t*)bt_head, (int32_t*)bt_nodes, stride}});
}

// shared memory a block of streams n bytes wide
extern "C" int64_t csc_k6_smem(int64_t n) { return (int64_t)k6_smem(n); }

// the int32 words of a stream's cells (NFIELD * CELLS)
extern "C" int64_t csc_k6_cell_words() {
    return (int64_t)k6::NFIELD * k6::CELLS;
}

// blocks of streams n bytes wide that one SM holds at once: of streams
// their dictionary covers (ring 0) or of longer ones (ring 1)
extern "C" int csc_k6_blocks_per_sm(int64_t n, int32_t ring, int* blocks) {
    return ring ? k6_occupancy<false, true>(n, blocks)
                : k6_occupancy<false, false>(n, blocks);
}

// the same of m5's kernels (the tree's)
extern "C" int csc_k6_bt_blocks_per_sm(int64_t n, int32_t ring,
                                       int* blocks) {
    return ring ? k6_occupancy<true, true>(n, blocks)
                : k6_occupancy<true, false>(n, blocks);
}

#ifdef K6_PHASES
// block 0's phase clocks and counts (k5::K6Phase order) into host memory
// dst [k5::K6_NPHASE] uint64, and zeroes them
extern "C" int csc_k6_phases(void* dst) {
    unsigned long long* acc = (unsigned long long*)dst;
    for (int i = 0; i < k5::K6_NPHASE; ++i) acc[i] = 0;
    cudaError_t e = k6_phases_take<false, false>(acc);
#ifdef K6_PART
    // each part's kernel has clocks of its own
    if (e == cudaSuccess) e = k6_phases_take<false, true>(acc);
    if (e == cudaSuccess) e = k6_phases_take<true, false>(acc);
    if (e == cudaSuccess) e = k6_phases_take<true, true>(acc);
#endif
    return (int)e;
}
#endif
#endif  // K6_GLUE
