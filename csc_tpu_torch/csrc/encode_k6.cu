// K6 on Hopper: the batched exact optimal parse of m3 / m4, priced by the
// live model, one warp a stream.
//
// Replaces nothing on the TPU: csc_tpu codes these streams with its
// golden host encoder (csc_tpu/ops/pipeline.py:248-262: m3-m5 under
// CSC_ENCODE_PARSE=exact, and every m3-m5 stream over its 1 MB device
// cap).  Each block is one warp that runs its stream's whole parse
// (encode_k6.cuh): K5's finder, slide, walk and probe, the stretch DP
// a length a lane, the back-walk's tokens and the shadow model's
// updates by lane 0.  A stream of at most 64 KB is staged as words in
// shared memory, as K5 stages it; after the words sit the model's small
// trees, the length-price cache and the p_2_bits table (2 216 bytes).
// p_lit (128 KB) and the stretch's cells (74 KB) are a slice a stream of
// device memory, as are the hash tables; the wrapper allocates them, the
// kernel sets them up.
//
// The bound: the data read once and the tape written once, over the
// card's 3.35 TB/s, microseconds for the encode path's groups.  Each
// position's find is K5's chain of dependent table loads and compares,
// and its DP step a chain of dependent cell and probability loads: K6 is
// bound by load latency, not by bytes.
#include <cuda_runtime.h>

#include "encode_k6.cuh"

// the model's part of a block's shared memory: the length cache, the
// small trees, the p_2_bits table
constexpr size_t K6_MODEL = 32 * 4 + k6::M_SMALL * 2 + k6::NP2B * 2;

static size_t k6_words(int64_t n) {
    return n <= k5::STAGE_MAX
               ? (size_t)(((n + 3) / 4 + k5::STAGE_PAD) * 4) : 0;
}

static size_t k6_smem(int64_t n) { return k6_words(n) + K6_MODEL; }

// one block a stream, one warp a block; the whole register file allowed
// one block, as K5's (the covered streams' parse of K5 is K6's finder)
__global__ void __launch_bounds__(k5::WARP, 1) k6_parse_kernel(
    const uint8_t* __restrict__ data, int64_t n,
    const int32_t* __restrict__ blocks, int32_t nblk,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t hash_bits, int32_t hash_width, int32_t good_len,
    const uint16_t* __restrict__ p2b, int32_t* __restrict__ ht2,
    int32_t* __restrict__ ht3, int32_t* __restrict__ ht6,
    uint16_t* __restrict__ lit, int32_t* __restrict__ cells,
    int32_t* __restrict__ tape, int64_t tcap, int32_t* __restrict__ out,
    int32_t* __restrict__ btypes) {
    const int64_t b = blockIdx.x;
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
    const k6::Result r = staged ? k6::parse_stream<true>(x)
                                : k6::parse_stream<false>(x);
    if (threadIdx.x == 0) {
        const int64_t B = gridDim.x;
        out[0 * B + b] = r.tok_cnt;
        out[1 * B + b] = r.done;
        out[2 * B + b] = r.err;
    }
}

// staged launches take shared memory first, the others L1
static cudaError_t k6_setup(int64_t n) {
    cudaError_t e = cudaFuncSetAttribute(
        k6_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)k6_smem(k5::STAGE_MAX));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        k6_parse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        n <= k5::STAGE_MAX ? cudaSharedmemCarveoutMaxShared
                           : cudaSharedmemCarveoutMaxL1);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// blocks: [B, nblk, 2] int32 (each block's cumulative end and info word);
// p2b: [512] uint16, the p_2_bits table; ht2 / ht3 / ht6: [B, 16384],
// [B, 65536], [B, hash_width << hash_bits] int32 zeros; lit: [B, 65536]
// uint16 and cells [B, NFIELD * CELLS] int32, scratch the kernel sets up;
// tape: [B, tcap, 2] int32; out: [3, B] int32 rows tok_cnt, done and err;
// btypes: [B, nblk] int32 zeros, each block's final type.  Every stream
// at most its dictionary; 1 <= hash_width <= 8, 1 <= hash_bits <= 24, 2
// <= good_len <= 32.
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
    cudaError_t e = k6_setup(n);
    if (e != cudaSuccess) return (int)e;
    k6_parse_kernel<<<batch, k5::WARP, k6_smem(n), (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, (const int32_t*)blocks, nblk,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, hash_bits,
        hash_width, good_len, (const uint16_t*)p2b, (int32_t*)ht2,
        (int32_t*)ht3, (int32_t*)ht6, (uint16_t*)lit, (int32_t*)cells,
        (int32_t*)tape, tcap, (int32_t*)out, (int32_t*)btypes);
    return (int)cudaGetLastError();
}

// shared memory a block of streams n bytes wide
extern "C" int64_t csc_k6_smem(int64_t n) { return (int64_t)k6_smem(n); }

// the int32 words of a stream's cells (NFIELD * CELLS)
extern "C" int64_t csc_k6_cell_words() {
    return (int64_t)k6::NFIELD * k6::CELLS;
}

// blocks of streams n bytes wide that one SM holds at once
extern "C" int csc_k6_blocks_per_sm(int64_t n, int* blocks) {
    cudaError_t e = k6_setup(n);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k6_parse_kernel, k5::WARP, k6_smem(n));
}
