// K5 on Hopper: the batched exact m1/m2 parse with live hash tables, one
// warp a stream.
//
// Replaces csc_tpu/ops/encode_scan.py::encode_parse_step (an XLA
// while_loop driven by run_parse: the B streams step in lockstep, one
// micro-op each a step: a hash-table probe, a 4-byte extension word, an
// insertion or a decision).  Here each block is one warp that runs its
// stream's whole parse with the natural loops of csc_mf.cpp / csc_lz.cpp
// (encode_k5.cuh): a find's probes, extensions and fold across the
// lanes, a slide 32 insertions a pass.  It counts the micro-ops the
// lockstep version would take, so that a step budget cuts both at the
// same token.  A stream of at most 64 KB is staged as words in shared
// memory (about 16 KB a block for the encode path's 16 KB streams, so a
// dozen blocks fit an SM); a longer one is read from device memory.  The
// hash tables live in device memory, one slice a stream, zeroed by the
// wrapper.
//
// The bound: the data read once and the tape written once, over the
// card's 3.35 TB/s, microseconds for the encode path's groups.  A find's
// table loads sit at addresses the position's bytes make, and its
// extensions compare bytes at addresses the tables gave: a chain of
// dependent loads a position, so K5 is bound by load latency (the tables
// sit in L2 or device memory), not by bytes.
#include <cuda_runtime.h>

#include "encode_k5.cuh"

static size_t k5_smem(int64_t n) {
    return n <= k5::STAGE_MAX
               ? (size_t)(((n + 3) / 4 + k5::STAGE_PAD) * 4) : 0;
}

// one block a stream, one warp a block; at the default register bound
// ptxas spills (72 registers, a 24-byte frame): allow one block an SM the
// whole register file (at most 255 a thread still leaves eight blocks an
// SM, the 1 024-stream group's need)
__global__ void __launch_bounds__(k5::WARP, 1) k5_parse_kernel(
    const uint8_t* __restrict__ data, int64_t n,
    const int32_t* __restrict__ run_ends, int32_t nrun,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t hash_bits, int32_t hash_width, int32_t good_len, int32_t lazy,
    int32_t* __restrict__ ht2, int32_t* __restrict__ ht3,
    int32_t* __restrict__ ht6, int32_t* __restrict__ tape, int64_t tcap,
    int64_t max_steps, int32_t* __restrict__ out) {
    const int64_t b = blockIdx.x;
    const uint8_t* row = data + b * n;
    const bool staged = n <= k5::STAGE_MAX;
    if (staged) {
        const int64_t nw = (n + 3) / 4 + k5::STAGE_PAD;
        // whole words only where every row starts on a word (the data
        // pointer aligned as well as n)
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
        __syncwarp();
    }
    k5::Stream s;
    s.data = row;
    s.words = nullptr;
    s.n = n;
    s.run_ends = run_ends + b * nrun;
    s.nrun = nrun;
    s.size = sizes[b];
    s.dict_size = dict_sizes[b];
    s.hash_bits = hash_bits;
    s.hash_width = hash_width;
    s.good_len = good_len;
    s.lazy = lazy;
    s.ht2 = ht2 + b * k5::HT2_SIZE;
    s.ht3 = ht3 + b * k5::HT3_SIZE;
    s.ht6 = ht6 + b * ((int64_t)hash_width << hash_bits);
    s.tape = tape + b * 2 * tcap;
    s.tcap = tcap;
    s.max_steps = max_steps;
    const k5::Result r = staged ? k5::parse_stream<true>(s)
                                : k5::parse_stream<false>(s);
    if (threadIdx.x == 0) {
        const int64_t B = gridDim.x;
        out[0 * B + b] = r.tok_cnt;
        out[1 * B + b] = r.done;
        out[2 * B + b] = r.err;
        out[3 * B + b] = r.steps;
    }
}

// staged launches take shared memory first, the others L1
static cudaError_t k5_setup(int64_t n) {
    cudaError_t e = cudaFuncSetAttribute(
        k5_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)k5_smem(k5::STAGE_MAX));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        k5_parse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        n <= k5::STAGE_MAX ? cudaSharedmemCarveoutMaxShared
                           : cudaSharedmemCarveoutMaxL1);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// ht2 / ht3 / ht6: [B, 16384], [B, 65536], [B, hash_width << hash_bits]
// int32 zeros; tape: [B, tcap, 2] int32; out: [4, B] int32 rows tok_cnt,
// done, err and steps.  1 <= hash_width <= 8, 1 <= hash_bits <= 24,
// max_steps < 2^31.
extern "C" int csc_k5_launch(
    const void* data, int64_t n, const void* run_ends, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t hash_bits,
    int32_t hash_width, int32_t good_len, int32_t lazy, void* ht2, void* ht3,
    void* ht6, void* tape, int64_t tcap, int64_t max_steps, void* out,
    int32_t batch, void* stream) {
    if (hash_width < 1 || hash_width > k5::MAX_WIDTH || hash_bits < 1
        || hash_bits > 24 || max_steps >= ((int64_t)1 << 31) || tcap < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = k5_setup(n);
    if (e != cudaSuccess) return (int)e;
    k5_parse_kernel<<<batch, k5::WARP, k5_smem(n), (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, (const int32_t*)run_ends, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, hash_bits,
        hash_width, good_len, lazy, (int32_t*)ht2, (int32_t*)ht3,
        (int32_t*)ht6, (int32_t*)tape, tcap, max_steps, (int32_t*)out);
    return (int)cudaGetLastError();
}

// shared memory a block of streams n bytes wide
extern "C" int64_t csc_k5_smem(int64_t n) { return (int64_t)k5_smem(n); }

// blocks of streams n bytes wide that one SM holds at once
extern "C" int csc_k5_blocks_per_sm(int64_t n, int* blocks) {
    cudaError_t e = k5_setup(n);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k5_parse_kernel, k5::WARP, k5_smem(n));
}

#ifdef K5_PHASES
// block 0's phase clocks and counts (k5::Phase order) into host memory
// dst [k5::NPHASE] uint64, and zeroes them
extern "C" int csc_k5_phases(void* dst) {
    cudaError_t e = cudaMemcpyFromSymbol(dst, k5::k5_phases,
                                         sizeof(k5::k5_phases));
    if (e != cudaSuccess) return (int)e;
    static const unsigned long long zero[k5::NPHASE] = {};
    return (int)cudaMemcpyToSymbol(k5::k5_phases, zero, sizeof(zero));
}
#endif
