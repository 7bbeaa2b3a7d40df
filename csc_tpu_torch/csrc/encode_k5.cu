// K5 on Hopper: the batched exact m1/m2 parse with live hash tables, one
// stream a thread.
//
// Replaces csc_tpu/ops/encode_scan.py::encode_parse_step (an XLA
// while_loop driven by run_parse: the B streams step in lockstep, one
// micro-op each a step: a hash-table probe, a 4-byte extension word, an
// insertion or a decision).  Here each thread runs its stream's whole
// parse with the natural loops of csc_mf.cpp / csc_lz.cpp
// (encode_k5.cuh), and counts the micro-ops the lockstep version would
// take, so that a step budget cuts both at the same token.  The hash
// tables live in device memory, one slice a stream, zeroed by the
// wrapper; each block holds one thread, so that streams never share a
// warp's control flow and up to 32 of them share an SM.
//
// The bound: the data read once and the tape written once, over the
// card's 3.35 TB/s, microseconds for the encode path's groups.  Each
// probe is a load from a hash table at an address the position's bytes
// make, and its extension compares bytes at an address the table gave:
// a chain of dependent loads a position, so K5 is bound by load latency
// (the tables of a few streams sit in L2), not by bytes.
#include <cuda_runtime.h>

#include "encode_k5.cuh"

__global__ void __launch_bounds__(1) k5_parse_kernel(
    const uint8_t* __restrict__ data, int64_t n,
    const int32_t* __restrict__ run_ends, int32_t nrun,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t hash_bits, int32_t hash_width, int32_t good_len, int32_t lazy,
    int32_t* __restrict__ ht2, int32_t* __restrict__ ht3,
    int32_t* __restrict__ ht6, int32_t* __restrict__ tape, int64_t tcap,
    int64_t max_steps, int32_t* __restrict__ out) {
    const int64_t b = blockIdx.x;
    k5::Stream s;
    s.data = data + b * n;
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
    const k5::Result r = k5::parse_stream(s);
    const int64_t B = gridDim.x;
    out[0 * B + b] = r.tok_cnt;
    out[1 * B + b] = r.done;
    out[2 * B + b] = r.err;
    out[3 * B + b] = r.steps;
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
    k5_parse_kernel<<<batch, 1, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n, (const int32_t*)run_ends, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, hash_bits,
        hash_width, good_len, lazy, (int32_t*)ht2, (int32_t*)ht3,
        (int32_t*)ht6, (int32_t*)tape, tcap, max_steps, (int32_t*)out);
    return (int)cudaGetLastError();
}
