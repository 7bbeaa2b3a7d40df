// K2 on Hopper: batched lazy parse over precomputed candidates, one
// stream per CUDA block of one warp.
//
// Replaces csc_tpu/ops/pallas_parse.py::_make_kernel (the TPU lockstep
// parse kernel, launched through _run / parse_batch_pallas).  Each block
// parses one whole stream with the 32 lanes of one warp running the
// parser of encode_k2.cuh.  The TPU kernel's register windows (pw / cw /
// rw / fw), the permuted rep map and the DMA service sweep exist because
// a TPU cannot gather; a warp gathers a position's candidate words and
// rep bytes in one round trip, one lane each.
//
// What bounds it on this card: a token's decision depends on the rep
// queue and lazy state left by the previous token, so a stream is one
// serial chain; the bytes it must move (data + packed candidates + tape)
// take microseconds at the card's memory rate, the chain milliseconds.
// The design cuts each link to about one load round trip (both lazy
// probes' candidate words and rep heads at once, one lane each), warp-
// wide 32-byte strides for long extensions, and the order-dependent fold
// in registers.  A stream of at most K2_SMEM_DATA bytes is staged in
// shared memory first, so its byte compares read shared memory; a longer
// one reads through L1 / L2.
#include <cuda_runtime.h>

#include "encode_k2.cuh"

constexpr int K2_SMEM_DATA = 64 * 1024;

__global__ void __launch_bounds__(k2::WARP) k2_parse_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ cand,
    int64_t n, int32_t ncand, const int32_t* __restrict__ run_ends,
    const int32_t* __restrict__ run_skip, int32_t nrun,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t good_len, int32_t* __restrict__ tape, int64_t tcap,
    int32_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t staged[];
    const int64_t b = blockIdx.x;
    const uint8_t* row = data + b * n;
    if (n <= K2_SMEM_DATA) {
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
            staged[i] = row[i];
        __syncwarp();
        row = staged;
    }
    k2::Stream s;
    s.data = row;
    s.n = n;
    s.cand = cand + b * ncand * n;
    s.ncand = ncand;
    s.run_ends = run_ends + b * nrun;
    s.run_skip = run_skip + b * nrun;
    s.nrun = nrun;
    s.size = sizes[b];
    s.dict_size = dict_sizes[b];
    s.good_len = good_len;
    s.tape = tape + b * 2 * tcap;
    s.tcap = tcap;
    k2::Result r = k2::parse_stream(s);
    if (threadIdx.x == 0) {
        const int64_t B = gridDim.x;
        out[0 * B + b] = r.tok_cnt;
        out[1 * B + b] = r.done;
        out[2 * B + b] = r.err;
    }
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// out: [3, B] int32 rows tok_cnt, done, err.  ncand <= k2::MAX_CAND.
extern "C" int csc_k2_launch(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len, void* tape,
    int64_t tcap, void* out, int32_t batch, void* stream) {
    if (ncand > k2::MAX_CAND) return (int)cudaErrorInvalidValue;
    const int smem = n <= K2_SMEM_DATA ? (int)n : 0;
    cudaError_t e = cudaFuncSetAttribute(
        k2_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K2_SMEM_DATA);
    if (e != cudaSuccess) return (int)e;
    k2_parse_kernel<<<batch, k2::WARP, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)cand, n, ncand,
        (const int32_t*)run_ends, (const int32_t*)run_skip, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, good_len,
        (int32_t*)tape, tcap, (int32_t*)out);
    return (int)cudaGetLastError();
}
