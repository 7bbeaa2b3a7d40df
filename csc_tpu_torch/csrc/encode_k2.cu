// K2 on Hopper: batched lazy parse over precomputed candidates, one
// stream per CUDA block.
//
// Replaces csc_tpu/ops/pallas_parse.py::_make_kernel (the TPU lockstep
// parse kernel, launched through _run / parse_batch_pallas).  Each block
// parses one whole stream with one thread running the straight parser of
// encode_k2.cuh.  The TPU kernel's register windows (pw / cw / rw / fw),
// the permuted rep map and the DMA service sweep exist because a TPU
// cannot gather; a CUDA thread keeps its four reps in registers and reads
// candidates and data bytes from device memory.
//
// What bounds it on this card: a token's decision depends on the rep
// queue and lazy state left by the previous token, so a stream is one
// serial chain, and each link waits on the latency of its candidate and
// data reads (C + 2 words per position, then byte compares for live
// extension).  The bytes it must move (data + packed candidates + tape)
// take microseconds at the card's memory rate; the chain takes
// milliseconds.  This kernel's answer is the simplest one: one stream per
// block, state in registers, many streams in flight across the SMs.
#include <cuda_runtime.h>

#include "encode_k2.cuh"

__global__ void k2_parse_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ cand,
    int64_t n, int32_t ncand, const int32_t* __restrict__ run_ends,
    const int32_t* __restrict__ run_skip, int32_t nrun,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t good_len, int32_t* __restrict__ tape, int64_t tcap,
    int32_t* __restrict__ out) {
    const int64_t b = blockIdx.x;
    if (threadIdx.x != 0) return;
    k2::Stream s;
    s.data = data + b * n;
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
    const int64_t B = gridDim.x;
    out[0 * B + b] = r.tok_cnt;
    out[1 * B + b] = r.done;
    out[2 * B + b] = r.err;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// out: [3, B] int32 rows tok_cnt, done, err.
extern "C" int csc_k2_launch(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len, void* tape,
    int64_t tcap, void* out, int32_t batch, void* stream) {
    k2_parse_kernel<<<batch, 1, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)cand, n, ncand,
        (const int32_t*)run_ends, (const int32_t*)run_skip, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, good_len,
        (int32_t*)tape, tcap, (int32_t*)out);
    return (int)cudaGetLastError();
}
