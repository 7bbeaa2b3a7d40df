// K1 on Hopper: batched CSC stream decode, one stream per CUDA block.
//
// Replaces csc_tpu/ops/pallas_decode.py::_make_kernel (the TPU lockstep
// mega-kernel, launched through _run / _run_fused).  Each block decodes
// one whole stream with one thread running the straight decoder of
// decode_k1.cuh; the other threads only fill the block's probability
// tables before it starts.
//
// What bounds it on this card: every coded bit depends on the coder
// state left by the previous bit, so a stream is one serial chain of
// dependent operations, and each link waits on the latency of a
// probability read (shared memory for the small trees and p_lit,
// device memory for p_delta) and, for LZ copies and coder refills, of a
// window or input read from device memory.  No instruction- or
// memory-throughput limit of the card is near.  This kernel's answer is
// the simplest one: one stream per block, coder state in registers, the
// hot probability tables (small trees + p_lit, 133 KB as uint16_t) in
// dynamic shared memory.  Streams run in parallel across SMs; making one
// stream, or one SM, faster is later work.
#include <cuda_runtime.h>

#include "decode_k1.cuh"

constexpr int K1_THREADS = 128;

__global__ void k1_decode_kernel(
    const uint8_t* __restrict__ rc, int64_t rcl,
    const uint8_t* __restrict__ bc, int64_t bcl,
    const int32_t* __restrict__ rc_ends, int32_t nb_rc,
    const int32_t* __restrict__ bc_ends, int32_t nb_bc,
    uint8_t* __restrict__ wnd, int64_t wnd_stride, int64_t wnd_size,
    uint16_t* __restrict__ pdelta, int32_t* __restrict__ blk_log,
    int32_t max_blocks, int64_t max_steps, int32_t* __restrict__ out) {
    extern __shared__ uint16_t probs[];
    const int64_t b = blockIdx.x;
    for (int i = threadIdx.x; i < k1::NPROB_MAIN; i += blockDim.x)
        probs[i] = 2048;
    __syncthreads();
    if (threadIdx.x != 0) return;

    k1::Stream s;
    s.rc = rc + b * rcl;
    s.rcl = rcl;
    s.bc = bc + b * bcl;
    s.bcl = bcl;
    s.rc_ends = rc_ends + b * nb_rc;
    s.nb_rc = nb_rc;
    s.bc_ends = bc_ends + b * nb_bc;
    s.nb_bc = nb_bc;
    s.wnd = wnd + b * wnd_stride;
    s.wnd_size = wnd_size;
    s.probs = probs;
    s.pdelta = pdelta + b * k1::NPROB_DELTA;
    s.blk_log = blk_log + b * 2 * (int64_t)max_blocks;
    s.max_blocks = max_blocks;
    s.max_steps = max_steps;
    k1::Result r = k1::decode_stream(s);
    const int64_t B = gridDim.x;
    out[0 * B + b] = r.wnd_pos;
    out[1 * B + b] = r.done;
    out[2 * B + b] = r.err;
    out[3 * B + b] = r.blk_cnt;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// out: [4, B] int32 rows wnd_pos, done, err, blk_cnt.
extern "C" int csc_k1_launch(
    const void* rc, int64_t rcl, const void* bc, int64_t bcl,
    const void* rc_ends, int32_t nb_rc, const void* bc_ends, int32_t nb_bc,
    void* wnd, int64_t wnd_stride, int64_t wnd_size, void* pdelta,
    void* blk_log, int32_t max_blocks, int64_t max_steps, void* out,
    int32_t batch, void* stream) {
    const size_t smem = sizeof(uint16_t) * k1::NPROB_MAIN;
    cudaError_t e = cudaFuncSetAttribute(
        k1_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    k1_decode_kernel<<<batch, K1_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)rc, rcl, (const uint8_t*)bc, bcl,
        (const int32_t*)rc_ends, nb_rc, (const int32_t*)bc_ends, nb_bc,
        (uint8_t*)wnd, wnd_stride, wnd_size, (uint16_t*)pdelta,
        (int32_t*)blk_log, max_blocks, max_steps, (int32_t*)out);
    return (int)cudaGetLastError();
}
