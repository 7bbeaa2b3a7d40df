// K3 on Hopper: batched phase-B coding (token tape -> range-coded and
// bit-coded bytes), one stream per CUDA block.
//
// Replaces csc_tpu/ops/pallas_encode.py::_make_kernel (the TPU lockstep
// phase-B kernel, launched through _run / encode_bits_pallas).  Each
// block codes one whole stream with one thread running the straight coder
// of encode_k3.cuh; the other threads only fill the block's probability
// table before it starts.  The TPU kernel's float32 probability tiles,
// KBITS unrolling, token ring tiles and output ring flushes exist for
// the TPU's vector unit and DMA engine; here the probabilities are 12-bit
// integers in shared memory and the outputs are written where they go.
//
// What bounds it on this card: every coded bit depends on the coder
// registers and the probability left by the previous bit, so a stream is
// one serial chain of dependent operations, and each link waits on the
// latency of a probability read-modify-write (shared memory for the small
// trees and p_lit, device memory for p_delta).  The bytes it moves (four
// tape words per token in, the coded bytes out) take microseconds at the
// card's memory rate; the chain takes milliseconds.  This kernel's answer
// is the simplest one: one stream per block, coder state in registers,
// the hot probability tables (small trees + p_lit, 133 KB as uint16_t) in
// dynamic shared memory, streams in parallel across the SMs.
#include <cuda_runtime.h>

#include "encode_k3.cuh"

constexpr int K3_THREADS = 128;

__global__ void k3_code_kernel(
    const int32_t* __restrict__ kind, const int32_t* __restrict__ a,
    const int32_t* __restrict__ b, const int32_t* __restrict__ c,
    int64_t ntok, uint8_t* __restrict__ rc_out, int64_t max_rc,
    uint8_t* __restrict__ bc_out, int64_t max_bc,
    int32_t* __restrict__ rc_map, int32_t* __restrict__ bc_map, int32_t nmap,
    int32_t* __restrict__ chunk_log, int32_t nchunk, int64_t bsize,
    uint16_t* __restrict__ pdelta, int32_t* __restrict__ out) {
    extern __shared__ uint16_t probs[];
    const int64_t i = blockIdx.x;
    for (int j = threadIdx.x; j < k3::NPROB_MAIN; j += blockDim.x)
        probs[j] = 2048;
    __syncthreads();
    if (threadIdx.x != 0) return;

    k3::Stream s;
    s.kind = kind + i * ntok;
    s.a = a + i * ntok;
    s.b = b + i * ntok;
    s.c = c + i * ntok;
    s.ntok = ntok;
    s.rc_out = rc_out + i * max_rc;
    s.max_rc = max_rc;
    s.bc_out = bc_out + i * max_bc;
    s.max_bc = max_bc;
    s.rc_map = rc_map + i * nmap;
    s.bc_map = bc_map + i * nmap;
    s.nmap = nmap;
    s.chunk_log = chunk_log + i * 2 * (int64_t)nchunk;
    s.nchunk = nchunk;
    s.bsize = bsize;
    s.probs = probs;
    s.pdelta = pdelta + i * k3::NPROB_DELTA;
    k3::Result r = k3::code_stream(s);
    const int64_t B = gridDim.x;
    out[0 * B + i] = r.rc_cnt;
    out[1 * B + i] = r.bc_cnt;
    out[2 * B + i] = r.chunk_cnt;
    out[3 * B + i] = r.done;
    out[4 * B + i] = r.err;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// out: [5, B] int32 rows rc_cnt, bc_cnt, chunk_cnt, done, err.
extern "C" int csc_k3_launch(
    const void* kind, const void* a, const void* b, const void* c,
    int64_t ntok, void* rc_out, int64_t max_rc, void* bc_out,
    int64_t max_bc, void* rc_map, void* bc_map, int32_t nmap,
    void* chunk_log, int32_t nchunk, int64_t bsize, void* pdelta, void* out,
    int32_t batch, void* stream) {
    const size_t smem = sizeof(uint16_t) * k3::NPROB_MAIN;
    cudaError_t e = cudaFuncSetAttribute(
        k3_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    k3_code_kernel<<<batch, K3_THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)kind, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)c, ntok, (uint8_t*)rc_out, max_rc, (uint8_t*)bc_out,
        max_bc, (int32_t*)rc_map, (int32_t*)bc_map, nmap,
        (int32_t*)chunk_log, nchunk, bsize, (uint16_t*)pdelta,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
