// K1 on Hopper: batched CSC stream decode, one stream per CUDA block, two
// blocks on each SM.
//
// Replaces csc_tpu/ops/pallas_decode.py::_make_kernel (the TPU lockstep
// mega-kernel, launched through _run / _run_fused).  Each block decodes
// one whole stream with one thread running the straight decoder of
// decode_k1.cuh; the other threads only fill the block's model before it
// starts.
//
// What bounds it on this card: every coded bit depends on the coder
// state left by the previous bit, so a stream is one serial chain of
// dependent operations; no instruction- or memory-throughput limit of
// the card is near.  The design shortens the chain (decode_k1.cuh: the
// children's probabilities load while a bit decodes, coder bytes come
// from register words loaded ahead, copies read a shared ring) and puts
// two chains on each SM: the model (small trees as uint16, p_lit as
// 12-bit values) and an 8 KB output ring take 110,592 B of dynamic shared
// memory, under the 115,712 B at which two blocks fit an SM's 228 KB.
// p_delta lives in a device scratch (DLT blocks only).
#include <cuda_runtime.h>

#include "decode_k1.cuh"

constexpr int K1_THREADS = 128;

__global__ void __launch_bounds__(K1_THREADS, k1::BLOCKS_PER_SM)
k1_decode_kernel(
    const uint8_t* __restrict__ rc, int64_t rcl,
    const uint8_t* __restrict__ bc, int64_t bcl,
    const int32_t* __restrict__ rc_ends, int32_t nb_rc,
    const int32_t* __restrict__ bc_ends, int32_t nb_bc,
    uint8_t* __restrict__ wnd, int64_t wnd_stride, int64_t wnd_size,
    uint16_t* __restrict__ pdelta, int32_t* __restrict__ blk_log,
    int32_t max_blocks, int64_t max_steps, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int64_t b = blockIdx.x;
    uint4* words = (uint4*)smem;
    for (int i = threadIdx.x; i < k1::INIT_WORDS / 4; i += blockDim.x) {
        const uint32_t w = k1::init_word(4 * i);
        words[i] = make_uint4(w, w, w, w);
    }
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
    s.smem = smem;
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

static cudaError_t k1_setup() {
    cudaError_t e = cudaFuncSetAttribute(
        k1_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        k1::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(k1_decode_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// out: [4, B] int32 rows wnd_pos, done, err, blk_cnt.
extern "C" int csc_k1_launch(
    const void* rc, int64_t rcl, const void* bc, int64_t bcl,
    const void* rc_ends, int32_t nb_rc, const void* bc_ends, int32_t nb_bc,
    void* wnd, int64_t wnd_stride, int64_t wnd_size, void* pdelta,
    void* blk_log, int32_t max_blocks, int64_t max_steps, void* out,
    int32_t batch, void* stream) {
    cudaError_t e = k1_setup();
    if (e != cudaSuccess) return (int)e;
    k1_decode_kernel<<<batch, K1_THREADS, k1::SMEM_BYTES,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)rc, rcl, (const uint8_t*)bc, bcl,
        (const int32_t*)rc_ends, nb_rc, (const int32_t*)bc_ends, nb_bc,
        (uint8_t*)wnd, wnd_stride, wnd_size, (uint16_t*)pdelta,
        (int32_t*)blk_log, max_blocks, max_steps, (int32_t*)out);
    return (int)cudaGetLastError();
}

// K1's resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its launch shape) into *blocks; returns the cudaError_t.
extern "C" int csc_k1_blocks_per_sm(int* blocks) {
    cudaError_t e = k1_setup();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k1_decode_kernel, K1_THREADS, k1::SMEM_BYTES);
}
