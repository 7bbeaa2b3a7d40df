// K4 on Hopper: batched optimal (AP) parse of m3-m5 over precomputed
// candidates and snapshot prices, one stream per CUDA block.
//
// Replaces csc_tpu/ops/parse_ap.py::ap_parse_step (an XLA while_loop
// driven by run_ap_parse: the B streams step in lockstep, one FSM action
// each a step).  Here lane 0 of each block runs its stream's whole parse
// (encode_k4.cuh) in sequence; the other lanes only stage the price
// tables and, for a stream of at most K4_SMEM_DATA bytes, the data in
// shared memory.  The DP cells live in the caller's per-stream scratch
// [B, 10, n] in device memory (L1 / L2 hold a stretch's cells).
//
// What bounds it: a stream is one serial chain of positions, each a
// dependent walk through its cells, lanes and fold.  This first design
// makes no attempt at overlap; a stretch spans at most AP_LIMIT + 1
// cells, so a shared-memory ring of cells is the next step.
#include <cuda_runtime.h>

#include "encode_k4.cuh"

constexpr int K4_SMEM_DATA = 64 * 1024;

__global__ void __launch_bounds__(32) k4_parse_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ cand,
    int64_t n, int32_t ncand, const int32_t* __restrict__ run_ends,
    const int32_t* __restrict__ run_skip, int32_t nrun,
    const int32_t* __restrict__ sizes, const int32_t* __restrict__ dict_sizes,
    int32_t good_len, const int32_t* __restrict__ prices,
    int32_t* __restrict__ tape, int64_t tcap, int64_t max_steps,
    int32_t* __restrict__ cells, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t smem[];
    const int64_t b = blockIdx.x;
    int32_t* pr = smem;
    for (int i = threadIdx.x; i < k4::PRICES_LEN; i += blockDim.x)
        pr[i] = prices[i];
    const uint8_t* row = data + b * n;
    if (n <= K4_SMEM_DATA) {
        uint8_t* staged = (uint8_t*)(smem + k4::PRICES_LEN);
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
            staged[i] = row[i];
        row = staged;
    }
    __syncwarp();
    if (threadIdx.x != 0) return;
    k4::Stream s;
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
    s.max_steps = max_steps;
    s.cells = cells + b * k4::CELL_ROWS * n;
    s.pr = k4::prices_at(pr);
    k4::Result r = k4::parse_stream(s);
    const int64_t B = gridDim.x;
    out[0 * B + b] = r.tok_cnt;
    out[1 * B + b] = r.done;
    out[2 * B + b] = r.err;
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// prices: [736] int32 (ops/prices.py TABLES); cells: [B, 10, n] int32
// scratch with row 1 (the stamps) at -1; out: [3, B] int32 rows tok_cnt,
// done, err.  ncand <= k4::MAX_CAND, good_len <= k4::MAX_GOOD_LEN.
extern "C" int csc_k4_launch(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len,
    const void* prices, void* tape, int64_t tcap, int64_t max_steps,
    void* cells, void* out, int32_t batch, void* stream) {
    if (ncand > k4::MAX_CAND || good_len > k4::MAX_GOOD_LEN || good_len < 2)
        return (int)cudaErrorInvalidValue;
    const int smem = k4::PRICES_LEN * 4 + (n <= K4_SMEM_DATA ? (int)n : 0);
    cudaError_t e = cudaFuncSetAttribute(
        k4_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        k4::PRICES_LEN * 4 + K4_SMEM_DATA);
    if (e != cudaSuccess) return (int)e;
    k4_parse_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)cand, n, ncand,
        (const int32_t*)run_ends, (const int32_t*)run_skip, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, good_len,
        (const int32_t*)prices, (int32_t*)tape, tcap, max_steps,
        (int32_t*)cells, (int32_t*)out);
    return (int)cudaGetLastError();
}
