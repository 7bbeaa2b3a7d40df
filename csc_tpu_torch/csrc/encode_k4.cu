// K4 on Hopper: batched optimal (AP) parse of m3-m5 over precomputed
// candidates and snapshot prices, one stream per CUDA block of one warp.
//
// Replaces csc_tpu/ops/parse_ap.py::ap_parse_step (an XLA while_loop
// driven by run_ap_parse: the B streams step in lockstep, one FSM action
// each a step).  Here the 32 lanes of each block run their stream's whole
// parse (encode_k4.cuh): a candidate pass over 32 positions a lane each,
// the rep lanes, the fold and the length grid of a FIND position across
// the warp, the bookkeeping, MARK and WALK uniform.  Shared memory holds
// the price tables, the stretch's DP cells (back, ndist and nxt in a
// window of k4::WINDOW cells, price and the relaxations' nodes in a ring
// of k4::RING cells keyed with the stretch id and the position), the
// candidate pass and, for a stream of at most K4_SMEM_DATA bytes, the
// data as words; a longer stream reads its data through L1 / L2.  About
// 40 KB a block at 16 KB streams: five blocks an SM, so a launch of the
// encode path's largest group (64 MB of 16 KB streams, 4 096 blocks)
// keeps 660 streams on the card at once; 32 streams use 32 SMs.
//
// What bounds it: a stream is one serial chain of positions, each a node
// made by the relaxations of the positions before it.  The chain holds a
// shared load for the node, the rep lanes' compares, four shuffles, two
// ballots and two warp ORs, the grid's table reads and its shared
// read-compare-writes, and a __syncwarp; the candidate rows, the one
// device-memory read, come from a pass that covers 32 positions at once.
#include <cuda_runtime.h>

#include "encode_k4.cuh"

constexpr int K4_SMEM_DATA = 64 * 1024;

// dynamic shared memory of a block: price tables, window, staged data
// (the data's words and WORDS_PAD words of zeros)
static int64_t k4_smem(int64_t n) {
    return k4::PRICES_LEN * 4 + k4::WINDOW_BYTES
         + (n <= K4_SMEM_DATA ? ((n + 3) / 4 + k4::WORDS_PAD) * 4 : 0);
}

// (32, 1): ptxas keeps the parse's registers (100; shared memory, not
// registers, bounds the blocks an SM) where it spilled some at its
// default choice of 72
__global__ void __launch_bounds__(k4::WARP, 1) k4_parse_kernel(
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
    uint8_t* win = (uint8_t*)(smem + k4::PRICES_LEN);
    const k4::Window w = k4::window_at(win);
    for (int i = threadIdx.x; i < k4::RING; i += blockDim.x)
        w.key(i) = 0;
    const uint8_t* row = data + b * n;
    uint32_t* words = nullptr;
    if (n <= K4_SMEM_DATA) {
        words = (uint32_t*)(win + k4::WINDOW_BYTES);
        const int64_t nw = (n + 3) / 4 + k4::WORDS_PAD;
        for (int64_t i = threadIdx.x; i < nw; i += blockDim.x) {
            uint32_t v = 0;
            for (int k = 0; k < 4; ++k)
                if (4 * i + k < n) v |= (uint32_t)row[4 * i + k] << (8 * k);
            words[i] = v;
        }
    }
    __syncwarp();
    k4::Stream s;
    s.data = row;
    s.words = words;
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
    s.cells = cells ? cells + b * k4::CELL_ROWS * n : nullptr;
    s.pr = k4::prices_at(pr);
    s.win = w;
    k4::Result r = k4::parse_stream(s);
    if (threadIdx.x == 0) {
        const int64_t B = gridDim.x;
        out[0 * B + b] = r.tok_cnt;
        out[1 * B + b] = r.done;
        out[2 * B + b] = r.err;
        out[3 * B + b] = r.finds;
    }
}

// the largest block's shared memory, and as much of the SM's L1 / shared
// split for shared memory as it offers, so that the blocks an SM holds
// are bound by the blocks' shared memory alone
static cudaError_t k4_setup() {
    cudaError_t e = cudaFuncSetAttribute(
        k4_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)k4_smem(K4_SMEM_DATA));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        k4_parse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued).
// prices: [736] int32 (ops/prices.py TABLES); cells: null, or a [B, 10, n]
// int32 debug copy of the DP cells, row 1 (the stamps) at -1, which every
// cell write also updates; out: [4, B] int32 rows tok_cnt, done, err and
// the FIND positions at which the lanes ran (the candidate rows read).
// ncand <= k4::MAX_CAND, good_len <= k4::MAX_GOOD_LEN, n < 2^31.
extern "C" int csc_k4_launch(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len,
    const void* prices, void* tape, int64_t tcap, int64_t max_steps,
    void* cells, void* out, int32_t batch, void* stream) {
    if (ncand > k4::MAX_CAND || good_len > k4::MAX_GOOD_LEN || good_len < 2
        || n >= (int64_t)1 << 31)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = k4_setup();
    if (e != cudaSuccess) return (int)e;
    k4_parse_kernel<<<batch, k4::WARP, (size_t)k4_smem(n),
                      (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)cand, n, ncand,
        (const int32_t*)run_ends, (const int32_t*)run_skip, nrun,
        (const int32_t*)sizes, (const int32_t*)dict_sizes, good_len,
        (const int32_t*)prices, (int32_t*)tape, tcap, max_steps,
        (int32_t*)cells, (int32_t*)out);
    return (int)cudaGetLastError();
}

// The dynamic shared memory a block of a launch over streams of n bytes
// takes.
extern "C" int64_t csc_k4_smem(int64_t n) { return k4_smem(n); }

// K4's resident blocks per SM for streams of n bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its launch shape) into
// *blocks; returns the cudaError_t.
extern "C" int csc_k4_blocks_per_sm(int64_t n, int* blocks) {
    cudaError_t e = k4_setup();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k4_parse_kernel, k4::WARP, (size_t)k4_smem(n));
}
