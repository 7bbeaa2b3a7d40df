// K3 on Hopper: batched phase-B coding (token tape -> range-coded and
// bit-coded bytes), one stream per CUDA block.
//
// Replaces csc_tpu/ops/pallas_encode.py::_make_kernel (the TPU lockstep
// phase-B kernel, launched through _run / encode_bits_pallas).  The TPU
// kernel's float32 probability tiles, KBITS unrolling, token ring tiles and
// output ring flushes exist for the TPU's vector unit and DMA engine; here
// the probabilities are 12-bit integers in shared memory and the outputs
// are written where they go.
//
// What bounds it on this card: a stream's coded bits form one serial chain
// (each bound needs the range the previous bit left), and one thread runs
// a dependent chain at about 5 cycles an instruction, a taken branch
// costing as much again.  The bytes it moves take microseconds; the chain
// takes milliseconds.  So the design leaves one thread the range-coder
// arithmetic alone, branch-free (encode_k3.cuh): warp 0 expands 32 tokens
// a pass into records in a ring of K3_SLOTS passes in shared memory; lane
// 0 of warp 1 walks each pass, replacing a coded bit's probability
// address by the probability and adapting the table (it depends on the
// earlier bits at that address only); lane 0 of warp 2 codes the walked
// pass, four records at a time, its ShiftLows deferred to a buffer and
// drained before any other record.  Named barriers hand each slot on
// (expanded: warp 0 -> 1; walked: 1 -> 2; free: 2 -> 0).  The small trees
// and p_lit (133 KB as uint16_t) sit in dynamic shared memory, p_delta in
// device memory; streams run in parallel across the SMs.
#include <cuda_runtime.h>

#include "encode_k3.cuh"

constexpr int K3_SLOTS = 4;          // passes in flight between the warps
constexpr int K3_THREADS = 96;       // expanding, walking and coding warps
constexpr int K3_PROB_BYTES = sizeof(uint16_t) * k3::NPROB_MAIN;
constexpr int K3_RING_BYTES = sizeof(uint32_t) * k3::SLOT * K3_SLOTS;
constexpr int K3_SMEM = K3_PROB_BYTES + K3_RING_BYTES
                        + sizeof(uint32_t) * (k3::CAP + 1)   // deferred tops
                        + sizeof(int32_t) * K3_SLOTS;       // pass headers
static_assert(K3_PROB_BYTES % 16 == 0, "the fill writes 16 bytes a thread");
static_assert(k3::SLOT % 4 == 0, "passes start 16-byte aligned");

// named barrier `id` (1-15) between two warps
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ int expanded(int slot) { return 1 + slot; }
__device__ __forceinline__ int walked(int slot) { return 1 + K3_SLOTS + slot; }
__device__ __forceinline__ int freed(int slot) {
    return 1 + 2 * K3_SLOTS + slot;
}

__global__ void __launch_bounds__(K3_THREADS) k3_code_kernel(
    const int32_t* __restrict__ kind, const int32_t* __restrict__ a,
    const int32_t* __restrict__ b, const int32_t* __restrict__ c,
    int64_t ntok, uint8_t* __restrict__ rc_out, int32_t max_rc,
    uint8_t* __restrict__ bc_out, int32_t max_bc,
    int32_t* __restrict__ rc_map, int32_t* __restrict__ bc_map, int32_t nmap,
    int32_t* __restrict__ chunk_log, int32_t nchunk, int32_t bsize,
    uint16_t* __restrict__ pdelta, int32_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* ring = (uint32_t*)(smem + K3_PROB_BYTES);
    uint32_t* tops = ring + k3::SLOT * K3_SLOTS;
    int32_t* hdr = (int32_t*)(tops + k3::CAP + 1);
    const uint4 init = {0x08000800u, 0x08000800u, 0x08000800u, 0x08000800u};
    for (int j = threadIdx.x; j < K3_PROB_BYTES / 16; j += K3_THREADS)
        ((uint4*)smem)[j] = init;
    __syncthreads();
    const int64_t i = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // records name small-table probabilities by 18-bit shared addresses
    const uint32_t pbase = (uint32_t)__cvta_generic_to_shared(smem);
    auto slot = [&](int s) {
        return k3::Ring{ring + k3::SLOT * s,
                        pbase + K3_PROB_BYTES + 4 * k3::SLOT * s};
    };

    if (warp == 0) {   // expand
        k3::Expander e{kind + i * ntok, a + i * ntok, b + i * ntok,
                       c + i * ntok, ntok, 0, 0, 0, pbase};
        for (int k = 0;; ++k) {
            const int s = k % K3_SLOTS;
            if (k >= K3_SLOTS) bar_sync(freed(s));
            const int32_t h = e.pass(ring + k3::SLOT * s);
            if (lane == 0) hdr[s] = h;
            __syncwarp();
            bar_arrive(expanded(s));
            if (h & k3::H_LAST) {
                // match the coder's arrivals on the passes still out
                for (int j = k >= K3_SLOTS ? k - K3_SLOTS + 1 : 0; j <= k; ++j)
                    bar_sync(freed(j % K3_SLOTS));
                return;
            }
        }
    }
    if (warp == 1) {   // walk: lane 0, the others keep the barriers' count
        const k3::Tables t{smem - pbase, pdelta + i * k3::NPROB_DELTA};
        for (int k = 0;; ++k) {
            const int s = k % K3_SLOTS;
            bar_sync(expanded(s));
            const int32_t h = hdr[s];
            if (lane == 0)
                k3::walk(t, slot(s), h & k3::H_NREC,
                         pbase + 2 * k3::P_LONGLEN);
            __syncwarp();
            bar_arrive(walked(s));
            if (h & k3::H_LAST) return;
        }
    }
    // code: lane 0
    k3::Coder cd;
    cd.init(k3::Out{rc_out + i * max_rc, max_rc, bc_out + i * max_bc, max_bc,
                    rc_map + i * nmap, bc_map + i * nmap, nmap,
                    chunk_log + i * 2 * (int64_t)nchunk, nchunk, bsize},
            k3::Ring{tops, pbase + K3_PROB_BYTES + K3_RING_BYTES});
    int32_t h;
    for (int k = 0;; ++k) {
        const int s = k % K3_SLOTS;
        bar_sync(walked(s));
        h = hdr[s];
        if (lane == 0) cd.code(slot(s), h & k3::H_NREC);
        __syncwarp();
        bar_arrive(freed(s));
        if (h & k3::H_LAST) break;
    }
    if (lane == 0) {
        const k3::Result r = cd.result((h & k3::H_DONE) ? 1 : 0);
        const int64_t B = gridDim.x;
        out[0 * B + i] = r.rc_cnt;
        out[1 * B + i] = r.bc_cnt;
        out[2 * B + i] = r.chunk_cnt;
        out[3 * B + i] = r.done;
        out[4 * B + i] = r.err;
    }
}

// Launch on `stream`; returns the launch's cudaError_t (0 = queued), or
// cudaErrorInvalidValue for sizes the int32 counters do not take.
// out: [5, B] int32 rows rc_cnt, bc_cnt, chunk_cnt, done, err.
extern "C" int csc_k3_launch(
    const void* kind, const void* a, const void* b, const void* c,
    int64_t ntok, void* rc_out, int64_t max_rc, void* bc_out,
    int64_t max_bc, void* rc_map, void* bc_map, int32_t nmap,
    void* chunk_log, int32_t nchunk, int64_t bsize, void* pdelta, void* out,
    int32_t batch, void* stream) {
    if (max_rc >= (1 << 30) || max_bc >= (1 << 30) || bsize >= (1 << 30))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        k3_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM);
    if (e != cudaSuccess) return (int)e;
    k3_code_kernel<<<batch, K3_THREADS, K3_SMEM, (cudaStream_t)stream>>>(
        (const int32_t*)kind, (const int32_t*)a, (const int32_t*)b,
        (const int32_t*)c, ntok, (uint8_t*)rc_out, (int32_t)max_rc,
        (uint8_t*)bc_out, (int32_t)max_bc, (int32_t*)rc_map,
        (int32_t*)bc_map, nmap, (int32_t*)chunk_log, nchunk, (int32_t)bsize,
        (uint16_t*)pdelta, (int32_t*)out);
    return (int)cudaGetLastError();
}
