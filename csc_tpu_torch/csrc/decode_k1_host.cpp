// Test-only host build of K1's per-stream decoder (decode_k1.cuh) with
// g++.  It runs the kernel's decode logic on the CPU, stream after
// stream, so the CPU tests can hold it against the plain PyTorch version.
// Not on any decode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC decode_k1_host.cpp -o libk1host.so
#include <vector>

#include "decode_k1.cuh"

// Same arguments and outputs as csc_k1_launch in decode_k1.cu, with host
// pointers and no stream.  pdelta may be any buffer of B * 65536 entries.
extern "C" int csc_k1_host(
    const void* rc, int64_t rcl, const void* bc, int64_t bcl,
    const void* rc_ends, int32_t nb_rc, const void* bc_ends, int32_t nb_bc,
    void* wnd, int64_t wnd_stride, int64_t wnd_size, void* pdelta,
    void* blk_log, int32_t max_blocks, int64_t max_steps, void* out,
    int32_t batch) {
    // the block's shared memory, 4-byte aligned as on the card
    std::vector<uint32_t> smem(k1::SMEM_BYTES / 4);
    int32_t* o = (int32_t*)out;
    for (int64_t b = 0; b < batch; ++b) {
        for (int i = 0; i < k1::INIT_WORDS; ++i) smem[i] = k1::init_word(i);
        uint16_t* pd = (uint16_t*)pdelta + b * k1::NPROB_DELTA;
        for (int i = 0; i < k1::NPROB_DELTA; ++i) pd[i] = 2048;
        k1::Stream s;
        s.rc = (const uint8_t*)rc + b * rcl;
        s.rcl = rcl;
        s.bc = (const uint8_t*)bc + b * bcl;
        s.bcl = bcl;
        s.rc_ends = (const int32_t*)rc_ends + b * nb_rc;
        s.nb_rc = nb_rc;
        s.bc_ends = (const int32_t*)bc_ends + b * nb_bc;
        s.nb_bc = nb_bc;
        s.wnd = (uint8_t*)wnd + b * wnd_stride;
        s.wnd_size = wnd_size;
        s.smem = (uint8_t*)smem.data();
        s.pdelta = pd;
        s.blk_log = (int32_t*)blk_log + b * 2 * (int64_t)max_blocks;
        s.max_blocks = max_blocks;
        s.max_steps = max_steps;
        k1::Result r = k1::decode_stream(s);
        o[0 * batch + b] = r.wnd_pos;
        o[1 * batch + b] = r.done;
        o[2 * batch + b] = r.err;
        o[3 * batch + b] = r.blk_cnt;
    }
    return 0;
}
