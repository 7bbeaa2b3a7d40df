// Test-only host build of K3's per-stream coder (encode_k3.cuh) with g++.
// It runs the kernel's coding logic on the CPU, stream after stream, so
// the CPU tests can hold it against the plain PyTorch version.  Not on any
// encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k3_host.cpp -o libk3host.so
#include <vector>

#include "encode_k3.cuh"

// Same arguments and outputs as csc_k3_launch in encode_k3.cu, with host
// pointers and no stream.  pdelta may be any buffer of B * 65536 entries.
extern "C" int csc_k3_host(
    const void* kind, const void* a, const void* b, const void* c,
    int64_t ntok, void* rc_out, int64_t max_rc, void* bc_out,
    int64_t max_bc, void* rc_map, void* bc_map, int32_t nmap,
    void* chunk_log, int32_t nchunk, int64_t bsize, void* pdelta, void* out,
    int32_t batch) {
    std::vector<uint16_t> probs(k3::NPROB_MAIN);
    int32_t* o = (int32_t*)out;
    for (int64_t i = 0; i < batch; ++i) {
        probs.assign(k3::NPROB_MAIN, 2048);
        uint16_t* pd = (uint16_t*)pdelta + i * k3::NPROB_DELTA;
        for (int j = 0; j < k3::NPROB_DELTA; ++j) pd[j] = 2048;
        k3::Stream s;
        s.kind = (const int32_t*)kind + i * ntok;
        s.a = (const int32_t*)a + i * ntok;
        s.b = (const int32_t*)b + i * ntok;
        s.c = (const int32_t*)c + i * ntok;
        s.ntok = ntok;
        s.rc_out = (uint8_t*)rc_out + i * max_rc;
        s.max_rc = max_rc;
        s.bc_out = (uint8_t*)bc_out + i * max_bc;
        s.max_bc = max_bc;
        s.rc_map = (int32_t*)rc_map + i * nmap;
        s.bc_map = (int32_t*)bc_map + i * nmap;
        s.nmap = nmap;
        s.chunk_log = (int32_t*)chunk_log + i * 2 * (int64_t)nchunk;
        s.nchunk = nchunk;
        s.bsize = bsize;
        s.probs = probs.data();
        s.pdelta = pd;
        k3::Result r = k3::code_stream(s);
        o[0 * batch + i] = r.rc_cnt;
        o[1 * batch + i] = r.bc_cnt;
        o[2 * batch + i] = r.chunk_cnt;
        o[3 * batch + i] = r.done;
        o[4 * batch + i] = r.err;
    }
    return 0;
}
