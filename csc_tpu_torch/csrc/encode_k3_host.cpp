// Test-only host build of K3's expansion, walk and coder (encode_k3.cuh)
// with g++.  It runs the kernel's logic on the CPU, stream after stream,
// each pass expanded, walked and then coded, so the CPU tests can hold it
// against the plain PyTorch version.  Not on any encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k3_host.cpp -o libk3host.so
//
// -DK3_CAP=<n> builds it with n records a pass (at least k3::MAX_REC).
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
    if (max_rc >= (1 << 30) || max_bc >= (1 << 30) || bsize >= (1 << 30))
        return 1;
    std::vector<uint16_t> probs(k3::NPROB_MAIN);
    std::vector<uint32_t> ring(k3::SLOT), tops(k3::CAP + 1);
    uint32_t* recs = ring.data();
    int32_t* o = (int32_t*)out;
    for (int64_t i = 0; i < batch; ++i) {
        probs.assign(k3::NPROB_MAIN, 2048);
        uint16_t* pd = (uint16_t*)pdelta + i * k3::NPROB_DELTA;
        for (int j = 0; j < k3::NPROB_DELTA; ++j) pd[j] = 2048;
        k3::Expander e{(const int32_t*)kind + i * ntok,
                       (const int32_t*)a + i * ntok,
                       (const int32_t*)b + i * ntok,
                       (const int32_t*)c + i * ntok, ntok, 0, 0, 0, 0};
        k3::Out s{(uint8_t*)rc_out + i * max_rc, (int32_t)max_rc,
                  (uint8_t*)bc_out + i * max_bc, (int32_t)max_bc,
                  (int32_t*)rc_map + i * nmap, (int32_t*)bc_map + i * nmap,
                  nmap, (int32_t*)chunk_log + i * 2 * (int64_t)nchunk, nchunk,
                  (int32_t)bsize};
        k3::Tables t{(uint8_t*)probs.data(), pd};
        k3::Coder cd;
        cd.init(s, k3::Ring{tops.data(), 0});
        int32_t h;
        do {
            h = e.pass(recs);
            k3::walk(t, k3::Ring{recs, 0}, h & k3::H_NREC, 2 * k3::P_LONGLEN);
            cd.code(k3::Ring{recs, 0}, h & k3::H_NREC);
        } while (!(h & k3::H_LAST));
        const k3::Result r = cd.result((h & k3::H_DONE) ? 1 : 0);
        o[0 * batch + i] = r.rc_cnt;
        o[1 * batch + i] = r.bc_cnt;
        o[2 * batch + i] = r.chunk_cnt;
        o[3 * batch + i] = r.done;
        o[4 * batch + i] = r.err;
    }
    return 0;
}
