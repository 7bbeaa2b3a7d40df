// Test-only host build of K2's per-stream parser (encode_k2.cuh) with g++.
// It runs the kernel's parse logic on the CPU, stream after stream, so the
// CPU tests can hold it against the plain PyTorch version.  Not on any
// encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k2_host.cpp -o libk2host.so
#include "encode_k2.cuh"

// Same arguments and outputs as csc_k2_launch in encode_k2.cu, with host
// pointers and no stream.
extern "C" int csc_k2_host(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len, void* tape,
    int64_t tcap, void* out, int32_t batch) {
    int32_t* o = (int32_t*)out;
    for (int64_t b = 0; b < batch; ++b) {
        k2::Stream s;
        s.data = (const uint8_t*)data + b * n;
        s.n = n;
        s.cand = (const int32_t*)cand + b * ncand * n;
        s.ncand = ncand;
        s.run_ends = (const int32_t*)run_ends + b * nrun;
        s.run_skip = (const int32_t*)run_skip + b * nrun;
        s.nrun = nrun;
        s.size = ((const int32_t*)sizes)[b];
        s.dict_size = ((const int32_t*)dict_sizes)[b];
        s.good_len = good_len;
        s.tape = (int32_t*)tape + b * 2 * tcap;
        s.tcap = tcap;
        k2::Result r = k2::parse_stream(s);
        o[0 * batch + b] = r.tok_cnt;
        o[1 * batch + b] = r.done;
        o[2 * batch + b] = r.err;
    }
    return 0;
}
