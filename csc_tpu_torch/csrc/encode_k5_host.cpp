// Test-only host build of K5's per-stream parser (encode_k5.cuh) with g++.
// It runs the kernel's parse logic on the CPU, stream after stream, so the
// CPU tests can hold it against the plain PyTorch version.  Not on any
// encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k5_host.cpp -o libk5host.so
#include "encode_k5.cuh"

// Same arguments and outputs as csc_k5_launch in encode_k5.cu, with host
// pointers and no stream.
extern "C" int csc_k5_host(
    const void* data, int64_t n, const void* run_ends, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t hash_bits,
    int32_t hash_width, int32_t good_len, int32_t lazy, void* ht2, void* ht3,
    void* ht6, void* tape, int64_t tcap, int64_t max_steps, void* out,
    int32_t batch) {
    if (hash_width < 1 || hash_width > k5::MAX_WIDTH || hash_bits < 1
        || hash_bits > 24 || max_steps >= ((int64_t)1 << 31) || tcap < 1)
        return 1;
    int32_t* o = (int32_t*)out;
    for (int64_t b = 0; b < batch; ++b) {
        k5::Stream s;
        s.data = (const uint8_t*)data + b * n;
        s.n = n;
        s.run_ends = (const int32_t*)run_ends + b * nrun;
        s.nrun = nrun;
        s.size = ((const int32_t*)sizes)[b];
        s.dict_size = ((const int32_t*)dict_sizes)[b];
        s.hash_bits = hash_bits;
        s.hash_width = hash_width;
        s.good_len = good_len;
        s.lazy = lazy;
        s.ht2 = (int32_t*)ht2 + b * k5::HT2_SIZE;
        s.ht3 = (int32_t*)ht3 + b * k5::HT3_SIZE;
        s.ht6 = (int32_t*)ht6 + b * ((int64_t)hash_width << hash_bits);
        s.tape = (int32_t*)tape + b * 2 * tcap;
        s.tcap = tcap;
        s.max_steps = max_steps;
        const k5::Result r = k5::parse_stream(s);
        o[0 * batch + b] = r.tok_cnt;
        o[1 * batch + b] = r.done;
        o[2 * batch + b] = r.err;
        o[3 * batch + b] = r.steps;
    }
    return 0;
}
