// Test-only host build of K4's per-stream parser (encode_k4.cuh) with g++.
// It runs the kernel's parse logic on the CPU, stream after stream, the
// 32 lanes of the warp in loops, so the CPU tests can hold it against the
// plain PyTorch version.  Not on any encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k4_host.cpp -o libk4host.so
#include <vector>

#include "encode_k4.cuh"

// Same arguments and outputs as csc_k4_launch in encode_k4.cu, with host
// pointers and no stream, and one more: a stream of n <= stage_max bytes
// is staged as words, as the kernel stages one of at most 64 KB; a
// longer one is read as bytes.  Each stream's window starts with its
// ring keys at 0, as in the kernel.
extern "C" int csc_k4_host(
    const void* data, const void* cand, int64_t n, int32_t ncand,
    const void* run_ends, const void* run_skip, int32_t nrun,
    const void* sizes, const void* dict_sizes, int32_t good_len,
    const void* prices, void* tape, int64_t tcap, int64_t max_steps,
    void* cells, void* out, int32_t batch, int64_t stage_max) {
    if (ncand > k4::MAX_CAND || good_len > k4::MAX_GOOD_LEN || good_len < 2
        || n >= (int64_t)1 << 31)
        return 1;
    std::vector<k4::Rep4> win(k4::WINDOW_BYTES / sizeof(k4::Rep4));
    std::vector<uint32_t> words((n + 3) / 4 + k4::WORDS_PAD);
    int32_t* o = (int32_t*)out;
    for (int64_t b = 0; b < batch; ++b) {
        k4::Stream s;
        s.data = (const uint8_t*)data + b * n;
        s.words = nullptr;
        if (n <= stage_max) {
            for (int64_t i = 0; i < (int64_t)words.size(); ++i) {
                uint32_t v = 0;
                for (int k = 0; k < 4; ++k)
                    if (4 * i + k < n)
                        v |= (uint32_t)s.data[4 * i + k] << (8 * k);
                words[i] = v;
            }
            s.words = words.data();
        }
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
        s.max_steps = max_steps;
        s.cells = cells ? (int32_t*)cells + b * k4::CELL_ROWS * n : nullptr;
        s.pr = k4::prices_at((const int32_t*)prices);
        s.win = k4::window_at(win.data());
        for (int i = 0; i < k4::RING; ++i) s.win.key(i) = 0;
        k4::Result r = k4::parse_stream(s);
        o[0 * batch + b] = r.tok_cnt;
        o[1 * batch + b] = r.done;
        o[2 * batch + b] = r.err;
        o[3 * batch + b] = r.finds;
    }
    return 0;
}
