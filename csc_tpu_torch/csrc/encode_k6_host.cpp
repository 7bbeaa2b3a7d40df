// Test-only host build of K6's per-stream parser (encode_k6.cuh) with g++.
// It runs the kernel's parse logic on the CPU, stream after stream, the
// 32 lanes of the warp in loops, so the CPU tests can hold it against the
// plain version.  Not on any encode path.
//
//   g++ -O2 -std=c++17 -shared -fPIC encode_k6_host.cpp -o libk6host.so
#include <vector>

#include "encode_k6.cuh"

// the model a stream leaves, as csc_k6_host_staged writes it to `model`:
// the small trees, p_lit, the length cache, then state, ctx and the
// cache's counter
constexpr int64_t MODEL_WORDS = k6::M_SMALL + k6::NLIT + 32 + 3;

// Same arguments and outputs as csc_k6_launch in encode_k6.cu, with host
// pointers and no stream (btypes zeros; the p_lit and cell scratch made
// here), and two more: a stream of n <= stage_max bytes is staged as
// words (STAGE_PAD zero words after it), as the kernel stages one of at
// most k5::STAGE_MAX bytes, a longer one read from its bytes; `model`
// [B, MODEL_WORDS] int32, when not null, gets the model each stream
// leaves.
extern "C" int csc_k6_host_staged(
    const void* data, int64_t n, const void* blocks, int32_t nblk,
    const void* sizes, const void* dict_sizes, int32_t hash_bits,
    int32_t hash_width, int32_t good_len, const void* p2b, void* ht2,
    void* ht3, void* ht6, void* tape, int64_t tcap, void* out,
    void* btypes, int32_t batch, int64_t stage_max, void* model) {
    if (hash_width < 1 || hash_width > k5::MAX_WIDTH || hash_bits < 1
        || hash_bits > 24 || good_len < 2 || good_len > k6::MAX_GOOD
        || tcap < 1 || nblk < 1)
        return 1;
    std::vector<uint32_t> words((n + 3) / 4 + k5::STAGE_PAD);
    std::vector<uint16_t> small(k6::M_SMALL), lit(k6::NLIT);
    std::vector<uint16_t> table((const uint16_t*)p2b,
                                (const uint16_t*)p2b + k6::NP2B);
    std::vector<int32_t> lenp(32), cells(k6::NFIELD * k6::CELLS);
    int32_t* o = (int32_t*)out;
    for (int64_t b = 0; b < batch; ++b) {
        k6::Stream x;
        k5::Stream& s = x.s;
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
        s.blocks = (const int32_t*)blocks + b * 2 * nblk;
        s.nblk = nblk;
        s.btypes = (int32_t*)btypes + b * nblk;
        s.size = ((const int32_t*)sizes)[b];
        s.dict_size = ((const int32_t*)dict_sizes)[b];
        if (s.size > s.dict_size) return 1;
        s.hash_bits = hash_bits;
        s.hash_width = hash_width;
        s.good_len = good_len;
        s.lazy = 0;
        s.ht2 = (int32_t*)ht2 + b * k5::HT2_SIZE;
        s.ht3 = (int32_t*)ht3 + b * k5::HT3_SIZE;
        s.ht6 = (int32_t*)ht6 + b * ((int64_t)hash_width << hash_bits);
        s.tape = (int32_t*)tape + b * 2 * tcap;
        s.tcap = tcap;
        s.max_steps = 0;
        x.small = small.data();
        x.lenp = lenp.data();
        x.p2b = table.data();
        x.lit = lit.data();
        x.cells = cells.data();
        k6::Result r;
        int32_t regs[3];
        if (s.words)
            r = k6::parse_stream<true>(x, regs);
        else
            r = k6::parse_stream<false>(x, regs);
        if (model) {
            int32_t* m = (int32_t*)model + b * MODEL_WORDS;
            for (int32_t i = 0; i < k6::M_SMALL; ++i) *m++ = small[i];
            for (int32_t i = 0; i < k6::NLIT; ++i) *m++ = lit[i];
            for (int32_t i = 0; i < 32; ++i) *m++ = lenp[i];
            for (int32_t i = 0; i < 3; ++i) *m++ = regs[i];
        }
        o[0 * batch + b] = r.tok_cnt;
        o[1 * batch + b] = r.done;
        o[2 * batch + b] = r.err;
    }
    return 0;
}

// csc_k6_host_staged with the kernel's own staging rule.
extern "C" int csc_k6_host(
    const void* data, int64_t n, const void* blocks, int32_t nblk,
    const void* sizes, const void* dict_sizes, int32_t hash_bits,
    int32_t hash_width, int32_t good_len, const void* p2b, void* ht2,
    void* ht3, void* ht6, void* tape, int64_t tcap, void* out,
    void* btypes, int32_t batch) {
    return csc_k6_host_staged(data, n, blocks, nblk, sizes, dict_sizes,
                              hash_bits, hash_width, good_len, p2b, ht2,
                              ht3, ht6, tape, tcap, out, btypes, batch,
                              k5::STAGE_MAX, nullptr);
}
