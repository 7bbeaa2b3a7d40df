// Test-only host build of the spike probes' step code (spike_common.cuh)
// with g++.  It runs a probe on the CPU stream after stream, as layout a
// does on the card, so the CPU tests can hold it against the plain PyTorch
// version.  Not on any measurement path.
//
//   g++ -O2 -std=c++17 -shared -fPIC spike_host.cpp -o libspikehost.so
#include <cstring>
#include <vector>

#include "spike_common.cuh"

namespace spk {

template <class P> int host_run(const Args& a) {
    std::vector<V16> smem((smem_bytes<P>(a, 1) + 15) / 16 + 1);
    for (int32_t b = 0; b < a.n; ++b) {
        const Ctx c = make_ctx<P>(a, b, 0, 1, (unsigned char*)smem.data());
        typename P::S s;
        P::init(a, c, s);
        for (int32_t i = 0; i < *a.steps; ++i) P::step(a, c, s, i);
        P::fini(a, c, s);
    }
    return 0;
}

#define SPK_HOST(file)                                                  \
    namespace file {                                                    \
    template <int K> int host(int kid, const Args& a) {                 \
        if constexpr (K == COUNT) {                                     \
            return -1;                                                  \
        } else {                                                        \
            if (kid == K) return host_run<typename Pick<K>::type>(a);   \
            return host<K + 1>(kid, a);                                 \
        }                                                               \
    }                                                                   \
    }
SPK_HOST(carry) SPK_HOST(dma) SPK_HOST(gather) SPK_HOST(marginal)
SPK_HOST(mxu_stage) SPK_HOST(pallas) SPK_HOST(pallas2) SPK_HOST(pallas3)
SPK_HOST(regops) SPK_HOST(roofline)

}  // namespace spk

// Same arguments as spike_<file>_launch with host pointers, the spike
// file's name in place of the stream, layout a only.  Returns -1 for an
// unknown file or probe.
extern "C" int spike_host_run(const char* file, int kid, int n,
                              const void* steps, void* p0, void* p1,
                              void* p2, void* p3, void* p4, void* p5,
                              void* p6, void* p7, int64_t q0, int64_t q1,
                              int64_t q2, int64_t q3, int64_t q4,
                              int64_t q5) {
    using namespace spk;
    Args a{(const int32_t*)steps, {p0, p1, p2, p3, p4, p5, p6, p7},
           {q0, q1, q2, q3, q4, q5}, n, 0};
#define SPK_TRY(f) if (!strcmp(file, #f)) return f::host<0>(kid, a);
    SPK_TRY(carry) SPK_TRY(dma) SPK_TRY(gather) SPK_TRY(marginal)
    SPK_TRY(mxu_stage) SPK_TRY(pallas) SPK_TRY(pallas2) SPK_TRY(pallas3)
    SPK_TRY(regops) SPK_TRY(roofline)
    return -1;
}
