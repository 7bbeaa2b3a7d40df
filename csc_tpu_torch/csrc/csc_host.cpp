// Native host runtime of csc_tpu_torch: content filters, checksums and the
// block analyzer, the host-side paths around the batched codec (the
// reference keeps them in C++ too: csc_filters.cpp, csa_adler32.cpp,
// csc_analyzer.cpp).  A copy of csc_tpu/native/csc_host.cpp, exposed via a
// C ABI for ctypes.
//
// Build: csc_tpu_torch/_build.py compiles it with g++ into build/ on first
// use (csc_tpu_torch/native.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Adler32 (zlib algorithm; archiver seeds with 0, csa_io.h:250)
// ---------------------------------------------------------------------
uint32_t csc_adler32(uint32_t prev, const uint8_t *buf, uint64_t n) {
    const uint32_t MOD = 65521;
    uint32_t s1 = prev & 0xFFFF;
    uint32_t s2 = (prev >> 16) & 0xFFFF;
    uint64_t i = 0;
    while (i < n) {
        // 5552 is the largest k with k*(k+1)/2*255 + k*65520 < 2^32
        uint64_t chunk = n - i < 5552 ? n - i : 5552;
        for (uint64_t j = 0; j < chunk; j++) {
            s1 += buf[i + j];
            s2 += s1;
        }
        s1 %= MOD;
        s2 %= MOD;
        i += chunk;
    }
    return s1 | (s2 << 16);
}

// ---------------------------------------------------------------------
// x86 E8/E9 call-target transform (Shelwien's algorithm; behavior matches
// csc_filters.cpp:508-610 bit for bit).
// State: two 32-bit shift registers forming an 8-byte pipeline, a mask of
// not-yet-valid slots, and a skip counter that prevents re-triggering
// inside a rewritten operand.
// ---------------------------------------------------------------------
struct E89State {
    uint32_t hi, lo;      // x0, x1: lookahead pipeline (newest in hi)
    uint8_t  vacant;      // cs: top bit set while the pipeline warms up
    uint32_t seen, gate;  // i, k: byte counter and retrigger gate
};

static inline void e89_reset(E89State &s) {
    s.vacant = 0xFF;
    s.hi = s.lo = 0;
    s.seen = 0;
    s.gate = 5;
}

static inline int32_t e89_push(E89State &s, int32_t c) {
    int32_t out = (s.vacant & 0x80) ? -1 : (int32_t)(s.lo & 0xFF);
    s.lo = (s.lo >> 8) | (s.hi << 24);
    s.hi = (s.hi >> 8) | ((uint32_t)c << 24);
    s.vacant <<= 1;
    s.seen++;
    return out;
}

static inline uint32_t e89_fwd_swap(uint32_t x) {
    x <<= 7;
    return (x >> 24) | (((x >> 16) & 0xFF) << 8) | (((x >> 8) & 0xFF) << 16)
           | ((x & 0xFF) << (24 - 7));
}

static inline uint32_t e89_inv_swap(uint32_t x) {
    x = (((x >> 24) & 0xFF) << 7) | (((x >> 16) & 0xFF) << 8)
        | (((x >> 8) & 0xFF) << 16) | (x << 24);
    return x >> 7;
}

static void e89_run(uint8_t *buf, uint64_t n, bool forward) {
    E89State s;
    e89_reset(s);
    uint64_t w = 0;
    for (uint64_t i = 0; i < n; i++) {
        if (s.seen >= s.gate && (s.lo & 0xFE000000u) == 0xE8000000u) {
            s.gate = s.seen + 4;
            uint32_t x = s.hi - 0xFF000000u;
            if (x < 0x02000000u) {
                if (forward) {
                    x = (x + s.seen) & 0x01FFFFFFu;
                    s.hi = e89_fwd_swap(x) + 0xFF000000u;
                } else {
                    x = (e89_inv_swap(x) - s.seen) & 0x01FFFFFFu;
                    s.hi = x + 0xFF000000u;
                }
            }
        }
        int32_t c = e89_push(s, buf[i]);
        if (c >= 0) buf[w++] = (uint8_t)c;
    }
    // drain (E89flush semantics: pad with zeros until the pipeline empties)
    while (s.vacant != 0xFF) {
        while (s.vacant & 0x80) {
            e89_push(s, 0);
            s.vacant++;
        }
        int32_t c = e89_push(s, 0);
        s.vacant++;
        if (c >= 0) buf[w++] = (uint8_t)c;
    }
}

void csc_e89_forward(uint8_t *buf, uint64_t n) { e89_run(buf, n, true); }
void csc_e89_inverse(uint8_t *buf, uint64_t n) { e89_run(buf, n, false); }

// ---------------------------------------------------------------------
// Channel delta transform (csc_filters.cpp:132-164, 371-398): de-interleave
// into chn channels, byte-delta with one running predecessor.
// ---------------------------------------------------------------------
void csc_delta_forward(uint8_t *buf, uint64_t n, uint32_t chn) {
    if (n < 512) return;
    std::vector<uint8_t> tmp(buf, buf + n);
    uint64_t w = 0;
    uint8_t prev = 0;
    for (uint32_t ch = 0; ch < chn; ch++)
        for (uint64_t j = ch; j < n; j += chn) {
            buf[w++] = (uint8_t)(tmp[j] - prev);
            prev = tmp[j];
        }
}

void csc_delta_inverse(uint8_t *buf, uint64_t n, uint32_t chn) {
    if (n < 512) return;
    std::vector<uint8_t> tmp(buf, buf + n);
    uint64_t r = 0;
    uint8_t prev = 0;
    for (uint32_t ch = 0; ch < chn; ch++)
        for (uint64_t j = ch; j < n; j += chn) {
            buf[j] = (uint8_t)(tmp[r++] + prev);
            prev = buf[j];
        }
}

// ---------------------------------------------------------------------
// English dictionary transform (csc_filters.cpp:256-368): a trie over the
// 123-word list maps common fragments to symbols 0x82.., escaping raw
// bytes >= 0x82 with 254.  Word list and thresholds are format spec.
// ---------------------------------------------------------------------
static const char *kWords[] = {
    "",
    "ac", "ad", "ai", "al", "am", "an", "ar", "as", "at", "ea",
    "ec", "ed", "ee", "el", "en", "er", "es", "et", "id", "ie",
    "ig", "il", "in", "io", "is", "it", "of", "ol", "on", "oo",
    "or", "os", "ou", "ow", "ul", "un", "ur", "us", "ba", "be",
    "ca", "ce", "co", "ch", "de", "di", "ge", "gh", "ha", "he",
    "hi", "ho", "ra", "re", "ri", "ro", "rs", "la", "le", "li",
    "lo", "ld", "ll", "ly", "se", "si", "so", "sh", "ss", "st",
    "ma", "me", "mi", "ne", "nc", "nd", "ng", "nt", "pa", "pe",
    "ta", "te", "ti", "to", "th", "tr", "wa", "ve",
    "all", "and", "but", "dow", "for", "had", "hav", "her",
    "him", "his", "man", "mor", "not", "now", "one", "out",
    "she", "the", "was", "wer", "whi", "whe", "wit", "you",
    "any", "are",
    "that", "said", "with", "have", "this", "from", "were", "tion",
};
enum { kNumWords = sizeof(kWords) / sizeof(kWords[0]) };

struct TrieNode {
    int32_t next[26];
    int32_t symbol;
};
static std::vector<TrieNode> g_trie;
static int32_t g_word_of_symbol[256];
static int32_t g_max_symbol = 0;

static void dict_init() {
    if (!g_trie.empty()) return;
    TrieNode root;
    memset(&root, -1, sizeof(root));
    root.symbol = 0;
    g_trie.push_back(root);
    memset(g_word_of_symbol, 0, sizeof(g_word_of_symbol));
    int32_t symbol = 0x82;
    for (int wi = 1; wi < kNumWords; wi++) {
        int pos = 0;
        for (const char *p = kWords[wi]; *p; p++) {
            int idx = *p - 'a';
            if (g_trie[pos].next[idx] < 0) {
                TrieNode n;
                memset(&n, -1, sizeof(n));
                n.symbol = 0;
                g_trie.push_back(n);
                g_trie[pos].next[idx] = (int32_t)g_trie.size() - 1;
            }
            pos = g_trie[pos].next[idx];
        }
        g_trie[pos].symbol = symbol;
        g_word_of_symbol[symbol] = wi;
        symbol++;
    }
    g_max_symbol = symbol;
}

// Returns 1 and rewrites buf in place (0x20-padded to n) when the
// substituted form shrinks below 82% of the original, else 0.
int32_t csc_dict_forward(uint8_t *buf, uint64_t n) {
    dict_init();
    if (n < 16384) return 0;
    std::vector<uint8_t> dst;
    dst.reserve(n);
    uint64_t i = 0;
    while (i + 5 < n) {
        if (dst.size() > n - 16) return 0;
        uint8_t c = buf[i];
        if (c >= 'a' && c <= 'z') {
            int32_t match_symbol = 0;
            uint64_t longest = 0;
            int pos = 0;
            uint64_t j = 0;
            for (;;) {
                int idx = (int)buf[i + j] - 'a';
                if (idx < 0 || idx > 25 || g_trie[pos].next[idx] < 0)
                    break;
                pos = g_trie[pos].next[idx];
                j++;
                if (g_trie[pos].symbol) {
                    match_symbol = g_trie[pos].symbol;
                    longest = j;
                }
            }
            if (match_symbol) {
                dst.push_back((uint8_t)match_symbol);
                i += longest;
                continue;
            }
            dst.push_back(c);
            i++;
        } else {
            if (c >= 0x82) dst.push_back(254);
            dst.push_back(c);
            i++;
        }
    }
    for (; i < n; i++) {
        uint8_t c = buf[i];
        if (c >= 0x82) dst.push_back(254);
        dst.push_back(c);
    }
    if ((double)dst.size() > (double)n * 0.82) return 0;
    memcpy(buf, dst.data(), dst.size());
    memset(buf + dst.size(), 0x20, n - dst.size());
    return 1;
}

void csc_dict_inverse(uint8_t *buf, uint64_t n) {
    dict_init();
    std::vector<uint8_t> dst;
    dst.reserve(n);
    uint64_t i = 0;
    while (dst.size() < n) {
        uint8_t c = buf[i];
        if (c >= 0x82 && c < g_max_symbol) {
            const char *w = kWords[g_word_of_symbol[c]];
            for (const char *p = w; *p && dst.size() < n; p++)
                dst.push_back((uint8_t)*p);
        } else if (c == 254 && i + 1 < n && buf[i + 1] >= 0x82) {
            i++;
            dst.push_back(buf[i]);
        } else {
            dst.push_back(c);
        }
        i++;
    }
    memcpy(buf, dst.data(), n);
}

// ---------------------------------------------------------------------
// Block analyzer (csc_analyzer.cpp:184-239): order-0 entropy with the
// integer-truncated log table + content heuristics.  Returns the block
// type; *bpb_out receives the integer bits-per-byte estimate x100.
// ---------------------------------------------------------------------
static uint32_t log_tbl[513];
static bool log_ready = false;

static void analyzer_init() {
    for (uint32_t i = 0; i < 512; i++)
        log_tbl[i] = (uint32_t)(100.0 * std::log((double)(i * 16 + 8))
                                / std::log(2.0));
    log_tbl[512] = (uint32_t)(100.0 * std::log(8192.0) / std::log(2.0));
    log_ready = true;
}

static int32_t channel_pick(const uint8_t *p, uint32_t n) {
    static const uint32_t strides[5] = {1, 2, 3, 4, 8};
    uint64_t same[5] = {0}, succ[5] = {0};
    for (uint32_t i = 0; i + 16 < n; i++)
        for (int k = 0; k < 5; k++) {
            uint8_t a = p[i], b = p[i + strides[k]];
            same[k] += (a == b);
            succ[k] += a > b ? a - b : b - a;
        }
    uint64_t min_same = same[0], max_succ = succ[0], min_succ = succ[0];
    int best = 0;
    for (int k = 0; k < 5; k++) {
        if (same[k] < min_same) min_same = same[k];
        if (succ[k] > max_succ) max_succ = succ[k];
        if (succ[k] < min_succ) { min_succ = succ[k]; best = k; }
    }
    if ((max_succ > succ[best] * 4 || max_succ > succ[best] + 40ull * n)
        && same[best] > min_same * 3 && same[0] < 0.3 * n)
        return best;
    return -1;
}

// type codes match csc_typedef.h
uint32_t csc_analyze(const uint8_t *p, uint32_t n, uint32_t *bpb_out) {
    if (!log_ready) analyzer_init();
    if (n > 8192) n = 8192;
    if (n < 512) return 0x1E;  // DT_SKIP

    uint32_t freq[256] = {0};
    for (uint32_t i = 0; i < n; i++) freq[p[i]]++;

    uint32_t diff = 0;
    uint64_t hi_half = 0;
    uint32_t entropy = n * log_tbl[n >> 4];
    for (int i = 0; i < 256; i++) {
        entropy -= freq[i] * log_tbl[freq[i] >> 4];
        diff += freq[i] > 0;
        if (i >= 128) hi_half += freq[i];
    }
    *bpb_out = entropy / n;
    uint32_t avg = n >> 8;

    uint32_t alpha = 0;
    for (int i = 'a'; i <= 'z'; i++) alpha += freq[i];

    if (hi_half < (n >> 3)
        && freq[' '] + freq['\n'] + freq[':'] + freq['.'] + freq['/'] > (n >> 4)
        && freq['a'] + freq['e'] + freq['t'] > (n >> 4)
        && entropy > 300u * n && alpha > n / 3)
        return 0x02;  // DT_ENGTXT
    if (freq[0x8B] > avg && freq[0x00] > avg * 2 && freq[0xE8] > 6)
        return 0x03;  // DT_EXE
    if (diff < 16 && diff >= 6
        && entropy > (std::log((double)diff - 2) / std::log(2.0) - 0.6)
                         * 100.0 * n)
        return 0x07;  // DT_ENTROPY
    if (entropy < 400u * n && diff < 200)
        return 0x01;  // DT_NORMAL
    int32_t dlt = channel_pick(p, n);
    if (dlt >= 0) return 0x10 + dlt;
    if (entropy > 795u * n) return 0x08;  // DT_BAD
    if (entropy > 780u * n) return 0x04;  // DT_FAST
    return 0x01;
}

}  // extern "C"
