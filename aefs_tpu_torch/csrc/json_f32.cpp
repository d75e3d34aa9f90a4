// The reply's float arrays as JSON text: "[v0,v1,...]", each value as
// printf's "%.5g" writes (double)v, NaN and +-inf as 0.  Host C++, built
// with g++ by engine/jsonfmt.py (a .cpp, so the kernels' nvcc build never
// sees it), and byte-identical to native/aefs_native.cpp:json_f32_array,
// which calls snprintf once a value (~300 ns: glibc's general
// multi-precision path).
//
// A finite nonzero float is |v| = m 2^e with m < 2^24.  "%.5g" rounds it to
// five significant digits, half to even on the exact binary value: with E
// = floor(log10 |v|) and k = 4 - E, N = round(m 2^e 10^k) lies in
// [10^4, 10^5].  Here that is integer arithmetic:
//   k >= 0: m 5^k 2^(e+k), a product below 2^122 for every normal float
//           (k <= 42), shifted right by -(e+k) with the remainder held
//           against the half;
//   k < 0:  m 2^e / 10^-k, a 64-bit division (|v| < 1e9, so -k <= 5) with
//           the remainder doubled against the divisor.
// E is first taken one too high at most, from e alone; a quotient under
// 10^4 takes it one down.  N = 10^5 carries to E + 1.  Then "%g" style: fixed
// notation with 4 - E decimals when -4 <= E < 5, else d.dddde+XX (two
// exponent digits at least), trailing zeros and a bare point dropped.
// Subnormals and |v| >= 1e9 are handed to snprintf itself, and counted.
//
// An array of at least SPLIT values is formatted in PIECES slices per
// thread, which the threads (the caller among them) take in turn from a
// shared counter: a thread that starts late or loses its core holds up one
// slice, not a fixed share of the array.  Slice i writes its text (commas
// inside it) into its own region of 16 bytes a value of the output, and
// the regions are then moved together with a comma between.  Shorter
// arrays run on the calling thread.
//
// aefs_json_reply writes a whole reply into one buffer in one call: a list
// of segments, each verbatim text, a float32 array in "%.5g" (the above),
// or a 2-D float32 array as json.dumps writes the Python floats of its
// .tolist(): float.__repr__ of each (double)v, whose shortest
// round-trip digits come from std::to_chars, laid out as Python lays them
// out (fixed for decimal exponents -4 to 15, with ".0" on integral values;
// else d.ddde-05 / e+16), NaN and +-inf as NaN, Infinity, -Infinity, and
// ", " between items.  aefs_json_plain tells whether a string's bytes go
// into JSON as they are.

#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <system_error>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

constexpr int64_t SPLIT = 1 << 16;
constexpr int64_t PIECES = 8;  // slices a thread
constexpr uint64_t P10[] = {1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull};

// 5^k, k = 0 .. 42 (5^42 < 2^98).
struct Pow5 {
    u128 v[43];
    constexpr Pow5() : v() {
        v[0] = 1;
        for (int k = 1; k < 43; ++k) v[k] = v[k - 1] * 5;
    }
};
constexpr Pow5 POW5;

// floor(|v| 10^k) and whether the dropped part is above, at or below a
// half (+1, 0, -1); |v| = m 2^e, k >= 0, a normal float.
inline uint64_t scale_up(uint32_t m, int e, int k, int* cmp) {
    u128 p = (u128)m * POW5.v[k];
    int sh = -(e + k);
    if (sh <= 0) {  // an integer: nothing dropped
        *cmp = -1;
        return (uint64_t)(p << -sh);
    }
    u128 q = p >> sh;
    u128 r = p - (q << sh);
    u128 half = (u128)1 << (sh - 1);
    *cmp = r > half ? 1 : (r == half ? 0 : -1);
    return (uint64_t)q;
}

// The same for k < 0 and |v| < 1e9.
inline uint64_t scale_down(uint32_t m, int e, int k, int* cmp) {
    uint64_t num = (uint64_t)m, den = P10[-k];
    if (e >= 0) num <<= e; else den <<= -e;
    uint64_t q = num / den, r2 = 2 * (num - q * den);
    *cmp = r2 > den ? 1 : (r2 == den ? 0 : -1);
    return q;
}

inline char* put_exp(char* p, int E) {
    *p++ = 'e';
    *p++ = E < 0 ? '-' : '+';
    unsigned a = E < 0 ? -E : E;  // < 100 on this path
    *p++ = (char)('0' + a / 10);
    *p++ = (char)('0' + a % 10);
    return p;
}

// One value's text at p; returns its end.  Adds 1 to *fallbacks when the
// value went to snprintf.
inline char* format_one(float v, char* p, int64_t* fallbacks) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    bool neg = bits >> 31;
    int ef = (bits >> 23) & 0xff;
    uint32_t frac = bits & 0x7fffff;
    if (ef == 0xff) {  // NaN or +-inf -> 0 (valid JSON)
        *p++ = '0';
        return p;
    }
    if (ef == 0 && frac == 0) {
        if (neg) *p++ = '-';
        *p++ = '0';
        return p;
    }
    if (ef == 0 || (bits & 0x7fffffff) >= 0x4e6e6b28u) {  // subnormal, or >= 1e9
        ++*fallbacks;
        return p + snprintf(p, 16, "%.5g", (double)v);
    }
    uint32_t m = frac | (1u << 23);
    int e = ef - 150;
    // |v| < 2^(e+24): E <= floor((e+24) log10 2), at most one above.
    int E = ((e + 24) * 78913) >> 18;
    int cmp;
    uint64_t N;
    for (;;) {
        int k = 4 - E;
        N = k >= 0 ? scale_up(m, e, k, &cmp) : scale_down(m, e, k, &cmp);
        if (N >= 10000) break;
        --E;
    }
    if (cmp > 0 || (cmp == 0 && (N & 1))) ++N;
    if (N == 100000) {
        N = 10000;
        ++E;
    }
    char d[5];
    for (int i = 4; i >= 0; --i) {
        d[i] = (char)('0' + N % 10);
        N /= 10;
    }
    int last = 4;  // the last digit kept: trailing zeros go
    while (d[last] == '0') --last;
    if (neg) *p++ = '-';
    if (E >= -4 && E < 5) {
        if (E >= 0) {
            std::memcpy(p, d, E + 1);
            p += E + 1;
            if (last > E) {
                *p++ = '.';
                std::memcpy(p, d + E + 1, last - E);
                p += last - E;
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -E - 1; ++i) *p++ = '0';
            std::memcpy(p, d, last + 1);
            p += last + 1;
        }
        return p;
    }
    *p++ = d[0];
    if (last > 0) {
        *p++ = '.';
        std::memcpy(p, d + 1, last);
        p += last;
    }
    return put_exp(p, E);
}

// data[0..n) as "v0,v1,..." at p; returns its end.
char* format_run(const float* data, int64_t n, char* p, int64_t* fallbacks) {
    for (int64_t i = 0; i < n; ++i) {
        if (i) *p++ = ',';
        p = format_one(data[i], p, fallbacks);
    }
    return p;
}

// The longest text repr_one writes: "-1.2345678901234567e-45".
constexpr int REPR_MAX = 24;

// One value as json.dumps writes float((double)v); returns its end.
inline char* repr_one(float v, char* p) {
    double d = v;
    if (std::isnan(d)) {
        std::memcpy(p, "NaN", 3);
        return p + 3;
    }
    if (std::signbit(d)) {
        *p++ = '-';
        d = -d;
    }
    if (std::isinf(d)) {
        std::memcpy(p, "Infinity", 8);
        return p + 8;
    }
    if (d == 0) {
        std::memcpy(p, "0.0", 3);
        return p + 3;
    }
    // The shortest digits, as d[.ddd]e(+|-)XX.
    char s[32];
    const char* end = std::to_chars(s, s + sizeof s, d, std::chars_format::scientific).ptr;
    char digits[20];
    int n = 0;
    const char* q = s;
    for (; *q != 'e'; ++q)
        if (*q != '.') digits[n++] = *q;
    int E = 0;
    for (const char* r = q + 2; r < end; ++r) E = 10 * E + (*r - '0');
    if (q[1] == '-') E = -E;
    if (E < -4 || E > 15) {  // d.ddde-05, d.ddde+16
        *p++ = digits[0];
        if (n > 1) {
            *p++ = '.';
            std::memcpy(p, digits + 1, n - 1);
            p += n - 1;
        }
        *p++ = 'e';
        *p++ = E < 0 ? '-' : '+';
        unsigned a = E < 0 ? -E : E;
        if (a >= 100) {
            *p++ = (char)('0' + a / 100);
            a %= 100;
        }
        *p++ = (char)('0' + a / 10);
        *p++ = (char)('0' + a % 10);
        return p;
    }
    if (E < 0) {  // 0.000ddd
        *p++ = '0';
        *p++ = '.';
        for (int i = 0; i < -E - 1; ++i) *p++ = '0';
        std::memcpy(p, digits, n);
        return p + n;
    }
    int whole = E + 1;  // digits before the point
    if (n <= whole) {   // integral: ddd00.0
        std::memcpy(p, digits, n);
        p += n;
        for (int i = n; i < whole; ++i) *p++ = '0';
        *p++ = '.';
        *p++ = '0';
        return p;
    }
    std::memcpy(p, digits, whole);
    p += whole;
    *p++ = '.';
    std::memcpy(p, digits + whole, n - whole);
    return p + n - whole;
}

// x[0..n) as json.dumps writes a list of their Python floats: "[a, b]".
char* repr_list(const float* x, int64_t n, char* p) {
    *p++ = '[';
    for (int64_t i = 0; i < n; ++i) {
        if (i) {
            *p++ = ',';
            *p++ = ' ';
        }
        p = repr_one(x[i], p);
    }
    *p++ = ']';
    return p;
}

inline int64_t now_ns() {
    timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);  // time.perf_counter_ns's clock
    return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}

enum : int32_t { SEG_TEXT = 0, SEG_REPR = 1, SEG_G5 = 2 };

}  // namespace

extern "C" int64_t aefs_json_f32_array(const float* data, int64_t n, char* out, int threads,
                                       int64_t* fallbacks, int64_t* slices);

extern "C" {

// 1 when s[0..n) is printable ASCII without '"' and '\' (json.dumps
// writes such a string as it is, between quotes), else 0.
int aefs_json_plain(const unsigned char* s, int64_t n) {
    unsigned char bad = 0;  // bytes throughout, so the loop vectorizes
    for (int64_t i = 0; i < n; ++i) {
        unsigned char c = s[i];
        bad |= (unsigned char)((unsigned char)(c - 0x20) > 0x5e) | (c == '"') | (c == '\\');
    }
    return !bad;
}

// The bytes one segment may take: the bound aefs_json_reply's caller
// sizes its output by.
int64_t aefs_json_bound(int32_t kind, int64_t d0, int64_t d1) {
    switch (kind) {
        case SEG_TEXT: return d0;
        case SEG_REPR: return d0 * (d1 * (REPR_MAX + 2) + 4) + 2;
        case SEG_G5: return d0 * 16 + 3;
    }
    return -1;
}

// Write `count` segments one after another into out, which holds the sum
// of their aefs_json_bound; segment i is kinds[i] over data[i] with dims
// dims[2i], dims[2i+1]:
//   SEG_TEXT  d0 bytes, copied;
//   SEG_REPR  a (d0, d1) row-major float32 array as json.dumps writes its
//             list of lists;
//   SEG_G5    d0 float32s as aefs_json_f32_array writes them, over up to
//             `threads` threads.
// Returns the bytes written.  stats gets the SEG_G5 segments' fallbacks
// and slices (summed), and the CLOCK_MONOTONIC ns at the start of the
// first SEG_G5 and at the end of the last (0, 0 without one).
int64_t aefs_json_reply(int64_t count, const int32_t* kinds, const void* const* data,
                        const int64_t* dims, char* out, int threads, int64_t* stats) {
    char* p = out;
    stats[0] = stats[1] = stats[2] = stats[3] = 0;
    for (int64_t i = 0; i < count; ++i) {
        int64_t d0 = dims[2 * i], d1 = dims[2 * i + 1];
        const float* x = (const float*)data[i];
        switch (kinds[i]) {
            case SEG_TEXT:
                if (d0) std::memcpy(p, data[i], d0);
                p += d0;
                break;
            case SEG_REPR:
                *p++ = '[';
                for (int64_t r = 0; r < d0; ++r) {
                    if (r) {
                        *p++ = ',';
                        *p++ = ' ';
                    }
                    p = repr_list(x + r * d1, d1, p);
                }
                *p++ = ']';
                break;
            case SEG_G5: {
                if (!stats[2]) stats[2] = now_ns();
                int64_t fb, sl;
                p += aefs_json_f32_array(x, d0, p, threads, &fb, &sl);
                stats[0] += fb;
                stats[1] += sl;
                stats[3] = now_ns();
                break;
            }
        }
    }
    return (int64_t)(p - out);
}

// Serialize n float32s as "[v0,v1,...]" into out, which holds at least
// n*16 + 3 bytes, over up to `threads` threads (1 below SPLIT values; at
// most 64), in PIECES slices a thread (so no slice is empty).
// Returns the bytes written, the NUL left out; *fallbacks gets the values
// handed to snprintf and *slices the slices used.
int64_t aefs_json_f32_array(const float* data, int64_t n, char* out, int threads,
                            int64_t* fallbacks, int64_t* slices) {
    int64_t t = (n >= SPLIT && threads > 1) ? (threads < 64 ? threads : 64) : 1;
    int64_t s = t > 1 ? t * PIECES : 1;
    std::vector<char*> ends(s);
    std::vector<int64_t> fb(s, 0);
    auto lo = [&](int64_t i) { return n * i / s; };
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        for (int64_t i; (i = next.fetch_add(1, std::memory_order_relaxed)) < s;)
            ends[i] = format_run(data + lo(i), lo(i + 1) - lo(i), out + 1 + lo(i) * 16, &fb[i]);
    };
    std::vector<std::thread> pool;
    try {
        for (int64_t k = 1; k < t; ++k) pool.emplace_back(work);
    } catch (const std::system_error&) {  // no thread to be had: no exception
    }                                      // may leave this C entry point
    work();
    for (auto& th : pool) th.join();
    out[0] = '[';
    char* p = ends[0];
    *fallbacks = fb[0];
    for (int64_t i = 1; i < s; ++i) {
        char* start = out + 1 + lo(i) * 16;
        *p++ = ',';
        std::memmove(p, start, ends[i] - start);
        p += ends[i] - start;
        *fallbacks += fb[i];
    }
    *p++ = ']';
    *p = '\0';
    *slices = s;
    return (int64_t)(p - out);
}

}  // extern "C"
