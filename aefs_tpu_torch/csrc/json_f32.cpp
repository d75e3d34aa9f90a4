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
// An array of at least SPLIT values is formatted in slices, one thread
// each: slice i writes its text (commas inside it) into its own region of
// 16 bytes a value of the output, and the regions are then moved together
// with a comma between.  Shorter arrays run on the calling thread.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

constexpr int64_t SPLIT = 1 << 16;
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

}  // namespace

extern "C" {

// Serialize n float32s as "[v0,v1,...]" into out, which holds at least
// n*16 + 3 bytes, over up to `threads` threads (1 below SPLIT values; at
// most 64, so no slice is empty).
// Returns the bytes written, the NUL left out; *fallbacks gets the values
// handed to snprintf and *slices the slices used.
int64_t aefs_json_f32_array(const float* data, int64_t n, char* out, int threads,
                            int64_t* fallbacks, int64_t* slices) {
    int64_t s = (n >= SPLIT && threads > 1) ? (threads < 64 ? threads : 64) : 1;
    std::vector<char*> ends(s);
    std::vector<int64_t> fb(s, 0);
    auto lo = [&](int64_t i) { return n * i / s; };
    auto slice = [&](int64_t i) {
        ends[i] = format_run(data + lo(i), lo(i + 1) - lo(i), out + 1 + lo(i) * 16, &fb[i]);
    };
    if (s == 1) {
        slice(0);
    } else {
        std::vector<std::thread> pool;
        int64_t started = 1;
        try {
            for (; started < s; ++started) pool.emplace_back(slice, started);
        } catch (const std::system_error&) {  // no thread to be had: no exception
        }                                      // may leave this C entry point
        for (int64_t i = started; i < s; ++i) slice(i);
        slice(0);
        for (auto& t : pool) t.join();
    }
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
