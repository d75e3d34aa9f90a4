// Kernel K1: both octaver grain taps in one launch.
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/resample.py:_fused_kernel
// (entered through octaver_taps_fused <- ringbuf.fractional_read_resample2
// <- models/octaver.py).  The TPU kernel recasts the 4-tap read as a
// banded one-hot contraction per tile because gathers are slow there; on
// Hopper a direct gather is the natural form, so this kernel is one thread
// per (tap, output sample):
//
//   ca = ceil(ago), frac = ca - ago
//   y0..y3 = ext[size + n - (ca + 1) .. + 3]   (clamped, ringbuf.py:689)
//   out = Hermite(frac; y0..y3)                (cubic_hermite's op order)
//
// with ext = hist ++ x read through two pointers (no concatenation), and
// the reference's ring-boundary wrap lanes (ca <= 1 or ca >= size - 1)
// folded in: they read ext[size - j + n] for j = (ca + offset) mod size,
// j in {0, 1, 2, size-3, size-2, size-1} (ringbuf._wrap_patch).
//
// Build with -fmad=false: the plain version runs these products and sums
// as separate eager ops, and an FMA would make the two differ in the last
// ulp.  The double-single phase arithmetic that produces ``ago`` stays
// outside, in eager torch, for the same reason.
//
// What bounds it on the H100: at the streaming shape (N = 256 samples,
// size = 1920) it is 512 threads, 8 loads each, from a 9 KB stream that
// sits in L1/L2 — one tiny launch per block, bound by launch latency
// (a few microseconds), not by bytes or FLOPs.  A whole-file call
// (N ~ 10^6) is a gather over a stream that fits in L2, bound by the
// load path; neither case is worth tiling yet.
//
// Kernel K3: one stream's tap read, rows in one launch.
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/resample.py:_resample_kernel
// (entered through catmull_rom_resample <- ringbuf.fractional_read_resample).
// The TPU kernel anchors a window per tile and position cluster and
// evaluates the read as a one-hot band times the window, with its frac
// taken as qw - floor(qw) in window coordinates; the wrap lanes are patched
// outside by _wrap_patch.  Here it is the same gather as K1 (tap_read,
// frac = ceil(ago) - ago, wrap lanes folded in), one thread per (row,
// sample): equal to the plain gather bit for bit, within float rounding
// of the TPU kernel's band form.  Bound like K1: launch latency at the
// chorus's streaming shape (2 rows x 256), the load path at a whole file
// (2 rows x ~10^6, a 7 MB stream that fits in L2).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ext_at(const float* __restrict__ hist,
                                        const float* __restrict__ x,
                                        int size, int i) {
  return i < size ? hist[i] : x[i - size];
}

__device__ __forceinline__ float hermite(float frac, float y0, float y1,
                                         float y2, float y3) {
  const float c0 = y1;
  const float c1 = 0.5f * (y2 - y0);
  const float c2 = ((y0 - 2.5f * y1) + 2.0f * y2) - 0.5f * y3;
  const float c3 = 0.5f * (y3 - y0) + 1.5f * (y1 - y2);
  return ((c3 * frac + c2) * frac + c1) * frac + c0;
}

// Distance back (in samples from the block start) of a wrapped tap:
// floored (ca + off) mod size, kept only where the reference's patch has a
// static shift for it (every in-range ago lands in that set).
__device__ __forceinline__ int wrap_back(int ca, int off, int size) {
  int back = (ca + off) % size;
  if (back < 0) back += size;
  if (back == 1 || back == 2 || back == size - 3 || back == size - 2 ||
      back == size - 1)
    return back;
  return 0;
}

// One Hermite read at distance ``a`` for output sample j of a block of n
// on the stream hist (size,) ++ x (n,), with the reference's wrap lanes.
__device__ __forceinline__ float tap_read(const float* __restrict__ hist,
                                          const float* __restrict__ x,
                                          int size, int n, int j, float a) {
  const float caf = ceilf(a);
  const float frac = caf - a;
  const int ca = (int)caf;
  if (ca <= 1 || ca >= size - 1) {
    return hermite(frac,
                   ext_at(hist, x, size, size - wrap_back(ca, 1, size) + j),
                   ext_at(hist, x, size, size - wrap_back(ca, 0, size) + j),
                   ext_at(hist, x, size, size - wrap_back(ca, -1, size) + j),
                   ext_at(hist, x, size, size - wrap_back(ca, -2, size) + j));
  }
  int start = size + j - (ca + 1);
  start = start < 0 ? 0 : start;
  start = start > size + n - 4 ? size + n - 4 : start;
  return hermite(frac, ext_at(hist, x, size, start),
                 ext_at(hist, x, size, start + 1),
                 ext_at(hist, x, size, start + 2),
                 ext_at(hist, x, size, start + 3));
}

__global__ void octaver_taps_kernel(const float* __restrict__ hist,
                                    const float* __restrict__ x,
                                    const float* __restrict__ ago1,
                                    const float* __restrict__ ago2,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2, int size, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const int tap = t >= n;
  const int j = t - tap * n;
  (tap ? s2 : s1)[j] = tap_read(hist, x, size, n, j, (tap ? ago2 : ago1)[j]);
}

// Kernel K3: one stream's read per row, rows independent (the chorus reads
// both channels in one launch).  The flat (row, sample) index is 64-bit:
// rows * n reaches 2 x 892,800 for a whole-file render.
__global__ void fractional_read_kernel(const float* __restrict__ hist,
                                       const float* __restrict__ x,
                                       const float* __restrict__ ago,
                                       float* __restrict__ out, int rows,
                                       int size, int n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * n) return;
  const long long r = t / n;
  const int j = (int)(t - r * n);
  out[t] = tap_read(hist + r * size, x + r * n, size, n, j, ago[t]);
}

}  // namespace

// hist (size,), x (n,), ago1/ago2 (n,) float32 on the device; s1/s2 (n,)
// outputs.  Launches on ``stream``; returns cudaGetLastError().
extern "C" int aefs_octaver_taps(const float* hist, const float* x,
                                 const float* ago1, const float* ago2,
                                 float* s1, float* s2, int size, int n,
                                 cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (2 * n + threads - 1) / threads;
  octaver_taps_kernel<<<blocks, threads, 0, stream>>>(hist, x, ago1, ago2, s1,
                                                      s2, size, n);
  return (int)cudaGetLastError();
}

// Kernel K3.  hist (rows, size), x (rows, n), ago (rows, n) float32 on the
// device; out (rows, n).  Launches on ``stream``; returns cudaGetLastError().
extern "C" int aefs_fractional_read(const float* hist, const float* x,
                                    const float* ago, float* out, int rows,
                                    int size, int n, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)rows * n;
  const long long blocks = (total + threads - 1) / threads;
  if (rows < 1 || n < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fractional_read_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      hist, x, ago, out, rows, size, n);
  return (int)cudaGetLastError();
}
