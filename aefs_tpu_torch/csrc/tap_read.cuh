// The 4-point Hermite tap read shared by the octaver and chorus step
// kernels (csrc/resample.cu): the device form of
// ops/ringbuf.py:fractional_read_cubic, the reference's op order and its
// ring-wrap lanes.
//
//   ca = ceil(ago), frac = ca - ago
//   y0..y3 = ext[size + j - (ca + 1) .. + 3]   (clamped, ringbuf.py)
//   out = Hermite(frac; y0..y3)                (cubic_hermite's op order)
//
// on the stream ext = hist (size,) ++ x (n,), with the wrap lanes (ca <= 1
// or ca >= size - 1) reading ext[size - back + j] for back = (ca + offset)
// mod size in {0, 1, 2, size-3, size-2, size-1} (ringbuf._wrap_patch).
//
// Every read of output j lands in ext[j + 1 .. j + size] (the clamp never
// binds for 2 <= ca <= size - 2, and the wrap lanes read at most ``size``
// back), so a thread block that stages that window for its outputs can
// read it from shared memory.
//
// Build with -fmad=false: the plain version runs these products and sums
// as separate eager ops, and an FMA would make the two differ in the last
// ulp.
#pragma once

namespace aefs {

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

// One Hermite read at distance ``a`` for output sample j of a block of n;
// ``ext(i)`` returns element i of hist ++ x.
template <class Ext>
__device__ __forceinline__ float tap_read(const Ext& ext, int size, int n,
                                          int j, float a) {
  const float caf = ceilf(a);
  const float frac = caf - a;
  const int ca = (int)caf;
  if (ca <= 1 || ca >= size - 1) {
    return hermite(frac, ext(size - wrap_back(ca, 1, size) + j),
                   ext(size - wrap_back(ca, 0, size) + j),
                   ext(size - wrap_back(ca, -1, size) + j),
                   ext(size - wrap_back(ca, -2, size) + j));
  }
  int start = size + j - (ca + 1);
  start = start < 0 ? 0 : start;
  start = start > size + n - 4 ? size + n - 4 : start;
  return hermite(frac, ext(start), ext(start + 1), ext(start + 2),
                 ext(start + 3));
}

// A staged window of the stream: element i of hist ++ x at s[i - lo].
struct Window {
  const float* s;
  int lo;
  __device__ __forceinline__ float operator()(int i) const { return s[i - lo]; }
};

}  // namespace aefs
