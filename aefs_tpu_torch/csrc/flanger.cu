// Kernel K6: the regenerative flanger's line solve in one launch
// (flanger_file), for a whole file or a streaming step.
//
// Replaces no TPU kernel: the JAX package solves a block with XLA matmuls
// (aefs_tpu/models/flanger.py, no pallas_call): per chunk of 256 samples a
// dense one-hot tap operator, iterated or squared, and dependent matvecs.
// In eager PyTorch that form was ~129,000 launches for an 18.6 s stereo
// file, each a few microseconds of the card against ~18 us of the host.
// Underneath is a scalar recurrence per (file or slot, channel) row:
//
//   tap[n] = ((w0[n] v[p] + w1[n] v[p+1]) + w2[n] v[p+2]) + w3[n] v[p+3],
//            p = n - ca[n] - 1 (v before the block is the state's history)
//   v[n]   = x[n] + fb[r] tap[n]                    (the delay line)
//   y[n]   = (1 - mix[r]) x[n] + mix[r] tap[n]
//
// and, since ca >= 24 (ops/kernels/flanger.py:D_MIN), its nearest read is
// at least 22 samples back.  So any stretch of L <= min(ca) - 2 consecutive
// samples reads only v from before the stretch, and its L samples are
// computed at once.
//
// One warp per row.  The row's v lives in a ring in shared memory (a
// power of two >= H + 32 floats, seeded from the history); the operands
// (x, ca and the four weights) arrive a tile of 512 samples at a time by
// cp.async, three tiles in flight, so device memory's latency stays off
// the chain.  (Without the staging, each lane reading its next stretch's
// operands from device memory one stretch ahead, the same bits took 13.9
// ms against 5.24 ms for 2 x 892,928 samples on an H100: the loads'
// latency, not the stretch's work, then sets the pace.)  Per tile the
// warp takes the least ca of the tile and walks it in stretches of
// L = min(32, least ca - 2) samples: lane j computes
// sample n0 + j from four ring reads, writes v to the ring, y and v to
// device memory, then the warp syncs.  The next stretch's operands are
// read from the tile before that sync, so a stretch's critical path is
// the ring reads, the tap's three adds, v and the store.
//
// Exactness: the plain version (ops/kernels/flanger.py:flanger_file_plain)
// is the same recurrence in eager ops, each rounding once, in this order;
// the library builds with -fmad=false, so the two agree bit for bit.  How
// the samples are grouped into stretches changes no sample's arithmetic.
//
// What bounds it on the H100: not bytes (32 bytes a sample, 57 MB for
// 2 x 892,928 samples: 17 us at 3.35 TB/s) nor operations (~12 a sample),
// but the chain of dependent stretches: at least n / 32 of them a row
// (27,904 at the demo's length), each a shared-memory round trip, the
// tap's dependent adds, v, and a warp sync, ~65 instructions issued by
// one warp: 5.3 ms, ~190 ns a stretch, for 2 x 892,928 samples.  Moving
// the y and v stores off the chain (staged, written after each tile) took
// 7% off, so they are not what binds.  Rows are independent warps, so F
// files and C channels take no longer than one row while they fit on the
// card.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;       // samples of operands a stage holds
constexpr int kStages = 3;       // tiles in flight
constexpr int kOperands = 6;     // x, ca, w0..w3
constexpr int kMaxRing = 16384;  // floats: a history up to 16,352 samples
constexpr unsigned kFull = 0xffffffffu;

// Stage the operands of tile ``t`` of row ``off`` into stage buffer ``st``
// (x, ca, w0, w1, w2, w3, kTile each) in 16-byte copies: n is a multiple
// of 4 and x, ca and w start on 16-byte boundaries (the entry checks).
__device__ __forceinline__ void stage_tile(float* st, const float* x, const int* ca,
                                           const float* w, long long off, long long plane,
                                           int n, int t, int lane) {
  const int b = t * kTile;
  const int len = min(kTile, n - b);
  const long long g = off + b;
  for (int j = 4 * lane; j < len; j += 128) {
    __pipeline_memcpy_async(st + j, x + g + j, 16);
    __pipeline_memcpy_async(st + kTile + j, ca + g + j, 16);
    for (int k = 0; k < 4; ++k)
      __pipeline_memcpy_async(st + (2 + k) * kTile + j, w + k * plane + g + j, 16);
  }
}

// x, ca, y, v (rows, n); w (4, rows, n); hist (rows, h); fb, mix (rows).
// One warp per row; dynamic shared memory: the ring (mask + 1 floats),
// then kStages stage buffers of kOperands * kTile words.
__global__ void __launch_bounds__(32) flanger_file_kernel(
    const float* __restrict__ x, const int* __restrict__ ca, const float* __restrict__ w,
    const float* __restrict__ fb_p, const float* __restrict__ mix_p,
    const float* __restrict__ hist, float* __restrict__ y, float* __restrict__ v,
    int rows, int n, int h, int mask) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* stages = smem + mask + 1;
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const long long off = (long long)r * n;
  const long long plane = (long long)rows * n;
  const float fb = fb_p[r];
  const float mix = mix_p[r];
  const float dry = 1.0f - mix;

  // Ring position of stream sample q (history at 0..h-1, x[i] at h + i).
  for (int j = lane; j < h; j += 32) ring[j & mask] = hist[(long long)r * h + j];

  const int tiles = (n + kTile - 1) / kTile;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) stage_tile(stages + s * kOperands * kTile, x, ca, w, off, plane, n, s, lane);
    __pipeline_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int tn = t + kStages - 1;  // into the stage tile t - 1 left
    if (tn < tiles) stage_tile(stages + (tn % kStages) * kOperands * kTile, x, ca, w, off,
                               plane, n, tn, lane);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);  // this lane's copies of tile t
    __syncwarp();                        // and every lane's, and the ring's seed
    const float* sx = stages + (t % kStages) * kOperands * kTile;
    const int* sca = reinterpret_cast<const int*>(sx + kTile);
    const float* sw = sx + 2 * kTile;
    const int b = t * kTile;
    const int len = min(kTile, n - b);

    int least = INT_MAX;
    for (int j = lane; j < len; j += 32) least = min(least, sca[j]);
    least = __reduce_min_sync(kFull, least);
    const int span = max(1, min(32, least - 2));  // samples a stretch

    // Operands of this lane's sample in the first stretch.
    int j = lane;
    bool live = lane < span && j < len;
    float xv = 0.0f, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
    int p = 0;
    if (live) {
      xv = sx[j];
      p = h + b + j - sca[j] - 1;
      w0 = sw[j];
      w1 = sw[kTile + j];
      w2 = sw[2 * kTile + j];
      w3 = sw[3 * kTile + j];
    }
    for (int j0 = 0; j0 < len; j0 += span) {
      if (live) {
        const float v0 = ring[p & mask];
        const float v1 = ring[(p + 1) & mask];
        const float v2 = ring[(p + 2) & mask];
        const float v3 = ring[(p + 3) & mask];
        const float tap = ((w0 * v0 + w1 * v1) + w2 * v2) + w3 * v3;
        const float vn = xv + fb * tap;
        ring[(h + b + j) & mask] = vn;
        v[off + b + j] = vn;
        y[off + b + j] = dry * xv + mix * tap;
      }
      // The next stretch's operands, read before the sync that ends this one.
      j = j0 + span + lane;
      live = lane < span && j < len;
      if (live) {
        xv = sx[j];
        p = h + b + j - sca[j] - 1;
        w0 = sw[j];
        w1 = sw[kTile + j];
        w2 = sw[2 * kTile + j];
        w3 = sw[3 * kTile + j];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Kernel K6.  x (rows, n), ca (rows, n) int32, w (4, rows, n): the cubic
// tap weights; fb, mix (rows) float32 on the card, one value a row; hist
// (rows, h): the line signal before the block, oldest first.  Outputs y
// and v (rows, n).  Needs 24 <= ca <= h - 1 (the taps read from the
// history's first sample to 22 samples back); outside that the taps read
// stale ring entries.
// Refuses (cudaErrorInvalidValue) an n that is not a multiple of 4, or x,
// ca or w off a 16-byte boundary: the stages copy 16 bytes at a time.
// Launches on ``stream`` of ``device``; returns the CUDA error code (0 on
// success).
extern "C" int aefs_flanger_file(const float* x, const int* ca, const float* w,
                                 const float* fb, const float* mix, const float* hist,
                                 float* y, float* v, int rows, int n, int h, int device,
                                 cudaStream_t stream) {
  if (rows < 1 || n < 4 || n % 4 || h < 1 || h > kMaxRing - 32 || (long long)n + h > INT_MAX ||
      ((reinterpret_cast<unsigned long long>(x) | reinterpret_cast<unsigned long long>(ca) |
        reinterpret_cast<unsigned long long>(w)) & 15))
    return (int)cudaErrorInvalidValue;
  int ring = 64;
  while (ring < h + 32) ring *= 2;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  // 36 KB of stages and up to 64 KB of ring: over the 48 KB a block may
  // hold without the opt-in from a history of 2,017 samples (fs above
  // ~134 kHz, so at 192 kHz).
  const int smem = (ring + kStages * kOperands * kTile) * (int)sizeof(float);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, flanger_file_kernel);
  if (e == cudaSuccess && smem + (int)attr.sharedSizeBytes > attr.maxDynamicSharedSizeBytes)
    e = cudaFuncSetAttribute(flanger_file_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem + (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  flanger_file_kernel<<<rows, 32, smem, stream>>>(x, ca, w, fb, mix, hist, y, v, rows, n, h,
                                                  ring - 1);
  return (int)cudaGetLastError();
}
