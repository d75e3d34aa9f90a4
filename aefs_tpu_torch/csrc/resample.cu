// Kernel K1: the octaver's whole block step in one launch (octaver_step).
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/resample.py:_fused_kernel
// (entered through octaver_taps_fused <- ringbuf.fractional_read_resample2
// <- models/octaver.py), together with the double-single phase arithmetic
// that XLA fused around it there (ops/dsphase.py).  The TPU kernel recasts
// the two 4-tap reads as banded one-hot contractions because gathers are
// slow there; here the reads gather from shared memory.  One launch
// computes what Octaver.process computes, state included:
//
//   prologue (once per thread block, two threads): 2^(s/12) in double-
//     single (12 Horner steps), the step, its three stride levels, the
//     re-anchor test and the fold of the previous step over n_abs;
//   staging: the window of hist ++ mean(x) its outputs can reach;
//   per output sample: both grain phases (base-4096 digit ramp), both
//     Hermite taps, the Hann gains and the dry/wet blend of every channel;
//   the new ring and the new phase scalars.
//
// Exactness: the phase code is error-free transforms, so every product and
// sum is written as the eager op it repeats, in its order, with the same
// float32 constants (the exp2 table below is pinned to ops/dsphase.py by a
// CPU test); the library builds with -fmad=false and no fast math;
// torch.remainder is PyTorch's CUDA form (fmod, then + b where the signs
// differ), torch.round is rintf, divisions are IEEE.  Only cosf is a
// library call.
//
// What bounds it on the H100: at the streaming shape (N = 256, ring 1920,
// two channels) it moves 19.5 KB (5.8 ns at 3.35 TB/s); its time is one
// launch plus the prologue's ~700 dependent float32 operations on one
// thread, which the other threads overlap with staging: 4.0 us on the
// device per launch (H100 80GB HBM3, 700 W).  A file call (the +7 st
// render) runs the same kernel over tiles of kTile outputs.
//
// Slot grid (the serving pool): the grid is (tiles, S), one column of
// thread blocks per slot, each slot with its own semitones, mix and phase
// state, so the S serial prologues run side by side in one launch and the
// launch count per pool step stays 1 at any S.  Outputs are slot-major,
// the six state scalars as (6, S) rows.
//
// Kernel K3: the chorus's whole block step in one launch (chorus_step).
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/resample.py:_resample_kernel
// (entered through catmull_rom_resample <- ringbuf.fractional_read_resample
// <- models/chorus.py), together with the LFO arithmetic around it
// (models/lfo.py): one thread block per (tile, channel) computes the LFO
// ramp and channel spread, the delay law with sin in float64 rounded once
// (lfo.py:f64), the clamped distance, the Hermite tap from the staged
// window and the blend; the last tile of each row writes its new history,
// one thread the phase advance.  Bound like K1 at 2 x 256 (42.6 KB, 12.7
// ns; 3.0 us on the device per launch); a whole file (2 x 892,800, 14.4
// MB, 4.3 us) is a grid of tiles, each staging kTile + history samples per
// row (15.3 us; both on an H100 80GB HBM3, 700 W).  The pool's slots are
// more rows: the grid is (tiles, S * C), row r = slot * C + channel, and
// the phase pair is written as (2, S) rows.

#include <cuda_runtime.h>

#include "tap_read.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // outputs per thread block (4 per thread)
// float32(2 * math.pi), as PyTorch rounds the Python scalar.
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

// ops/dsphase.py's float32 constants: 1/12 as (hi, lo) and the degree-12
// Taylor coefficients of 2^r as (hi, lo) pairs.
constexpr float kInv12Hi = 0x1.555556p-4f;
constexpr float kInv12Lo = -0x1.555556p-29f;
__constant__ float kExp2Hi[13] = {
    0x1p+0f,        0x1.62e43p-1f,  0x1.ebfbep-3f,  0x1.c6b08ep-5f,
    0x1.3b2ab6p-7f, 0x1.5d87fep-10f, 0x1.430912p-13f, 0x1.ffcbfcp-17f,
    0x1.62c022p-20f, 0x1.b5253ep-24f, 0x1.e4cf52p-28f, 0x1.e8cac8p-32f,
    0x1.c3bd66p-36f};
__constant__ float kExp2Lo[13] = {
    0x0p+0f,         -0x1.05c61p-29f, -0x1.f4e9c8p-33f, -0x1.1f6be8p-30f,
    0x1.f749cep-32f, 0x1.e299ccp-36f, 0x1.f0d8fp-38f,   0x1.622c32p-43f,
    0x1.d2e41p-47f,  -0x1.8d4308p-49f, -0x1.4e8e28p-53f, -0x1.95c89cp-57f,
    -0x1.e07ad0p-61f};

struct DS {
  float hi, lo;
};

__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = a + b;
  const float bp = s - a;
  return {s, (a - (s - bp)) + (b - bp)};
}

__device__ __forceinline__ DS split12(float v) {
  const float c = v * 4097.0f;
  const float hi = c - (c - v);
  return {hi, v - hi};
}

__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = a * b;
  const DS x = split12(a), y = split12(b);
  return {p, ((x.hi * y.hi - p) + x.hi * y.lo + x.lo * y.hi) + x.lo * y.lo};
}

__device__ __forceinline__ DS ds_add(DS a, DS b) {
  const DS s = two_sum(a.hi, b.hi);
  return two_sum(s.hi, s.lo + (a.lo + b.lo));
}

__device__ __forceinline__ DS ds_mul(DS a, DS b) {
  const DS p = two_prod(a.hi, b.hi);
  return two_sum(p.hi, p.lo + (a.hi * b.lo + a.lo * b.hi));
}

// torch.remainder of float32 as PyTorch's CUDA kernel computes it.
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// dsphase.ds_exp2_div12: double-single 2^(s/12).
__device__ DS ds_exp2_div12(float s) {
  const DS p = two_prod(s, kInv12Hi);
  const DS y = two_sum(p.hi, p.lo + s * kInv12Lo);
  const float k = rintf(y.hi);
  const DS r = two_sum(y.hi - k, y.lo);
  DS t = {kExp2Hi[12], kExp2Lo[12]};
  for (int j = 11; j >= 0; --j) {
    t = ds_mul(t, r);
    t = ds_add(t, DS{kExp2Hi[j], kExp2Lo[j]});
  }
  const float scale = ldexpf(1.0f, (int)k);
  return {t.hi * scale, t.lo * scale};
}

// dsphase._stride_levels' lift: ((4096 * r) mod 1) renormalized.
__device__ __forceinline__ DS lift(DS r) {
  float rh = r.hi * 4096.0f;
  rh = rh - floorf(rh);
  return two_sum(rh, r.lo * 4096.0f);
}

// dsphase._phase_accum for one int32 index.
__device__ __forceinline__ DS phase_accum(int idx, const DS* strides,
                                          DS base) {
  float acc = base.hi + 0.0f;
  float err = base.lo + 0.0f;
  const int digits[3] = {idx & 4095, (idx >> 12) & 4095, (idx >> 24) & 4095};
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const DS ab = split12(strides[l].hi);
    const float jf = (float)digits[l];
    const float t_exact = remainder(jf * ab.hi, 1.0f);
    const float t_small = jf * ab.lo + jf * strides[l].lo;
    const DS s1 = two_sum(acc, t_exact);
    const DS s2 = two_sum(s1.hi, t_small);
    acc = s2.hi;
    err = err + (s1.lo + s2.lo);
  }
  return {acc, err};
}

// Stage stream elements [lo, hi) of hist (size,) ++ v(k) into win.
template <class V>
__device__ __forceinline__ void stage(float* win, int lo, int hi,
                                      const float* __restrict__ hist,
                                      int size, const V& v) {
  for (int i = lo + (int)threadIdx.x; i < hi; i += kThreads)
    win[i - lo] = i < size ? hist[i] : v(i - size);
}

// out = [y (S, c, n) | ring (S, size) | (6, S): n_abs (int32 bits),
//        base_hi, base_lo, semi_prev, step_hi, step_lo].  Slot z's x rows
// start z * ldxs and are ldx apart; its ring and scalars are slot-major.
__global__ void __launch_bounds__(kThreads) octaver_step_kernel(
    const float* __restrict__ x, long long ldxs, long long ldx, int c, int n,
    const float* __restrict__ hist, int size,
    const float* __restrict__ semitones, const float* __restrict__ mix_p,
    const int* __restrict__ n_abs, const float* __restrict__ base_hi,
    const float* __restrict__ base_lo, const float* __restrict__ semi_prev,
    const float* __restrict__ step_hi, const float* __restrict__ step_lo,
    float* __restrict__ out) {
  extern __shared__ float win[];
  __shared__ DS s_strides[3];
  __shared__ DS s_base;
  __shared__ int s_n0;

  const int tid = threadIdx.x;
  const int z = blockIdx.y;  // the slot
  const int slots = gridDim.y;
  const int t0 = blockIdx.x * kTile;
  const int lo = t0 + 1;  // every read of outputs t0.. lies in [t0 + 1, .)
  const int hi = min(t0 + kTile + size, size + n);
  x += z * ldxs;
  hist += (long long)z * size;
  float* scal = out + (long long)slots * (c * n + size) + z;  // row k at scal[k * slots]
  float* new_hist = out + (long long)slots * c * n + (long long)z * size;
  out += (long long)z * c * n;
  const bool first = blockIdx.x == 0;

  if (tid == 0) {
    // The step (1 - 2^(s/12)) / size in double-single and its levels.
    const float semi = semitones[z];
    const DS ratio = ds_exp2_div12(semi);
    const float size_f = (float)size;
    const DS d = two_sum(1.0f, -ratio.hi);
    const float num_lo = d.lo - ratio.lo;
    const float sh = d.hi / size_f;
    const DS a = split12(sh);
    const float rem = (d.hi - a.hi * size_f) - a.lo * size_f;
    const float sl = (rem + num_lo) / size_f;
    s_strides[0] = DS{sh, sl};
    s_strides[1] = lift(s_strides[0]);
    s_strides[2] = lift(s_strides[1]);
    if (first) {
      scal[3 * slots] = semi;
      scal[4 * slots] = sh;
      scal[5 * slots] = sl;
    }
  } else if (tid == 32) {
    // The re-anchor: fold the previous step over n_abs on a semitone
    // change or past 2^28 samples.
    const int na = n_abs[z];
    const bool refold = (semitones[z] != semi_prev[z]) || (na >= (1 << 28));
    DS base = {base_hi[z], base_lo[z]};
    int n0 = na;
    if (refold) {
      DS prev[3];
      prev[0] = DS{step_hi[z], step_lo[z]};
      prev[1] = lift(prev[0]);
      prev[2] = lift(prev[1]);
      const DS acc = phase_accum(na, prev, base);
      base = two_sum(remainder(acc.hi, 1.0f), acc.lo);
      n0 = 0;
    }
    s_base = base;
    s_n0 = n0;
    if (first) {
      reinterpret_cast<int*>(scal)[0] = n0 + n;
      scal[slots] = base.hi;
      scal[2 * slots] = base.lo;
    }
  }
  // mono = torch.mean(x, 0): (x0 + x1) * 0.5 for two channels.
  const float* x1 = x + (c == 2 ? ldx : 0);
  stage(win, lo, hi, hist, size, [&](int k) {
    return c == 2 ? (x[k] + x1[k]) * 0.5f : x[k] * 1.0f;
  });
  __syncthreads();

  if (blockIdx.x == gridDim.x - 1) {
    for (int i = tid; i < size; i += kThreads) new_hist[i] = win[n + i - lo];
  }
  const DS strides[3] = {s_strides[0], s_strides[1], s_strides[2]};
  const DS base = s_base;
  const int n0 = s_n0;
  const float mix = mix_p[z];
  const float omm = 1.0f - mix;
  const float size_f = (float)size;
  const aefs::Window w{win, lo};
  const int end = min(t0 + kTile, n);
  for (int j = t0 + tid; j < end; j += kThreads) {
    const DS acc = phase_accum(n0 + j, strides, base);
    const float p1 = remainder(remainder(acc.hi, 1.0f) + acc.lo, 1.0f);
    const float p2 = remainder(p1 + 0.5f, 1.0f);
    const float s1 = aefs::tap_read(w, size, n, j, p1 * size_f);
    const float s2 = aefs::tap_read(w, size, n, j, p2 * size_f);
    const float g1 = 0.5f * (1.0f - cosf(kTwoPi * p1));  // Hann crossfade
    const float g2 = 0.5f * (1.0f - cosf(kTwoPi * p2));
    const float wet = s1 * g1 + s2 * g2;
    for (int ch = 0; ch < c; ++ch)
      out[(long long)ch * n + j] = x[ch * ldx + j] * omm + wet * mix;
  }
}

// out = [y (S, c, n) | history (S, c, hl) | (2, S): ph_hi, ph_lo].  One
// thread block per (tile, row), row r = slot * c + channel; slot z's x rows
// start z * ldxs and are ldx apart.
__global__ void __launch_bounds__(kThreads) chorus_step_kernel(
    const float* __restrict__ x, long long ldxs, long long ldx, int c, int n,
    const float* __restrict__ hist, int hl, float fs,
    const float* __restrict__ rate, const float* __restrict__ depth_p,
    const float* __restrict__ base_p, const float* __restrict__ mix_p,
    const float* __restrict__ spread_p, const float* __restrict__ ph_hi,
    const float* __restrict__ ph_lo, float* __restrict__ out) {
  extern __shared__ float win[];
  const int tid = threadIdx.x;
  const int r = blockIdx.y;
  const int rows = gridDim.y;
  const int z = r / c;        // the slot
  const int row = r - z * c;  // the channel
  const int t0 = blockIdx.x * kTile;
  const int lo = t0 + 1;
  const int hi = min(t0 + kTile + hl, hl + n);
  const float* xr = x + z * ldxs + row * ldx;
  float* new_hist = out + (long long)rows * n;
  float* tail = new_hist + (long long)rows * hl;

  stage(win, lo, hi, hist + (long long)r * hl, hl,
        [&](int k) { return xr[k]; });
  const float dph = rate[z] / fs;  // lfo.py: rate_hz / fs, IEEE
  const float phi = ph_hi[z], plo = ph_lo[z];
  if (row == 0 && blockIdx.x == 0 && tid == 0) {
    // lfo_advance: the pair n samples on, hi wrapped into [0, 1).
    const DS t = two_sum(phi, plo + (float)n * dph);
    tail[z] = t.hi - floorf(t.hi);
    tail[rows / c + z] = t.lo;
  }
  __syncthreads();

  if (blockIdx.x == gridDim.x - 1) {
    for (int i = tid; i < hl; i += kThreads)
      new_hist[(long long)r * hl + i] = win[n + i - lo];
  }
  const float spread = spread_p[z] * (float)row;
  const float base = base_p[z], depth = depth_p[z];
  const float mix = mix_p[z];
  const float omm = 1.0f - mix;
  const float fs_ms = fs / 1000.0f;
  const float max_ago = (float)(hl - 2);
  const aefs::Window w{win, lo};
  const int end = min(t0 + kTile, n);
  for (int j = t0 + tid; j < end; j += kThreads) {
    const float ph = phi + (plo + (float)j * dph) + spread;
    const float sn = (float)sin((double)(kTwoPi * ph));
    const float delay_ms = base + depth * sn;
    const float ago = fminf(fmaxf(delay_ms * fs_ms, 2.0f), max_ago);
    const float tap = aefs::tap_read(w, hl, n, j, ago);
    out[(long long)r * n + j] = omm * xr[j] + mix * tap;
  }
}

// Allow ``bytes`` of dynamic shared memory for ``kernel`` where it exceeds
// the default 48 KB.  A refusal is returned and cleared.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// Make ``device`` this library's current device before a launch.  The
// library carries its own CUDA runtime, whose current device is its own:
// without this a launch for another card than the one this runtime first
// saw could go to the wrong context.
cudaError_t use_device(int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

int launched() {
  const cudaError_t e = cudaGetLastError();  // returns and clears
  return (int)e;
}

}  // namespace

// Kernel K1.  x (S, c, n) float32, slots ldxs apart and rows ldx apart,
// c in {1, 2}; hist (S, size); semitones, mix, base_hi, base_lo,
// semi_prev, step_hi, step_lo (S,) float32; n_abs (S,) int32; out
// (S * (c*n + size + 6)) float32.  S = 1 is the single-stream step.
// Launches on ``stream`` of ``device``; returns the CUDA error code (0 on
// success).
extern "C" int aefs_octaver_step(const float* x, long long ldxs, long long ldx,
                                 int c, int n, int slots, const float* hist,
                                 int size, const float* semitones,
                                 const float* mix, const int* n_abs,
                                 const float* base_hi, const float* base_lo,
                                 const float* semi_prev, const float* step_hi,
                                 const float* step_lo, float* out, int device,
                                 cudaStream_t stream) {
  if (c < 1 || c > 2 || n < 1 || size < 4 || slots < 1 || slots > 65535)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t d = use_device(device)) return (int)d;
  const size_t smem = (size_t)(kTile + size) * sizeof(float);
  const cudaError_t e = allow_smem(octaver_step_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kTile - 1) / kTile, slots);
  octaver_step_kernel<<<grid, kThreads, smem, stream>>>(
      x, ldxs, ldx, c, n, hist, size, semitones, mix, n_abs, base_hi, base_lo,
      semi_prev, step_hi, step_lo, out);
  return launched();
}

// Kernel K3.  x (S, c, n) float32, slots ldxs apart and rows ldx apart;
// hist (S, c, hl); rate, depth, base, mix, spread, ph_hi, ph_lo (S,)
// float32; out (S * (c*n + c*hl + 2)) float32.  S = 1 is the
// single-stream step.  Launches on ``stream`` of ``device``; returns the
// CUDA error code.
extern "C" int aefs_chorus_step(const float* x, long long ldxs, long long ldx,
                                int c, int n, int slots, const float* hist,
                                int hl, float fs, const float* rate,
                                const float* depth, const float* base,
                                const float* mix, const float* spread,
                                const float* ph_hi, const float* ph_lo,
                                float* out, int device, cudaStream_t stream) {
  if (c < 1 || slots < 1 || (long long)c * slots > 65535 || n < 1 || hl < 4)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t d = use_device(device)) return (int)d;
  const size_t smem = (size_t)(kTile + hl) * sizeof(float);
  const cudaError_t e = allow_smem(chorus_step_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kTile - 1) / kTile, c * slots);
  chorus_step_kernel<<<grid, kThreads, smem, stream>>>(
      x, ldxs, ldx, c, n, hist, hl, fs, rate, depth, base, mix, spread, ph_hi,
      ph_lo, out);
  return launched();
}
