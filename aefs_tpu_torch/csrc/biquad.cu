// Kernel K5: the biquad's whole streaming block step in one launch
// (biquad_step).
//
// Replaces no TPU kernel: the JAX package solves the biquad with XLA ops
// (aefs_tpu/ops/scan.py:biquad_block, no pallas_call), which XLA fuses into
// the step.  Eager PyTorch has no such fusion: the same block step in a
// captured step graph was ~490 nodes of about a microsecond each, for a few
// hundred bytes of work (the seven filter types' RBJ rows on 0-dim tensors,
// the one-hot select, then ops/scan.py:linrec2's Hillis levels over six
// float64 planes, a dozen pad/slice/multiply/add kernels a level).  One
// launch computes what BiquadFilter.process computes for a block shorter
// than 1,024 samples, state included:
//
//   thread 0 of each thread block: the slot's coefficients (the clamp,
//     w0, cos and sin, and 10^(gain/40) only for the shelves and the peak,
//     then only the selected type's row and the divisions by a0);
//   every thread, one per sample: v[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2]
//     from the state's x1, x2, then the log2(N) Hillis levels of the 2x2
//     companion maps (earlier maps applied first), the planes double-
//     buffered in shared memory, then y = p y1 + q y2 + u rounded once;
//   the last two threads: the new state [x[-1], x[-2], y[-1], y[-2]].
//
// Exactness: the plain version (ops/kernels/biquad.py:biquad_step_plain)
// is a chain of eager ops, each rounding once, and so is every expression
// here, written in the plain version's order: float32 for the
// coefficients (PyTorch rounds a Python scalar to float32 in a tensor-
// scalar op: kTwoPi, 0.45 fs; a division by 2 is exact either way),
// float64 for the solve.  Each level computes every product for every
// sample, with the identity map left of the edge where the plain version
// pads with it.  The one-hot select of the plain version adds exact zeros
// to the selected row, which changes no value.  The library builds with
// -fmad=false and no fast math, so divisions and sqrtf are IEEE; cos, sin
// and pow are the float64 library calls PyTorch's CUDA kernels make, each
// rounded once to float32 (models/lfo.py:f64).
//
// What bounds it on the H100: the streaming shape (2 x 256) reads 2 KB
// and writes 2 KB (1.2 ns at 3.35 TB/s) and does 20 float64 operations a
// sample a level (8 levels: 82 KFLOP, 2.4 ns at 34 TFLOP/s); its time is
// one launch, the coefficient thread's float64 cos, sin and pow, and the 8
// dependent levels with a barrier each.  One thread block per (slot,
// channel) row and one thread per sample keep every level one barrier
// deep; the rows of the serving pool's slots are more thread blocks of the
// same launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 1023;  // longer signals take the file solve
// float32(2 * math.pi), as PyTorch rounds the Python scalar.
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

struct Coefs {
  float b0, b1, b2, a1, a2;
};

// models/biquad.py:coefficients for one slot.
__device__ Coefs rbj(float ftype, float cutoff, float q, float gain_db, int fs) {
  const float fc_max = (float)(0.45 * (double)fs);
  const float fc = cutoff > fc_max ? fc_max : cutoff;  // torch.clamp(max=)
  const float w0 = (kTwoPi * fc) / (float)fs;
  const float cw = (float)cos((double)w0);
  const float sw = (float)sin((double)w0);
  const float alpha = sw / (2.0f * q);
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  const int t = (int)rintf(ftype);  // torch.round: half to even
  if ((t >= 0 && t <= 2) || t == 6) {
    a0 = 1.0f + alpha;
    a1 = -2.0f * cw;
    a2 = 1.0f - alpha;
    if (t == 0) {  // low-pass
      b0 = (1.0f - cw) / 2.0f;
      b1 = 1.0f - cw;
      b2 = (1.0f - cw) / 2.0f;
    } else if (t == 1) {  // high-pass
      b0 = (1.0f + cw) / 2.0f;
      b1 = -(1.0f + cw);
      b2 = (1.0f + cw) / 2.0f;
    } else if (t == 2) {  // band-pass
      b0 = alpha;
      b2 = -alpha;
    } else {  // all-pass
      b0 = 1.0f - alpha;
      b1 = -2.0f * cw;
      b2 = 1.0f + alpha;
    }
  } else if (t >= 3 && t <= 5) {
    const float big_a = (float)pow(10.0, (double)(gain_db / 40.0f));
    if (t == 3) {  // peak
      b0 = 1.0f + alpha * big_a;
      b1 = -2.0f * cw;
      b2 = 1.0f - alpha * big_a;
      a0 = 1.0f + alpha / big_a;
      a1 = -2.0f * cw;
      a2 = 1.0f - alpha / big_a;
    } else {
      const float tsa = (2.0f * sqrtf(big_a)) * alpha;
      const float ap1 = big_a + 1.0f, am1 = big_a - 1.0f;
      if (t == 4) {  // low shelf
        b0 = big_a * ((ap1 - am1 * cw) + tsa);
        b1 = (2.0f * big_a) * (am1 - ap1 * cw);
        b2 = big_a * ((ap1 - am1 * cw) - tsa);
        a0 = (ap1 + am1 * cw) + tsa;
        a1 = -2.0f * (am1 + ap1 * cw);
        a2 = (ap1 + am1 * cw) - tsa;
      } else {  // high shelf
        b0 = big_a * ((ap1 + am1 * cw) + tsa);
        b1 = (-2.0f * big_a) * (am1 + ap1 * cw);
        b2 = big_a * ((ap1 + am1 * cw) - tsa);
        a0 = (ap1 - am1 * cw) + tsa;
        a1 = 2.0f * (am1 - ap1 * cw);
        a2 = (ap1 - am1 * cw) - tsa;
      }
    }
  }
  // A type outside 0..6 selects no row: all zeros, 0/0 as in the plain version.
  return {b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0};
}

// out = [y (rows, n) | state (rows, 4)], row r = slot * c + channel; slot
// z's x rows start z * ldxs and are ldx apart, df1 is (rows, 4).  One
// thread block per row, blockDim.x >= n, 2 * 6 * n doubles of dynamic
// shared memory.
__global__ void __launch_bounds__(1024) biquad_step_kernel(
    const float* __restrict__ x, long long ldxs, long long ldx, int c, int n,
    const float* __restrict__ df1, int fs, const float* __restrict__ ftype,
    const float* __restrict__ cutoff, const float* __restrict__ q,
    const float* __restrict__ gain_db, float* __restrict__ out) {
  extern __shared__ double planes[];  // [2][6][n]
  __shared__ Coefs s_coef;
  const int i = threadIdx.x;
  const int r = blockIdx.x;
  const int z = r / c;
  const float* xr = x + z * ldxs + (long long)(r - z * c) * ldx;
  const float* st = df1 + 4LL * r;
  if (i == 0) s_coef = rbj(ftype[z], cutoff[z], q[z], gain_db[z], fs);

  const bool live = i < n;
  const double x1 = st[0], x2 = st[1], y1 = st[2], y2 = st[3];
  double xi = 0.0, xm1 = 0.0, xm2 = 0.0;
  if (live) {
    xi = xr[i];
    xm1 = i >= 1 ? (double)xr[i - 1] : x1;
    xm2 = i >= 2 ? (double)xr[i - 2] : (i == 1 ? x1 : x2);
  }
  __syncthreads();
  const Coefs k = s_coef;
  const double b0 = k.b0, b1 = k.b1, b2 = k.b2;
  // The map of sample i: s -> [[-a1, -a2], [1, 0]] s + [v, 0].
  double cp = -(double)k.a1, cq = -(double)k.a2, cr = 1.0, cs = 0.0;
  double cu = (b0 * xi + b1 * xm1) + b2 * xm2, cv = 0.0;

  double* buf = planes;
  for (int s = 1; s < n; s *= 2) {
    if (live) {
      buf[i] = cp;
      buf[n + i] = cq;
      buf[2 * n + i] = cr;
      buf[3 * n + i] = cs;
      buf[4 * n + i] = cu;
      buf[5 * n + i] = cv;
    }
    __syncthreads();  // the other buffer's reads finished a level ago
    double p1 = 1.0, q1 = 0.0, r1 = 0.0, s1 = 1.0, u1 = 0.0, v1 = 0.0;
    if (live && i >= s) {
      const int j = i - s;
      p1 = buf[j];
      q1 = buf[n + j];
      r1 = buf[2 * n + j];
      s1 = buf[3 * n + j];
      u1 = buf[4 * n + j];
      v1 = buf[5 * n + j];
    }
    const double np = cp * p1 + cq * r1;
    const double nq = cp * q1 + cq * s1;
    const double nr = cr * p1 + cs * r1;
    const double ns = cr * q1 + cs * s1;
    const double nu = (cp * u1 + cq * v1) + cu;
    const double nv = (cr * u1 + cs * v1) + cv;
    cp = np;
    cq = nq;
    cr = nr;
    cs = ns;
    cu = nu;
    cv = nv;
    buf = buf == planes ? planes + 6 * n : planes;
  }
  if (!live) return;
  const float y = (float)((cp * y1 + cq * y2) + cu);
  out[(long long)r * n + i] = y;
  float* new_st = out + (long long)gridDim.x * n + 4LL * r;
  if (i == n - 1) {
    new_st[0] = xr[i];
    new_st[1] = (float)xm1;
    new_st[2] = y;
    if (n == 1) new_st[3] = st[2];
  } else if (i == n - 2) {
    new_st[3] = y;
  }
}

}  // namespace

// Kernel K5.  x (S, c, n) float32, slots ldxs apart and rows ldx apart,
// 1 <= n <= 1023; df1 (S, c, 4); filter_type, cutoff_hz, q, gain_db (S,)
// float32, already smoothed; out (S * c * (n + 4)) float32.  S = 1 is the
// single-stream step.  Launches on ``stream`` of ``device``; returns the
// CUDA error code (0 on success).
extern "C" int aefs_biquad_step(const float* x, long long ldxs, long long ldx, int c,
                                int n, int slots, const float* df1, int fs,
                                const float* ftype, const float* cutoff, const float* q,
                                const float* gain_db, float* out, int device,
                                cudaStream_t stream) {
  if (c < 1 || slots < 1 || n < 1 || n > kMaxBlock || fs < 1 ||
      (long long)c * slots > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // The library carries its own CUDA runtime, whose current device is its
  // own: make the operands' card current before launching there.
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  // The planes take 96 n bytes.  Without the opt-in a block may hold 48 KB
  // of shared memory, static and dynamic together, which n >= 512 exceeds.
  // The opt-in lasts (a graph's warm-up makes it before its capture), and
  // it counts the static part too, so the next launch of n finds it made.
  const int smem = 12 * n * (int)sizeof(double);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, biquad_step_kernel);
  if (e == cudaSuccess) {
    const int need = smem + (int)attr.sharedSizeBytes;
    if (need > attr.maxDynamicSharedSizeBytes)
      e = cudaFuncSetAttribute(biquad_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, need);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int threads = (n + 31) / 32 * 32;
  biquad_step_kernel<<<c * slots, threads, smem, stream>>>(
      x, ldxs, ldx, c, n, df1, fs, ftype, cutoff, q, gain_db, out);
  return (int)cudaGetLastError();
}
