// Kernel K2: whole-file damped comb bank, reduced to per-side sums.
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/comb.py:_make_sums_kernel
// (entered through comb_bank_file_pallas_sums <- ringbuf.comb_bank_file_sums
// <- models/reverb.py:process_file).  Per comb b, from fresh state:
//
//   y_b[n]      = x[side_of[b], n - L_b] + g_b * damped_b[n - L_b]
//   damped_b[n] = h * damped_b[n-1] + (1 - h) * y_b[n]
//
// solved in chunks of C samples with C <= L_b < 2C, so every lag read of
// chunk k lands in chunks k-2 and k-1.  Outputs: ysum (n_sides, M, C), the
// sum of each side's combs in ascending comb order (no atomics: the result
// is deterministic), and d_tail (3, B, C), the damped state of the last
// three chunks (zero rows before the signal start).
//
// The TPU kernel carries the chunk recursion from one sequential grid step
// to the next in VMEM scratch.  CUDA blocks carry nothing between each
// other, so here the chunk loop runs INSIDE one thread block per side:
// the block keeps that side's combs' last two damped chunks and the current
// y chunk (plus a 32-sample reach-back for the FIR) in dynamic shared
// memory — about 90 KB at C = 1408 with 4 combs, above the 48 KB default,
// hence cudaFuncSetAttribute.  Per chunk:
//   1. y for all C lanes of every comb in parallel (lags >= C);
//   2. the side's sum, ascending comb order, into ysum;
//   3. damping: with a baked h (h_static accepted by fir_damp_weights) a
//      <= 32-tap FIR whose dropped tail is < 2^-40 of the output — exact
//      in f32; otherwise a block-wide Hillis-Steele scan with h^(2^k)
//      (the TPU kernel's log-step scan, same level order);
//   4. the last three chunks are copied to d_tail as they complete.
//
// What bounds it on the H100: latency.  The flagship file (18.6 s at
// 48 kHz) is ~635 strictly sequential chunk steps, each a handful of
// __syncthreads-separated phases (13 with the scan), on 2 of the 132 SMs;
// bytes (x read once, ysum written once) and FLOPs are negligible.
// Parallelising over combs, files or a chunked look-back is later work.
// Built with -fmad=false like the tap kernel, so every product rounds as
// in the plain version's separate eager ops.
//
// Kernel K4: the same comb bank with full per-chunk outputs.
//
// Replaces the TPU kernel aefs_tpu/ops/pallas/comb.py:_make_kernel
// (entered through comb_bank_file_pallas <- ringbuf.comb_bank_file_chunks).
// The TPU kernel keeps a (C, C) damping propagator resident in VMEM and
// writes every comb's y and damped chunk; at C = 1408 the propagator is
// 7.9 MB, far beyond an SM's 227 KB of shared memory, so here the damping
// is K2's log-step Hillis scan (traced h, no FIR) and the same kernel
// runs with the per-side sums and the tail switched off and y / damped
// written for every chunk into (M, B, C) outputs.  With the default
// identity side map every comb is its own side: one block per comb.
// Bound like K2 by the chain of sequential chunk steps; the outputs add
// 2 x M x B x C floats of coalesced writes (57 MB for the demo file with
// 8 combs), far below what the device memory moves in that time.

#include <cuda_runtime.h>

#define AEFS_MAX_COMBS 16
#define AEFS_FIR_PAD 32  // y reach-back kept per comb (>= the FIR's taps - 1)

namespace {

struct CombGeom {
  int lags[AEFS_MAX_COMBS];
  int side_of[AEFS_MAX_COMBS];
  int b;
};

__global__ void __launch_bounds__(1024)
comb_sums_kernel(const float* __restrict__ x, int n,
                                 const float* __restrict__ g,
                                 const float* __restrict__ hptr,
                                 const float* __restrict__ fir_w, int n_taps,
                                 CombGeom geom, int c, int m, int n_sides,
                                 float* __restrict__ ysum,
                                 float* __restrict__ d_tail,
                                 float* __restrict__ y_out,
                                 float* __restrict__ d_out) {
  extern __shared__ float sm[];
  __shared__ float dlast[AEFS_MAX_COMBS];

  const int side = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int combs[AEFS_MAX_COMBS];
  int nb = 0;
  for (int b = 0; b < geom.b; ++b)
    if (geom.side_of[b] == side) combs[nb++] = b;

  const int cp = c + AEFS_FIR_PAD;
  float* dh = sm;              // nb x 2C: damped chunk k in slot (k & 1)
  float* ya = dh + nb * 2 * c;  // nb x (PAD + C): y with reach-back; scan ping
  float* yb = ya + nb * cp;     // nb x (PAD + C): scan pong
  const float h = *hptr;

  for (int i = tid; i < nb * 2 * c; i += nt) dh[i] = 0.f;
  for (int i = tid; i < 2 * nb * cp; i += nt) ya[i] = 0.f;
  if (tid < nb) dlast[tid] = 0.f;
  for (int r = 0; d_tail && r < 3 && m - 3 + r < 0; ++r)
    for (int idx = tid; idx < nb * c; idx += nt)
      d_tail[((size_t)r * geom.b + combs[idx / c]) * c + idx % c] = 0.f;
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    const int slot = (k & 1) * c;

    // 1. comb outputs: lag reads land in chunks k-2, k-1 (slots still live).
    for (int idx = tid; idx < nb * c; idx += nt) {
      const int bl = idx / c, i = idx - bl * c;
      const int b = combs[bl];
      const long src = (long)k * c + i - geom.lags[b];
      float xs = 0.f, r = 0.f;
      if (src >= 0) {
        xs = x[(size_t)geom.side_of[b] * n + src];
        const int ks = (int)(src / c);
        r = dh[bl * 2 * c + (ks & 1) * c + (int)(src - (long)ks * c)];
      }
      const float yv = xs + g[b] * r;
      ya[bl * cp + AEFS_FIR_PAD + i] = yv;
      if (y_out) y_out[((size_t)k * geom.b + b) * c + i] = yv;
    }
    __syncthreads();

    // 2. per-side sum, ascending comb order.
    if (side < n_sides) {
      for (int i = tid; i < c; i += nt) {
        float s = 0.f;
        for (int bl = 0; bl < nb; ++bl) s = s + ya[bl * cp + AEFS_FIR_PAD + i];
        ysum[((size_t)side * m + k) * c + i] = s;
      }
    }

    // 3. damping into slot (k & 1): chunk k-2's slot, consumed in step 1.
    if (n_taps > 0) {
      for (int idx = tid; idx < nb * c; idx += nt) {
        const int bl = idx / c, i = idx - bl * c;
        const float* yy = ya + bl * cp + AEFS_FIR_PAD + i;
        float d = 0.f;
        for (int t = 0; t < n_taps; ++t) d = d + fir_w[t] * yy[-t];
        dh[bl * 2 * c + slot + i] = d;
      }
      __syncthreads();
      // The chunk's last PAD samples of y become the next reach-back
      // (read all, sync, then write: the ranges overlap when C < PAD).
      const bool mine = tid < nb * AEFS_FIR_PAD;
      const int bl = tid / AEFS_FIR_PAD, t = tid - bl * AEFS_FIR_PAD;
      const float v = mine ? ya[bl * cp + c + t] : 0.f;
      __syncthreads();
      if (mine) ya[bl * cp + t] = v;
    } else {
      for (int idx = tid; idx < nb * c; idx += nt) {
        const int bl = idx / c, i = idx - bl * c;
        float v = (1.f - h) * ya[bl * cp + AEFS_FIR_PAD + i];
        if (i == 0) v = v + h * dlast[bl];
        yb[bl * cp + AEFS_FIR_PAD + i] = v;
      }
      __syncthreads();
      float* src = yb;
      float* dst = ya;
      float hs = h;
      for (int step = 1; step < c; step *= 2) {
        const bool last = 2 * step >= c;
        for (int idx = tid; idx < nb * c; idx += nt) {
          const int bl = idx / c, i = idx - bl * c;
          const float* s = src + bl * cp + AEFS_FIR_PAD;
          float v = s[i];
          if (i >= step) v = v + hs * s[i - step];
          if (last)
            dh[bl * 2 * c + slot + i] = v;
          else
            dst[bl * cp + AEFS_FIR_PAD + i] = v;
        }
        hs = hs * hs;
        float* tmp = src;
        src = dst;
        dst = tmp;
        __syncthreads();
      }
      if (c == 1) {
        for (int bl = tid; bl < nb; bl += nt)
          dh[bl * 2 * c + slot] = yb[bl * cp + AEFS_FIR_PAD];
      }
    }
    __syncthreads();
    if (tid < nb) dlast[tid] = dh[tid * 2 * c + slot + c - 1];

    // 4. the damped chunk to d_out (K4); the last three to d_tail (K2).
    const int r = k - (m - 3);
    const bool tail = d_tail && r >= 0;
    if (d_out || tail) {
      for (int idx = tid; idx < nb * c; idx += nt) {
        const int bl = idx / c, i = idx - bl * c;
        const float v = dh[bl * 2 * c + slot + i];
        if (d_out) d_out[((size_t)k * geom.b + combs[bl]) * c + i] = v;
        if (tail) d_tail[((size_t)r * geom.b + combs[bl]) * c + i] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Shared launcher: validates the geometry, sizes the dynamic shared memory
// for the largest side and launches one block per side.
static int launch_comb(const float* x, int x_rows, int n, const float* g,
                       const float* h, const float* fir_w, int n_taps,
                       const int* lags, const int* side_of, int b, int c,
                       int m, int n_sides, float* ysum, float* d_tail,
                       float* y_out, float* d_out, cudaStream_t stream) {
  if (b < 1 || b > AEFS_MAX_COMBS || n_taps > AEFS_FIR_PAD || c < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  CombGeom geom;
  geom.b = b;
  int per_side[AEFS_MAX_COMBS] = {0};
  int n_blocks = n_sides;
  for (int i = 0; i < b; ++i) {
    if (side_of[i] < 0 || side_of[i] >= x_rows || side_of[i] >= AEFS_MAX_COMBS)
      return (int)cudaErrorInvalidValue;
    geom.lags[i] = lags[i];
    geom.side_of[i] = side_of[i];
    per_side[side_of[i]] += 1;
    if (side_of[i] + 1 > n_blocks) n_blocks = side_of[i] + 1;
  }
  int nb_max = 0;
  for (int s = 0; s < AEFS_MAX_COMBS; ++s)
    nb_max = per_side[s] > nb_max ? per_side[s] : nb_max;
  const int threads = 1024;
  if (nb_max * AEFS_FIR_PAD > threads) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)nb_max * (2 * (size_t)c + 2 * ((size_t)c + AEFS_FIR_PAD));
  cudaError_t err = cudaFuncSetAttribute(
      comb_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  comb_sums_kernel<<<n_blocks, threads, smem, stream>>>(
      x, n, g, h, fir_w, n_taps, geom, c, m, n_sides, ysum, d_tail, y_out, d_out);
  return (int)cudaGetLastError();
}

// Kernel K2.  x (x_rows, n) float32, g (b,), h scalar, fir_w (n_taps,) —
// all device pointers (fir_w may be null when n_taps == 0, which selects
// the scan); lags/side_of (b,) are HOST int arrays.  ysum (n_sides, m, c)
// and d_tail (3, b, c) are device outputs.  One block per side; returns
// cudaGetLastError() (or the attribute call's error when the shared memory
// the side needs exceeds the device limit).
extern "C" int aefs_comb_sums(const float* x, int x_rows, int n,
                              const float* g, const float* h,
                              const float* fir_w, int n_taps, const int* lags,
                              const int* side_of, int b, int c, int m,
                              int n_sides, float* ysum, float* d_tail,
                              cudaStream_t stream) {
  return launch_comb(x, x_rows, n, g, h, fir_w, n_taps, lags, side_of, b, c, m,
                     n_sides, ysum, d_tail, nullptr, nullptr, stream);
}

// Kernel K4.  Same operands as aefs_comb_sums with traced h only (scan
// damping); y_out and d_out (m, b, c) device outputs receive every comb's
// y and damped chunk.  One block per side of side_of.
extern "C" int aefs_comb_chunks(const float* x, int x_rows, int n,
                                const float* g, const float* h,
                                const int* lags, const int* side_of, int b,
                                int c, int m, float* y_out, float* d_out,
                                cudaStream_t stream) {
  return launch_comb(x, x_rows, n, g, h, nullptr, 0, lags, side_of, b, c, m, 0,
                     nullptr, nullptr, y_out, d_out, stream);
}
