// Kernels K2 and K4: the whole-file damped comb bank, one block per comb and file.
//
// K2 (aefs_comb_sums) replaces the TPU kernel
// aefs_tpu/ops/pallas/comb.py:_make_sums_kernel (entered through
// comb_bank_file_pallas_sums <- ringbuf.comb_bank_file_sums <-
// models/reverb.py:process_file); K4 (aefs_comb_chunks) replaces
// comb.py:_make_kernel (entered through comb_bank_file_pallas <-
// ringbuf.comb_bank_file_chunks).  Per comb b, from fresh state:
//
//   y_b[n]      = x[side_of[b], n - L_b] + g_b * damped_b[n - L_b]
//   damped_b[n] = h * damped_b[n-1] + (1 - h) * y_b[n]
//
// solved in chunks of C samples with C <= L_b < 2C, so every lag read of
// chunk k lands in chunks k-2 and k-1.  K4 writes every chunk's y and
// damped, (M, B, C) each.  K2 writes y into an (M, B, C) scratch the
// wrapper allocates and the damped state of the last three chunks into
// d_tail (3, B, C) (zero rows before the signal start); a second kernel
// then sums each side's combs lane-parallel into ysum (n_sides, M, C), in
// ascending comb order (0 + y_b0 + y_b1 + ..., the plain version's order:
// no atomics, so two launches are bit-equal).
//
// The TPU kernels carry the chunk recursion from one sequential grid step
// to the next in VMEM.  CUDA blocks carry nothing between each other, so
// the chunk loop runs inside a block.  What bounds it on the H100 is that
// chain: the demo file (892,800 frames, C = 1408) is 635 strictly
// sequential chunk steps.  On an H100 80GB HBM3 at 700 W a step takes
// ~1.1-1.2 us at 2 lanes per thread (K2's FIR and scan, K4: 0.71-0.78 ms
// per launch; chip_smoke.py): two barriers, the phases' shared-memory
// round trips, the output stores and the instructions of 22 warps sharing
// four schedulers.  Bytes (x read once, outputs written once: 14 MB for
// K2, 64 MB for K4) would take 4-19 us at 3.35 TB/s.  The design, against
// what held the first port back (two blocks, one per side, of 1,024
// threads walking every comb of the side):
//
//   1. One block per comb (B blocks, not one per side): each block owns
//      one recursion; a thread owns V consecutive lanes (V = 2..32, a
//      template parameter; launch_comb picks it from C, 2 where C allows:
//      at C = 1408 it ran the FIR faster than 4) and keeps their y, x and
//      damping in registers.  Shared memory holds two damped chunks and
//      two y chunks with a 32-sample reach-back (~23 KB at C = 1408), so
//      the blocks spread over SMs and C up to 14,336 fits.
//   2. Two barriers per chunk step: A after y is written (the FIR reads
//      neighbours' y; the scan publishes its warp totals), B after the
//      damped chunk is written (the next step's lag reads see it).  The
//      stores of y, damped and the tail wait for no barrier: after B they
//      are read back from shared memory as coalesced stores (lane i by
//      thread i mod threads) at the top of the next step.  Storing each
//      thread's lanes straight from registers measured slower (y and
//      damped then live across B).
//   3. x is prefetched: chunk k+1's lag-shifted window does not depend on
//      the recursion, so each thread loads it into registers during chunk
//      k (two register sets alternate, the loop unrolled by two, so the
//      load is first consumed a step later).  Registers, not cp.async or
//      TMA: a lag offset is not 16-byte aligned, each thread reads only
//      its own lanes, and V loads per thread per step are few.
//   4. Damping.  With a baked h (h_static accepted by fir_damp_weights)
//      a <= 32-tap FIR whose dropped tail is < 2^-40 of the output, exact
//      in f32, each lane summing d = d + w[t] * y[n-t] in ascending t (a
//      tap-by-tap loop's arithmetic, bit for bit); the weights
//      come by value in the geometry struct.  Taps go in groups of four:
//      per group a thread loads the V + 4 lanes of y its V sums need once
//      (vector loads) and forms all V sums from them.
//      With a traced h, a scan without block-wide levels: a serial scan
//      over the thread's V lanes, a warp-shuffle scan of the thread totals
//      (h^V, h^2V, ... by repeated squaring), the warp totals exchanged
//      through shared memory at barrier A, and the cross-chunk carry from
//      lane C-1 of chunk k-1.  All powers of h come from multiplications
//      in a fixed order, so the result is deterministic.
//
// A batched render's files share g and h and differ in x: the grid is
// (combs, files), block (b, f) running comb b of file f with its x, y,
// damped and tail rows offset by f, so one launch serves F files and each
// file's blocks do exactly the arithmetic of an F = 1 launch (bit-equal
// outputs).  At the demo's length a file is 8 blocks of ~22 warps on a
// 132-SM card, so up to 16 files run side by side in the time of one.
//
// Built with -fmad=false like the tap kernel, so every product rounds as
// in the plain version's separate eager ops.

#include <cuda_runtime.h>

#define AEFS_MAX_COMBS 16
#define AEFS_FIR_PAD 32  // the FIR's taps at most, and the y reach-back kept

namespace {

struct CombGeom {
  int lags[AEFS_MAX_COMBS];
  int side_of[AEFS_MAX_COMBS];
  float fir_w[AEFS_FIR_PAD];  // FIR damping weights, zero-padded
  int n_taps;                 // 0: traced-h scan
  int b;
};

template <int W> struct Vec;
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

// W floats to / from shared memory at a 4W-byte-aligned address.
template <int W>
__device__ __forceinline__ void lds(const float* p, float* out) {
  const typename Vec<W>::T v = *reinterpret_cast<const typename Vec<W>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = f[j];
}

template <int W>
__device__ __forceinline__ void sts(float* p, const float* in) {
  typename Vec<W>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < W; ++j) f[j] = in[j];
  *reinterpret_cast<typename Vec<W>::T*>(p) = v;
}

// One block per comb and file; blockDim.x * V >= c.  Per file (x_file
// floats of x apart): y_out (m, b, c) always; d_out (m, b, c) and d_tail
// (3, b, c) may be null.  Block (b, f) offsets every operand by file f.
template <int V, int MAXT>
__global__ void __launch_bounds__(MAXT)
comb_bank_kernel(const float* __restrict__ x, long long x_file, int n,
                 const float* __restrict__ g, const float* __restrict__ hptr,
                 const CombGeom geom, int c, int m, float* __restrict__ y_out,
                 float* __restrict__ d_out, float* __restrict__ d_tail) {
  constexpr int PAD = AEFS_FIR_PAD;
  constexpr int W = V < 4 ? V : 4;
  extern __shared__ __align__(16) float sm[];

  const int b = blockIdx.x;
  const size_t f = blockIdx.y;  // the file: its rows of every operand
  const size_t fo = f * m * geom.b * c;  // its y / damped chunks' offset
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ys = PAD + nt * V;  // one y buffer: reach-back, then the lanes
  float* ybuf = sm;             // 2 x ys: chunk k's y in buffer k & 1
  float* dh = sm + 2 * ys;      // 2C: damped chunk k in slot (k & 1)
  float* wt = dh + 2 * c;       // the scan's warp totals
  float* fir_w = wt + 32;       // the FIR weights, zero-padded to PAD
  const int i0 = tid * V;       // this thread's first lane

  const int lag = geom.lags[b];
  const float* xs = x + f * x_file + (size_t)geom.side_of[b] * n;
  // Pin the file's x row in a register: left to itself the compiler
  // re-derives it from the kernel parameters at every prefetch, inside the
  // chunk loop, which slowed an F = 1 launch by 10-20% on an H100.
  asm volatile("" : "+l"(xs));
  const float gb = g[b];
  const float h = *hptr;
  const int n_taps = geom.n_taps;

  for (int i = tid; i < 2 * ys + 2 * c; i += nt) sm[i] = 0.f;
  if (tid < PAD) fir_w[tid] = geom.fir_w[tid];
  for (int r = 0; d_tail && r < 3 - m; ++r)
    for (int i = tid; i < c; i += nt) d_tail[((f * 3 + r) * geom.b + b) * c + i] = 0.f;
  __syncthreads();

  // The scan's powers of h, each by repeated multiplication in one order:
  // hp[v] = h^(v+1), hoff[l] = h^(V 2^l), hlane = h^(V lane), hwarp = h^(32 V).
  float hp[V], hoff[5];
  float p = 1.f;
#pragma unroll
  for (int v = 0; v < V; ++v) hp[v] = p = p * h;
  hoff[0] = hp[V - 1];
#pragma unroll
  for (int l = 1; l < 5; ++l) hoff[l] = hoff[l - 1] * hoff[l - 1];
  float hlane = 1.f;
  for (int j = 0; j < lane; ++j) hlane = hlane * hoff[0];
  const float hwarp = hoff[4] * hoff[4];

  // Chunk k's lag-shifted input for this thread's lanes (0 before the
  // signal start and past lane C-1; src <= n-1 since L >= C).
  auto load_x = [&](int k, float (&dst)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long src = (long long)k * c + i0 + v - lag;
      dst[v] = (i0 + v < c && src >= 0) ? __ldg(xs + src) : 0.f;
    }
  };

  // Chunk k's outputs, complete since barrier B of step k: coalesced.
  auto store_chunk = [&](int k) {
    const float* yk = ybuf + (k & 1) * ys + PAD;
    const float* dk = dh + (k & 1) * c;
    const int r = k - (m - 3);
    float* yo = y_out + fo + ((size_t)k * geom.b + b) * c;
    float* dout = d_out ? d_out + fo + ((size_t)k * geom.b + b) * c : nullptr;
    float* dt = (d_tail && r >= 0) ? d_tail + ((f * 3 + r) * geom.b + b) * c : nullptr;
    for (int i = tid; i < c; i += nt) {
      yo[i] = yk[i];
      if (dout) dout[i] = dk[i];
      if (dt) dt[i] = dk[i];
    }
  };

  auto step = [&](int k, float (&xc)[V], float (&xn)[V]) {
    float* yk = ybuf + (k & 1) * ys;
    float* yk1 = ybuf + ((k + 1) & 1) * ys;  // chunk k+1's (and k-1's) buffer
    const int slot = (k & 1) * c;            // chunk k's slot, chunk k-2's until now
    if (k > 0) store_chunk(k - 1);

    // 1. y: lane i reads position r = i - L + 2C of [chunk k-2 | chunk k-1].
    float y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = i0 + v;
      const int r = i - lag + 2 * c;
      float d = 0.f;
      if (i < c && (long long)(k - 2) * c + r >= 0) {
        const int idx = slot + r;
        d = dh[idx >= 2 * c ? idx - 2 * c : idx];
      }
      y[v] = xc[v] + gb * d;
    }
#pragma unroll
    for (int v = 0; v < V; v += W) sts<W>(yk + PAD + i0 + v, y + v);
    if (k + 1 < m) load_x(k + 1, xn);

    float s[V], exc = 0.f;
    if (n_taps > 0) {
      // The last PAD lanes of y become chunk k+1's reach-back; when C < PAD
      // the older lanes carry over from this chunk's own reach-back.
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = i0 + v - (c - PAD);
        if (j >= 0 && i0 + v < c) yk1[j] = y[v];
      }
      if (tid < PAD - c) yk1[tid] = yk[c + tid];
    } else {
      // Serial scan over the thread's lanes from zero carry, then a warp
      // scan of the thread totals: (h^V, s) pairs composed by shuffles.
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float a = (1.f - h) * y[v];
        acc = v == 0 ? a : h * acc + a;
        s[v] = acc;
      }
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        const float up = __shfl_up_sync(0xffffffffu, acc, 1 << l);
        if (lane >= (1 << l)) acc = acc + hoff[l] * up;
      }
      const float before = __shfl_up_sync(0xffffffffu, acc, 1);
      exc = lane > 0 ? before : 0.f;
      if (lane == 31) wt[warp] = acc;
    }
    __syncthreads();  // A

    // 2. Damping of this thread's lanes into chunk k's slot.
    float d[V];
    if (n_taps > 0) {
      // Taps in groups of four, a runtime loop (an unrolled loop guarded
      // by t < n_taps would execute all 32 taps).  Past n_taps the weights
      // are zero and d + 0 * y == d, so the sums equal the tap-by-tap
      // ones bit for bit.  Group t0 reads lanes i0 - t0 - 4 .. i0 + V - 1
      // - t0 once, as aligned vectors, into win.
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = 0.f;
      for (int t0 = 0; t0 < n_taps; t0 += 4) {
        float win[V + 4];
#pragma unroll
        for (int q = 0; q < V + 4; q += W) lds<W>(yk + PAD + i0 - t0 - 4 + q, win + q);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const float w = fir_w[t0 + tt];
#pragma unroll
          for (int v = 0; v < V; ++v) d[v] = d[v] + w * win[4 + v - tt];
        }
      }
    } else {
      // Carry into the warp: damped at lane C-1 of chunk k-1, then the
      // warp totals before this warp; into the thread: its warp prefix.
      float cw = k > 0 ? dh[((k + 1) & 1) * c + c - 1] : 0.f;
      for (int w = 0; w < warp; ++w) cw = hwarp * cw + wt[w];
      const float ct = hlane * cw + exc;
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = hp[v] * ct + s[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (i0 + v < c) dh[slot + i0 + v] = d[v];
    __syncthreads();  // B
  };

  float xa[V], xb[V];
  load_x(0, xa);
  for (int k = 0; k < m; k += 2) {
    step(k, xa, xb);
    if (k + 1 < m) step(k + 1, xb, xa);
  }
  store_chunk(m - 1);
}

// ysum[f, s, k, i] = 0 + y[f, k, b0, i] + y[f, k, b1, i] + ... over side
// s's combs b0 < b1 < ... (zeros for a side with none); one thread per
// output, striding over every file's outputs.
__global__ void comb_side_sums_kernel(const float* __restrict__ y, const CombGeom geom,
                                      int c, int m, int n_sides, int files,
                                      float* __restrict__ ysum) {
  const long long mc = (long long)m * c;
  const long long per_file = n_sides * mc;
  const long long total = files * per_file;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long f = t / per_file;
    const long long st = t - f * per_file;  // s * m * c + k * c + i
    const int s = (int)(st / mc);
    const long long ki = st - s * mc;  // k * c + i
    const long long k = ki / c;
    const long long i = ki - k * c;
    const float* yk = y + (f * m + k) * geom.b * c + i;
    float acc = 0.f;
    for (int bb = 0; bb < geom.b; ++bb)
      if (geom.side_of[bb] == s) acc = acc + yk[(long long)bb * c];
    ysum[t] = acc;
  }
}

// ceil(c / v) threads, rounded up to a warp.
int threads_for(int c, int v) { return ((c + v - 1) / v + 31) / 32 * 32; }

template <int V, int MAXT>
int launch_bank(cudaStream_t stream, const float* x, long long x_file, int n, int files,
                const float* g, const float* h, const CombGeom& geom, int c, int m,
                float* y_out, float* d_out, float* d_tail) {
  const int threads = threads_for(c, V);
  const size_t smem = sizeof(float) * (2 * ((size_t)AEFS_FIR_PAD + (size_t)threads * V) +
                                       2 * (size_t)c + 32 + AEFS_FIR_PAD);
  cudaError_t err = cudaFuncSetAttribute(
      comb_bank_kernel<V, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it, or the next launch's check reports it
    return (int)err;
  }
  comb_bank_kernel<V, MAXT><<<dim3(geom.b, files), threads, smem, stream>>>(
      x, x_file, n, g, h, geom, c, m, y_out, d_out, d_tail);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared launcher: validates the geometry, packs it (and the FIR weights)
// into the by-value struct and launches one block per comb and file.  It owns the
// launch geometry: 2 lanes per thread where the chunk fits in 768 threads
// (C <= 1536), else the fewest of 4, 8, 16, 32 that fit in 512, each
// variant compiled for its thread limit.  A chunk no variant takes
// (C > 16,384) or whose shared memory exceeds the card's per-block limit
// (cudaFuncSetAttribute refuses it: C > 14,336 on the H100) returns the
// error.
static int launch_comb(const float* x, int x_rows, int n, int files, const float* g,
                       const float* h, const float* fir_w, int n_taps,
                       const int* lags, const int* side_of, int b, int c, int m,
                       float* y_out, float* d_out, float* d_tail, int device,
                       cudaStream_t stream) {
  if (b < 1 || b > AEFS_MAX_COMBS || n_taps < 0 || n_taps > AEFS_FIR_PAD || c < 1 ||
      m < 1 || files < 1 || files > 65535 || y_out == nullptr)
    return (int)cudaErrorInvalidValue;
  // The library carries its own CUDA runtime, whose current device is its
  // own: make the operands' card current before launching there.
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) {
    cudaGetLastError();
    return (int)dev_err;
  }
  const long long x_file = (long long)x_rows * n;
  CombGeom geom = {};
  geom.b = b;
  geom.n_taps = n_taps;
  for (int t = 0; t < AEFS_FIR_PAD; ++t) geom.fir_w[t] = t < n_taps ? fir_w[t] : 0.f;
  for (int i = 0; i < AEFS_MAX_COMBS; ++i) {
    geom.lags[i] = i < b ? lags[i] : 0;
    geom.side_of[i] = i < b ? side_of[i] : -1;
  }
  for (int i = 0; i < b; ++i)
    if (side_of[i] < 0 || side_of[i] >= x_rows || lags[i] < c || lags[i] >= 2 * c)
      return (int)cudaErrorInvalidValue;
  if (threads_for(c, 2) <= 768)
    return launch_bank<2, 768>(stream, x, x_file, n, files, g, h, geom, c, m, y_out,
                                  d_out, d_tail);
  if (threads_for(c, 4) <= 512)
    return launch_bank<4, 512>(stream, x, x_file, n, files, g, h, geom, c, m, y_out,
                                  d_out, d_tail);
  if (threads_for(c, 8) <= 512)
    return launch_bank<8, 512>(stream, x, x_file, n, files, g, h, geom, c, m, y_out,
                                  d_out, d_tail);
  if (threads_for(c, 16) <= 512)
    return launch_bank<16, 512>(stream, x, x_file, n, files, g, h, geom, c, m, y_out,
                                  d_out, d_tail);
  if (threads_for(c, 32) <= 512)
    return launch_bank<32, 512>(stream, x, x_file, n, files, g, h, geom, c, m, y_out,
                                  d_out, d_tail);
  return (int)cudaErrorInvalidValue;
}

// Kernel K2.  x (files, x_rows, n) float32, g (b,), h scalar: device
// pointers.  fir_w (n_taps,) HOST floats, n_taps <= 32; n_taps == 0 selects
// the scan (fir_w may then be null).  lags/side_of (b,) HOST ints.
// y_scratch (files, m, b, c), ysum (files, n_sides, m, c), d_tail
// (files, 3, b, c): device outputs.
// Launches the comb kernel, then the side sums; returns the first
// launch error (cudaGetLastError()), or cudaErrorInvalidValue for a
// geometry it does not take.
extern "C" int aefs_comb_sums(const float* x, int x_rows, int n, int files,
                              const float* g, const float* h, const float* fir_w,
                              int n_taps, const int* lags, const int* side_of, int b,
                              int c, int m, int n_sides, float* y_scratch, float* ysum,
                              float* d_tail, int device, cudaStream_t stream) {
  if (n_sides < 1) return (int)cudaErrorInvalidValue;
  int err = launch_comb(x, x_rows, n, files, g, h, fir_w, n_taps, lags, side_of, b, c, m,
                        y_scratch, nullptr, d_tail, device, stream);
  if (err != 0) return err;
  CombGeom geom = {};
  geom.b = b;
  for (int i = 0; i < b; ++i) geom.side_of[i] = side_of[i];
  const long long total = (long long)files * n_sides * m * c;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  comb_side_sums_kernel<<<blocks, threads, 0, stream>>>(y_scratch, geom, c, m, n_sides,
                                                        files, ysum);
  return (int)cudaGetLastError();
}

// Kernel K4.  Same operands as aefs_comb_sums with traced h only (the
// scan); y_out and d_out (files, m, b, c) device outputs receive every
// comb's y and damped chunk.
extern "C" int aefs_comb_chunks(const float* x, int x_rows, int n, int files,
                                const float* g, const float* h, const int* lags,
                                const int* side_of, int b, int c, int m, float* y_out,
                                float* d_out, int device, cudaStream_t stream) {
  return launch_comb(x, x_rows, n, files, g, h, nullptr, 0, lags, side_of, b, c, m, y_out,
                     d_out, nullptr, device, stream);
}
