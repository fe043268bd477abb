// Fused CWT + phase transform + bin map for the synchrosqueezed CWT.
//
// Replaces the TPU kernel ssqueezepy_tpu/ops/cwt_pallas.py::_make_kernel
// in its bins + direct mode (entry point cwt_fused_bins_direct). For each
// scale a and output time n in [n1, n1 + N):
//
//   W[a, n] = (1/n_up) sum_m psih(a xi_m) h_m xh_m e^{+2 pi i m n / n_up}
//   D[a, n] = the same sum with the extra factor i xi_m / dt
//
// over the half spectrum m in [0, n_up/2] (h_m = 1/2 at the Nyquist bin),
// then w = |Im(D / W)| / 2pi, the gamma gate |W|^2 > gamma^2, and the
// lin / log / log-piecewise bin map with flipud. Outputs: Wx (na, N)
// interleaved complex and k (na, N) int32, k = -1 on gated cells.
//
// Design: four-step DFT over n_up = f1 * f2 with n = k1 + f1 k2 and
// m = m1 f2 + m2, both steps inside these kernels (no cuFFT).
//   launch 1 (stage1): one block per (scale, P1 columns m2). Synthesizes
//     psih in closed form (GMW, log space), forms both spectra, runs the
//     length-f1 inverse DFT over m1 in shared memory (radix 2), applies
//     the twiddle e^{+2 pi i m2 k1 / n_up} / n_up and writes both planes
//     to a scratch buffer (2 x rows x n_up complex).
//   launch 2 (stage2): one block per (scale, P2 columns k1). Runs the
//     length-f2 DFT over m2, keeps the k2 whose n lands in [n1, n1+N),
//     and runs the phase / gate / bin epilogue; dWx never leaves the chip
//     beyond the scratch plane.
// Bound: at the main path's shape (293 scales, n_up = 2^18) the two
// inverse DFTs per scale (~13 GFLOP in float32 at 5 n log2 n, less the
// first stage, whose upper half-spectrum inputs are zero) outweigh the
// bytes the function must move (~0.56 GB), so it is operation-bound on
// paper; this first version also moves the scratch planes through device
// memory twice (~2.5 GB), which the bound does not count. Templated on
// float and double.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Cplx;
template <> struct Cplx<float> { typedef float2 type; };
template <> struct Cplx<double> { typedef double2 type; };

__device__ __forceinline__ void sincospi_t(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void sincospi_t(double x, double* s, double* c) {
  sincospi(x, s, c);
}
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float pow_t(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double pow_t(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float log2_t(float x) { return log2f(x); }
__device__ __forceinline__ double log2_t(double x) { return log2(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fabs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_t(double x) { return fabs(x); }
__device__ __forceinline__ float fmin_t(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double fmin_t(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float fmax_t(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double fmax_t(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ bool finite_t(float x) { return fabsf(x) <= 3.402823466e38f; }
__device__ __forceinline__ bool finite_t(double x) { return fabs(x) <= 1.7976931348623157e308; }

// Host-side parameter block, copied by value into both launches.
struct Cfg {
  int n_up, f1, f2, lg1, lg2, half, n1, N, P1, P2, rows, row0;
  int l1_norm, mode, idx1, omax, flipud;
  double xi_step, inv_dt, gamma_gate;
  double logconst, amp, wgamma, beta, wc;
  double a0, d0, a1, d1;
};

// GMW (order 0) in log space: amp * exp(logconst + beta ln w - w^gamma)
// for w > 0, else 0 (ssqueezepy_tpu/models/gmw.py gmw_l1 / gmw_l2).
template <typename T>
__device__ __forceinline__ T gmw_psih(T w, const Cfg& c) {
  w = w * (T)c.wc;
  if (!(w > (T)0)) return (T)0;
  return (T)c.amp * exp_t((T)c.logconst + (T)c.beta * log_t(w) -
                          pow_t(w, (T)c.wgamma));
}

// In-place radix-2 DIT over `nseq` sequences of length L = 2^lg stored
// back to back in shared memory, inputs in bit-reversed order, outputs in
// natural order; tw[k] = e^{+2 pi i k / L}, k < L/2 (inverse sign).
template <typename T>
__device__ void block_fft(typename Cplx<T>::type* buf, int nseq, int L, int lg,
                          const typename Cplx<T>::type* tw) {
  typedef typename Cplx<T>::type CT;
  const int halfL = L >> 1;
  const int total = nseq * halfL;
  for (int s = 1; s <= lg; ++s) {
    const int hl = 1 << (s - 1);
    const int tstride = L >> s;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int q = b >> (lg - 1);
      const int r = b & (halfL - 1);
      const int grp = r >> (s - 1);
      const int pos = r & (hl - 1);
      const int i0 = q * L + (grp << s) + pos;
      const int i1 = i0 + hl;
      const CT w = tw[pos * tstride];
      const CT x1 = buf[i1];
      const CT x0 = buf[i0];
      const T tr = w.x * x1.x - w.y * x1.y;
      const T ti = w.x * x1.y + w.y * x1.x;
      CT y0, y1;
      y0.x = x0.x + tr; y0.y = x0.y + ti;
      y1.x = x0.x - tr; y1.y = x0.y - ti;
      buf[i0] = y0;
      buf[i1] = y1;
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void fill_twiddles(typename Cplx<T>::type* tw, int L) {
  for (int i = threadIdx.x; i < (L >> 1); i += blockDim.x) {
    T s, c;
    sincospi_t((T)(2 * i) / (T)L, &s, &c);
    tw[i].x = c;
    tw[i].y = s;
  }
}

__device__ __forceinline__ int bitrev(int i, int lg) {
  return (int)(__brev((unsigned)i) >> (32 - lg));
}

template <typename T>
__global__ void stage1(const typename Cplx<T>::type* __restrict__ xh,
                       const T* __restrict__ scales, Cfg c,
                       typename Cplx<T>::type* __restrict__ scratch) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* buf = tw + (c.f1 >> 1);             // [plane][p][m1], 2*P1*f1
  const int L = c.f1, P = c.P1;
  const int a = blockIdx.y;               // row within this chunk
  const int m2_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);

  const T scale = scales[c.row0 + a];
  const T inv_dt = (T)c.inv_dt;
  const T norm = c.l1_norm ? (T)1 : sqrt_t(scale);
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int p = e % P;
    const int m1 = e / P;
    const long m = (long)m1 * c.f2 + m2_0 + p;
    CT X, Xd;
    X.x = X.y = Xd.x = Xd.y = (T)0;
    if (m < c.half) {
      const T xi = (T)((double)m * c.xi_step);
      T psi = gmw_psih<T>(scale * xi, c) * norm;
      if (m == c.half - 1 && (c.n_up & 1) == 0) psi *= (T)0.5;
      const CT v = xh[m];
      X.x = psi * v.x;
      X.y = psi * v.y;
      const T xid = xi * inv_dt;
      Xd.x = -xid * X.y;
      Xd.y = xid * X.x;
    }
    const int br = bitrev(m1, c.lg1);
    buf[p * L + br] = X;
    buf[(P + p) * L + br] = Xd;
  }
  __syncthreads();
  block_fft<T>(buf, 2 * P, L, c.lg1, tw);

  const T inv_n = (T)1 / (T)c.n_up;
  const size_t plane = (size_t)c.rows * c.n_up;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int k1 = e % L;
    const int p = e / L;
    const int m2 = m2_0 + p;
    // m2 * k1 < f2 * f1 = n_up: the twiddle's argument is exact
    T s, co;
    sincospi_t((T)((double)(2 * (long)m2 * k1) / c.n_up), &s, &co);
    const size_t o = ((size_t)a * c.f2 + m2) * c.f1 + k1;
    for (int q = 0; q < 2; ++q) {
      const CT v = buf[(q * P + p) * L + k1];
      CT y;
      y.x = (v.x * co - v.y * s) * inv_n;
      y.y = (v.x * s + v.y * co) * inv_n;
      scratch[q * plane + o] = y;
    }
  }
}

template <typename T>
__device__ __forceinline__ int bin_of(T w, const Cfg& c) {
  T kf;
  if (c.mode == 0) {                        // lin
    kf = fmin_t(rint_t(fmax_t((w - (T)c.a0) / (T)c.d0, (T)0)), (T)c.omax);
  } else if (c.mode == 1) {                 // log
    const T wl = log2_t(w);
    kf = fmin_t(rint_t(fmax_t((wl - (T)c.a0) / (T)c.d0, (T)0)), (T)c.omax);
  } else {                                  // log-piecewise
    const T wl = log2_t(w);
    if (wl > (T)c.a1)
      kf = fmin_t(rint_t((wl - (T)c.a1) / (T)c.d1) + (T)c.idx1, (T)c.omax);
    else
      kf = fmax_t(rint_t((wl - (T)c.a0) / (T)c.d0), (T)0);
  }
  const int k = (int)kf;
  return c.flipud ? c.omax - k : k;
}

template <typename T>
__global__ void stage2(const typename Cplx<T>::type* __restrict__ scratch,
                       Cfg c, typename Cplx<T>::type* __restrict__ wx,
                       int32_t* __restrict__ kout) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* buf = tw + (c.f2 >> 1);             // [plane][p][m2], 2*P2*f2
  const int L = c.f2, P = c.P2;
  const int a = blockIdx.y;
  const int k1_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);

  const size_t plane = (size_t)c.rows * c.n_up;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int p = e % P;
    const int m2 = e / P;
    const size_t o = ((size_t)a * c.f2 + m2) * c.f1 + k1_0 + p;
    const int br = bitrev(m2, c.lg2);
    buf[p * L + br] = scratch[o];
    buf[(P + p) * L + br] = scratch[plane + o];
  }
  __syncthreads();
  block_fft<T>(buf, 2 * P, L, c.lg2, tw);

  const int k2lo = c.n1 / c.f1;
  const int k2hi = (c.n1 + c.N + c.f1 - 1) / c.f1;
  const T gate = (T)c.gamma_gate * (T)c.gamma_gate;
  const T two_pi = (T)6.283185307179586;
  const size_t row = (size_t)(c.row0 + a) * c.N;
  for (int e = threadIdx.x; e < P * (k2hi - k2lo); e += blockDim.x) {
    const int p = e % P;
    const int k2 = k2lo + e / P;
    const int j = k1_0 + p + c.f1 * k2 - c.n1;
    if (j < 0 || j >= c.N) continue;
    const CT W = buf[p * L + k2];
    const CT Dw = buf[(P + p) * L + k2];
    // w = |Im(dW / W)| / 2pi, W = C + iD, dW = A + iB
    const T denom = W.x * W.x + W.y * W.y;
    const T w = fabs_t((Dw.y * W.x - Dw.x * W.y) / (denom * two_pi));
    const bool valid = (denom > gate) && finite_t(w);
    wx[row + j] = W;
    kout[row + j] = valid ? bin_of<T>(w, c) : -1;
  }
}

template <typename T>
int launch(const void* xh, const void* scales, const Cfg& c, void* scratch,
           void* wx, void* kout, void* stream) {
  typedef typename Cplx<T>::type CT;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm1 = (size_t)(c.f1 / 2 + 2 * c.P1 * c.f1) * sizeof(CT);
  const size_t sm2 = (size_t)(c.f2 / 2 + 2 * c.P2 * c.f2) * sizeof(CT);
  cudaFuncSetAttribute(stage1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm1);
  cudaFuncSetAttribute(stage2<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm2);
  dim3 g1(c.f2 / c.P1, c.rows), g2(c.f1 / c.P2, c.rows);
  stage1<T><<<g1, 256, sm1, st>>>(static_cast<const CT*>(xh),
                                  static_cast<const T*>(scales), c,
                                  static_cast<CT*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage2<T><<<g2, 256, sm2, st>>>(static_cast<const CT*>(scratch), c,
                                  static_cast<CT*>(wx),
                                  static_cast<int32_t*>(kout));
  return (int)cudaGetLastError();
}

Cfg make_cfg(const int* ip, const double* dp) {
  Cfg c;
  c.n_up = ip[0]; c.f1 = ip[1]; c.f2 = ip[2]; c.lg1 = ip[3]; c.lg2 = ip[4];
  c.half = ip[5]; c.n1 = ip[6]; c.N = ip[7]; c.P1 = ip[8]; c.P2 = ip[9];
  c.rows = ip[10]; c.row0 = ip[11]; c.l1_norm = ip[12]; c.mode = ip[13];
  c.idx1 = ip[14]; c.omax = ip[15]; c.flipud = ip[16];
  c.xi_step = dp[0]; c.inv_dt = dp[1]; c.gamma_gate = dp[2];
  c.logconst = dp[3]; c.amp = dp[4]; c.wgamma = dp[5]; c.beta = dp[6];
  c.wc = dp[7]; c.a0 = dp[8]; c.d0 = dp[9]; c.a1 = dp[10]; c.d1 = dp[11];
  return c;
}

}  // namespace

// ip: 17 ints, dp: 12 doubles (layout in ops/cwt_cuda.py). Returns
// cudaGetLastError() after the launches.
extern "C" int cwt_bins_f32(const void* xh, const void* scales, const int* ip,
                            const double* dp, void* scratch, void* wx,
                            void* kout, void* stream) {
  return launch<float>(xh, scales, make_cfg(ip, dp), scratch, wx, kout,
                       stream);
}

extern "C" int cwt_bins_f64(const void* xh, const void* scales, const int* ip,
                            const double* dp, void* scratch, void* wx,
                            void* kout, void* stream) {
  return launch<double>(xh, scales, make_cfg(ip, dp), scratch, wx, kout,
                        stream);
}
