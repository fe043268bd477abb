// Fused CWT (+ phase transform + bin map for the synchrosqueezed CWT).
//
// Replaces the TPU kernel ssqueezepy_tpu/ops/cwt_pallas.py::_make_kernel
// in three of its modes, each over a batch of spectra (B spectra x na
// scales, row g = b * na + scale):
//   * bins mode (entry points cwt_fused_bins_direct for one signal and
//     cwt_fused_bins_pallas for a batch): outputs Wx and the bin plane k;
//     the phase / gate / bin arithmetic is bins.cuh's phase_bin;
//   * plain/derivative mode (entry point cwt_fused_pallas): outputs Wx,
//     and dWx when asked;
//   * order-2 (WSST2) mode (entry point cwt_fused_bins2_direct): outputs
//     W and the bin plane k of the chirp-corrected estimate (below).
// For each scale a and output time n in [n1, n1 + N):
//
//   W[a, n] = (1/n_up) sum_m psih(a xi_m) h_m xh_m e^{+2 pi i m n / n_up}
//   D[a, n] = the same sum with the extra factor i xi_m / dt
//
// over the half spectrum m in [0, n_up/2] (h_m = 1/2 at the Nyquist bin),
// times sqrt(scale) for l1_norm = 0; in bins mode then w = |Im(D / W)| /
// 2pi, the gamma gate |W|^2 > gamma^2, and the lin / log / log-piecewise
// bin map with flipud. Outputs: Wx (B * na, N) interleaved complex and
// either k (B * na, N) int32, k = -1 on gated cells, or dWx like Wx. A
// row's arithmetic does not depend on its batch index or on how the
// wrapper chunks the rows, so a batched row is bit-identical to the same
// signal run alone.
//
// Order-2 mode (out_mode 3) forms five spectra from psih and its closed-
// form derivatives psih', psih'' at w = a xi (GMW: with u = wc w,
// psih' = psih (beta - gamma u^gamma) / w, psih'' = psih ((beta - gamma
// u^gamma)^2 - beta - gamma (gamma - 1) u^gamma) / w^2):
//   W = psih xh, A = i xi psih xh, B = i a psih' xh, Bd = -xi a psih' xh,
//   C = -a^2 psih'' xh
// (xi not divided by dt; the Nyquist bin halved in all five), and per
// cell p2 = (Bd W - A B) / (B^2 - C W), p1 = (A + p2 B) / W, both divides
// regularized by |den|^2 + tiny, w2 = |Im p1| / (2 pi dt), the gamma gate
// and the bin map (XLA twin: ssqueezepy_tpu/models/ssq_cwt2.py
// _wsst2_rows; products in its order).
//
// Design: four-step DFT over n_up = f1 * f2 with n = k1 + f1 k2 and
// m = m1 f2 + m2, both steps inside these kernels (no cuFFT).
//   launch 1 (stage1): one block per (scale, P1 columns m2). Synthesizes
//     psih in closed form (GMW, log space), forms the spectra (W, and D
//     unless only Wx is asked), runs the length-f1 inverse DFT over m1 in
//     shared memory (radix 2), applies the twiddle
//     e^{+2 pi i m2 k1 / n_up} / n_up and writes the planes to a scratch
//     buffer (planes x rows x n_up complex).
//   launch 2 (stage2): one block per (scale, P2 columns k1). Runs the
//     length-f2 DFT over m2, keeps the k2 whose n lands in [n1, n1+N),
//     and writes Wx (and dWx), or runs the phase / gate / bin epilogue,
//     where dWx never leaves the chip beyond the scratch plane.
// Bound (bins mode): at the main path's shape (293 scales, n_up = 2^18) the two
// inverse DFTs per scale (~13 GFLOP in float32 at 5 n log2 n, less the
// first stage, whose upper half-spectrum inputs are zero) outweigh the
// bytes the function must move (~0.56 GB), so it is operation-bound on
// paper; this first version also moves the scratch planes through device
// memory twice (~2.5 GB), which the bound does not count. Order-2 mode:
// five DFTs per scale (~33 GFLOP) against the same ~0.56 GB, operation-
// bound; its five scratch planes (~6 GB of traffic at that shape) exceed
// the wrapper's scratch budget, so rows run in two chunks. Templated on
// float and double.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"

namespace {

using namespace bins;

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
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

// Host-side parameter block, copied by value into both launches.
struct Cfg {
  int n_up, f1, f2, lg1, lg2, half, n1, N, P1, P2, rows, row0;
  int l1_norm;
  // out_mode 0: (Wx, k); 1: Wx; 2: (Wx, dWx); 3: (W, k) of order 2
  int out_mode, planes, na;
  double xi_step, inv_dt, gamma_gate;
  double logconst, amp, wgamma, beta, wc;
  double tiny, two_pi_dt;  // order 2: divide regularizer, 2 pi dt
  BinMap bm;
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

template <typename CT>
__device__ __forceinline__ CT cmul(CT a, CT b) {
  CT y;
  y.x = a.x * b.x - a.y * b.y;
  y.y = a.x * b.y + a.y * b.x;
  return y;
}

template <typename CT>
__device__ __forceinline__ CT csub(CT a, CT b) {
  CT y;
  y.x = a.x - b.x;
  y.y = a.y - b.y;
  return y;
}

// a / b with the denominator |b|^2 + tiny
template <typename T, typename CT>
__device__ __forceinline__ CT cdiv(CT a, CT b, T tiny) {
  const T d = b.x * b.x + b.y * b.y + tiny;
  CT y;
  y.x = (a.x * b.x + a.y * b.y) / d;
  y.y = (a.y * b.x - a.x * b.y) / d;
  return y;
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
  CT* buf = tw + (c.f1 >> 1);             // [plane][p][m1], planes*P1*f1
  const int L = c.f1, P = c.P1;
  const int a = blockIdx.y;               // row within this chunk
  const int g = c.row0 + a;               // global row b * na + scale
  const int m2_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);

  xh += (size_t)(g / c.na) * c.half;
  const T scale = scales[g % c.na];
  const T inv_dt = (T)c.inv_dt;
  const T norm = c.l1_norm ? (T)1 : sqrt_t(scale);
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int p = e % P;
    const int m1 = e / P;
    const long m = (long)m1 * c.f2 + m2_0 + p;
    CT X[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) X[q].x = X[q].y = (T)0;
    if (m < c.half) {
      const T xi = (T)((double)m * c.xi_step);
      const T w = scale * xi;
      const T psi = gmw_psih<T>(w, c) * norm;
      CT v = xh[m];
      if (m == c.half - 1 && (c.n_up & 1) == 0) {  // Nyquist halving
        v.x *= (T)0.5;
        v.y *= (T)0.5;
      }
      X[0].x = psi * v.x;
      X[0].y = psi * v.y;
      if (c.planes == 2) {                  // dW: times i xi / dt
        const T xid = xi * inv_dt;
        X[1].x = -xid * X[0].y;
        X[1].y = xid * X[0].x;
      } else if (c.planes == 5) {           // order 2: A, B, Bd, C
        T tb = (T)0, t2b = (T)0;
        if (psi != (T)0) {
          const T ug = pow_t(w * (T)c.wc, (T)c.wgamma);
          const T r = (T)c.beta - (T)c.wgamma * ug;
          const T d1 = psi * r / w;
          const T d2 = psi * (r * r - (T)c.beta -
                              (T)c.wgamma * ((T)c.wgamma - (T)1) * ug) /
                       (w * w);
          tb = scale * d1;
          t2b = (scale * scale) * d2;
        }
        X[1].x = -xi * X[0].y;
        X[1].y = xi * X[0].x;
        X[2].x = -(tb * v.y);
        X[2].y = tb * v.x;
        X[3].x = -xi * (tb * v.x);
        X[3].y = -xi * (tb * v.y);
        X[4].x = -(t2b * v.x);
        X[4].y = -(t2b * v.y);
      }
    }
    const int br = bitrev(m1, c.lg1);
#pragma unroll
    for (int q = 0; q < 5; ++q)
      if (q < c.planes) buf[(q * P + p) * L + br] = X[q];
  }
  __syncthreads();
  block_fft<T>(buf, c.planes * P, L, c.lg1, tw);

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
    for (int q = 0; q < c.planes; ++q) {
      const CT v = buf[(q * P + p) * L + k1];
      CT y;
      y.x = (v.x * co - v.y * s) * inv_n;
      y.y = (v.x * s + v.y * co) * inv_n;
      scratch[q * plane + o] = y;
    }
  }
}

template <typename T>
__global__ void stage2(const typename Cplx<T>::type* __restrict__ scratch,
                       Cfg c, typename Cplx<T>::type* __restrict__ wx,
                       void* __restrict__ out2) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* buf = tw + (c.f2 >> 1);             // [plane][p][m2], planes*P2*f2
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
    for (int q = 0; q < c.planes; ++q)
      buf[(q * P + p) * L + br] = scratch[q * plane + o];
  }
  __syncthreads();
  block_fft<T>(buf, c.planes * P, L, c.lg2, tw);

  const int k2lo = c.n1 / c.f1;
  const int k2hi = (c.n1 + c.N + c.f1 - 1) / c.f1;
  const T gate = (T)c.gamma_gate * (T)c.gamma_gate;
  const size_t row = (size_t)(c.row0 + a) * c.N;
  for (int e = threadIdx.x; e < P * (k2hi - k2lo); e += blockDim.x) {
    const int p = e % P;
    const int k2 = k2lo + e / P;
    const int j = k1_0 + p + c.f1 * k2 - c.n1;
    if (j < 0 || j >= c.N) continue;
    const CT W = buf[p * L + k2];
    wx[row + j] = W;
    if (c.out_mode == 1) continue;
    if (c.out_mode == 3) {
      const CT A = buf[(P + p) * L + k2], B = buf[(2 * P + p) * L + k2];
      const CT Bd = buf[(3 * P + p) * L + k2], C = buf[(4 * P + p) * L + k2];
      const T tiny = (T)c.tiny;
      const CT p2 = cdiv(csub(cmul(Bd, W), cmul(A, B)),
                         csub(cmul(B, B), cmul(C, W)), tiny);
      const CT pB = cmul(p2, B);
      CT num;
      num.x = A.x + pB.x;
      num.y = A.y + pB.y;
      const T w2 = fabs_t(cdiv(num, W, tiny).y) / (T)c.two_pi_dt;
      const bool valid = (W.x * W.x + W.y * W.y > gate) && finite_t(w2);
      static_cast<int32_t*>(out2)[row + j] = valid ? bin_of<T>(w2, c.bm) : -1;
      continue;
    }
    const CT Dw = buf[(P + p) * L + k2];
    if (c.out_mode == 2) {
      static_cast<CT*>(out2)[row + j] = Dw;
      continue;
    }
    static_cast<int32_t*>(out2)[row + j] =
        phase_bin<T>(W, Dw, false, (T)0, gate, c.bm);
  }
}

template <typename T>
int launch(const void* xh, const void* scales, const Cfg& c, void* scratch,
           void* wx, void* out2, void* stream) {
  typedef typename Cplx<T>::type CT;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm1 = (size_t)(c.f1 / 2 + c.planes * c.P1 * c.f1) * sizeof(CT);
  const size_t sm2 = (size_t)(c.f2 / 2 + c.planes * c.P2 * c.f2) * sizeof(CT);
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
                                  static_cast<CT*>(wx), out2);
  return (int)cudaGetLastError();
}

Cfg make_cfg(const int* ip, const double* dp) {
  Cfg c;
  c.n_up = ip[0]; c.f1 = ip[1]; c.f2 = ip[2]; c.lg1 = ip[3]; c.lg2 = ip[4];
  c.half = ip[5]; c.n1 = ip[6]; c.N = ip[7]; c.P1 = ip[8]; c.P2 = ip[9];
  c.rows = ip[10]; c.row0 = ip[11]; c.l1_norm = ip[12]; c.bm.mode = ip[13];
  c.bm.idx1 = ip[14]; c.bm.omax = ip[15]; c.bm.flipud = ip[16];
  c.out_mode = ip[17]; c.planes = ip[18]; c.na = ip[19];
  c.xi_step = dp[0]; c.inv_dt = dp[1]; c.gamma_gate = dp[2];
  c.logconst = dp[3]; c.amp = dp[4]; c.wgamma = dp[5]; c.beta = dp[6];
  c.wc = dp[7]; c.bm.a0 = dp[8]; c.bm.d0 = dp[9]; c.bm.a1 = dp[10];
  c.bm.d1 = dp[11];
  c.tiny = dp[12]; c.two_pi_dt = dp[13];
  return c;
}

}  // namespace

// ip: 20 ints, dp: 14 doubles (layout in ops/cwt_cuda.py). `out2` is k
// (out_mode 0 or 3), dWx (2) or null (1); out_mode in ip says which. Returns
// cudaGetLastError() after the launches.
extern "C" int cwt_bins_f32(const void* xh, const void* scales, const int* ip,
                            const double* dp, void* scratch, void* wx,
                            void* out2, void* stream) {
  return launch<float>(xh, scales, make_cfg(ip, dp), scratch, wx, out2,
                       stream);
}

extern "C" int cwt_bins_f64(const void* xh, const void* scales, const int* ip,
                            const double* dp, void* scratch, void* wx,
                            void* out2, void* stream) {
  return launch<double>(xh, scales, make_cfg(ip, dp), scratch, wx, out2,
                        stream);
}
