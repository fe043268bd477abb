// Phase transform -> reassignment frequency -> bin index, shared by the
// fused CWT kernel's bins epilogues (cwt_bins.cu) and the fused phase +
// bins + scatter kernel (B4, scatter_kv.cu), so both give the same k for
// the same (W, dW) cell.
//
// Replaces the arithmetic of ssqueezepy_tpu/ops/ssq_pallas.py::
// _phase_bin_math and _bins_from_w: w = Im(dW / W) / 2pi as
// (B C - A D) / ((C^2 + D^2) 2pi) with W = C + iD, dW = A + iB; w <- |w|,
// or |sfs - w| for the STFT; the gamma gate |W|^2 > gamma^2; then the
// lin / log / log-piecewise bin map, rounding half to even, and flipud
// (k -> omax - k). A cell that is gated or whose w is not finite gets
// k = -1. w = 0 (log2 = -inf) clamps to bin 0 and stays valid.
#pragma once
#include <cuda_runtime.h>

namespace bins {

template <typename T> struct Cplx;
template <> struct Cplx<float> { typedef float2 type; };
template <> struct Cplx<double> { typedef double2 type; };

__device__ __forceinline__ float log2_t(float x) { return log2f(x); }
__device__ __forceinline__ double log2_t(double x) { return log2(x); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float fabs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_t(double x) { return fabs(x); }
__device__ __forceinline__ float fmin_t(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ double fmin_t(double x, double y) { return fmin(x, y); }
__device__ __forceinline__ float fmax_t(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double fmax_t(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ bool finite_t(float x) { return fabsf(x) <= 3.402823466e38f; }
__device__ __forceinline__ bool finite_t(double x) { return fabs(x) <= 1.7976931348623157e308; }

// The bin map of ssq_bin_params: mode 0 'lin' (a0 = vmin, d0 = dv),
// 1 'log' (a0 = vlmin, d0 = dvl), 2 'log-piecewise' (a0 = vlmin0,
// d0 = dvl0, a1 = vlmin1, d1 = dvl1, idx1).
struct BinMap {
  int mode, idx1, omax, flipud;
  double a0, d0, a1, d1;
};

template <typename T>
__device__ __forceinline__ int bin_of(T w, const BinMap& m) {
  T kf;
  if (m.mode == 0) {
    kf = fmin_t(rint_t(fmax_t((w - (T)m.a0) / (T)m.d0, (T)0)), (T)m.omax);
  } else if (m.mode == 1) {
    const T wl = log2_t(w);
    kf = fmin_t(rint_t(fmax_t((wl - (T)m.a0) / (T)m.d0, (T)0)), (T)m.omax);
  } else {
    const T wl = log2_t(w);
    if (wl > (T)m.a1)
      kf = fmin_t(rint_t((wl - (T)m.a1) / (T)m.d1) + (T)m.idx1, (T)m.omax);
    else
      kf = fmax_t(rint_t((wl - (T)m.a0) / (T)m.d0), (T)0);
  }
  const int k = (int)kf;
  return m.flipud ? m.omax - k : k;
}

// k of one cell from W and dW (has_sfs: the STFT's per-row frequency
// sfs); gate = gamma^2 in T. -1 where gated or w is not finite.
template <typename T, typename CT>
__device__ __forceinline__ int phase_bin(CT W, CT dW, bool has_sfs, T sfs,
                                         T gate, const BinMap& m) {
  const T denom = W.x * W.x + W.y * W.y;
  const T r = (dW.y * W.x - dW.x * W.y) / (denom * (T)6.283185307179586);
  const T w = has_sfs ? fabs_t(sfs - r) : fabs_t(r);
  return (denom > gate && finite_t(w)) ? bin_of<T>(w, m) : -1;
}

}  // namespace bins
