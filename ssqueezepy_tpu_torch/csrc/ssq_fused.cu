// Fused synchrosqueezing reassignment from a transform and its derivative:
// for each cell (b, i, j), with C + iD = Wx[b, i, j], A + iB = dWx[b, i, j],
//
//   w = (B C - A D) / ((C^2 + D^2) 2pi);  w <- |w|, or |Sfs[i] - w|
//   k = the lin / log / log-piecewise bin of w (flipud: omax - k),
//       dropped where C^2 + D^2 <= gamma^2 or w is not finite
//   Tx[b, k, j] += Wx[b, i, j] * cst[i]
//
// Wx, dWx (B, na, N) and Tx (B, nbins, N) interleaved complex, cst and Sfs
// (na,) real; Tx is written whole. The phase / gate / bin arithmetic is
// bins.cuh's phase_bin, the one the CWT kernel's bins mode runs.
//
// Replaces the TPU kernel ssqueezepy_tpu/ops/ssq_pallas.py::
// _make_fused_kernel (site _ssq_fused_call, entry point ssq_fused_pallas,
// vmapped over a batch). The TPU has no per-lane scatter: it shifted rows
// by their displacement from a natural bin and reduced the edge bins
// apart. This card scatters into shared memory directly, so neither the
// natural-bin row placement nor the edge reductions are carried over.
//
// Design (the scatter kernel's, scatter_kv.cu): a block owns TC
// consecutive time columns of one signal (blockIdx.y = b); each thread owns
// one column, walks the rows i in order, computes the cell's bin in
// registers and accumulates Wx * cst into its own column of a (nbins, TC)
// shared-memory accumulator. The derivative plane is read once and the bin
// plane never exists in device memory. No atomics: the result is
// bit-identical from run to run. Reads of Wx and dWx are coalesced across
// the block's columns; the accumulator is written out row by row.
// Bound: memory. It must read Wx and dWx and write Tx (~1.1 GB at 293 x
// 160000 in complex64, ~0.34 ms at 3.35 TB/s); the per-cell arithmetic
// (one divide, one log2, ~20 FLOP) stays below the float32 peak.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"

namespace {

using namespace bins;

// The row walk stays inline here: moved out of line as in scatter_kv.cu,
// it measured slower on the H100.
template <typename T>
__global__ void ssq_fused_kernel(const typename Cplx<T>::type* __restrict__ wx,
                                 const typename Cplx<T>::type* __restrict__ dwx,
                                 const T* __restrict__ cst,
                                 const T* __restrict__ sfs, BinMap bm,
                                 double gamma, int na, int N, int nbins,
                                 typename Cplx<T>::type* __restrict__ tx) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* acc = reinterpret_cast<CT*>(smem_raw);  // [bin][column]
  const int TC = blockDim.x;
  const int t = threadIdx.x;
  const int j = blockIdx.x * TC + t;
  if (j >= N) return;
  wx += (size_t)blockIdx.y * na * N;
  dwx += (size_t)blockIdx.y * na * N;
  tx += (size_t)blockIdx.y * nbins * N;
  for (int b = 0; b < nbins; ++b) {
    acc[b * TC + t].x = (T)0;
    acc[b * TC + t].y = (T)0;
  }
  const T g = (T)gamma;
  const T gate = g * g;
  const bool has_sfs = sfs != nullptr;
#pragma unroll 4
  for (int i = 0; i < na; ++i) {
    const size_t o = (size_t)i * N + j;
    const CT v = wx[o];
    const CT dv = dwx[o];
    const int kk = phase_bin<T>(v, dv, has_sfs, has_sfs ? sfs[i] : (T)0,
                                gate, bm);
    if (kk >= 0 && kk < nbins) {
      const T c = cst[i];
      CT s = acc[kk * TC + t];
      s.x += v.x * c;
      s.y += v.y * c;
      acc[kk * TC + t] = s;
    }
  }
  for (int b = 0; b < nbins; ++b) tx[(size_t)b * N + j] = acc[b * TC + t];
}

template <typename T>
int launch(const void* wx, const void* dwx, const void* cst, const void* sfs,
           const int* ip, const double* dp, void* tx, void* stream) {
  typedef typename Cplx<T>::type CT;
  const int B = ip[0], na = ip[1], N = ip[2], nbins = ip[3], tc = ip[4];
  BinMap bm;
  bm.mode = ip[6]; bm.idx1 = ip[7]; bm.omax = ip[8]; bm.flipud = ip[9];
  bm.a0 = dp[1]; bm.d0 = dp[2]; bm.a1 = dp[3]; bm.d1 = dp[4];
  const size_t smem = (size_t)nbins * tc * sizeof(CT);
  cudaFuncSetAttribute(ssq_fused_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + tc - 1) / tc, B);
  ssq_fused_kernel<T><<<grid, tc, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const CT*>(wx), static_cast<const CT*>(dwx),
      static_cast<const T*>(cst), ip[5] ? static_cast<const T*>(sfs) : nullptr,
      bm, dp[0], na, N, nbins, static_cast<CT*>(tx));
  return (int)cudaGetLastError();
}

}  // namespace

// ip: B, na, N, nbins, tc (columns per block), has_sfs, mode, idx1, omax,
// flipud; dp: gamma, a0, d0, a1, d1 (layout in ops/ssq_cuda.py). `sfs` may
// be null when has_sfs is 0. Returns cudaGetLastError() after the launch.
extern "C" int ssq_fused_f32(const void* wx, const void* dwx, const void* cst,
                             const void* sfs, const int* ip, const double* dp,
                             void* tx, void* stream) {
  return launch<float>(wx, dwx, cst, sfs, ip, dp, tx, stream);
}

extern "C" int ssq_fused_f64(const void* wx, const void* dwx, const void* cst,
                             const void* sfs, const int* ip, const double* dp,
                             void* tx, void* stream) {
  return launch<double>(wx, dwx, cst, sfs, ip, dp, tx, stream);
}
