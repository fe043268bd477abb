// Synchrosqueezing reassignment from precomputed bin indices:
//
//   Tx[b, k[b, i, j], j] += Wx[b, i, j] * cst[i]   for 0 <= k <= nbins - 1
//
// any other k (the -1 of gated cells included) is dropped. Wx and Tx are
// interleaved complex, k int32, cst real; Wx and k are (B, na, N), Tx
// (B, nbins, N) is written whole (B = 1 for one signal).
//
// Replaces the TPU kernel ssqueezepy_tpu/ops/ssq_pallas.py::_make_kv_kernel
// with _shift_scatter_core (entry points scatter_kv_direct, and
// scatter_kv_pallas, vmapped over a batch). The TPU has
// no per-lane scatter and decomposed it into sublane shifts; this card
// scatters into shared memory directly.
//
// Design: a block owns TC consecutive time columns of one signal
// (blockIdx.y = b, so a batch is one launch); each thread owns one
// column and walks the rows i in order, accumulating into its own column
// of a (nbins, TC) shared-memory accumulator. No two threads touch the
// same address, so there are no atomics and the result is bit-identical
// from run to run (streaming resume relies on that). Reads of Wx and k are
// coalesced across the block's columns; the accumulator is written out
// row by row, also coalesced.
// Bound: memory — it must read Wx + k + cst and write Tx (~0.94 GB at
// 293 x 160000 in complex64 + int32, ~2 FLOP per byte at most).
//
// The same file holds the generic scatter (B5), which takes cells marked
// valid and wraps a negative bin once, as numpy indexing does:
//
//   k' = k + nbins where k < 0
//   out[b, k'[b, i, j], j] += v[b, i, j] * cst[i]
//        for valid[b, i, j] and 0 <= k' <= nbins - 1
//
// any other cell is dropped (so k = -1 lands in bin nbins - 1 here, where
// B2 drops it). valid is a byte plane (torch.bool) or null (all valid),
// cst (na,) or null (1). It replaces ssqueezepy_tpu/ops/ssq_pallas.py::
// _make_scatter_kernel (site _scatter_call, entry point
// shift_scatter_pallas, selected by ops/ssq_kernels.py::_dispatch_scatter
// and vmapped over a batch). Design and bound are B2's; it reads one byte
// more per cell (~0.98 GB at 293 x 160000, ~0.29 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Cplx;
template <> struct Cplx<float> { typedef float2 type; };
template <> struct Cplx<double> { typedef double2 type; };

// One thread's column j of one signal: the rows in order into its column
// of the accumulator, then the column of Tx. Kept out of line: inlined
// into the kernel beside the batch offset, the compiler scheduled the
// unrolled loop's loads worse and the kernel ran ~1.6x slower on the
// H100; called with the offset pointers it runs as the one-signal kernel
// did (PERF.md, section 6).
template <typename T>
__device__ __noinline__ void scatter_column(
    const typename Cplx<T>::type* __restrict__ wx,
    const int32_t* __restrict__ k, const T* __restrict__ cst, int na, int N,
    int nbins, int j, int t, int TC, typename Cplx<T>::type* acc,
    typename Cplx<T>::type* __restrict__ tx) {
  typedef typename Cplx<T>::type CT;
  for (int b = 0; b < nbins; ++b) {
    acc[b * TC + t].x = (T)0;
    acc[b * TC + t].y = (T)0;
  }
#pragma unroll 8
  for (int i = 0; i < na; ++i) {
    const size_t o = (size_t)i * N + j;
    const int kk = k[o];
    const CT v = wx[o];
    const T c = cst[i];
    if (kk >= 0 && kk < nbins) {
      CT s = acc[kk * TC + t];
      s.x += v.x * c;
      s.y += v.y * c;
      acc[kk * TC + t] = s;
    }
  }
  for (int b = 0; b < nbins; ++b) tx[(size_t)b * N + j] = acc[b * TC + t];
}

template <typename T>
__global__ void scatter_kv_kernel(const typename Cplx<T>::type* __restrict__ wx,
                                  const int32_t* __restrict__ k,
                                  const T* __restrict__ cst, int na, int N,
                                  int nbins,
                                  typename Cplx<T>::type* __restrict__ tx) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* acc = reinterpret_cast<CT*>(smem_raw);  // [bin][column]
  const int TC = blockDim.x;
  const int t = threadIdx.x;
  const int j = blockIdx.x * TC + t;
  if (j >= N) return;
  const size_t in = (size_t)blockIdx.y * na * N;
  scatter_column<T>(wx + in, k + in, cst, na, N, nbins, j, t, TC, acc,
                    tx + (size_t)blockIdx.y * nbins * N);
}

template <typename T>
int launch(const void* wx, const void* k, const void* cst, int B, int na,
           int N, int nbins, int tc, void* tx, void* stream) {
  typedef typename Cplx<T>::type CT;
  const size_t smem = (size_t)nbins * tc * sizeof(CT);
  cudaFuncSetAttribute(scatter_kv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + tc - 1) / tc, B);
  scatter_kv_kernel<T><<<grid, tc, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const CT*>(wx), static_cast<const int32_t*>(k),
      static_cast<const T*>(cst), na, N, nbins, static_cast<CT*>(tx));
  return (int)cudaGetLastError();
}

// B5's column walk, out of line for the reason given above. HasValid and
// HasConst are compile-time so that B5 without a mask or a const runs B2's
// loop with only the wrap added.
template <typename T, bool HasValid, bool HasConst>
__device__ __noinline__ void shift_scatter_column(
    const typename Cplx<T>::type* __restrict__ v,
    const int32_t* __restrict__ k, const uint8_t* __restrict__ valid,
    const T* __restrict__ cst, int na, int N, int nbins, int j, int t,
    int TC, typename Cplx<T>::type* acc,
    typename Cplx<T>::type* __restrict__ out) {
  typedef typename Cplx<T>::type CT;
  for (int b = 0; b < nbins; ++b) {
    acc[b * TC + t].x = (T)0;
    acc[b * TC + t].y = (T)0;
  }
#pragma unroll 8
  for (int i = 0; i < na; ++i) {
    const size_t o = (size_t)i * N + j;
    int kk = k[o];
    const CT x = v[o];
    const T c = HasConst ? cst[i] : (T)1;
    bool ok = true;
    if (HasValid) ok = valid[o] != 0;
    if (kk < 0) kk += nbins;
    if (ok && kk >= 0 && kk < nbins) {
      CT s = acc[kk * TC + t];
      if (HasConst) {
        s.x += x.x * c;
        s.y += x.y * c;
      } else {
        s.x += x.x;
        s.y += x.y;
      }
      acc[kk * TC + t] = s;
    }
  }
  for (int b = 0; b < nbins; ++b) out[(size_t)b * N + j] = acc[b * TC + t];
}

template <typename T, bool HasValid, bool HasConst>
__global__ void shift_scatter_kernel(
    const typename Cplx<T>::type* __restrict__ v,
    const int32_t* __restrict__ k, const uint8_t* __restrict__ valid,
    const T* __restrict__ cst, int na, int N, int nbins,
    typename Cplx<T>::type* __restrict__ out) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* acc = reinterpret_cast<CT*>(smem_raw);  // [bin][column]
  const int TC = blockDim.x;
  const int t = threadIdx.x;
  const int j = blockIdx.x * TC + t;
  if (j >= N) return;
  const size_t in = (size_t)blockIdx.y * na * N;
  shift_scatter_column<T, HasValid, HasConst>(
      v + in, k + in, HasValid ? valid + in : valid, cst, na, N, nbins, j, t,
      TC, acc, out + (size_t)blockIdx.y * nbins * N);
}

template <typename T, bool HasValid, bool HasConst>
int launch_shift(const void* v, const void* k, const void* valid,
                 const void* cst, int B, int na, int N, int nbins, int tc,
                 void* out, void* stream) {
  typedef typename Cplx<T>::type CT;
  const size_t smem = (size_t)nbins * tc * sizeof(CT);
  cudaFuncSetAttribute(shift_scatter_kernel<T, HasValid, HasConst>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + tc - 1) / tc, B);
  shift_scatter_kernel<T, HasValid, HasConst>
      <<<grid, tc, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const CT*>(v), static_cast<const int32_t*>(k),
          static_cast<const uint8_t*>(valid), static_cast<const T*>(cst),
          na, N, nbins, static_cast<CT*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shift_any(const void* v, const void* k, const void* valid,
                     const void* cst, int B, int na, int N, int nbins, int tc,
                     void* out, void* stream) {
  if (valid && cst)
    return launch_shift<T, true, true>(v, k, valid, cst, B, na, N, nbins, tc,
                                       out, stream);
  if (valid)
    return launch_shift<T, true, false>(v, k, valid, cst, B, na, N, nbins,
                                        tc, out, stream);
  if (cst)
    return launch_shift<T, false, true>(v, k, valid, cst, B, na, N, nbins,
                                        tc, out, stream);
  return launch_shift<T, false, false>(v, k, valid, cst, B, na, N, nbins, tc,
                                       out, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch. `tc` columns per block, B
// signals (B <= 65535).
extern "C" int scatter_kv_f32(const void* wx, const void* k, const void* cst,
                              int B, int na, int N, int nbins, int tc,
                              void* tx, void* stream) {
  return launch<float>(wx, k, cst, B, na, N, nbins, tc, tx, stream);
}

extern "C" int scatter_kv_f64(const void* wx, const void* k, const void* cst,
                              int B, int na, int N, int nbins, int tc,
                              void* tx, void* stream) {
  return launch<double>(wx, k, cst, B, na, N, nbins, tc, tx, stream);
}

// B5. valid (uint8) and cst may be null. Returns cudaGetLastError() after
// the launch.
extern "C" int shift_scatter_f32(const void* v, const void* k,
                                 const void* valid, const void* cst, int B,
                                 int na, int N, int nbins, int tc, void* out,
                                 void* stream) {
  return launch_shift_any<float>(v, k, valid, cst, B, na, N, nbins, tc, out,
                                 stream);
}

extern "C" int shift_scatter_f64(const void* v, const void* k,
                                 const void* valid, const void* cst, int B,
                                 int na, int N, int nbins, int tc, void* out,
                                 void* stream) {
  return launch_shift_any<double>(v, k, valid, cst, B, na, N, nbins, tc, out,
                                  stream);
}
