// Hop-1 STFT rows from precomputed window tables: the table kernel.
//
// Replaces the TPU kernels ssqueezepy_tpu/ops/stft_conv.py::_make_stft_kernel
// (entries stft_pallas_rows, stft_conv_bins, stft_conv) and, in mode 3,
// fsst2_pallas_rows (FSST2, below). At hop 1 each STFT
// row i is a correlation of the padded signal with a fixed kernel, so with
// xh = fft(pad(x), Np2) and the row tables H, Hd (n_rows, Np2):
//
//   Sx[i, n]  = (1/Np2) sum_m H[i, m]  xh[m] e^{+2 pi i m n / Np2}
//   dSx[i, n] = fs * the same sum over Hd[i, m]
//
// for n in [0, N). Four modes: 0 Sx; 1 Sx and dSx; 2 Sx and the bin
// plane k, where dSx stays in the kernel and k[i, n] is the lin bin of
// w = |Sfs[i] - Im(dSx / Sx) / 2pi| (round half to even, clamped to
// [0, omax], flipud), or -1 where |Sx|^2 <= gamma^2; 3 FSST2: H is a bank
// of five tables (windows g, g', t g, t g', g'', per-sample units) giving
// V, Vg1, Vt, Vtd, Vd2, and k is the lin bin of the chirp-corrected
//   w2 = |Sfs[i] - fs Im(Vg1/V)/2pi + (fs/2pi) Im((Vd2 V - Vg1^2) /
//        (Vtd V - Vt Vg1)) Re(Vt/V)|
// (divides regularized by |den|^2 + tiny; XLA twin
// ssqueezepy_tpu/models/ssq_stft.py _fsst2_rows, products in its order);
// V is written, the four other rows stay in the kernel.
//
// Design: four-step inverse DFT over Np2 = f1 * f2 with n = k1 + f1 k2,
// m = m1 f2 + m2, both steps in these kernels (no cuFFT). Np2 is
// 2^a * {1, 3, 5, 9, 15}, so each step is a mixed-radix (4, 2, 3, 5)
// Stockham transform in shared memory, ping-ponging between two buffers.
//   launch 1 (stage1): one block per (row, P1 columns m2). Reads the
//     table row(s) and xh, forms the products, runs the length-f1
//     transform over m1, applies the twiddle e^{+2 pi i m2 k1 / Np2} / Np2
//     and writes one or two planes to a scratch buffer.
//   launch 2 (stage2): one block per (row, P2 columns k1). Runs the
//     length-f2 transform over m2, keeps the n that land in [0, N) and
//     runs the mode's epilogue.
// Twiddle arguments are exact: products of integers below Np2 (or below
// the transform length) index a table or are reduced before sincospi.
// Bound: at the ssq_stft headline (300 rows, Np2 = 163840 = 320 x 512,
// bins mode) the bytes the function must move (xh + Sx + k, ~0.58 GB)
// outweigh the DFT operations (~8.5 GFLOP in float32), so it is
// bytes-bound on paper; this first version also reads the two tables
// (~0.79 GB) and moves the scratch planes through device memory twice
// (~1.6 GB), which the bound does not count. Mode 3 at the ssq_stft2
// headline: five DFTs per row (~21 GFLOP) against ~0.58 GB, operation-
// bound on paper; it also reads five tables (~1.97 GB) and moves five
// scratch planes (~3.9 GB of traffic). Templated on float and double.
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

template <typename CT>
__device__ __forceinline__ CT cmul(CT a, CT b) {
  CT y;
  y.x = a.x * b.x - a.y * b.y;
  y.y = a.x * b.y + a.y * b.x;
  return y;
}

template <typename CT>
__device__ __forceinline__ CT cadd(CT a, CT b) {
  CT y;
  y.x = a.x + b.x;
  y.y = a.y + b.y;
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

// Host-side parameter block, copied by value into both launches.
struct Cfg {
  int Np2, f1, f2, N, P1, P2, rows, row0, mode, planes, omax, flipud;
  int tab_rows;                            // rows of each table
  double inv_n, fs, gamma_gate, vmin, dv;
  double tiny, two_pi, fs_2pi;             // mode 3: regularizer, 2 pi, fs/2pi
};

// tw[t] = e^{+2 pi i t / L}, t < L (inverse sign).
template <typename T>
__device__ void fill_twiddles(typename Cplx<T>::type* tw, int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    T s, c;
    sincospi_t((T)(2 * i) / (T)L, &s, &c);
    tw[i].x = c;
    tw[i].y = s;
  }
}

// Inverse DFT (unnormalized, sign +) of `nseq` length-L sequences stored
// back to back in `a`, natural order in and out: mixed-radix Stockham
// autosort, radices 4, 2, 3, 5, ping-ponging between `a` and `b`. Returns
// the buffer that holds the result. Ends with __syncthreads().
template <typename T>
__device__ typename Cplx<T>::type* stockham(typename Cplx<T>::type* a,
                                            typename Cplx<T>::type* b,
                                            int nseq, int L,
                                            const typename Cplx<T>::type* tw) {
  typedef typename Cplx<T>::type CT;
  int Ns = 1, rem = L;
  while (rem > 1) {
    const int R = (rem % 4 == 0) ? 4 : (rem % 2 == 0) ? 2 : (rem % 3 == 0) ? 3 : 5;
    const int LR = L / R;
    const int tstep = L / (Ns * R);
    for (int e = threadIdx.x; e < nseq * LR; e += blockDim.x) {
      const int s = e / LR;
      const int j = e - s * LR;
      const int jm = j % Ns;
      const CT* src = a + (size_t)s * L;
      CT v[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        if (r < R) {
          // r * jm * tstep < R * Ns * L / (Ns * R) = L
          v[r] = r == 0 ? src[j] : cmul(src[j + r * LR], tw[r * jm * tstep]);
        }
      }
      CT* dst = b + (size_t)s * L + (j / Ns) * Ns * R + jm;
      if (R == 2) {
        CT y0, y1;
        y0.x = v[0].x + v[1].x; y0.y = v[0].y + v[1].y;
        y1.x = v[0].x - v[1].x; y1.y = v[0].y - v[1].y;
        dst[0] = y0;
        dst[Ns] = y1;
      } else if (R == 4) {
        // e^{+2 pi i r k / 4} = i^{r k}
        const T s02x = v[0].x + v[2].x, s02y = v[0].y + v[2].y;
        const T d02x = v[0].x - v[2].x, d02y = v[0].y - v[2].y;
        const T s13x = v[1].x + v[3].x, s13y = v[1].y + v[3].y;
        const T d13x = v[1].x - v[3].x, d13y = v[1].y - v[3].y;
        CT y;
        y.x = s02x + s13x; y.y = s02y + s13y; dst[0] = y;
        y.x = d02x - d13y; y.y = d02y + d13x; dst[Ns] = y;
        y.x = s02x - s13x; y.y = s02y - s13y; dst[2 * Ns] = y;
        y.x = d02x + d13y; y.y = d02y - d13x; dst[3 * Ns] = y;
      } else {
        // radix 3 or 5: e^{+2 pi i r k / R} = tw[((r k) mod R) * L / R]
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          if (k < R) {
            CT acc = v[0];
#pragma unroll
            for (int r = 1; r < 5; ++r) {
              if (r < R) acc = cadd(acc, cmul(v[r], tw[((r * k) % R) * LR]));
            }
            dst[k * Ns] = acc;
          }
        }
      }
    }
    __syncthreads();
    CT* t = a; a = b; b = t;
    Ns *= R;
    rem /= R;
  }
  return a;
}

template <typename T>
__global__ void stage1(const typename Cplx<T>::type* __restrict__ xh,
                       const typename Cplx<T>::type* __restrict__ H,
                       const typename Cplx<T>::type* __restrict__ Hd, Cfg c,
                       typename Cplx<T>::type* __restrict__ scratch) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = c.f1, P = c.P1, nseq = c.planes * P;
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* bufa = tw + L;                       // [plane][p][m1]
  CT* bufb = bufa + (size_t)nseq * L;
  const int a = blockIdx.y;                // row within this chunk
  const size_t trow = (size_t)(c.row0 + a) * c.Np2;
  const int m2_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);

  // mode 3: table q of the bank starts at H + q * tab_rows * Np2
  const size_t tplane = (size_t)c.tab_rows * c.Np2;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int p = e % P;
    const int m1 = e / P;
    const size_t m = (size_t)m1 * c.f2 + m2_0 + p;
    const CT x = xh[m];
    bufa[p * L + m1] = cmul(H[trow + m], x);
    if (c.mode == 3) {
#pragma unroll
      for (int q = 1; q < 5; ++q)
        bufa[(q * P + p) * L + m1] = cmul(H[q * tplane + trow + m], x);
    } else if (c.planes == 2) {
      bufa[(P + p) * L + m1] = cmul(Hd[trow + m], x);
    }
  }
  __syncthreads();
  const CT* res = stockham<T>(bufa, bufb, nseq, L, tw);

  const T inv_n = (T)c.inv_n;
  const size_t plane = (size_t)c.rows * c.Np2;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int k1 = e % L;
    const int p = e / L;
    const int m2 = m2_0 + p;
    // m2 * k1 < f2 * f1 = Np2: the twiddle's argument is exact
    T s, co;
    sincospi_t((T)((double)(2 * (long long)m2 * k1) / c.Np2), &s, &co);
    const size_t o = ((size_t)a * c.f2 + m2) * c.f1 + k1;
    for (int q = 0; q < c.planes; ++q) {
      const CT v = res[(q * P + p) * L + k1];
      CT y;
      y.x = (v.x * co - v.y * s) * inv_n;
      y.y = (v.x * s + v.y * co) * inv_n;
      scratch[q * plane + o] = y;
    }
  }
}

template <typename T>
__global__ void stage2(const typename Cplx<T>::type* __restrict__ scratch,
                       const T* __restrict__ sfs, Cfg c,
                       typename Cplx<T>::type* __restrict__ sx,
                       void* __restrict__ out2) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = c.f2, P = c.P2, nseq = c.planes * P;
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* bufa = tw + L;                       // [plane][p][m2]
  CT* bufb = bufa + (size_t)nseq * L;
  const int a = blockIdx.y;
  const int k1_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);

  const size_t plane = (size_t)c.rows * c.Np2;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int p = e % P;
    const int m2 = e / P;
    const size_t o = ((size_t)a * c.f2 + m2) * c.f1 + k1_0 + p;
    for (int q = 0; q < c.planes; ++q)
      bufa[(q * P + p) * L + m2] = scratch[q * plane + o];
  }
  __syncthreads();
  const CT* res = stockham<T>(bufa, bufb, nseq, L, tw);

  const int k2hi = (c.N + c.f1 - 1) / c.f1;
  const int i = c.row0 + a;
  const size_t row = (size_t)i * c.N;
  const T fs = (T)c.fs;
  const T gate = (T)c.gamma_gate * (T)c.gamma_gate;
  const T two_pi = (T)6.283185307179586;
  const T sfs_i = c.mode >= 2 ? sfs[i] : (T)0;
  for (int e = threadIdx.x; e < P * k2hi; e += blockDim.x) {
    const int p = e % P;
    const int k2 = e / P;
    const int n = k1_0 + p + c.f1 * k2;
    if (n >= c.N) continue;
    const CT S = res[p * L + k2];
    sx[row + n] = S;
    if (c.mode == 0) continue;
    CT D = res[(P + p) * L + k2];
    T denom, w;
    if (c.mode == 3) {
      // S = V, D = Vg1; fs enters only here (per-sample windows)
      const CT Vt = res[(2 * P + p) * L + k2];
      const CT Vtd = res[(3 * P + p) * L + k2];
      const CT Vd2 = res[(4 * P + p) * L + k2];
      const T tiny = (T)c.tiny;
      const T w1 = sfs_i - fs * cdiv(D, S, tiny).y / (T)c.two_pi;
      const T trel = cdiv(Vt, S, tiny).x;
      const T q = cdiv(csub(cmul(Vd2, S), cmul(D, D)),
                       csub(cmul(Vtd, S), cmul(Vt, D)), tiny).y;
      denom = S.x * S.x + S.y * S.y;
      w = fabs_t(w1 + (T)c.fs_2pi * q * trel);
    } else {
      D.x *= fs;
      D.y *= fs;
      if (c.mode == 1) {
        static_cast<CT*>(out2)[row + n] = D;
        continue;
      }
      // w = |Sfs[i] - Im(D / S) / 2pi|, S = C + iE, D = A + iB
      denom = S.x * S.x + S.y * S.y;
      w = fabs_t(sfs_i - (D.y * S.x - D.x * S.y) / (denom * two_pi));
    }
    int k = -1;
    if (denom > gate && finite_t(w)) {
      k = (int)fmin_t(rint_t(fmax_t((w - (T)c.vmin) / (T)c.dv, (T)0)),
                      (T)c.omax);
      if (c.flipud) k = c.omax - k;
    }
    static_cast<int32_t*>(out2)[row + n] = k;
  }
}

template <typename T>
int launch(const void* xh, const void* H, const void* Hd, const void* sfs,
           const Cfg& c, void* scratch, void* sx, void* out2, void* stream) {
  typedef typename Cplx<T>::type CT;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t sm1 = (size_t)c.f1 * (1 + 2 * c.planes * c.P1) * sizeof(CT);
  const size_t sm2 = (size_t)c.f2 * (1 + 2 * c.planes * c.P2) * sizeof(CT);
  cudaFuncSetAttribute(stage1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm1);
  cudaFuncSetAttribute(stage2<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sm2);
  dim3 g1(c.f2 / c.P1, c.rows), g2(c.f1 / c.P2, c.rows);
  stage1<T><<<g1, 256, sm1, st>>>(static_cast<const CT*>(xh),
                                  static_cast<const CT*>(H),
                                  static_cast<const CT*>(Hd), c,
                                  static_cast<CT*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage2<T><<<g2, 256, sm2, st>>>(static_cast<const CT*>(scratch),
                                  static_cast<const T*>(sfs), c,
                                  static_cast<CT*>(sx), out2);
  return (int)cudaGetLastError();
}

Cfg make_cfg(const int* ip, const double* dp) {
  Cfg c;
  c.Np2 = ip[0]; c.f1 = ip[1]; c.f2 = ip[2]; c.N = ip[3]; c.P1 = ip[4];
  c.P2 = ip[5]; c.rows = ip[6]; c.row0 = ip[7]; c.mode = ip[8];
  c.planes = ip[9]; c.omax = ip[10]; c.flipud = ip[11]; c.tab_rows = ip[12];
  c.inv_n = dp[0]; c.fs = dp[1]; c.gamma_gate = dp[2]; c.vmin = dp[3];
  c.dv = dp[4]; c.tiny = dp[5]; c.two_pi = dp[6]; c.fs_2pi = dp[7];
  return c;
}

}  // namespace

// ip: 13 ints, dp: 8 doubles (layout in ops/stft_cuda.py). `Hd`, `sfs`
// and `out2` may be null where the mode does not read or write them; in
// mode 3 `H` is the (5, tab_rows, Np2) bank and `Hd` is null.
// Returns cudaGetLastError() after the launches.
extern "C" int stft_conv_f32(const void* xh, const void* H, const void* Hd,
                             const void* sfs, const int* ip, const double* dp,
                             void* scratch, void* sx, void* out2,
                             void* stream) {
  return launch<float>(xh, H, Hd, sfs, make_cfg(ip, dp), scratch, sx, out2,
                       stream);
}

extern "C" int stft_conv_f64(const void* xh, const void* H, const void* Hd,
                             const void* sfs, const int* ip, const double* dp,
                             void* scratch, void* sx, void* out2,
                             void* stream) {
  return launch<double>(xh, H, Hd, sfs, make_cfg(ip, dp), scratch, sx, out2,
                        stream);
}
