// Hop-1 STFT rows from precomputed window tables: the table kernel.
//
// Replaces the TPU kernels ssqueezepy_tpu/ops/stft_conv.py::_make_stft_kernel
// (entries stft_pallas_rows, stft_conv_bins, stft_conv) and, in mode 3,
// fsst2_pallas_rows (FSST2, below); mode 4 is mode 3 with w2 written as a
// real plane in place of its bins, for ssq_stft2(get_w=True) (the TPU
// package computes that plane on its XLA path,
// ssqueezepy_tpu/models/ssq_stft.py::_fsst2_rows). At hop 1 each STFT
// row i is a correlation of the padded signal with a fixed kernel, so with
// xh = fft(pad(x), Np2) and the row tables H, Hd (n_rows, Np2):
//
//   Sx[i, n]  = (1/Np2) sum_m H[i, m]  xh[m] e^{+2 pi i m n / Np2}
//   dSx[i, n] = fs * the same sum over Hd[i, m]
//
// for n in [0, N). Five modes: 0 Sx; 1 Sx and dSx; 2 Sx and the bin
// plane k, where dSx stays in the kernel and k[i, n] is the lin bin of
// w = |Sfs[i] - Im(dSx / Sx) / 2pi| (round half to even, clamped to
// [0, omax], flipud), or -1 where |Sx|^2 <= gamma^2; 3 FSST2: H is a bank
// of five tables (windows g, g', t g, t g', g'', per-sample units) giving
// V, Vg1, Vt, Vtd, Vd2, and k is the lin bin of the chirp-corrected
//   w2 = |Sfs[i] - fs Im(Vg1/V)/2pi + (fs/2pi) Im((Vd2 V - Vg1^2) /
//        (Vtd V - Vt Vg1)) Re(Vt/V)|
// (divides regularized by |den|^2 + tiny; XLA twin
// ssqueezepy_tpu/models/ssq_stft.py _fsst2_rows, products in its order);
// V is written, the four other rows stay in the kernel; 4 FSST2 with V
// and w2 written, +inf where |V|^2 <= gamma^2 or w2 is not finite. Modes 3
// and 4 take w2 from one function (fsst2_w), so V and w2 are the bits
// that mode 3 bins.
//
// Design: four-step inverse DFT over Np2 = f1 * f2 with n = k1 + f1 k2,
// m = m1 f2 + m2, both steps in these kernels (no cuFFT). Np2 is
// 2^a * {1, 3, 5, 9, 15} and f2 a power of two, so each step is a
// mixed-radix (4, 2, 3, 5) Stockham transform in shared memory
// (dft_mixed.cuh: sequences at an odd stride, the sequence fastest in the
// passes). The mode is a template parameter of the launch pair, chosen at
// compile time: no mode branch runs inside a kernel.
//   launch 1 (stft_stage1<T, NP>): one block per (row, P1 columns m2),
//     over the mode's NP planes. The products table row x spectrum
//     (`Products`, one function of m1) feed the length-f1 transform over
//     m1, then the twiddle e^{+2 pi i m2 k1 / Np2} / Np2 and its planes go
//     to a scratch buffer (planes x rows x Np2)
//     (ops/stft_cuda.py::launch_plan picks the columns).
//   launch 2 (stft_stage2<T, MODE>): one block per (row, P2 columns k1).
//     The scratch planes feed the length-f2 transform over m2 of every
//     plane of the mode, and the n that land in [0, N) go through the
//     mode's epilogue.
// A batch of spectra xh (B, Np2) runs as B * tab_rows rows, global row
// g = b * tab_rows + i (as the CWT engine's batch): stage 1 reads table row
// g % tab_rows and the spectrum of signal g / tab_rows, stage 2 Sfs at
// g % tab_rows and writes output row g; the divide is once per block, and
// no arithmetic of a row depends on b, so each row is bit-identical to its
// signal launched alone. Row chunks may cross signals.
// With one or two planes per block the first pass reads its inputs from
// device memory itself (`Direct`): the passes put the sequence
// q = plane * P + p fastest, so it reads P consecutive columns per plane
// and position, as a column-fastest gather would, and the input never
// passes through shared memory. With five, a gather stores them first,
// the column p fastest and positions walked through swz (a half-warp's
// 16 / P positions lie P apart: p * S + P * u, 16 distinct bank pairs).
// The stage-2 epilogue walks k2 the same way; the stage-1 epilogue puts
// the position k1 fastest (consecutive elements, coalesced scratch
// writes). Every butterfly, twiddle and product is the one the first
// version of this kernel computed, in the same order.
// Band plan (the TPU kernel's `_band_plan`, ops/stft_conv.py): a table row
// may hold only its spectral band, br of the f1 rows m1 of the split,
// starting at r0[row] and wrapping mod f1: table row i is then (br, f2)
// and holds m1 = (r0[i] + r) % f1 at r < br. Stage 1 reads the table at r
// = (m1 - r0) mod f1 and takes the product as zero where r >= br, reading
// neither the table nor xh there; the passes, the twiddle and stage 2 do
// not change. A full table is the band br = f1, r0 = 0 (null r0): then
// every address and product is the one the kernel computed before it had
// a band, so full-table outputs keep their bits. Banding is data, not a
// template parameter: one body serves both.
// Twiddle arguments are exact: products of integers below Np2 (or below
// the transform length) index a table or are reduced before sincospi.
// Bound: at the ssq_stft headline (300 rows, Np2 = 163840 = 320 x 512,
// bins mode) the bytes the function must move (xh + Sx + k, ~0.58 GB)
// outweigh the DFT operations (~8.5 GFLOP in float32), so it is
// bytes-bound on paper; the design also reads the two tables (~0.79 GB
// full, ~0.098 GB on their band of 40 of 320 rows) and moves the scratch
// planes through device memory twice (~1.6 GB), which the bound does not
// count. Mode 3 at the ssq_stft2 headline: five DFTs per row (~21 GFLOP)
// against ~0.58 GB, operation-bound on paper; it also reads five tables
// (~1.97 GB full, ~0.30 GB on their band of 48 rows) and moves five
// scratch planes (~3.9 GB of traffic). Templated on float and double.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dft_mixed.cuh"

namespace {

using namespace dft;

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

// a / b with the denominator |b|^2 + tiny
template <typename T, typename CT>
__device__ __forceinline__ CT cdiv(CT a, CT b, T tiny) {
  const T d = b.x * b.x + b.y * b.y + tiny;
  CT y;
  y.x = (a.x * b.x + a.y * b.y) / d;
  y.y = (a.y * b.x - a.x * b.y) / d;
  return y;
}

// Modes (ops/stft_cuda.py _MODE_*): Sx; Sx and dSx; Sx and k; FSST2 (V
// and k); FSST2 (V and w2).
enum { MODE_SX = 0, MODE_SX_DSX = 1, MODE_BINS = 2, MODE_FSST2 = 3,
       MODE_FSST2_W = 4 };

// planes a mode's DFT carries
__host__ __device__ constexpr int planes_of(int mode) {
  return mode == MODE_SX ? 1 : mode >= MODE_FSST2 ? 5 : 2;
}

// Threads per block of both launches.
constexpr int kThreads = 256;

// Host-side parameter block, copied by value into both launches.
struct Cfg {
  int Np2, f1, f2, N, P1, P2, rows, row0, omax, flipud;
  int tab_rows;                            // rows of each table (i)
  int br;                                  // band rows of each table row
  int S1, S2, sw1, sw2;                    // sequence strides, swizzles
  double inv_n, fs, gamma_gate, vmin, dv;
  // modes 3-4: the divides' regularizer, 2 pi, fs / 2 pi
  double tiny, two_pi, fs_2pi;
};

__device__ __forceinline__ float inf_t(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double inf_t(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The lin bin of w: round half to even, clamped to [0, omax], flipud.
template <typename T>
__device__ __forceinline__ int lin_bin(T w, const Cfg& c) {
  const int k = (int)fmin_t(rint_t(fmax_t((w - (T)c.vmin) / (T)c.dv, (T)0)),
                            (T)c.omax);
  return c.flipud ? c.omax - k : k;
}

// The chirp-corrected frequency of one cell from its five rows V, Vg1,
// Vt, Vtd, Vd2 (fs enters only here: per-sample windows): w2 = |sfs_i -
// fs Im(Vg1 / V) / 2pi + (fs / 2pi) Im((Vd2 V - Vg1^2) / (Vtd V - Vt Vg1))
// Re(Vt / V)|, divides regularized; +inf where w2 is not finite or where
// |V|^2 <= gate (gamma^2). MODE_FSST2 bins it, MODE_FSST2_W writes it.
template <typename T, typename CT>
__device__ __forceinline__ T fsst2_w(CT V, CT Vg1, CT Vt, CT Vtd, CT Vd2,
                                     T sfs_i, T gate, const Cfg& c) {
  const T tiny = (T)c.tiny;
  const T w1 = sfs_i - (T)c.fs * cdiv(Vg1, V, tiny).y / (T)c.two_pi;
  const T trel = cdiv(Vt, V, tiny).x;
  const T q = cdiv(csub(cmul(Vd2, V), cmul(Vg1, Vg1)),
                   csub(cmul(Vtd, V), cmul(Vt, Vg1)), tiny).y;
  const T w = fabs_t(w1 + (T)c.fs_2pi * q * trel);
  return (V.x * V.x + V.y * V.y > gate && finite_t(w)) ? w : inf_t(w);
}

// The table of each plane (H; H, Hd; the five FSST2 tables).
template <typename T>
struct Tabs {
  const typename Cplx<T>::type* t[5];
};

// Stage-1 input: position m1 of sequence q = g * P + p is the product
// table[g][r f2 + m2] x xh[m] at column m = m1 f2 + m2, m2 = m2_0 + p,
// band row r = (m1 - r0) mod f1 (tab[g] the row of plane g), and zero
// where r >= br; read by the first pass or by a gather (`Direct`).
template <typename T, int NP>
struct Products {
  typedef typename Cplx<T>::type CT;
  const CT* xh;
  const CT* tab[NP];
  int f1, f2, m2_0, lgP, r0, br;
  // the band row of m1, or -1 outside the band
  __device__ __forceinline__ int band_row(int m1) const {
    int r = m1 - r0;
    if (r < 0) r += f1;
    return r < br ? r : -1;
  }
  __device__ __forceinline__ CT operator()(int q, int m1) const {
    const int g = q >> lgP;
    const int m2 = m2_0 + (q & ((1 << lgP) - 1));
    const int r = band_row(m1);
    if (r < 0) return CT{(T)0, (T)0};
    const CT* t = tab[0];
#pragma unroll
    for (int i = 1; i < NP; ++i)           // no run-time index into tab
      if (g == i) t = tab[i];
    return cmul(t[(size_t)r * f2 + m2], xh[(size_t)m1 * f2 + m2]);
  }
  // all NP products at (p, m1), for a gather into shared memory
  __device__ __forceinline__ void all(int p, int m1, CT (&X)[NP]) const {
    const int m2 = m2_0 + p;
    const int r = band_row(m1);
    if (r < 0) {
#pragma unroll
      for (int g = 0; g < NP; ++g) X[g] = CT{(T)0, (T)0};
      return;
    }
    const CT x = xh[(size_t)m1 * f2 + m2];
    const size_t o = (size_t)r * f2 + m2;
#pragma unroll
    for (int g = 0; g < NP; ++g) X[g] = cmul(tab[g][o], x);
  }
};

// Whether the first pass of a transform over NP planes per block reads
// device memory itself (one or two planes) or a gather into shared
// memory first (five): timed per stage, the direct read is faster with
// one plane and no slower with two (scripts/torch_ssq_cwt_profile.py),
// the gather faster with five. ops/stft_cuda.py::_DIRECT_MAX_PLANES
// holds the same number for the launch plan (`direct`), which
// tests/test_torch_stft_layout.py models and checks against this one.
constexpr int kDirectMaxPlanes = 2;
template <int NP>
struct Direct {
  static constexpr bool value = NP <= kDirectMaxPlanes;
};
static_assert(Direct<1>::value && Direct<2>::value && !Direct<5>::value,
              "one or two planes read directly, five through a gather");

// Stage-2 input: position m2 of sequence q = g * P + p is scratch plane
// g at row a, column (m2, k1_0 + p), read by the first pass or by a
// gather (`Direct`).
template <typename T>
struct ScratchSeq {
  typedef typename Cplx<T>::type CT;
  const CT* scratch;
  size_t plane, row;                       // plane stride, a * f2
  int f1, k1_0, lgP;
  __device__ __forceinline__ CT operator()(int q, int m2) const {
    return scratch[(size_t)(q >> lgP) * plane + (row + m2) * f1 + k1_0 +
                   (q & ((1 << lgP) - 1))];
  }
  // every plane's value at (p, m2), for a gather into shared memory
  template <int NP>
  __device__ __forceinline__ void all(int p, int m2, CT (&X)[NP]) const {
    const size_t o = (row + m2) * f1 + k1_0 + p;
#pragma unroll
    for (int g = 0; g < NP; ++g) X[g] = scratch[g * plane + o];
  }
};

// Stage 1's launch bound caps its registers: 64 in float (four blocks of
// kThreads), which times 2% faster than no cap with five planes and the
// same with one or two; 128 in double (two blocks: its 86-96 spill under
// 64, and its shared memory leaves room for two blocks per SM).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
stft_stage1(const typename Cplx<T>::type* __restrict__ xh, Tabs<T> tabs,
            const int* __restrict__ r0, Cfg c,
            typename Cplx<T>::type* __restrict__ scratch) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = c.f1, P = c.P1, S = c.S1, lgP = ilog2(c.P1);
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* bufa = tw + L;                       // sequence q * P + p at q * S
  CT* bufb = bufa + NP * P * S;
  const int a = blockIdx.y;                // row within this chunk
  const int gr = c.row0 + a;               // global row b * tab_rows + i
  const int i = gr % c.tab_rows;            // table row
  const size_t trow = (size_t)i * c.br * c.f2;
  const int m2_0 = blockIdx.x * P;
  Products<T, NP> first;
  first.xh = xh + (size_t)(gr / c.tab_rows) * c.Np2;
#pragma unroll
  for (int g = 0; g < NP; ++g) first.tab[g] = tabs.t[g] + trow;
  first.f1 = c.f1;
  first.f2 = c.f2;
  first.m2_0 = m2_0;
  first.lgP = lgP;
  first.r0 = r0 ? r0[i] : 0;
  first.br = c.br;
  fill_twiddles<T>(tw, L);
  const CT* res;
  if constexpr (Direct<NP>::value) {
    __syncthreads();
    res = transform<T, NP>(first, bufa, bufb, lgP, S, L, tw);
  } else {
    // the column p fastest, positions walked through swz into bufb
    for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
      const int p = e & (P - 1);
      const int m1 = swz(e >> lgP, c.sw1);
      CT X[NP];
      first.all(p, m1, X);
#pragma unroll
      for (int g = 0; g < NP; ++g) bufb[(g * P + p) * S + m1] = X[g];
    }
    __syncthreads();
    res = transform<T, NP>(SmemSeq<CT>{bufb, S}, bufa, bufb, lgP, S, L, tw);
  }

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
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const CT v = res[(q * P + p) * S + k1];
      CT y;
      y.x = (v.x * co - v.y * s) * inv_n;
      y.y = (v.x * s + v.y * co) * inv_n;
      scratch[q * plane + o] = y;
    }
  }
}

template <typename T, int MODE>
__global__ void stft_stage2(const typename Cplx<T>::type* __restrict__ scratch,
                            const T* __restrict__ sfs, Cfg c,
                            typename Cplx<T>::type* __restrict__ sx,
                            void* __restrict__ out2) {
  typedef typename Cplx<T>::type CT;
  constexpr int NP = planes_of(MODE);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = c.f2, P = c.P2, S = c.S2, lgP = ilog2(c.P2);
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  CT* bufa = tw + L;                       // sequence q * P + p at q * S
  CT* bufb = bufa + NP * P * S;
  const int a = blockIdx.y;
  const int k1_0 = blockIdx.x * P;
  fill_twiddles<T>(tw, L);
  ScratchSeq<T> first;
  first.scratch = scratch;
  first.plane = (size_t)c.rows * c.Np2;
  first.row = (size_t)a * c.f2;
  first.f1 = c.f1;
  first.k1_0 = k1_0;
  first.lgP = lgP;
  const CT* res;
  if constexpr (Direct<NP>::value) {
    __syncthreads();
    res = transform<T, NP>(first, bufa, bufb, lgP, S, L, tw);
  } else {
    // the column p fastest, positions walked through swz into bufb
    for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
      const int p = e & (P - 1);
      const int m2 = swz(e >> lgP, c.sw2);
      CT X[NP];
      first.all(p, m2, X);
#pragma unroll
      for (int g = 0; g < NP; ++g) bufb[(g * P + p) * S + m2] = X[g];
    }
    __syncthreads();
    res = transform<T, NP>(SmemSeq<CT>{bufb, S}, bufa, bufb, lgP, S, L, tw);
  }

  const int k2hi = (c.N + c.f1 - 1) / c.f1;
  // k2 walked through swz over whole blocks of 2^sw2 (<= f2)
  const int nk = ((k2hi + (1 << c.sw2) - 1) >> c.sw2) << c.sw2;
  const int gr = c.row0 + a;               // global row b * tab_rows + i
  const size_t row = (size_t)gr * c.N;
  const T fs = (T)c.fs;
  const T gate = (T)c.gamma_gate * (T)c.gamma_gate;
  const T two_pi = (T)6.283185307179586;
  T sfs_i = (T)0;
  if constexpr (MODE >= MODE_BINS) sfs_i = sfs[gr % c.tab_rows];
  for (int e = threadIdx.x; e < P * nk; e += blockDim.x) {
    const int p = e & (P - 1);
    const int k2 = swz(e >> lgP, c.sw2);
    const int n = k1_0 + p + c.f1 * k2;
    if (k2 >= k2hi || n >= c.N) continue;
    const CT Sv = res[p * S + k2];
    sx[row + n] = Sv;
    if constexpr (MODE >= MODE_FSST2) {
      // Sv = V, then Vg1, Vt, Vtd, Vd2
      const T w2 = fsst2_w<T>(Sv, res[(P + p) * S + k2],
                              res[(2 * P + p) * S + k2],
                              res[(3 * P + p) * S + k2],
                              res[(4 * P + p) * S + k2], sfs_i, gate, c);
      if constexpr (MODE == MODE_FSST2_W)
        static_cast<T*>(out2)[row + n] = w2;
      else
        static_cast<int32_t*>(out2)[row + n] =
            finite_t(w2) ? lin_bin<T>(w2, c) : -1;
    } else if constexpr (MODE != MODE_SX) {
      CT D = res[(P + p) * S + k2];
      D.x *= fs;
      D.y *= fs;
      if constexpr (MODE == MODE_SX_DSX) {
        static_cast<CT*>(out2)[row + n] = D;
        continue;
      }
      // w = |Sfs[i] - Im(D / S) / 2pi|, S = C + iE, D = A + iB
      const T denom = Sv.x * Sv.x + Sv.y * Sv.y;
      const T w =
          fabs_t(sfs_i - (D.y * Sv.x - D.x * Sv.y) / (denom * two_pi));
      static_cast<int32_t*>(out2)[row + n] =
          (denom > gate && finite_t(w)) ? lin_bin<T>(w, c) : -1;
    }
  }
}

template <typename T, int MODE>
int launch_mode(const void* xh, const Tabs<T>& tabs, const int* r0,
                const void* sfs, const Cfg& c, void* scratch, void* sx,
                void* out2, cudaStream_t st) {
  typedef typename Cplx<T>::type CT;
  constexpr int NP = planes_of(MODE);
  const size_t sm1 = (size_t)(c.f1 + 2 * NP * c.P1 * c.S1) * sizeof(CT);
  const size_t sm2 = (size_t)(c.f2 + 2 * NP * c.P2 * c.S2) * sizeof(CT);
  cudaFuncSetAttribute(stft_stage1<T, NP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  cudaFuncSetAttribute(stft_stage2<T, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2);
  dim3 g1(c.f2 / c.P1, c.rows), g2(c.f1 / c.P2, c.rows);
  stft_stage1<T, NP><<<g1, kThreads, sm1, st>>>(
      static_cast<const CT*>(xh), tabs, r0, c, static_cast<CT*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stft_stage2<T, MODE><<<g2, kThreads, sm2, st>>>(
      static_cast<const CT*>(scratch), static_cast<const T*>(sfs), c,
      static_cast<CT*>(sx), out2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xh, const void* H, const void* Hd, const int* r0,
           const void* sfs, const Cfg& c, int mode, void* scratch, void* sx,
           void* out2, void* stream) {
  typedef typename Cplx<T>::type CT;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Tabs<T> tabs;
  const CT* h = static_cast<const CT*>(H);
  for (int q = 0; q < 5; ++q)
    tabs.t[q] = h + (size_t)q * c.tab_rows * c.br * c.f2;
  // modes 3 and 4: the (5, rows, br, f2) bank
  tabs.t[1] = mode >= MODE_FSST2 ? tabs.t[1] : static_cast<const CT*>(Hd);
  switch (mode) {
    case MODE_SX:
      return launch_mode<T, MODE_SX>(xh, tabs, r0, sfs, c, scratch, sx, out2,
                                     st);
    case MODE_SX_DSX:
      return launch_mode<T, MODE_SX_DSX>(xh, tabs, r0, sfs, c, scratch, sx,
                                         out2, st);
    case MODE_BINS:
      return launch_mode<T, MODE_BINS>(xh, tabs, r0, sfs, c, scratch, sx,
                                       out2, st);
    case MODE_FSST2:
      return launch_mode<T, MODE_FSST2>(xh, tabs, r0, sfs, c, scratch, sx,
                                        out2, st);
    case MODE_FSST2_W:
      return launch_mode<T, MODE_FSST2_W>(xh, tabs, r0, sfs, c, scratch, sx,
                                          out2, st);
  }
  return (int)cudaErrorInvalidValue;
}

Cfg make_cfg(const int* ip, const double* dp) {
  Cfg c;
  c.Np2 = ip[0]; c.f1 = ip[1]; c.f2 = ip[2]; c.N = ip[3]; c.P1 = ip[4];
  c.P2 = ip[5]; c.rows = ip[6]; c.row0 = ip[7]; c.omax = ip[9];
  c.flipud = ip[10]; c.tab_rows = ip[11]; c.S1 = ip[12]; c.S2 = ip[13];
  c.sw1 = ip[14]; c.sw2 = ip[15]; c.br = ip[16];
  c.inv_n = dp[0]; c.fs = dp[1]; c.gamma_gate = dp[2]; c.vmin = dp[3];
  c.dv = dp[4]; c.tiny = dp[5]; c.two_pi = dp[6]; c.fs_2pi = dp[7];
  return c;
}

}  // namespace

// ip: 17 ints, dp: 8 doubles (layout in ops/stft_cuda.py; ip[8] the
// mode, ip[11] the rows of each table, ip[16] the band rows br). `xh` is
// (B, Np2), each table (tab_rows, br, f2), the rows of `sx` and `out2`
// B * tab_rows. `r0` is the (tab_rows,) int32 band starts, or null for
// full tables (br = f1). `Hd`, `sfs` and `out2` may be null where the
// mode does not read or write them; in modes 3 and 4 `H` is the
// (5, tab_rows, br, f2) bank and `Hd` is null, and in mode 4 `out2` is the
// real w2 plane.
// Returns cudaGetLastError() after the launches.
extern "C" int stft_conv_f32(const void* xh, const void* H, const void* Hd,
                             const void* r0, const void* sfs, const int* ip,
                             const double* dp, void* scratch, void* sx,
                             void* out2, void* stream) {
  return launch<float>(xh, H, Hd, static_cast<const int*>(r0), sfs,
                       make_cfg(ip, dp), ip[8], scratch, sx, out2, stream);
}

extern "C" int stft_conv_f64(const void* xh, const void* H, const void* Hd,
                             const void* r0, const void* sfs, const int* ip,
                             const double* dp, void* scratch, void* sx,
                             void* out2, void* stream) {
  return launch<double>(xh, H, Hd, static_cast<const int*>(r0), sfs,
                        make_cfg(ip, dp), ip[8], scratch, sx, out2, stream);
}
