// Fused CWT (+ phase transform + bin map for the synchrosqueezed CWT).
//
// Replaces the TPU kernel ssqueezepy_tpu/ops/cwt_pallas.py::_make_kernel
// in three of its modes, each over a batch of spectra (B spectra x na
// scales, row g = b * na + scale), and adds one output mode of its own:
//   * bins mode (entry points cwt_fused_bins_direct for one signal and
//     cwt_fused_bins_pallas for a batch): outputs Wx and the bin plane k;
//     the phase / gate / bin arithmetic is bins.cuh's phase_bin;
//   * plain/derivative mode (entry point cwt_fused_pallas): outputs Wx,
//     and dWx when asked;
//   * order-2 (WSST2) mode (entry point cwt_fused_bins2_direct): outputs
//     W and the bin plane k of the chirp-corrected estimate (below);
//   * order-2 w2 mode: the same, with the estimate w2 written as a real
//     plane in place of its bins, for ssq_cwt2(get_w=True) (the TPU
//     package computes that plane on its XLA path,
//     ssqueezepy_tpu/models/ssq_cwt2.py::_wsst2_rows). Both order-2
//     epilogues take w2 from one function (order2_w), so W and w2 are the
//     bits that the bins mode bins.
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
// row's arithmetic does not depend on its batch index, on how the
// wrapper chunks the rows or on the columns per block, so a batched row
// is bit-identical to the same signal run alone, and Wx is bit-identical
// across the modes.
//
// The wavelet psih(a xi_m) comes from one of two sources, a compile-time
// parameter SYN of stage 1 (the TPU kernel traces any real wavelet fn
// into its body):
//   * SYN_GMW: the order-0 GMW synthesized in closed form from its
//     parameters (log space), its derivatives too;
//   * SYN_TABLE: any other real-valued wavelet (GMW of order k, morlet,
//     bump, cmhat, hhhat, a user's function), read from a table in device
//     memory that the wrapper evaluates with torch (ops/cwt_cuda.py::
//     wavelet_table): (na, n_up/2 + 1) values psih(a xi_m), and for order
//     2 three such planes, psih, psih' and psih''. The table carries
//     neither the row norm nor the Nyquist halving: the kernel applies
//     both, as for the closed form. Row g reads row g % na.
//
// Order-2 mode forms five spectra from psih and its derivatives psih',
// psih'' at w = a xi (GMW in closed form: with u = wc w,
// psih' = psih (beta - gamma u^gamma) / w, psih'' = psih ((beta - gamma
// u^gamma)^2 - beta - gamma (gamma - 1) u^gamma) / w^2; else the table):
//   W = psih xh, A = i xi psih xh, B = i a psih' xh, Bd = -xi a psih' xh,
//   C = -a^2 psih'' xh
// (xi not divided by dt; the Nyquist bin halved in all five), and per
// cell p2 = (Bd W - A B) / (B^2 - C W), p1 = (A + p2 B) / W, both divides
// regularized by |den|^2 + tiny, w2 = |Im p1| / (2 pi dt), the gamma gate
// and the bin map (XLA twin: ssqueezepy_tpu/models/ssq_cwt2.py
// _wsst2_rows; products in its order).
//
// Design: four-step DFT over n_up = f1 * f2 with n = k1 + f1 k2 and
// m = m1 f2 + m2, both steps inside these kernels (no cuFFT), in one
// kernel pair for every mode, chosen at compile time: bins_stage1 is
// templated on the number of planes NP its DFT carries (1: W; 2: W and
// dW; 5: W, A, B, Bd, C) and on the source of psih (SYN), bins_stage2 on
// the mode, whose epilogue it runs. No mode or source branches at run
// time inside a kernel.
//   launch 1 (bins_stage1): one block per (row, P1 columns m2).
//     Synthesizes psih (closed form) or reads it (table), forms the NP
//     spectra, runs the length-f1 inverse DFT over m1 in shared memory,
//     applies the twiddle e^{+2 pi i m2 k1 / n_up} / n_up and writes the
//     planes to a scratch buffer (NP x rows x n_up complex). Only the
//     columns m1 below the row's support limit are formed, and the DFT
//     levels that would only copy them are skipped (the TPU kernel's
//     stage-1 pruning, ssqueezepy_tpu/ops/cwt_pallas.py::support_klims;
//     the limits from ops/cwt_cuda.py::_stage1_klims).
//   launch 2 (bins_stage2): one block per (row, P2 columns k1). Runs the
//     length-f2 DFT over m2, keeps the k2 whose n lands in [n1, n1+N),
//     and writes Wx (and dWx), or runs the bins or order-2 epilogue,
//     where the other planes never leave the chip beyond the scratch.
// Bound (bins mode): at the main path's shape (293 scales, n_up = 2^18) the two
// inverse DFTs per scale (~13 GFLOP in float32 at 5 n log2 n, less the
// first stage, whose upper half-spectrum inputs are zero) outweigh the
// bytes the function must move (~0.56 GB), so it is operation-bound on
// paper: 0.195 ms on an H100 SXM; this design also moves the scratch planes
// through device memory twice (~2.5 GB), which the bound does not count.
// Order-2 mode: five DFTs per scale (~33 GFLOP) against the same ~0.56 GB,
// operation-bound; its five scratch planes (~6 GB of traffic at that shape)
// exceed the wrapper's scratch budget, so rows run in two chunks; the w2
// mode is the same work and the same bytes (w2 in place of k, 4 bytes a
// cell in float32). Wx-only mode: one DFT per scale against ~0.37 GB,
// bound by bytes. Templated on float and double.
//
// Sizes: one column of a stage takes at most 220 KB of shared memory
// (ops/cwt_cuda.py::_SMEM_MAX, under the card's 227 KB per block), so the
// radix-4 engine reaches n_up = 2^28 with one plane in float32 (f1 =
// 2^14, one sequence of 16385 elements and 2^13 twiddles per block). Every
// offset that can pass 2^31 (rows x n_up, planes x rows x n_up, row x N)
// is size_t; int ones stay below n_up (positions, twiddle indices
// m2 k1 < n_up) or below one block's shared memory.
//
// The engine lays shared memory out so that a block's accesses avoid bank
// conflicts (32 banks of 4 bytes, 128 bytes per wavefront):
//   * layout: element i of sequence s = plane * P + p at smem_index(s, i)
//     = s * S + i, with the sequence stride S = L + 1 odd
//     (ops/cwt_cuda.py::smem_index, same form; no in-sequence pad is
//     needed);
//   * thread maps: the radix passes put the sequence index fastest, so a
//     half-warp's 16 accesses sit at q * S + const over 16 sequences q
//     (S odd: 16 distinct bank pairs) and its twiddle read is one
//     broadcast; the strided gathers (stage-1 spectra, stage-2 scratch)
//     and the stage-2 epilogue put the column p fastest and walk
//     positions through swz, which reverses the low `sw` bits of the
//     running index, so the 16 / P positions a half-warp covers lie P
//     apart: p * S + P * u, again 16 distinct bank pairs (stage 1 walks
//     position pairs 2u, 2u + 1 with sw - 1 bits, the same spacing); the
//     stage-1 epilogue reads consecutive elements.
//     The wrapper's plan (ops/cwt_cuda.py::bins_plan) takes P <= 8
//     columns that fit: for float32 at the main path P = 8, 8 and 4 for
//     1, 2 and 5 planes. With 2 planes every access pattern is then free
//     of bank conflicts (per quarter-warp for float64's 16-byte
//     elements); with 1 plane the passes walk 8 sequences and with 5
//     planes 20, and a half-warp that straddles two indices j is 2-way
//     there (tests/test_torch_cwt_layout.py enumerates every pattern).
//     One plane at P = 16 would be conflict-free, but P = 8 runs twice
//     the blocks per SM and times faster;
//   * radix 4: two radix-2 levels per pass in registers, one __syncthreads
//     per pass, a last radix-2 pass when the levels left are odd; stage 1
//     runs its first level in registers as it forms the spectra (the
//     partner column lies beyond the half spectrum), so at L = 512 stage 1
//     runs 4 passes and stage 2 5. Each butterfly is a radix-2 DIT
//     butterfly with a table twiddle, in the same order in every mode.
//
// Two engines, a compile-time parameter of both launches beside the
// planes or the mode (ops/cwt_cuda.py::bins_plan picks one per n_up):
//   * ENG_RADIX4, for a power-of-two n_up: the in-place radix-4 passes
//     above, in bit-reversed order, with L/2 twiddles;
//   * ENG_MIXED, for any other n_up >= 4 whose prime factors are at most
//     7 (the split f1 * f2 whose larger factor is smallest): the Stockham
//     passes of dft_mixed.cuh (radix 4, 2, 3, 5, 7, natural order in and
//     out) between two buffers of NP * P sequences, with L twiddles. Each
//     launch first gathers its NP planes into shared memory (stage 1
//     forms every spectrum column m1, zero from the half spectrum on;
//     stage 2 reads the scratch), the column p fastest and positions
//     walked through swz over the power of two in L (none for an odd L).
//     The columns per block need not divide the partner factor: the grid
//     rounds up, a column beyond it runs the passes on zeros, and its
//     outputs are not written.
// Both engines share the spectra, the four-step twiddle and the stage-2
// epilogues, so each keeps Wx bit-identical across the modes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"
#include "dft_mixed.cuh"

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

// Output modes (ops/cwt_cuda.py _OUT_*): (Wx, k); Wx; (Wx, dWx); (W, k)
// of order 2; (W, w2) of order 2.
enum { MODE_BINS = 0, MODE_W = 1, MODE_W_DW = 2, MODE_BINS2 = 3,
       MODE_W2 = 4 };

// planes a mode's DFT carries
__host__ __device__ constexpr int planes_of(int mode) {
  return mode == MODE_W ? 1 : mode >= MODE_BINS2 ? 5 : 2;
}

// Sources of psih (above): closed-form GMW, or the wavelet table.
enum { SYN_GMW = 0, SYN_TABLE = 1 };

// DFT engines (ops/cwt_cuda.py _ENGINE_*): radix 4 in place, for a
// power-of-two n_up; mixed radix (dft_mixed.cuh) between two buffers.
enum { ENG_RADIX4 = 0, ENG_MIXED = 1 };

__host__ __device__ constexpr int clog2(int v) {
  return v > 1 ? 1 + clog2(v >> 1) : 0;
}

// Host-side parameter block, copied by value into both launches.
struct Cfg {
  int n_up, f1, f2, lg1, lg2, half, n1, N, P1, P2, rows, row0;
  int l1_norm;
  int out_mode, na;
  double xi_step, inv_dt, gamma_gate;
  double logconst, amp, wgamma, beta, wc;
  double tiny, two_pi_dt;  // order 2: divide regularizer, 2 pi dt
  BinMap bm;
  // sequence strides and swizzle widths of the two stages
  int S1, S2, sw1, sw2;
  int engine;
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

__device__ __forceinline__ float inf_t(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double inf_t(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The order-2 estimate of one cell from its five planes: p2 = (Bd W -
// A B) / (B^2 - C W), p1 = (A + p2 B) / W, both divides regularized,
// w2 = |Im p1| / (2 pi dt); +inf where w2 is not finite or where |W|^2
// <= gate (gamma^2). MODE_BINS2 bins it, MODE_W2 writes it.
template <typename T, typename CT>
__device__ __forceinline__ T order2_w(CT W, CT A, CT B, CT Bd, CT C,
                                      const Cfg& c, T gate) {
  const T tiny = (T)c.tiny;
  const CT p2 = cdiv(csub(cmul(Bd, W), cmul(A, B)),
                     csub(cmul(B, B), cmul(C, W)), tiny);
  const CT pB = cmul(p2, B);
  CT num;
  num.x = A.x + pB.x;
  num.y = A.y + pB.y;
  const T w2 = fabs_t(cdiv(num, W, tiny).y) / (T)c.two_pi_dt;
  const bool valid = (W.x * W.x + W.y * W.y > gate) && finite_t(w2);
  return valid ? w2 : inf_t(w2);
}

// tw[k] = e^{+2 pi i k / L}, k < L/2 (inverse sign)
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

// r with its low b bits reversed (0 <= b <= 31): a bijection on every
// aligned block of 2^b (ops/cwt_cuda.py::swz).
__device__ __forceinline__ int swz(int r, int b) {
  const int m = (1 << b) - 1;
  return (r & ~m) | (int)(__brev((unsigned)(r & m)) >> (31 - b) >> 1);
}

// One radix-2 DIT butterfly, in place: (x0, x1) <- (x0 + w x1, x0 - w x1).
template <typename T, typename CT>
__device__ __forceinline__ void bfly(CT& x0, CT& x1, const CT w) {
  const T tr = w.x * x1.x - w.y * x1.y;
  const T ti = w.x * x1.y + w.y * x1.x;
  CT y0, y1;
  y0.x = x0.x + tr; y0.y = x0.y + ti;
  y1.x = x0.x - tr; y1.y = x0.y - ti;
  x0 = y0;
  x1 = y1;
}

// In-place radix-2 DIT transform, inputs in bit-reversed order, outputs
// in natural order, over NP * 2^lgP sequences of length L = 2^lg at
// buf[s * S + i], from level s0 on (the levels before it done already),
// levels fused in pairs: butterfly b -> sequence q = b mod (NP * 2^lgP)
// (fastest), index j = b div (NP * 2^lgP); level s pairs (x0, x1) and
// (x2, x3) with twiddle tw[pos L / 2^s], level s + 1 pairs (x0, x2) and
// (x1, x3) with tw[pos L / 2^(s+1)] and tw[(pos + hl) L / 2^(s+1)], as two
// radix-2 passes would.
template <typename T, int NP>
__device__ void block_fft4(typename Cplx<T>::type* buf, int lgP, int S, int L,
                           int lg, int s0,
                           const typename Cplx<T>::type* tw) {
  typedef typename Cplx<T>::type CT;
  // a power-of-two sequence count splits b by shift and mask
  constexpr bool POW2 = (NP & (NP - 1)) == 0;
  const int lgn = lgP + clog2(NP);
  const int qmask = (1 << lgn) - 1;
  const int nseq = NP << lgP;
  int s = s0;
  for (; s < lg; s += 2) {
    const int hl = 1 << (s - 1);
    const int t1 = L >> s, t2 = L >> (s + 1);
    for (int b = threadIdx.x; b < (POW2 ? (L << lgn) : L * nseq) >> 2;
         b += blockDim.x) {
      const int j = POW2 ? b >> lgn : (int)((unsigned)(b >> lgP) / NP);
      const int q = POW2 ? b & qmask : b - ((j * NP) << lgP);
      const int pos = j & (hl - 1);
      CT* x = buf + q * S + ((j >> (s - 1)) << (s + 1)) + pos;
      CT x0 = x[0], x1 = x[hl], x2 = x[2 * hl], x3 = x[3 * hl];
      const CT wa = tw[pos * t1];
      bfly<T>(x0, x1, wa);
      bfly<T>(x2, x3, wa);
      bfly<T>(x0, x2, tw[pos * t2]);
      bfly<T>(x1, x3, tw[(pos + hl) * t2]);
      x[0] = x0; x[hl] = x1; x[2 * hl] = x2; x[3 * hl] = x3;
    }
    __syncthreads();
  }
  if (s == lg) {                          // odd lg: the last level alone
    const int hl = L >> 1;
    for (int b = threadIdx.x; b < (POW2 ? hl << lgn : hl * nseq);
         b += blockDim.x) {
      const int j = POW2 ? b >> lgn : (int)((unsigned)(b >> lgP) / NP);
      const int q = POW2 ? b & qmask : b - ((j * NP) << lgP);
      CT* x = buf + q * S + j;
      CT x0 = x[0], x1 = x[hl];
      bfly<T>(x0, x1, tw[j]);
      x[0] = x0; x[hl] = x1;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// The NP spectra of column m, zero from m = half on: W = psih xh; with
// NP = 2 dW = i xi / dt W; with NP = 5 the order-2 spectra A, B, Bd, C.
// SYN_TABLE reads psih at tab[m] (the row's table), psih' and psih'' at
// tab[tplane + m] and tab[2 tplane + m].
template <typename T, int NP, int SYN>
__device__ __forceinline__ void spectra(const typename Cplx<T>::type* xh,
                                        long m, T scale, T norm,
                                        const Cfg& c, const T* tab,
                                        size_t tplane,
                                        typename Cplx<T>::type (&X)[NP]) {
#pragma unroll
  for (int q = 0; q < NP; ++q) X[q].x = X[q].y = (T)0;
  if (m < c.half) {
    const T xi = (T)((double)m * c.xi_step);
    const T w = scale * xi;
    T psi;
    if constexpr (SYN == SYN_TABLE)
      psi = tab[m] * norm;
    else
      psi = gmw_psih<T>(w, c) * norm;
    typename Cplx<T>::type v = xh[m];
    if (m == c.half - 1 && (c.n_up & 1) == 0) {  // Nyquist halving
      v.x *= (T)0.5;
      v.y *= (T)0.5;
    }
    X[0].x = psi * v.x;
    X[0].y = psi * v.y;
    if constexpr (NP == 2) {               // dW: times i xi / dt
      const T xid = xi * (T)c.inv_dt;
      X[1].x = -xid * X[0].y;
      X[1].y = xid * X[0].x;
    } else if constexpr (NP == 5) {        // order 2: A, B, Bd, C
      T tb = (T)0, t2b = (T)0;
      if constexpr (SYN == SYN_TABLE) {
        tb = scale * tab[tplane + m];
        t2b = (scale * scale) * tab[2 * tplane + m];
      } else if (psi != (T)0) {
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
}

// The mixed engine's gather of stage 1: the NP spectra of P columns m2
// at the L / Ns columns m1 (zero from klim on and beyond the last column
// m2), walked m1 = swz(., w) over the power of two in L / Ns, each written
// to its Ns positions m1 Ns ... m1 Ns + Ns - 1 of buf; COPIES = false is
// Ns = 1, every column in place, which compiles as the unpruned gather.
template <typename T, int NP, int SYN, bool COPIES>
__device__ __forceinline__ void mixed_columns(
    const typename Cplx<T>::type* xh, T scale, T norm, const Cfg& c,
    const T* tab, size_t tplane, typename Cplx<T>::type* buf, int P,
    int lgP, int S, int m2_0, int klim, int Ns) {
  typedef typename Cplx<T>::type CT;
  const int n1s = c.f1 / Ns;
  const int w = min(c.sw1, __ffs(n1s) - 1);
  for (int e = threadIdx.x; e < P * n1s; e += blockDim.x) {
    const int p = e & (P - 1);
    const int m1 = swz(e >> lgP, w);
    CT X[NP];
    if (m2_0 + p < c.f2 && m1 < klim) {
      spectra<T, NP, SYN>(xh, (long)m1 * c.f2 + m2_0 + p, scale, norm, c,
                          tab, tplane, X);
    } else {                      // beyond the support or the last column
#pragma unroll
      for (int q = 0; q < NP; ++q) X[q].x = X[q].y = (T)0;
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if constexpr (COPIES) {
        CT* d = buf + (q * P + p) * S + m1 * Ns;
        for (int t = 0; t < Ns; ++t) d[t] = X[q];
      } else {
        buf[(q * P + p) * S + m1] = X[q];
      }
    }
  }
}

// Stage 1: the NP spectra of P1 columns m2, the length-f1 DFT over m1,
// the four-step twiddle, NP scratch planes. The row's support limit klim
// (klims[g % na], ops/cwt_cuda.py::_stage1_klims) prunes it: the spectra
// of the columns m1 >= klim are zero (the wavelet is, in the kernel's
// arithmetic), so they are neither synthesized nor loaded.
//   Radix-4 engine, klim = rows0 = L/2 + 1 (the Nyquist row in): the
// first DFT level pairs position 2u (column m1 = bitrev(2u) < L/2) with
// 2u + 1 (m1 + L/2, whose spectra are zero except at the Nyquist column),
// with twiddle tw[0] = 1: a thread forms both columns and runs that
// butterfly in registers, and the passes start at level 2.
//   Radix-4 engine, klim <= L / 2^j (j >= 1 the largest such): in every
// aligned block of 2^j positions only the first, i = B 2^j (column m1 =
// bitrev(i) < L / 2^j), can hold a nonzero input, so the first j levels
// only copy it to the block's 2^j positions (x0 + w 0 = x0, bit for bit
// but for the sign of a zero): a thread forms one of the L / 2^j columns,
// writes its 2^j copies, and the passes start at level j + 1 (none for
// klim = 1). The passes that remain are the unpruned stage's butterflies.
//   Mixed engine (Stockham, natural order): while klim <= L / Ns for the
// product Ns of the leading radices, those passes only copy (position i
// then holds column i / Ns), so a thread forms one of the L / Ns columns
// (zero from klim on), writes it to its Ns positions, and the passes
// start after them.
template <typename T, int NP, int ENG, int SYN>
__global__ void bins_stage1(const typename Cplx<T>::type* __restrict__ xh,
                            const T* __restrict__ scales,
                            const T* __restrict__ table,
                            const int* __restrict__ klims, Cfg c,
                            typename Cplx<T>::type* __restrict__ scratch) {
  typedef typename Cplx<T>::type CT;
  extern __shared__ unsigned char smem_raw[];
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  const int L = c.f1, P = c.P1, S = c.S1, lgP = ilog2(c.P1);
  const int a = blockIdx.y;               // row within this chunk
  const int g = c.row0 + a;               // global row b * na + scale
  const int m2_0 = blockIdx.x * P;

  xh += (size_t)(g / c.na) * c.half;
  const T scale = scales[g % c.na];
  // the row's table (SYN_TABLE): planes of na * half values
  const size_t tplane = (size_t)c.na * c.half;
  const T* tab = SYN == SYN_TABLE ? table + (size_t)(g % c.na) * c.half
                                  : nullptr;
  const T norm = c.l1_norm ? (T)1 : sqrt_t(scale);
  // spectrum columns m1 >= klim are zero
  const int klim = klims[g % c.na];
  const CT* res;                          // sequence plane * P + p at s * S
  if constexpr (ENG == ENG_RADIX4) {
    CT* buf = tw + (L >> 1);
    fill_twiddles<T>(tw, L);
    int s0 = 2;                             // the first level left to run
    if (klim > (L >> 1)) {                  // the Nyquist row is in
      CT one;                               // tw[0] = sincospi(0), exactly
      one.x = (T)1;
      one.y = (T)0;
      for (int e = threadIdx.x; e < P * (L >> 1); e += blockDim.x) {
        const int p = e & (P - 1);
        const int i = 2 * swz(e >> lgP, c.sw1 - 1);  // pair (i, i + 1)
        const long m = (long)bitrev(i, c.lg1) * c.f2 + m2_0 + p;
        CT X0[NP], X1[NP];
        spectra<T, NP, SYN>(xh, m, scale, norm, c, tab, tplane, X0);
        spectra<T, NP, SYN>(xh, m + (long)(L >> 1) * c.f2, scale, norm, c,
                            tab, tplane, X1);
#pragma unroll
        for (int q = 0; q < NP; ++q) bfly<T>(X0[q], X1[q], one);
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          buf[(q * P + p) * S + i] = X0[q];
          buf[(q * P + p) * S + i + 1] = X1[q];
        }
      }
    } else {                                // klim <= L / 2^j, j >= 1
      int j = 1;
      while (j < c.lg1 && klim <= (L >> (j + 1))) ++j;
      // a wavefront's threads cover P columns and 2^lgG block starts;
      // reversing the starts' low w bits puts the starts P apart in the
      // banks, as the pairs' walk above (j = 1) does. Where w < lgG the
      // remaining bits of the start's index go to the copy order instead:
      // each thread writes copy r at i + (r ^ rot)
      const int w = c.sw1 > j ? c.sw1 - j : 0;
      const int lgG = c.sw1 > lgP ? c.sw1 - lgP : 0;
      for (int e = threadIdx.x; e < P * (L >> j); e += blockDim.x) {
        const int p = e & (P - 1);
        const int i = swz(e >> lgP, w) << j;  // block start, m1 < L / 2^j
        const int rot = (((e >> lgP) & ((1 << lgG) - 1)) >> w) << lgP;
        const int m1 = bitrev(i, c.lg1);
        CT X[NP];
        if (m1 < klim) {
          spectra<T, NP, SYN>(xh, (long)m1 * c.f2 + m2_0 + p, scale, norm,
                              c, tab, tplane, X);
        } else {
#pragma unroll
          for (int q = 0; q < NP; ++q) X[q].x = X[q].y = (T)0;
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          CT* d = buf + (q * P + p) * S + i;
          for (int r = 0; r < (1 << j); ++r) d[r ^ rot] = X[q];
        }
      }
      s0 = j + 1;
    }
    __syncthreads();
    block_fft4<T, NP>(buf, lgP, S, L, c.lg1, s0, tw);
    res = buf;
  } else {
    CT* bufa = tw + L;
    CT* bufb = bufa + NP * P * S;
    dft::fill_twiddles<T>(tw, L);
    // the leading passes (radices multiplying to Ns) whose partners are
    // all zero, klim <= L / Ns: they only copy, so that after them
    // position i holds column i / Ns, and the passes start after them
    int Ns = 1;
    for (int rem = L; rem > 1;) {
      const int R = dft::next_radix<true>(rem);
      if (klim * R > rem) break;
      Ns *= R;
      rem /= R;
    }
    if (Ns == 1)
      mixed_columns<T, NP, SYN, false>(xh, scale, norm, c, tab, tplane,
                                       bufb, P, lgP, S, m2_0, klim, 1);
    else
      mixed_columns<T, NP, SYN, true>(xh, scale, norm, c, tab, tplane,
                                      bufb, P, lgP, S, m2_0, klim, Ns);
    __syncthreads();
    res = dft::transform<T, NP, true>(dft::SmemSeq<CT>{bufb, S}, bufa,
                                      bufb, lgP, S, L, tw, Ns);
  }

  const T inv_n = (T)1 / (T)c.n_up;
  const size_t plane = (size_t)c.rows * c.n_up;
  for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
    const int k1 = ENG == ENG_RADIX4 ? e & (L - 1) : e % L;
    const int p = ENG == ENG_RADIX4 ? e >> c.lg1 : e / L;
    const int m2 = m2_0 + p;
    if (ENG == ENG_MIXED && m2 >= c.f2) continue;
    // m2 * k1 < f2 * f1 = n_up: the twiddle's argument is exact
    T s, co;
    sincospi_t((T)((double)(2 * (long)m2 * k1) / c.n_up), &s, &co);
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

// Stage 2: the length-f2 DFT over m2 of the mode's planes, then its
// epilogue on the kept k2: Wx and k (bins), Wx (Wx only), Wx and dWx
// (derivative), W and k of the order-2 estimate, W and the estimate w2.
template <typename T, int MODE, int ENG>
__global__ void bins_stage2(const typename Cplx<T>::type* __restrict__ scratch,
                            Cfg c, typename Cplx<T>::type* __restrict__ wx,
                            void* __restrict__ out2) {
  typedef typename Cplx<T>::type CT;
  constexpr int NP = planes_of(MODE);
  extern __shared__ unsigned char smem_raw[];
  CT* tw = reinterpret_cast<CT*>(smem_raw);
  const int L = c.f2, P = c.P2, S = c.S2, lgP = ilog2(c.P2);
  const int a = blockIdx.y;
  const int k1_0 = blockIdx.x * P;

  const size_t plane = (size_t)c.rows * c.n_up;
  const CT* buf;                          // sequence plane * P + p at s * S
  if constexpr (ENG == ENG_RADIX4) {
    CT* b = tw + (L >> 1);
    fill_twiddles<T>(tw, L);
    for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
      const int p = e & (P - 1);
      const int i = swz(e >> lgP, c.sw2);   // position, bit-reversed order
      const size_t o =
          ((size_t)a * c.f2 + bitrev(i, c.lg2)) * c.f1 + k1_0 + p;
#pragma unroll
      for (int q = 0; q < NP; ++q)
        b[(q * P + p) * S + i] = scratch[q * plane + o];
    }
    __syncthreads();
    block_fft4<T, NP>(b, lgP, S, L, c.lg2, 1, tw);
    buf = b;
  } else {
    CT* bufa = tw + L;
    CT* bufb = bufa + NP * P * S;
    dft::fill_twiddles<T>(tw, L);
    for (int e = threadIdx.x; e < P * L; e += blockDim.x) {
      const int p = e & (P - 1);
      const int m2 = swz(e >> lgP, c.sw2);  // position, natural order
      const bool in = k1_0 + p < c.f1;      // not beyond the last column
      const size_t o = ((size_t)a * c.f2 + m2) * c.f1 + k1_0 + p;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        CT v;
        v.x = v.y = (T)0;
        if (in) v = scratch[q * plane + o];
        bufb[(q * P + p) * S + m2] = v;
      }
    }
    __syncthreads();
    buf = dft::transform<T, NP, true>(dft::SmemSeq<CT>{bufb, S}, bufa,
                                      bufb, lgP, S, L, tw);
  }

  const int k2lo = c.n1 / c.f1;
  const int k2hi = (c.n1 + c.N + c.f1 - 1) / c.f1;
  // k2 offsets walked through swz over whole blocks of 2^sw2
  const int nk = ((k2hi - k2lo + (1 << c.sw2) - 1) >> c.sw2) << c.sw2;
  const T gate = (T)c.gamma_gate * (T)c.gamma_gate;
  const size_t row = (size_t)(c.row0 + a) * c.N;
  for (int e = threadIdx.x; e < P * nk; e += blockDim.x) {
    const int p = e & (P - 1);
    const int k2 = k2lo + swz(e >> lgP, c.sw2);
    const int j = k1_0 + p + c.f1 * k2 - c.n1;
    if (k2 >= k2hi || j < 0 || j >= c.N) continue;
    if (ENG == ENG_MIXED && k1_0 + p >= c.f1) continue;
    const CT W = buf[p * S + k2];
    if constexpr (MODE == MODE_BINS) {
      const CT Dw = buf[(P + p) * S + k2];
      wx[row + j] = W;
      static_cast<int32_t*>(out2)[row + j] =
          phase_bin<T>(W, Dw, false, (T)0, gate, c.bm);
    } else if constexpr (MODE == MODE_W) {
      wx[row + j] = W;
    } else if constexpr (MODE == MODE_W_DW) {
      wx[row + j] = W;
      static_cast<CT*>(out2)[row + j] = buf[(P + p) * S + k2];
    } else {
      const CT A = buf[(P + p) * S + k2], B = buf[(2 * P + p) * S + k2];
      const CT Bd = buf[(3 * P + p) * S + k2], C = buf[(4 * P + p) * S + k2];
      wx[row + j] = W;
      const T w2 = order2_w<T>(W, A, B, Bd, C, c, gate);
      if constexpr (MODE == MODE_BINS2)
        static_cast<int32_t*>(out2)[row + j] =
            finite_t(w2) ? bin_of<T>(w2, c.bm) : -1;
      else
        static_cast<T*>(out2)[row + j] = w2;
    }
  }
}

// Dynamic shared bytes of a stage over a length-L DFT of NP * P
// sequences S apart (ops/cwt_cuda.py::bins_plan reckons the same): the
// radix-4 engine's L/2 twiddles and one buffer, the mixed engine's L
// twiddles and two.
template <typename T, int ENG>
size_t smem_bytes(int L, int np, int P, int S) {
  typedef typename Cplx<T>::type CT;
  return (ENG == ENG_RADIX4 ? (size_t)(L / 2 + np * P * S)
                            : (size_t)(L + 2 * np * P * S)) * sizeof(CT);
}

template <typename T, int NP, int ENG, int SYN>
cudaError_t launch_stage1(const void* xh, const void* scales,
                          const void* table, const int* klims, const Cfg& c,
                          void* scratch, size_t sm1, cudaStream_t st) {
  typedef typename Cplx<T>::type CT;
  cudaFuncSetAttribute(bins_stage1<T, NP, ENG, SYN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  // the last block's columns may run past the partner factor (mixed)
  dim3 g1((c.f2 + c.P1 - 1) / c.P1, c.rows);
  bins_stage1<T, NP, ENG, SYN><<<g1, 256, sm1, st>>>(
      static_cast<const CT*>(xh), static_cast<const T*>(scales),
      static_cast<const T*>(table), klims, c, static_cast<CT*>(scratch));
  return cudaGetLastError();
}

template <typename T, int MODE, int ENG>
int launch_mode(const void* xh, const void* scales, const void* table,
                const int* klims, const Cfg& c, void* scratch, void* wx,
                void* out2, cudaStream_t st) {
  typedef typename Cplx<T>::type CT;
  constexpr int NP = planes_of(MODE);
  const size_t sm1 = smem_bytes<T, ENG>(c.f1, NP, c.P1, c.S1);
  const size_t sm2 = smem_bytes<T, ENG>(c.f2, NP, c.P2, c.S2);
  cudaFuncSetAttribute(bins_stage2<T, MODE, ENG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm2);
  dim3 g2((c.f1 + c.P2 - 1) / c.P2, c.rows);
  cudaError_t err =
      table ? launch_stage1<T, NP, ENG, SYN_TABLE>(xh, scales, table, klims,
                                                   c, scratch, sm1, st)
            : launch_stage1<T, NP, ENG, SYN_GMW>(xh, scales, table, klims, c,
                                                 scratch, sm1, st);
  if (err != cudaSuccess) return (int)err;
  bins_stage2<T, MODE, ENG><<<g2, 256, sm2, st>>>(
      static_cast<const CT*>(scratch), c, static_cast<CT*>(wx), out2);
  return (int)cudaGetLastError();
}

template <typename T, int ENG>
int launch_engine(const void* xh, const void* scales, const void* table,
                  const int* klims, const Cfg& c, void* scratch, void* wx,
                  void* out2, cudaStream_t st) {
  switch (c.out_mode) {
    case MODE_BINS:
      return launch_mode<T, MODE_BINS, ENG>(xh, scales, table, klims, c,
                                            scratch, wx, out2, st);
    case MODE_W:
      return launch_mode<T, MODE_W, ENG>(xh, scales, table, klims, c,
                                         scratch, wx, out2, st);
    case MODE_W_DW:
      return launch_mode<T, MODE_W_DW, ENG>(xh, scales, table, klims, c,
                                            scratch, wx, out2, st);
    case MODE_BINS2:
      return launch_mode<T, MODE_BINS2, ENG>(xh, scales, table, klims, c,
                                             scratch, wx, out2, st);
    case MODE_W2:
      return launch_mode<T, MODE_W2, ENG>(xh, scales, table, klims, c,
                                          scratch, wx, out2, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* xh, const void* scales, const void* table,
           const int* klims, const Cfg& c, void* scratch, void* wx,
           void* out2, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (c.engine) {
    case ENG_RADIX4:
      return launch_engine<T, ENG_RADIX4>(xh, scales, table, klims, c,
                                          scratch, wx, out2, st);
    case ENG_MIXED:
      return launch_engine<T, ENG_MIXED>(xh, scales, table, klims, c,
                                         scratch, wx, out2, st);
  }
  return (int)cudaErrorInvalidValue;
}

Cfg make_cfg(const int* ip, const double* dp) {
  Cfg c;
  c.n_up = ip[0]; c.f1 = ip[1]; c.f2 = ip[2]; c.lg1 = ip[3]; c.lg2 = ip[4];
  c.half = ip[5]; c.n1 = ip[6]; c.N = ip[7]; c.P1 = ip[8]; c.P2 = ip[9];
  c.rows = ip[10]; c.row0 = ip[11]; c.l1_norm = ip[12]; c.bm.mode = ip[13];
  c.bm.idx1 = ip[14]; c.bm.omax = ip[15]; c.bm.flipud = ip[16];
  c.out_mode = ip[17]; c.na = ip[18];
  c.S1 = ip[19]; c.S2 = ip[20]; c.sw1 = ip[21]; c.sw2 = ip[22];
  c.engine = ip[23];
  c.xi_step = dp[0]; c.inv_dt = dp[1]; c.gamma_gate = dp[2];
  c.logconst = dp[3]; c.amp = dp[4]; c.wgamma = dp[5]; c.beta = dp[6];
  c.wc = dp[7]; c.bm.a0 = dp[8]; c.bm.d0 = dp[9]; c.bm.a1 = dp[10];
  c.bm.d1 = dp[11];
  c.tiny = dp[12]; c.two_pi_dt = dp[13];
  return c;
}

}  // namespace

// ip: 24 ints, dp: 14 doubles (layout in ops/cwt_cuda.py). `table` is
// the wavelet table (real, of the scales' type: (na, n_up/2 + 1), three
// such planes in the order-2 modes) or null for the closed-form GMW.
// `klims` holds na int32 stage-1 row limits in device memory (row g reads
// klims[g % na]; rows0 = ceil((n_up/2 + 1) / f2) runs a row unpruned).
// `out2` is k (out_mode 0 or 3), dWx (2), w2 (4, real) or null (1);
// out_mode in ip says which. Returns cudaGetLastError() after the
// launches.
extern "C" int cwt_bins_f32(const void* xh, const void* scales,
                            const void* table, const int* klims,
                            const int* ip, const double* dp, void* scratch,
                            void* wx, void* out2, void* stream) {
  return launch<float>(xh, scales, table, klims, make_cfg(ip, dp), scratch,
                       wx, out2, stream);
}

extern "C" int cwt_bins_f64(const void* xh, const void* scales,
                            const void* table, const int* klims,
                            const int* ip, const double* dp, void* scratch,
                            void* wx, void* out2, void* stream) {
  return launch<double>(xh, scales, table, klims, make_cfg(ip, dp), scratch,
                        wx, out2, stream);
}
