// Mixed-radix (4, 2, 3, 5, 7) DFT passes in shared memory, laid out
// against bank conflicts: the engine of the STFT table kernel
// (stft_conv.cu) and of the CWT kernel's mixed path (cwt_bins.cu).
//
// Layout: position i of sequence s at buf[s * S + i], with the sequence
// stride S = L | 1 odd (ops/cwt_cuda.py::smem_index, same form), so the
// sequences at one position fall on distinct bank pairs (32 banks of 4
// bytes, 128 bytes per wavefront: 16 8-byte or 8 16-byte elements).
//
// Passes: Stockham autosort, natural order in and out, ping-ponging
// between two buffers, radix 4 while 4 divides what is left of L, then
// 2, 3, 5 and, where the caller asks for it (`transform<T, NP, true>`,
// the CWT kernel's mixed path), 7 (ops/stft_cuda.py::radices). The STFT
// kernel's lengths have no factor 7, and without radix 7 its passes
// compile as they did before radix 7 came (with it, their registers grow
// and stft_stage1<float, 2> spills). Butterfly b of a pass runs
// on sequence q = b mod nseq (the sequence fastest) at index j = b div nseq,
// so a half-warp reads and writes q * S + const over 16 sequences (16
// distinct bank pairs when nseq >= 16) and reads one twiddle (a
// broadcast). Each butterfly is the textbook Stockham one: inputs
// src[j + r L/R] times tw[r (j mod Ns) L / (Ns R)], outputs at
// dst[(j - j mod Ns) R + j mod Ns + k Ns], with the table
// tw[t] = e^{+2 pi i t / L}; radix 3, 5 and 7 sum over the table twiddles
// tw[((r k) mod R) L / R], which a thread loads once per pass.
#pragma once
#include <cuda_runtime.h>

namespace dft {

template <typename T> struct Cplx;
template <> struct Cplx<float> { typedef float2 type; };
template <> struct Cplx<double> { typedef double2 type; };

__device__ __forceinline__ void sincospi_t(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void sincospi_t(double x, double* s, double* c) {
  sincospi(x, s, c);
}

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

__host__ __device__ constexpr int clog2(int v) {
  return v > 1 ? 1 + clog2(v >> 1) : 0;
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// r with its low b bits reversed (0 <= b <= 31): a bijection on every
// aligned block of 2^b (ops/cwt_cuda.py::swz). A thread group that walks
// P columns fastest and positions swz(t, b) next covers positions P apart.
__device__ __forceinline__ int swz(int r, int b) {
  const int m = (1 << b) - 1;
  return (r & ~m) | (int)(__brev((unsigned)(r & m)) >> (31 - b) >> 1);
}

// tw[t] = e^{+2 pi i t / L}, t < L (inverse sign)
template <typename T>
__device__ void fill_twiddles(typename Cplx<T>::type* tw, int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    T s, c;
    sincospi_t((T)(2 * i) / (T)L, &s, &c);
    tw[i].x = c;
    tw[i].y = s;
  }
}

// Reads position i of sequence q from shared memory at a[q * S + i].
template <typename CT>
struct SmemSeq {
  const CT* a;
  int S;
  __device__ __forceinline__ CT operator()(int q, int i) const {
    return a[q * S + i];
  }
};

// One pass of radix R over the NP << lgP sequences of length L, reading
// position i of sequence q as src(q, i) (shared memory, or for the first
// pass the kernel's own loads from device memory) and writing dst[q * S
// + i]; Ns = the product of the earlier radices. Ends with
// __syncthreads(). Inlined at every call, so that the compiler sees
// which loads and stores address shared memory.
template <typename T, int NP, int R, typename Src>
__device__ __forceinline__ void stockham_pass(Src src,
                              typename Cplx<T>::type* __restrict__ dst,
                              int lgP, int S, int L, int Ns,
                              const typename Cplx<T>::type* __restrict__ tw) {
  typedef typename Cplx<T>::type CT;
  // a power-of-two sequence count splits b by shift and mask
  constexpr bool POW2 = (NP & (NP - 1)) == 0;
  const int lgn = lgP + clog2(NP);
  const int nseq = NP << lgP;
  const int LR = L / R;
  const int tstep = L / (Ns * R);
  CT wt[R];                                // radix 3, 5, 7: tw[t * L/R]
  if constexpr (R == 3 || R == 5 || R == 7) {
#pragma unroll
    for (int t = 0; t < R; ++t) wt[t] = tw[t * LR];
  }
  for (int b = threadIdx.x; b < nseq * LR; b += blockDim.x) {
    const int j = POW2 ? b >> lgn : (int)((unsigned)(b >> lgP) / NP);
    const int q = b - j * nseq;
    // radix 4 and 2 come first, so their Ns is a power of two
    const int jm = (R == 4 || R == 2) ? (j & (Ns - 1)) : j % Ns;
    CT v[R];
    v[0] = src(q, j);
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[r] = cmul(src(q, j + r * LR), tw[r * jm * tstep]);
    CT* d = dst + q * S + (j - jm) * R + jm;
    if constexpr (R == 2) {
      CT y0, y1;
      y0.x = v[0].x + v[1].x; y0.y = v[0].y + v[1].y;
      y1.x = v[0].x - v[1].x; y1.y = v[0].y - v[1].y;
      d[0] = y0;
      d[Ns] = y1;
    } else if constexpr (R == 4) {
      // e^{+2 pi i r k / 4} = i^{r k}
      const T s02x = v[0].x + v[2].x, s02y = v[0].y + v[2].y;
      const T d02x = v[0].x - v[2].x, d02y = v[0].y - v[2].y;
      const T s13x = v[1].x + v[3].x, s13y = v[1].y + v[3].y;
      const T d13x = v[1].x - v[3].x, d13y = v[1].y - v[3].y;
      CT y;
      y.x = s02x + s13x; y.y = s02y + s13y; d[0] = y;
      y.x = d02x - d13y; y.y = d02y + d13x; d[Ns] = y;
      y.x = s02x - s13x; y.y = s02y - s13y; d[2 * Ns] = y;
      y.x = d02x + d13y; y.y = d02y - d13x; d[3 * Ns] = y;
    } else {
      // e^{+2 pi i r k / R} = tw[((r k) mod R) * L / R]
#pragma unroll
      for (int k = 0; k < R; ++k) {
        CT acc = v[0];
#pragma unroll
        for (int r = 1; r < R; ++r)
          acc = cadd(acc, cmul(v[r], wt[(r * k) % R]));
        d[k * Ns] = acc;
      }
    }
  }
  __syncthreads();
}

// The radix of the next pass over what is left of L, `rem`: 4 while 4
// divides it, then 2, 3, 5 and, with R7, 7.
template <bool R7>
__device__ __forceinline__ int next_radix(int rem) {
  return rem % 4 == 0 ? 4 : rem % 2 == 0 ? 2 : rem % 3 == 0 ? 3
         : (!R7 || rem % 5 == 0) ? 5 : 7;
}

// The unnormalized inverse DFT of the NP << lgP length-L sequences, read
// as first(q, i) by the first pass (which the caller's loads feed
// directly, so the input never passes through shared memory), then
// ping-ponging between a and b at a[q * S + i]; returns the buffer
// holding the result. L's prime factors are 2, 3, 5, and 7 with R7. The
// caller has filled `tw` and synchronized; ends with __syncthreads().
// Ns0 > 1 starts from the pass after those whose radices multiply to Ns0
// (first(q, i) then holds their result; with Ns0 = L no pass runs and
// the result is the buffer `first` reads, which the caller passes as b).
template <typename T, int NP, bool R7 = false, typename Src>
__device__ typename Cplx<T>::type* transform(Src first,
                                             typename Cplx<T>::type* a,
                                             typename Cplx<T>::type* b,
                                             int lgP, int S, int L,
                                             const typename Cplx<T>::type* tw,
                                             int Ns0 = 1) {
  typedef typename Cplx<T>::type CT;
  if (L == 1) {                            // no pass: the input as it is
    for (int q = threadIdx.x; q < (NP << lgP); q += blockDim.x)
      a[q * S] = first(q, 0);
    __syncthreads();
    return a;
  }
  int Ns = Ns0, rem = L / Ns0;
  bool head = true;
  while (rem > 1) {
    const int R = next_radix<R7>(rem);
    if (head) {
      switch (R) {
        case 4: stockham_pass<T, NP, 4>(first, a, lgP, S, L, Ns, tw); break;
        case 2: stockham_pass<T, NP, 2>(first, a, lgP, S, L, Ns, tw); break;
        case 3: stockham_pass<T, NP, 3>(first, a, lgP, S, L, Ns, tw); break;
        default:
          if constexpr (R7) {
            if (R == 7) {
              stockham_pass<T, NP, 7>(first, a, lgP, S, L, Ns, tw);
              break;
            }
          }
          stockham_pass<T, NP, 5>(first, a, lgP, S, L, Ns, tw);
      }
      head = false;
    } else {
      const SmemSeq<CT> src{b, S};
      switch (R) {
        case 4: stockham_pass<T, NP, 4>(src, a, lgP, S, L, Ns, tw); break;
        case 2: stockham_pass<T, NP, 2>(src, a, lgP, S, L, Ns, tw); break;
        case 3: stockham_pass<T, NP, 3>(src, a, lgP, S, L, Ns, tw); break;
        default:
          if constexpr (R7) {
            if (R == 7) {
              stockham_pass<T, NP, 7>(src, a, lgP, S, L, Ns, tw);
              break;
            }
          }
          stockham_pass<T, NP, 5>(src, a, lgP, S, L, Ns, tw);
      }
    }
    CT* t = a;                             // the result is now in `b`
    a = b;
    b = t;
    Ns *= R;
    rem /= R;
  }
  return b;
}

}  // namespace dft
