// Ridge extraction's dynamic program (forward pass and backward trace),
// the one sequential loop of the analysis layer:
//
//   forward:  pe[b, 0, f] = e[b, 0, f]
//             pe[b, t, f] = e[b, t, f] + min_g (pe[b, t-1, g] + P[f, g])
//   P[f, g] = pen * ((v[f] - v[g]) * (v[f] - v[g]))
//
//   trace:    r[T-1] = argmin_f pe[T-1, f]; for t = T-2 .. 0, with
//             n = r[t+1] and val = pe[t+1, n] - e[t+1, n]:
//             r[t] = the last f with |val - (pe[t, f] + P[n, f])| < eps,
//                    else argmin_f pe[t, f] (its first occurrence)
//
// e and pe are real, time-major (B, T, F), contiguous: each step's row is
// one coalesced read or write. r is int32 (B, T).
//
// Replaces no Pallas kernel. It is the port's counterpart of the JAX
// package's XLA program ssqueezepy_tpu/models/ridge_extraction.py::
// _fw_bw_jit (a lax.scan over time with a min-plus F x F step, and a
// reverse scan for the trace), which XLA compiles into one program; in
// PyTorch a loop over t would launch several kernels per column
// (~640000 per pass at T = 160000).
//
// Exactness. pe must be bit-identical to the plain version
// (ops/ridge_cuda.py::ridge_forward_plain): P is computed per use with
// round-to-nearest intrinsics in the plain version's order (d = v_f - v_g;
// pen * (d * d); then pe + P; then e + min), so no FMA contraction can
// creep in. The min is exact; a NaN among the candidates makes the min
// NaN, as torch.amin and jnp.min do. The argmin treats NaN as the least
// value and takes the first occurrence, as torch.argmin and jnp.argmin do.
//
// Bound. The function needs B (T - 1) F^2 min-plus pairs (an add and a
// min: 2 operations each; at T = 160000, F = 293 about 2.7e10, 0.41 ms at
// 67 TFLOP/s) and moves e in and pe out (2 B T F elements, 0.11 ms at
// 3.35 TB/s): operations bound it. The trace reads pe once (and e along
// the path): bytes bound it (0.06 ms at that shape).
//
// Design (simple first). The steps are sequential, so one thread block
// per batch row does all of them: the forward keeps the previous and the
// current row and v in shared memory, threads over f, each thread's min
// over g in four partial minima from 128-bit broadcast loads, and one
// __syncthreads per step; P is recomputed per use (3 operations per
// pair), since F x F does not fit in shared memory (343 KB at F = 293
// in float). One SM therefore runs the whole pass: ~1-3 us per step. The
// trace is a second launch, one block per batch row: each step's rows of
// pe and e are copied into a double buffer with cp.async one step ahead,
// and a block reduction per step gives the last qualifying f and the
// argmin. A cluster that splits f over several SMs (distributed shared
// memory) is later work (ROADMAP.md, parked performance list).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_t(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
template <typename T> __device__ __forceinline__ T inf_t();
template <> __device__ __forceinline__ float inf_t<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_t<double>() { return CUDART_INF; }
template <typename T> __device__ __forceinline__ T nan_t();
template <> __device__ __forceinline__ float nan_t<float>() { return CUDART_NAN_F; }
template <> __device__ __forceinline__ double nan_t<double>() { return CUDART_NAN; }

// Four consecutive elements of a shared array, 16-byte aligned: one
// 128-bit load for float, two for double.
template <typename T> struct Quad { T a, b, c, d; };
__device__ __forceinline__ Quad<float> load4(const float* p) {
  float4 q = *reinterpret_cast<const float4*>(p);
  return {q.x, q.y, q.z, q.w};
}
__device__ __forceinline__ Quad<double> load4(const double* p) {
  double2 q0 = *reinterpret_cast<const double2*>(p);
  double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  return {q0.x, q0.y, q1.x, q1.y};
}

// One candidate pe[g] + P[f, g] into the partial min m, NaN noted apart
// (fmin drops a NaN; the flag puts it back after the loop).
template <typename T>
__device__ __forceinline__ void relax(T vf, T vg, T pg, T pen, T& m,
                                      bool& nan) {
  const T d = sub_rn(vf, vg);
  const T s = add_rn(pg, mul_rn(pen, mul_rn(d, d)));
  m = min_t(m, s);
  nan |= (s != s);
}

// Rows padded to a multiple of 4: v with 0, prev with +inf, whose
// candidates (+inf) never lower a min nor raise the NaN flag.
__host__ __device__ __forceinline__ int pad4(int F) { return (F + 3) & ~3; }

template <typename T>
__global__ void ridge_forward_kernel(const T* __restrict__ e,
                                     const T* __restrict__ v, T pen, int F,
                                     int Tn, T* __restrict__ pe) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Fp = pad4(F);
  T* sv = reinterpret_cast<T*>(smem_raw);
  T* prev = sv + Fp;
  T* cur = prev + Fp;
  const size_t base = (size_t)blockIdx.x * Tn * F;
  const T* eb = e + base;
  T* pb = pe + base;
  for (int f = threadIdx.x; f < Fp; f += blockDim.x) {
    const bool in = f < F;
    sv[f] = in ? v[f] : T(0);
    const T x = in ? eb[f] : inf_t<T>();
    prev[f] = x;
    cur[f] = inf_t<T>();
    if (in) pb[f] = x;
  }
  __syncthreads();
  for (int t = 1; t < Tn; ++t) {
    const T* et = eb + (size_t)t * F;
    T* pt = pb + (size_t)t * F;
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      const T ef = et[f];
      const T vf = sv[f];
      T m0 = inf_t<T>(), m1 = m0, m2 = m0, m3 = m0;
      bool nan = false;
      for (int g = 0; g < Fp; g += 4) {
        const Quad<T> vq = load4(sv + g);
        const Quad<T> pq = load4(prev + g);
        relax(vf, vq.a, pq.a, pen, m0, nan);
        relax(vf, vq.b, pq.b, pen, m1, nan);
        relax(vf, vq.c, pq.c, pen, m2, nan);
        relax(vf, vq.d, pq.d, pen, m3, nan);
      }
      const T m = nan ? nan_t<T>() : min_t(min_t(m0, m1), min_t(m2, m3));
      const T x = add_rn(ef, m);
      cur[f] = x;
      pt[f] = x;
    }
    __syncthreads();
    T* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// (value, index) with NaN the least value and ties to the lower index,
// the order of torch.argmin and jnp.argmin.
template <typename T>
__device__ __forceinline__ bool better(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy row t of pe and e into buffers (each thread its own elements).
template <typename T>
__device__ __forceinline__ void fetch_row(const T* pb, const T* eb, int t,
                                          int F, T* pdst, T* edst) {
  const size_t o = (size_t)t * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    cp_async(pdst + f, pb + o + f, (int)sizeof(T));
    cp_async(edst + f, eb + o + f, (int)sizeof(T));
  }
  cp_async_commit();
}

constexpr int kMaxWarps = 32;

// Block reduction of (last qualifying f, argmin pair); the result is
// valid in thread 0. red_* hold one entry per warp; the caller's next
// write to them follows a __syncthreads that thread 0 reaches after its
// reads.
template <typename T>
__device__ __forceinline__ void reduce_step(int& last, T& best, int& ibest,
                                            int* red_last, T* red_val,
                                            int* red_idx) {
  const unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) {
    last = max(last, __shfl_down_sync(full, last, o));
    const T b = __shfl_down_sync(full, best, o);
    const int ib = __shfl_down_sync(full, ibest, o);
    if (better(b, ib, best, ibest)) { best = b; ibest = ib; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_last[warp] = last;
    red_val[warp] = best;
    red_idx[warp] = ibest;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    for (int w = 1; w < nw; ++w) {
      last = max(last, red_last[w]);
      if (better(red_val[w], red_idx[w], best, ibest)) {
        best = red_val[w];
        ibest = red_idx[w];
      }
    }
  }
}

template <typename T>
__global__ void ridge_trace_kernel(const T* __restrict__ pe,
                                   const T* __restrict__ e,
                                   const T* __restrict__ v, T pen, T eps,
                                   int F, int Tn, int* __restrict__ ridge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red_val[kMaxWarps];
  __shared__ int red_last[kMaxWarps], red_idx[kMaxWarps];
  __shared__ int s_nxt;  // r[t+1] and val, from thread 0 to the block
  __shared__ T s_val;
  T* sv = reinterpret_cast<T*>(smem_raw);
  T* pbuf = sv + F;            // [2][F]
  T* ebuf = pbuf + 2 * F;      // [2][F]
  const size_t base = (size_t)blockIdx.x * Tn * F;
  const T* pb = pe + base;
  const T* eb = e + base;
  int* rb = ridge + (size_t)blockIdx.x * Tn;

  for (int f = threadIdx.x; f < F; f += blockDim.x) sv[f] = v[f];
  const int last_buf = (Tn - 1) & 1;
  fetch_row(pb, eb, Tn - 1, F, pbuf + last_buf * F, ebuf + last_buf * F);
  cp_async_wait_all();
  __syncthreads();
  {
    int last = -1, ib = F;
    T best = inf_t<T>();
    const T* row = pbuf + last_buf * F;
    for (int f = threadIdx.x; f < F; f += blockDim.x)
      if (better(row[f], f, best, ib)) { best = row[f]; ib = f; }
    reduce_step(last, best, ib, red_last, red_val, red_idx);
    if (threadIdx.x == 0) {
      rb[Tn - 1] = ib;
      s_nxt = ib;
      s_val = sub_rn(row[ib], ebuf[last_buf * F + ib]);
    }
  }
  if (Tn >= 2) {
    const int b = (Tn - 2) & 1;
    fetch_row(pb, eb, Tn - 2, F, pbuf + b * F, ebuf + b * F);
  }
  for (int t = Tn - 2; t >= 0; --t) {
    cp_async_wait_all();
    __syncthreads();  // row t landed for every thread; s_nxt/s_val visible
    const int cb = t & 1;
    if (t >= 1)  // the other buffer was last read before the sync above
      fetch_row(pb, eb, t - 1, F, pbuf + (1 - cb) * F, ebuf + (1 - cb) * F);
    const int nxt = s_nxt;
    const T val = s_val;
    const T vn = sv[nxt];
    const T* row = pbuf + cb * F;
    int last = -1, ib = F;
    T best = inf_t<T>();
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      const T pf = row[f];
      const T d = sub_rn(vn, sv[f]);
      const T s = add_rn(pf, mul_rn(pen, mul_rn(d, d)));
      if (abs_t(sub_rn(val, s)) < eps) last = f;
      if (better(pf, f, best, ib)) { best = pf; ib = f; }
    }
    reduce_step(last, best, ib, red_last, red_val, red_idx);
    if (threadIdx.x == 0) {
      const int idx = last >= 0 ? last : ib;
      rb[t] = idx;
      s_nxt = idx;
      s_val = sub_rn(row[idx], ebuf[cb * F + idx]);
    }
  }
}

int threads_for(int F) {
  int n = ((F + 31) / 32) * 32;
  return n > 1024 ? 1024 : (n < 32 ? 32 : n);
}

template <typename T>
int launch_forward(const void* e, const void* v, double pen, int B, int F,
                   int Tn, void* pe, void* stream) {
  if (B < 1 || F < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * pad4(F) * sizeof(T);
  auto fn = ridge_forward_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, threads_for(F), smem, (cudaStream_t)stream>>>(
      (const T*)e, (const T*)v, (T)pen, F, Tn, (T*)pe);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trace(const void* pe, const void* e, const void* v, double pen,
                 double eps, int B, int F, int Tn, void* ridge,
                 void* stream) {
  if (B < 1 || F < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)5 * F * sizeof(T);
  auto fn = ridge_trace_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, threads_for(F), smem, (cudaStream_t)stream>>>(
      (const T*)pe, (const T*)e, (const T*)v, (T)pen, (T)eps, F, Tn,
      (int*)ridge);
  return (int)cudaGetLastError();
}

}  // namespace

// pe (B, T, F) from e (B, T, F) and v (F,); pen is rounded to the type.
extern "C" int ridge_forward_f32(const void* e, const void* v, double pen,
                                 int B, int F, int Tn, void* pe,
                                 void* stream) {
  return launch_forward<float>(e, v, pen, B, F, Tn, pe, stream);
}

extern "C" int ridge_forward_f64(const void* e, const void* v, double pen,
                                 int B, int F, int Tn, void* pe,
                                 void* stream) {
  return launch_forward<double>(e, v, pen, B, F, Tn, pe, stream);
}

// ridge (B, T) int32 from pe and e (B, T, F) and v (F,).
extern "C" int ridge_trace_f32(const void* pe, const void* e, const void* v,
                               double pen, double eps, int B, int F, int Tn,
                               void* ridge, void* stream) {
  return launch_trace<float>(pe, e, v, pen, eps, B, F, Tn, ridge, stream);
}

extern "C" int ridge_trace_f64(const void* pe, const void* e, const void* v,
                               double pen, double eps, int B, int F, int Tn,
                               void* ridge, void* stream) {
  return launch_trace<double>(pe, e, v, pen, eps, B, F, Tn, ridge, stream);
}
