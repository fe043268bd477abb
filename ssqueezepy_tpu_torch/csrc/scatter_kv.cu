// Synchrosqueezing reassignment from precomputed bin indices (B2):
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
// and vmapped over a batch).
//
// Bound: device memory. B2 reads Wx + k + cst and writes Tx (~0.94 GB at
// 293 x 160000 in complex64 + int32, ~0.28 ms at 3.35 TB/s); B5 reads one
// byte more per cell (~0.98 GB, ~0.29 ms). At most 2 FLOP per byte.
//
// Design (both kernels, one body, ring_scatter; timings on an NVIDIA H100
// 80GB HBM3: PERF.md, section 6):
//  * A block owns TC consecutive time columns of one signal (blockIdx.y =
//    b, so a batch is one launch; the batch offset is a pointer offset).
//    Each thread owns one column j and sums the rows i in ascending order
//    into its own column of a [bin][column] complex accumulator in shared
//    memory, `s.x += v.x * c` as one FMA, as before. No two threads touch
//    one address, so there are no atomics and Tx is bit-identical from run
//    to run and to earlier versions of this kernel (streaming resume relies
//    on that).
//  * The accumulator takes up to 200 KB per block (294 x 16 x 8 = 37 KB at
//    the headline), so an SM holds few columns, and with plain loads too
//    few bytes were in flight to keep device memory busy. So the rows come
//    through a ring of S stages x kRows rows in shared memory ([stage][row]
//    [column] per plane: values, consts, k, B5's mask), filled by
//    asynchronous copies (cp.async): each thread copies only its own
//    column's cells (8 or 16 bytes of value, 4 of k, its row's const),
//    commits one group per stage, keeps S - 1 stages in flight while it
//    sums one, and waits with cp.async.wait_group S - 1. A thread reads
//    only what it copied itself, so no barrier is needed anywhere, and
//    threads of a ragged last block (j >= N) simply return. Element-sized
//    copies are naturally aligned for every N, odd N included. The consts
//    ride the ring because a plain load of cst[i] per row missed the L1
//    that the copies stream through and stalled every row. Plain loads of
//    1-3 chunks ahead into registers, with the same sums, ran 1.16-1.42x
//    slower at the headline at every depth (PERF.md, section 6).
//  * B5's mask: cp.async copies 4 bytes at least, so each thread copies
//    the naturally aligned 4-byte word that holds its own mask byte and
//    shifts the byte out. It keeps the copy private to the thread (no warp
//    sync, no hazard on the ragged last warp) and works for every N and
//    every alignment of the plane; the word's other bytes are never used,
//    and an aligned word never crosses an allocation's granule.
//  * A stage's kRows rows are summed in one go: every accumulator cell they
//    hit is read before any is written, a row whose bin an earlier row of
//    the stage also hit takes that row's sum instead of the stale read,
//    and the writes go in row order; a dropped cell goes to a spare bin
//    (row nbins) that is never written out. So each bin still sums its
//    rows in ascending order, and a stage costs one shared-memory latency
//    instead of one per row: the read-modify-write chain, not the copies,
//    bounded the kernel before.
//  * The accumulator and the ring are addressed in the shared state space
//    (an extern __shared__ base indexed in the kernel, cvta for the copies'
//    destinations); the mode is a template parameter: a run-time branch or
//    offset in the row loop cost 1.6x before (PERF.md, section 6).
//  * The prologue (S - 1 stages) is issued before the accumulator is
//    zeroed, so the zeroing hides the first loads. The launch plan (columns
//    per block TC and S) is ops/ssq_cuda.py::scatter_plan: one 128-byte
//    line of values per row, then the fewest stages that keep ~16 KB of
//    copies in flight per SM at the blocks per SM the runtime grants
//    (scatter_occupancy).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Cplx;
template <> struct Cplx<float> { typedef float2 type; };
template <> struct Cplx<double> { typedef double2 type; };

constexpr int kMaxColumns = 256;    // threads (columns) per block at most
constexpr int kRows = 8;            // rows per stage, summed in one go
constexpr int kMaxStages = 16;      // ring stages at most
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block

template <int Bytes>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Until at most `pending` of this thread's newest groups are in flight
// (the count is an immediate of the instruction; `pending` is uniform).
__device__ __forceinline__ void wait_group(int pending) {
  switch (pending) {
#define SCATTER_WAIT(n) \
  case n:               \
    wait_group_n<n>();  \
    break;
    SCATTER_WAIT(1) SCATTER_WAIT(2) SCATTER_WAIT(3) SCATTER_WAIT(4)
    SCATTER_WAIT(5) SCATTER_WAIT(6) SCATTER_WAIT(7) SCATTER_WAIT(8)
    SCATTER_WAIT(9) SCATTER_WAIT(10) SCATTER_WAIT(11) SCATTER_WAIT(12)
    SCATTER_WAIT(13) SCATTER_WAIT(14) SCATTER_WAIT(15)
#undef SCATTER_WAIT
    default:
      wait_group_n<0>();
  }
}

// Shared-memory bytes of one block: the (nbins + 1, tc) accumulator (a
// spare bin for dropped cells last), then the ring's planes, each (stages,
// kRows, tc): values, consts, k, mask words. The one statement of the
// layout: ring_scatter carves it, ops/ssq_cuda.py::scatter_plan reads it
// through scatter_occupancy.
template <typename T>
size_t smem_bytes(int nbins, int tc, int stages, bool has_valid,
                  bool has_const) {
  typedef typename Cplx<T>::type CT;
  return (size_t)(nbins + 1) * tc * sizeof(CT) +
         (size_t)stages * kRows * tc *
             (sizeof(CT) + (has_const ? sizeof(T) : 0) + 4 +
              (has_valid ? 4 : 0));
}

// One block's columns; Wrap: false for B2 (any k outside [0, nbins)
// dropped), true for B5 (a negative k wrapped once).
template <typename T, bool Wrap, bool HasValid, bool HasConst>
__device__ __forceinline__ void ring_scatter(
    const typename Cplx<T>::type* __restrict__ v,
    const int32_t* __restrict__ k, const uint8_t* __restrict__ valid,
    const T* __restrict__ cst, int na, int N, int nbins, int S,
    typename Cplx<T>::type* __restrict__ out) {
  typedef typename Cplx<T>::type CT;
  constexpr int R = kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TC = blockDim.x;
  const int t = threadIdx.x;
  const int j = blockIdx.x * TC + t;
  if (j >= N) return;
  const size_t in = (size_t)blockIdx.y * na * N + j;
  v += in;
  k += in;
  if (HasValid) valid += in;
  out += (size_t)blockIdx.y * nbins * N + j;

  // this thread's column of the accumulator and of each ring plane
  const int ring = S * R * TC;  // cells of one plane
  CT* acc = reinterpret_cast<CT*>(smem_raw) + t;
  CT* vring = reinterpret_cast<CT*>(smem_raw) + (size_t)(nbins + 1) * TC + t;
  T* cring = reinterpret_cast<T*>(vring - t + ring) + t;
  int32_t* kring =
      reinterpret_cast<int32_t*>(cring - t + (HasConst ? ring : 0)) + t;
  uint32_t* mring = reinterpret_cast<uint32_t*>(kring - t + ring) + t;
  const uint32_t vdst = (uint32_t)__cvta_generic_to_shared(vring);
  const uint32_t cdst = (uint32_t)__cvta_generic_to_shared(cring);
  const uint32_t kdst = (uint32_t)__cvta_generic_to_shared(kring);
  const uint32_t mdst = (uint32_t)__cvta_generic_to_shared(mring);
  // low bits of the byte address of this column's mask in row 0
  const unsigned m0 = HasValid ? (unsigned)(uintptr_t)valid : 0u;

  // copy the rows of chunk c (rows c R .. c R + R - 1) into stage s; one
  // group, empty past the last row
  auto issue = [&](int c, int s) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = c * R + r;
      if (i < na) {
        const size_t o = (size_t)i * N;
        const int e = (s * R + r) * TC;
        copy_async<(int)sizeof(CT)>(vdst + e * (int)sizeof(CT), v + o);
        if (HasConst) copy_async<(int)sizeof(T)>(cdst + e * (int)sizeof(T),
                                                 cst + i);
        copy_async<4>(kdst + e * 4, k + o);
        if (HasValid)
          copy_async<4>(mdst + e * 4,
                        reinterpret_cast<const void*>(
                            (uintptr_t)(valid + o) & ~(uintptr_t)3));
      }
    }
    commit_group();
  };

  for (int c = 0; c < S - 1; ++c) issue(c, c);
  for (int b = 0; b < nbins; ++b) {
    acc[b * TC].x = (T)0;
    acc[b * TC].y = (T)0;
  }
  const int chunks = (na + R - 1) / R;
  int si = S - 1;  // stage of the next chunk to copy
  int sc = 0;      // stage of the next chunk to sum
  for (int c = 0; c < chunks; ++c) {
    // stage si was summed one iteration ago, by this thread
    issue(c + S - 1, si);
    si = si + 1 == S ? 0 : si + 1;
    wait_group(S - 1);  // chunk c has landed
    // the chunk's R rows in one go (see the note at the top): bins, a
    // dropped cell or a slot past the last row to the spare bin
    int kk[R];
    T w[R];
    CT x[R], s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = (sc * R + r) * TC;
      const int i = c * R + r;
      x[r] = vring[e];
      if (HasConst) w[r] = cring[e];
      int b = kring[e];
      if (Wrap && b < 0) b += nbins;
      bool ok = i < na && b >= 0 && b < nbins;
      if (HasValid)
        ok = ok && ((mring[e] >> (((m0 + (unsigned)i * (unsigned)N) & 3u) *
                                  8u)) & 0xffu) != 0;
      kk[r] = ok ? b : nbins;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = acc[kk[r] * TC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < r; ++q)  // the latest earlier row of this bin
        if (kk[q] == kk[r]) s[r] = s[q];
      if (HasConst) {
        s[r].x += x[r].x * w[r];
        s[r].y += x[r].y * w[r];
      } else {
        s[r].x += x[r].x;
        s[r].y += x[r].y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[kk[r] * TC] = s[r];
    sc = sc + 1 == S ? 0 : sc + 1;
  }
  for (int b = 0; b < nbins; ++b) out[(size_t)b * N] = acc[b * TC];
}

template <typename T>
using Kernel = void (*)(const typename Cplx<T>::type*, const int32_t*,
                        const uint8_t*, const T*, int, int, int, int,
                        typename Cplx<T>::type*);

template <typename T>
__global__ void __launch_bounds__(kMaxColumns) scatter_kv_kernel(
    const typename Cplx<T>::type* __restrict__ wx,
    const int32_t* __restrict__ k, const uint8_t* __restrict__ unused,
    const T* __restrict__ cst, int na, int N, int nbins, int S,
    typename Cplx<T>::type* __restrict__ tx) {
  ring_scatter<T, false, false, true>(wx, k, unused, cst, na, N, nbins, S,
                                      tx);
}

template <typename T, bool HasValid, bool HasConst>
__global__ void __launch_bounds__(kMaxColumns) shift_scatter_kernel(
    const typename Cplx<T>::type* __restrict__ v,
    const int32_t* __restrict__ k, const uint8_t* __restrict__ valid,
    const T* __restrict__ cst, int na, int N, int nbins, int S,
    typename Cplx<T>::type* __restrict__ out) {
  ring_scatter<T, true, HasValid, HasConst>(v, k, valid, cst, na, N, nbins,
                                            S, out);
}

// kind 0: B2; 1-4: B5 with (valid, cst), valid only, cst only, neither
template <typename T>
Kernel<T> pick(int kind) {
  switch (kind) {
    case 0: return scatter_kv_kernel<T>;
    case 1: return shift_scatter_kernel<T, true, true>;
    case 2: return shift_scatter_kernel<T, true, false>;
    case 3: return shift_scatter_kernel<T, false, true>;
    default: return shift_scatter_kernel<T, false, false>;
  }
}

// The kernel of `kind` (0-4) for a block of tc columns and a ring of
// `stages`, with its shared bytes, or null when the plan is out of range.
// The kernel's shared-memory limit and carveout are set once per kernel
// and device (the first 32), not at every launch.
template <typename T>
Kernel<T> configure(int kind, int nbins, int tc, int stages, size_t* smem) {
  if (kind < 0 || kind > 4) return nullptr;
  *smem = smem_bytes<T>(nbins, tc, stages, kind == 1 || kind == 2,
                        kind <= 1 || kind == 3);
  if (nbins < 1 || tc < 1 || tc > kMaxColumns || stages < 2 ||
      stages > kMaxStages || *smem > (size_t)kMaxSmem)
    return nullptr;
  Kernel<T> fn = pick<T>(kind);
  static unsigned done[5];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(done[kind] >> dev & 1u)) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    if (dev < 32) done[kind] |= 1u << dev;
  }
  return fn;
}

template <typename T>
int launch(int kind, const void* v, const void* k, const void* valid,
           const void* cst, int B, int na, int N, int nbins, int tc,
           int stages, void* out, void* stream) {
  typedef typename Cplx<T>::type CT;
  size_t smem;
  Kernel<T> fn = configure<T>(kind, nbins, tc, stages, &smem);
  if (!fn) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + tc - 1) / tc, B);
  fn<<<grid, tc, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const CT*>(v), static_cast<const int32_t*>(k),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(cst), na, N,
      nbins, stages, static_cast<CT*>(out));
  return (int)cudaGetLastError();
}

int shift_kind(const void* valid, const void* cst) {
  return valid ? (cst ? 1 : 2) : (cst ? 3 : 4);
}

}  // namespace

// Each returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan out of range. `tc` columns per block, a ring of `stages`
// (ops/ssq_cuda.py::scatter_plan), B signals (B <= 65535).
extern "C" int scatter_kv_f32(const void* wx, const void* k, const void* cst,
                              int B, int na, int N, int nbins, int tc,
                              int stages, void* tx, void* stream) {
  return launch<float>(0, wx, k, nullptr, cst, B, na, N, nbins, tc, stages,
                       tx, stream);
}

extern "C" int scatter_kv_f64(const void* wx, const void* k, const void* cst,
                              int B, int na, int N, int nbins, int tc,
                              int stages, void* tx, void* stream) {
  return launch<double>(0, wx, k, nullptr, cst, B, na, N, nbins, tc, stages,
                        tx, stream);
}

// B5. valid (uint8) and cst may be null.
extern "C" int shift_scatter_f32(const void* v, const void* k,
                                 const void* valid, const void* cst, int B,
                                 int na, int N, int nbins, int tc, int stages,
                                 void* out, void* stream) {
  return launch<float>(shift_kind(valid, cst), v, k, valid, cst, B, na, N,
                       nbins, tc, stages, out, stream);
}

extern "C" int shift_scatter_f64(const void* v, const void* k,
                                 const void* valid, const void* cst, int B,
                                 int na, int N, int nbins, int tc, int stages,
                                 void* out, void* stream) {
  return launch<double>(shift_kind(valid, cst), v, k, valid, cst, B, na, N,
                        nbins, tc, stages, out, stream);
}

// For kind (0 B2, 1-4 B5 as shift_kind numbers them), f64 (nonzero for
// double), nbins, tc columns per block and a ring of `stages`: the block's
// shared bytes (into *smem, also where they do not fit) and the resident
// blocks per SM the runtime grants (into *blocks; 0 and
// cudaErrorInvalidValue where the block is out of range).
extern "C" int scatter_occupancy(int kind, int f64, int nbins, int tc,
                                 int stages, int* blocks, int* smem) {
  size_t bytes = 0;
  const void* fn;
  if (f64)
    fn = (const void*)configure<double>(kind, nbins, tc, stages, &bytes);
  else
    fn = (const void*)configure<float>(kind, nbins, tc, stages, &bytes);
  *smem = (int)bytes;
  *blocks = 0;
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, tc,
                                                            bytes);
}
