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
// (ops/ridge_cuda.py::ridge_forward_plain): P is computed with
// round-to-nearest intrinsics in the plain version's order (d = v_f - v_g;
// pen * (d * d); then pe + P; then e + min), so no FMA contraction can
// creep in; a P kept in registers holds the same rounded values. The min
// is exact and its order free (where -0 and +0 tie for it, its sign is
// as unspecified as in torch); a NaN among the candidates makes the min
// NaN, as torch.amin and jnp.min do (min.NaN.f32 for float, a flag for
// double). The argmin treats NaN as the least value, -0 and +0 as equal,
// and takes the first occurrence, as torch.argmin and jnp.argmin do.
//
// Bound. The function needs B (T - 1) F^2 min-plus pairs (an add and a
// min: 2 operations each; at T = 160000, F = 293 about 2.7e10, 0.41 ms at
// 67 TFLOP/s) and moves e in and pe out (2 B T F elements, 0.11 ms at
// 3.35 TB/s): operations bound it. The trace reads pe once (and e along
// the path): bytes bound it (0.06 ms at that shape). Neither bound is in
// reach: the T columns are sequential, so each column's latency (a
// barrier, a copy, a reduction) is paid T times.
//
// Forward design: one thread-block cluster of C = 8 CTAs per batch row
// (portable; 16 measured slower at (1, 160000, 293) on an H100, PERF.md
// §6: a column's chain is latency, not work, and 16 CTAs lengthen it).
// CTA c owns rows [c R, min(F, (c + 1) R)), R = ceil(F / C); each warp a
// row pair, its lanes 16-byte pieces of g. Where F <= 384 the pair's rows
// of P live in the warp's registers, computed once, and every lane takes
// three pieces (those past the row repeat its last: no branch); re-read
// from shared memory, the CTA's 37 x 296 slice at F = 293 would cost ~340
// cycles of bandwidth a column. Else P is recomputed per use (a
// compile-time mode). Each lane keeps four partial minima a row; one
// redux.sync on order-preserving integer keys gives the row's min (a vote
// the NaN; double: a shuffle tree). Column t goes by st.async into buffer
// t % 3 of every CTA of the cluster (distributed shared memory), counted
// by that buffer's mbarrier (complete-tx): one wait per column, no
// cluster barrier (st.shared::cluster and a cluster barrier per column,
// with two buffers, measured slower while this kernel was written). The
// three buffers make the data dependence the only guard: a
// CTA writes buffer t % 3 of a peer only after that peer's column t - 1,
// which came after its last read of the buffer. e comes three columns
// ahead by cp.async into a 4-slot ring of the warp's rows. Lanes below 16
// send, lanes 16-30 copy e in and pe out (a column late, from shared
// memory), thread 31 re-arms the mbarriers: no global access precedes a
// release in its thread. A cluster barrier after start-up and one at the
// end (after the last column has landed) guard the peers' memory; every
// CTA, one with no rows too, takes part.
//
// Trace design: one block of two warps per batch row. Warp 1 (one lane)
// is the producer: groups of G consecutive rows of pe and of e (up to 16
// rows, ~16 KB; contiguous in memory) in reverse time order, each by one
// cp.async.bulk of its 16-byte aligned superset (the few elements past
// the tensor's last whole 16 bytes by plain copies) into rings of 2-4
// slots, each slot with a full and an empty mbarrier. Warp 0 walks the
// chain, waiting and arriving once per group: each lane tests its f =
// lane + 32 j with the plain version's arithmetic, twelve at a time with
// their loads issued together and no branch among them (v_f in registers
// where F <= 384), __reduce_max_sync gives the last qualifying f, and
// only where none qualifies (rarely, along a ridge) does the warp take
// argmin_f pe[t] (its first NaN, else the first least value, by
// redux.sync). Nothing in the step loop is block-wide. At the largest F
// the resident plan takes, one row per slot, two slots of pe and one of e.
//
// The resident plan keeps whole rows of F in one block's shared memory:
// ops/ridge_cuda.py::ridge_resident takes it up to F = 11264 in float32
// and 5632 in float64. Past that (or when the plan asks for it) both
// kernels run row-tiled, with shared bytes that do not grow with F, so F
// is bounded by device memory alone:
//
// Tiled forward: one cooperative launch (every CTA resident at once, a
// grid barrier per column). A work item is (b, a tile of kTileRows rows
// f, a chunk of g): its CTA keeps its 2 rows per thread of min-plus
// accumulators in registers and streams the chunk's pe[t-1] and v
// through shared memory in tiles of kTileG. Items are B x ceil(F / 512) x
// S, S chunks of g chosen on the host so that the items fill the card
// (about 264 at B = 1); a CTA takes items i, i + grid, ... Each item
// writes its rows' partial minima over its chunk to part[t % 2][b][s], a
// scratch of 2 B S F elements; column t reads column t - 1 as pe[t-1, g]
// = e[t-1, g] + min_s part[(t-1) % 2][b][s][g] (the min is exact and its
// order free, so this is the plain version's value bit for bit, NaN by
// the same rule), and the items of the first row tile write that value
// to pe. Column 0 is e's, the last column is combined after the last
// barrier. Two parities: column t + 1 writes the buffer column t - 1
// wrote only after the barrier that follows every read of it. The
// partials are read through L2 (ld.global.cg), never a stale L1 line.
//
// Tiled trace: one block of kTraceThreads per batch row. Only one element
// of e and pe is needed per step beside pe[t] (val = pe[t+1, n] - e[t+1,
// n]: two scalar loads). The block scans pe[t] and v from global memory
// in tiles of kTraceThreads kScan elements from the high-f end, each
// thread testing kScan f with its loads issued together, one block-wide
// max per tile, and stops at the first tile that holds a qualifying f,
// which is the last one overall; only where none qualifies does it take
// the first-occurrence argmin over the whole row (three block-wide
// reductions: the first NaN, the least value, its first f).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
template <typename T> __device__ __forceinline__ T inf_t();
template <> __device__ __forceinline__ float inf_t<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_t<double>() { return CUDART_INF; }
template <typename T> __device__ __forceinline__ T nan_t();
template <> __device__ __forceinline__ float nan_t<float>() { return CUDART_NAN_F; }
template <> __device__ __forceinline__ double nan_t<double>() { return CUDART_NAN; }

constexpr unsigned kFull = 0xffffffffu;

// A running min with torch's NaN rule: float by min.NaN.f32, double by
// fmin and a flag (PTX has no min.NaN.f64). warp_min() gives every lane
// the warp's min: float by one redux.sync on order-preserving integers
// (NaN by a vote), double by a shuffle tree.
template <typename T> struct MinAcc;
template <> struct MinAcc<float> {
  float m;
  __device__ __forceinline__ MinAcc() : m(inf_t<float>()) {}
  __device__ __forceinline__ void add(float s) {
    asm("min.NaN.f32 %0, %0, %1;" : "+f"(m) : "f"(s));
  }
  __device__ __forceinline__ void merge(const MinAcc& o) { add(o.m); }
  __device__ __forceinline__ float value() const { return m; }
  __device__ __forceinline__ float warp_min() const {
    const int i = __float_as_int(m);
    const int k = __reduce_min_sync(kFull, i >= 0 ? i : i ^ 0x7fffffff);
    if (__any_sync(kFull, m != m)) return nan_t<float>();
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
  }
};
template <> struct MinAcc<double> {
  double m;
  bool nan;
  __device__ __forceinline__ MinAcc() : m(inf_t<double>()), nan(false) {}
  __device__ __forceinline__ void add(double s) {
    m = fmin(m, s);
    nan |= (s != s);
  }
  __device__ __forceinline__ void merge(const MinAcc& o) {
    m = fmin(m, o.m);
    nan |= o.nan;
  }
  __device__ __forceinline__ double value() const {
    return nan ? nan_t<double>() : m;
  }
  __device__ __forceinline__ double warp_min() const {
    double r = m;
    for (int o = 16; o > 0; o >>= 1)
      r = fmin(r, __shfl_xor_sync(kFull, r, o));
    return __any_sync(kFull, nan) ? nan_t<double>() : r;
  }
};

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

template <typename T>
__device__ __forceinline__ T penalty(T pen, T vf, T vg) {
  const T d = sub_rn(vf, vg);
  return mul_rn(pen, mul_rn(d, d));
}

// Rows padded to a multiple of 4: v with 0, pe rows with +inf and P with
// 0, whose candidates (+inf) never lower a min nor make it NaN.
__host__ __device__ __forceinline__ int pad4(int F) { return (F + 3) & ~3; }

constexpr int kERing = 4;  // columns of e in flight (forward)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Whether the phase of `parity` has completed, with acquire at cluster
// scope (kCluster: the forward's bytes come from peer CTAs) or CTA scope
// (the trace's, from its own bulk copies; no L1 invalidation).
template <bool kCluster>
__device__ __forceinline__ unsigned mbar_done(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  if (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  return done;
}
// Waits for the phase of `parity`. A wait past ~2^35 cycles (~20 s) can
// only be a broken protocol: trap, so that the launch fails instead of
// holding the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  long long t0 = 0;
  while (!mbar_done<kCluster>(bar, parity)) {
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 35))
      __trap();
  }
}

// Elements g0 .. g0 + n of src (a tensor of `total` elements) into a
// slot: the 16-byte aligned superset [a, a_end) by one bulk copy that
// completes on `bar`, the elements past the tensor's last whole 16 bytes
// by plain copies, then the arrival on `bar` expecting the copy's bytes.
// Element g lands at slot[g - a].
template <typename T>
__device__ __forceinline__ void load_span(const T* src, size_t g0, size_t n,
                                          size_t total, T* slot,
                                          uint64_t* bar) {
  constexpr int Q = 16 / sizeof(T);
  const size_t a = g0 / Q * Q;
  const size_t end = g0 + n;
  const size_t up = (end + Q - 1) / Q * Q, whole = total / Q * Q;
  const size_t a_end = up < whole ? up : whole;
  const size_t bulk_end = a_end > a ? a_end : a;
  for (size_t g = bulk_end; g < end; ++g) slot[g - a] = src[g];
  if (bulk_end < end)  // plain writes, ordered before later bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const unsigned bytes = (unsigned)((bulk_end - a) * sizeof(T));
  if (bytes == 0) {
    mbar_arrive(bar);
    return;
  }
  mbar_arrive_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(slot)),
      "l"(src + a), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The shared::cluster address of `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// A value into a peer's row buffer whose mbarrier counts its bytes.
__device__ __forceinline__ void st_async(unsigned addr, float x,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(x), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, double x,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "d"(x), "r"(bar)
      : "memory");
}

constexpr int kQuads = 3;  // P in registers: 16-byte pieces of g per lane

// The candidates of rows f0 and f1 over this lane's g (pieces g = 4 lane
// + 128 j), four partial minima per row: pe_prev[g] + P[f, g], P from the
// registers q0, q1 (kRegs) or recomputed from v.
template <typename T, bool kRegs>
__device__ __forceinline__ void row_pair(const T* prev, const T* sv,
                                         const Quad<T>* q0, const Quad<T>* q1,
                                         T vf0, T vf1, T pen, int Fp,
                                         int lane, MinAcc<T>& m0,
                                         MinAcc<T>& m1) {
  MinAcc<T> a0[4], a1[4];
  if (kRegs) {  // pieces past Fp repeat the last one: no branch
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const Quad<T> p = load4(prev + min(4 * lane + 128 * j, Fp - 4));
      a0[0].add(add_rn(p.a, q0[j].a)); a1[0].add(add_rn(p.a, q1[j].a));
      a0[1].add(add_rn(p.b, q0[j].b)); a1[1].add(add_rn(p.b, q1[j].b));
      a0[2].add(add_rn(p.c, q0[j].c)); a1[2].add(add_rn(p.c, q1[j].c));
      a0[3].add(add_rn(p.d, q0[j].d)); a1[3].add(add_rn(p.d, q1[j].d));
    }
  } else {
    for (int g = 4 * lane; g < Fp; g += 128) {
      const Quad<T> p = load4(prev + g);
      const Quad<T> w = load4(sv + g);
      a0[0].add(add_rn(p.a, penalty(pen, vf0, w.a)));
      a1[0].add(add_rn(p.a, penalty(pen, vf1, w.a)));
      a0[1].add(add_rn(p.b, penalty(pen, vf0, w.b)));
      a1[1].add(add_rn(p.b, penalty(pen, vf1, w.b)));
      a0[2].add(add_rn(p.c, penalty(pen, vf0, w.c)));
      a1[2].add(add_rn(p.c, penalty(pen, vf1, w.c)));
      a0[3].add(add_rn(p.d, penalty(pen, vf0, w.d)));
      a1[3].add(add_rn(p.d, penalty(pen, vf1, w.d)));
    }
  }
  a0[0].merge(a0[1]); a0[2].merge(a0[3]); a0[0].merge(a0[2]);
  a1[0].merge(a1[1]); a1[2].merge(a1[3]); a1[0].merge(a1[2]);
  m0 = a0[0];
  m1 = a1[0];
}

// Bytes of a ring slot holding n elements of itemsize isz from any
// offset: a 16-byte aligned superset.
__host__ __device__ __forceinline__ size_t span_slot(size_t n, int isz) {
  const size_t b = n * isz;
  return (b + 15) / 16 * 16 + 16;
}

// Shared memory of one forward CTA, in bytes: v, three pe rows, the e
// ring (kERing columns of the CTA's R rows), the three rows' mbarriers.
// ops/ridge_cuda.py::ridge_plan states the same layout; the launcher
// checks that they agree.
__host__ __device__ __forceinline__ size_t forward_smem_bytes(int F, int R,
                                                              int isz) {
  return ((size_t)4 * pad4(F) + (size_t)kERing * pad4(R)) * isz +
         3 * sizeof(uint64_t);
}

// kRegs: one row pair per warp, its P in registers (Fp <= 128 kQuads);
// else P recomputed per use.
template <typename T, bool kRegs>
__global__ void __launch_bounds__(kRegs ? 768 : 1024)
    ridge_forward_kernel(const T* __restrict__ e, const T* __restrict__ v,
                         T pen, int F, int Tn, int R, T* __restrict__ pe) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int f0 = min(F, c * R);
  const int nr = min(F, f0 + R) - f0;  // this CTA's rows (0 for a spare CTA)
  const int Fp = pad4(F), Rp = pad4(R);
  T* sv = reinterpret_cast<T*>(smem_raw);
  T* buf = sv + Fp;         // pe of column t at buf[(t % 3) Fp]
  T* ering = buf + 3 * Fp;  // e of column t at ering[(t % 4) Rp]
  uint64_t* full = reinterpret_cast<uint64_t*>(ering + kERing * Rp);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  // lanes 16-30 read e and write pe, thread 31 arms the mbarriers, lanes
  // below 16 send: no global access precedes a send or an arrive in its
  // thread, whose release would wait for it
  const int gl = lane - 16;
  const bool glob = gl >= 0 && gl < 15;
  const size_t base = (size_t)b * Tn * F;
  const T* eb = e + base;
  T* pb = pe + base;
  const unsigned rowb = (unsigned)(Fp * sizeof(T));

  for (int g = tid; g < Fp; g += nth) {
    sv[g] = g < F ? v[g] : T(0);
    buf[g] = buf[Fp + g] = buf[2 * Fp + g] = inf_t<T>();
  }
  // e of column col: the warp's rows warp + nw j into slot col % 4 of the
  // ring by cp.async, visible to the warp after the wait and a __syncwarp
  auto fetch = [&](int col) {
    if (col < Tn && glob)
      for (int i = warp + nw * gl; i < nr; i += 15 * nw)
        cp_async(ering + (col % kERing) * Rp + i,
                 eb + (size_t)col * F + f0 + i, (int)sizeof(T));
    cp_async_commit();
  };
  for (int col = 1; col < kERing; ++col) fetch(col);
  // column t's bytes from every CTA land in buffer t % 3 and count on its
  // mbarrier
  if (tid == 31) {
    for (int k = 0; k < 3; ++k) mbar_init(full + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < 3; ++k)  // columns 0, 1, 2
      mbar_arrive_tx(full + k, (unsigned)(F * sizeof(T)));
  }
  __syncthreads();
  // the warp's row pair: i0 = warp, i1 = warp + nw (kRegs: the only one)
  Quad<T> q0[kRegs ? kQuads : 1], q1[kRegs ? kQuads : 1];
  if (kRegs && warp < nr) {
    const T v0 = sv[f0 + warp], v1 = sv[f0 + min(warp + nw, nr - 1)];
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {  // row_pair's pieces of g
      const int g = min(4 * lane + 128 * j, Fp - 4);
      T* a0 = &q0[j].a;
      T* a1 = &q1[j].a;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool in = g + x < F;
        a0[x] = in ? penalty(pen, v0, sv[g + x]) : T(0);
        a1[x] = in ? penalty(pen, v1, sv[g + x]) : T(0);
      }
    }
  }
  // lane < C sends the warp's rows to CTA `lane`
  const unsigned peer = lane < C ? (unsigned)lane : 0u;
  const unsigned rbuf = mapa(smem_u32(buf), peer);
  const unsigned rbar = mapa(smem_u32(full), peer);
  auto send = [&](T x, int f, int t) {
    const int s = t % 3;
    if (lane < C)
      st_async(rbuf + s * rowb + (unsigned)(f * sizeof(T)), x,
               rbar + s * (unsigned)sizeof(uint64_t));
  };
  // this CTA's rows of column t to pe, coalesced
  auto store = [&](int t) {
    if (glob)
      for (int i = warp * 15 + gl; i < nr; i += 15 * nw)
        pb[(size_t)t * F + f0 + i] = buf[(t % 3) * Fp + f0 + i];
  };
  cluster.sync();  // every CTA started, its buffers and mbarriers ready

  for (int i = warp; i < nr; i += nw) send(eb[f0 + i], f0 + i, 0);
  for (int t = 1; t < Tn; ++t) {
    const int sp = (t - 1) % 3;
    mbar_wait<true>(full + sp, (unsigned)(((t - 1) / 3) & 1));
    cp_async_wait<kERing - 2>();  // column t of e, this lane's copies
    __syncwarp();
    const T* prev = buf + sp * Fp;
    const T* et = ering + (t % kERing) * Rp;
    for (int i0 = warp; i0 < nr; i0 += 2 * nw) {
      const bool two = i0 + nw < nr;
      const int i1 = two ? i0 + nw : i0;
      MinAcc<T> a0, a1;
      row_pair<T, kRegs>(prev, sv, q0, q1, sv[f0 + i0], sv[f0 + i1], pen,
                         Fp, lane, a0, a1);
      const T x0 = add_rn(et[i0], a0.warp_min());
      const T x1 = add_rn(et[i1], a1.warp_min());
      send(x0, f0 + i0, t);
      if (two) send(x1, f0 + i1, t);
    }
    // off the chain: the buffer's next column (t + 2), column t - 1 to
    // pe, column t + 3 of e into the slot of column t - 1 (whose reads
    // the warp finished: their values went into its last sends)
    if (tid == 31 && t + 2 < Tn)
      mbar_arrive_tx(full + sp, (unsigned)(F * sizeof(T)));
    store(t - 1);
    fetch(t + kERing - 1);
  }
  // the last column's bytes from every peer have landed here, then its
  // rows to pe; no CTA leaves while a peer may still write to it
  mbar_wait<true>(full + (Tn - 1) % 3, (unsigned)(((Tn - 1) / 3) & 1));
  store(Tn - 1);
  cluster.sync();
}

// argmin_f row[f] over the warp, every lane gets it: the first NaN if any
// (NaN is the least value, as torch.argmin and jnp.argmin take it), else
// the first f of the least value (-0 and +0 equal). Each lane keeps its
// first least element; two redux.sync on order-preserving integer keys
// give the least value and the first f that holds it.
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return x == 0.f ? 0 : (i >= 0 ? i : i ^ 0x7fffffff);
}
template <typename T>
__device__ __forceinline__ int warp_argmin(const T* row, int F, int lane) {
  constexpr int kNone = 0x7fffffff;
  T best = inf_t<T>();
  int ib = kNone, inan = kNone;
  for (int f = lane; f < F; f += 32) {
    const T x = row[f];
    if (x != x)
      inan = min(inan, f);
    else if (ib == kNone || x < best) {
      best = x;
      ib = f;
    }
  }
  inan = __reduce_min_sync(kFull, inan);
  if (inan != kNone) return inan;
  bool least;
  if (sizeof(T) == 4) {
    const int key = order_key((float)best);
    least = __reduce_min_sync(kFull, key) == key;
  } else {  // double: the least value by a shuffle tree
    T m = best;
    for (int o = 16; o > 0; o >>= 1)
      m = fmin(m, __shfl_xor_sync(kFull, m, o));
    least = best == m;
  }
  return __reduce_min_sync(kFull, least ? ib : kNone);
}

// Shared memory of one trace block, in bytes: the pe ring (dp slots), the
// e ring (de slots), each slot G rows (a 16-byte aligned superset), v,
// then per slot two mbarriers (full, empty).
__host__ __device__ __forceinline__ size_t trace_smem_bytes(int F, int isz,
                                                            int G, int dp,
                                                            int de) {
  const size_t vb = ((size_t)F * isz + 15) / 16 * 16;
  return (size_t)(dp + de) * span_slot((size_t)G * F, isz) + vb +
         (size_t)16 * (dp + de);
}

// A ring position: slot and the parity of its current use.
struct Ring {
  int slot, n;
  unsigned parity;
  __device__ __forceinline__ Ring(int n_) : slot(0), n(n_), parity(0) {}
  __device__ __forceinline__ void next() {
    if (++slot == n) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// The walker's scan: the last f with |val - (row[f] + P[n, f])| < eps,
// -1 if none. kScan f per lane at a time, their loads issued together and
// no branch among them (no short-circuit test), so that their latencies
// overlap (one f at a time, the chain of a load and seven dependent
// operations is paid per f).
// kRegV (F <= 32 kScan): the lane's v_f, clamped offsets and valid bits
// in registers, set once.
constexpr int kScan = 12;
template <typename T, bool kRegV>
struct Scan {
  T vr[kRegV ? kScan : 1];
  int off[kRegV ? kScan : 1];
  unsigned valid = 0;
  __device__ __forceinline__ Scan(const T* sv, int F, int lane) {
    if (kRegV)
#pragma unroll
      for (int j = 0; j < kScan; ++j) {
        const int f = lane + 32 * j;
        off[j] = min(f, F - 1);
        vr[j] = sv[off[j]];
        valid |= (f < F ? 1u : 0u) << j;
      }
  }
  __device__ __forceinline__ int find(const T* row, const T* sv, T vn, T val,
                                      T pen, T eps, int F, int lane) const {
    int last = -1;
    if (kRegV) {
      T r[kScan];
#pragma unroll
      for (int j = 0; j < kScan; ++j) r[j] = row[off[j]];
#pragma unroll
      for (int j = 0; j < kScan; ++j) {
        const T s = add_rn(r[j], penalty(pen, vn, vr[j]));
        const bool ok = (abs_t(sub_rn(val, s)) < eps) & bool(valid >> j & 1u);
        last = ok ? lane + 32 * j : last;
      }
    } else {
      for (int f = lane; f < F; f += 32 * kScan) {
        T r[kScan], w[kScan];
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          const int g = min(f + 32 * j, F - 1);
          r[j] = row[g];
          w[j] = sv[g];
        }
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          const T s = add_rn(r[j], penalty(pen, vn, w[j]));
          const bool ok = (abs_t(sub_rn(val, s)) < eps) & (f + 32 * j < F);
          last = ok ? f + 32 * j : last;
        }
      }
    }
    return __reduce_max_sync(kFull, last);
  }
};

// Rows are taken in groups of G consecutive rows (contiguous in memory:
// one bulk copy and one wait per group and tensor), group q holding rows
// [max(0, T - (q + 1) G), T - q G).
template <typename T, bool kRegV>
__global__ void __launch_bounds__(64)
    ridge_trace_kernel(const T* __restrict__ pe, const T* __restrict__ e,
                       const T* __restrict__ v, T pen, T eps, int F, int Tn,
                       int G, int dp, int de, int* __restrict__ ridge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t slot = span_slot((size_t)G * F, sizeof(T));
  unsigned char* ring_p = smem_raw;
  unsigned char* ring_e = ring_p + dp * slot;
  T* sv = reinterpret_cast<T*>(ring_e + de * slot);
  uint64_t* full_p = reinterpret_cast<uint64_t*>(
      smem_raw + trace_smem_bytes(F, sizeof(T), G, dp, de) -
      (size_t)16 * (dp + de));
  uint64_t* empty_p = full_p + dp;
  uint64_t* full_e = empty_p + dp;
  uint64_t* empty_e = full_e + de;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t total = (size_t)gridDim.x * Tn * F;
  const size_t row0 = (size_t)blockIdx.x * Tn;
  const int nq = (Tn + G - 1) / G;
  constexpr int Q = 16 / sizeof(T);

  for (int f = threadIdx.x; f < F; f += blockDim.x) sv[f] = v[f];
  if (threadIdx.x == 32) {
    for (int s = 0; s < dp; ++s) {
      mbar_init(full_p + s, 1);
      mbar_init(empty_p + s, 1);
    }
    for (int s = 0; s < de; ++s) {
      mbar_init(full_e + s, 1);
      mbar_init(empty_e + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // the producer: groups of rows, T-1 .. 0, into the rings
    if (lane == 0) {
      Ring rp(dp), re(de);
      for (int q = 0; q < nq; ++q) {
        const int lo = max(0, Tn - (q + 1) * G), hi = Tn - q * G;
        const size_t g0 = (row0 + lo) * F, n = (size_t)(hi - lo) * F;
        if (q >= dp) mbar_wait(empty_p + rp.slot, rp.parity ^ 1u);
        load_span(pe, g0, n, total,
                  reinterpret_cast<T*>(ring_p + rp.slot * slot),
                  full_p + rp.slot);
        if (q >= de) mbar_wait(empty_e + re.slot, re.parity ^ 1u);
        load_span(e, g0, n, total,
                  reinterpret_cast<T*>(ring_e + re.slot * slot),
                  full_e + re.slot);
        rp.next();
        re.next();
      }
    }
    return;
  }

  // the walker
  const Scan<T, kRegV> scan(sv, F, lane);
  int* rb = ridge + row0;
  int mine = 0;  // r[t] for t = 32 q + lane, stored when t reaches 32 q
  T val = T(0), vn = T(0);
  Ring rp(dp), re(de);
  for (int q = 0; q < nq; ++q) {
    const int lo = max(0, Tn - (q + 1) * G), hi = Tn - q * G;
    const size_t g0 = (row0 + lo) * F, off = g0 - g0 / Q * Q;
    // row t at gp + (t - lo) F, and of e at ge + (t - lo) F
    const T* gp = reinterpret_cast<const T*>(ring_p + rp.slot * slot) + off;
    const T* ge = reinterpret_cast<const T*>(ring_e + re.slot * slot) + off;
    mbar_wait(full_p + rp.slot, rp.parity);
    for (int t = hi - 1; t >= lo; --t) {
      const T* row = gp + (size_t)(t - lo) * F;
      int last = t == Tn - 1
                     ? -1
                     : scan.find(row, sv, vn, val, pen, eps, F, lane);
      if (last < 0) last = warp_argmin(row, F, lane);  // nothing qualifies
      if (t == hi - 1)  // e of the group (one slot: copied meanwhile)
        mbar_wait(full_e + re.slot, re.parity);
      val = sub_rn(row[last], ge[(size_t)(t - lo) * F + last]);
      vn = sv[last];
      if ((t & 31) == lane) mine = last;
      if ((t & 31) == 0 && t + lane < Tn) rb[t + lane] = mine;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_p + rp.slot);
      mbar_arrive(empty_e + re.slot);
    }
    rp.next();
    re.next();
  }
}


// ---- the row-tiled mode (F past the resident plan) ----------------------
constexpr int kTileThreads = 256;            // forward CTA
constexpr int kTileRows = 2 * kTileThreads;  // rows f per work item
constexpr int kTileG = 1024;                 // g per shared-memory tile
constexpr int kTraceThreads = 512;           // trace block
constexpr int kTraceWarps = kTraceThreads / 32;

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

// Shared memory of one tiled forward CTA, in bytes: a tile of pe[t-1]
// and of v (ops/ridge_cuda.py::ridge_plan states the same).
__host__ __device__ __forceinline__ size_t tiled_smem_bytes(int isz) {
  return (size_t)2 * kTileG * isz;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    ridge_forward_tiled_kernel(const T* __restrict__ e,
                               const T* __restrict__ v, T pen, int B, int F,
                               int Tn, int S, int chunk, T* part,
                               T* __restrict__ pe) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sp = reinterpret_cast<T*>(smem_raw);  // pe[t-1] of the tile
  T* sv = sp + kTileG;                     // v of the tile
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nf = (F + kTileRows - 1) / kTileRows;
  const long long items = (long long)B * nf * S;
  const size_t plane = (size_t)B * S * F;  // one parity of part
  const size_t nth = (size_t)gridDim.x * blockDim.x;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + tid;

  for (size_t i = gtid; i < (size_t)B * F; i += nth) {  // column 0
    const size_t o = i / F * Tn * F + i % F;
    pe[o] = e[o];
  }
  for (int t = 1; t < Tn; ++t) {
    const T* pin = part + (size_t)((t - 1) & 1) * plane;
    T* pout = part + (size_t)(t & 1) * plane;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int s = (int)(it % S);
      const long long r = it / S;
      const int i = (int)(r % nf), b = (int)(r / nf);
      const int g0 = s * chunk, g1 = min(F, g0 + chunk);
      const size_t col = ((size_t)b * Tn + (t - 1)) * F;  // column t - 1
      const T* pb = pin + (size_t)b * S * F;
      const int fa = i * kTileRows + tid, fb = fa + kTileThreads;
      const T va = v[min(fa, F - 1)], vb = v[min(fb, F - 1)];
      MinAcc<T> a[4], c[4];
      for (int gt = g0; gt < g1; gt += kTileG) {
        const int n = min(kTileG, g1 - gt);
        __syncthreads();  // the previous tile's reads are done
        for (int j = tid; j < kTileG; j += kTileThreads) {
          T x = inf_t<T>(), w = T(0);  // past the chunk: +inf, v 0
          if (j < n) {
            const int g = gt + j;
            if (t == 1) {
              x = e[col + g];
            } else {
              MinAcc<T> m;
              for (int q = 0; q < S; ++q) m.add(ldcg(pb + (size_t)q * F + g));
              x = add_rn(e[col + g], m.value());
              if (i == 0) pe[col + g] = x;
            }
            w = v[g];
          }
          sp[j] = x;
          sv[j] = w;
        }
        __syncthreads();
#pragma unroll 2
        for (int j = 0; j < n; j += 4) {
          const Quad<T> p = load4(sp + j);
          const Quad<T> w = load4(sv + j);
          a[0].add(add_rn(p.a, penalty(pen, va, w.a)));
          c[0].add(add_rn(p.a, penalty(pen, vb, w.a)));
          a[1].add(add_rn(p.b, penalty(pen, va, w.b)));
          c[1].add(add_rn(p.b, penalty(pen, vb, w.b)));
          a[2].add(add_rn(p.c, penalty(pen, va, w.c)));
          c[2].add(add_rn(p.c, penalty(pen, vb, w.c)));
          a[3].add(add_rn(p.d, penalty(pen, va, w.d)));
          c[3].add(add_rn(p.d, penalty(pen, vb, w.d)));
        }
      }
      a[0].merge(a[1]); a[2].merge(a[3]); a[0].merge(a[2]);
      c[0].merge(c[1]); c[2].merge(c[3]); c[0].merge(c[2]);
      T* po = pout + ((size_t)b * S + s) * F;
      if (fa < F) po[fa] = a[0].value();
      if (fb < F) po[fb] = c[0].value();
    }
    grid.sync();
  }
  if (Tn > 1) {  // the last column from its partial minima
    const T* pin = part + (size_t)((Tn - 1) & 1) * plane;
    for (size_t i = gtid; i < (size_t)B * F; i += nth) {
      const size_t b = i / F, g = i % F;
      MinAcc<T> m;
      for (int q = 0; q < S; ++q) m.add(ldcg(pin + (b * S + q) * F + g));
      const size_t o = (b * Tn + (Tn - 1)) * F + g;
      pe[o] = add_rn(e[o], m.value());
    }
  }
}

// Block-wide reductions of the tiled trace, every thread gets the result.
// Two buffers used in turns: between two writes of one buffer lies a
// barrier that every thread passes only after reading the first.
struct BlockReduce {
  int* ibuf;     // [2][kTraceWarps]
  void* vbuf;    // [2][kTraceWarps] of T
  int ph;
  template <bool kMax>
  __device__ __forceinline__ int ints(int x) {
    x = kMax ? __reduce_max_sync(kFull, x) : __reduce_min_sync(kFull, x);
    int* buf = ibuf + ph * kTraceWarps;
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = x;
    __syncthreads();
    int r = buf[0];
    for (int w = 1; w < kTraceWarps; ++w)
      r = kMax ? max(r, buf[w]) : min(r, buf[w]);
    ph ^= 1;
    return r;
  }
  template <typename T>
  __device__ __forceinline__ T least(T x) {  // NaN-free inputs
    for (int o = 16; o > 0; o >>= 1) x = fmin(x, __shfl_xor_sync(kFull, x, o));
    T* buf = reinterpret_cast<T*>(vbuf) + ph * kTraceWarps;
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = x;
    __syncthreads();
    T r = buf[0];
    for (int w = 1; w < kTraceWarps; ++w) r = fmin(r, buf[w]);
    ph ^= 1;
    return r;
  }
};

// argmin_f row[f] over the block: the first NaN if any, else the first f
// of the least value (-0 and +0 equal), as warp_argmin.
template <typename T>
__device__ __forceinline__ int block_argmin(const T* row, int F,
                                            BlockReduce& red) {
  constexpr int kNone = 0x7fffffff;
  T best = inf_t<T>();
  int ib = kNone, inan = kNone;
  for (int f = threadIdx.x; f < F; f += kTraceThreads) {
    const T x = row[f];
    if (x != x)
      inan = min(inan, f);
    else if (ib == kNone || x < best) {
      best = x;
      ib = f;
    }
  }
  inan = red.ints<false>(inan);
  if (inan != kNone) return inan;
  const T m = red.least(best);
  return red.ints<false>(ib != kNone && best == m ? ib : kNone);
}

template <typename T>
__global__ void __launch_bounds__(kTraceThreads)
    ridge_trace_tiled_kernel(const T* __restrict__ pe,
                             const T* __restrict__ e,
                             const T* __restrict__ v, T pen, T eps, int F,
                             int Tn, int* __restrict__ ridge) {
  __shared__ int ibuf[2 * kTraceWarps];
  __shared__ T vbuf[2 * kTraceWarps];
  BlockReduce red{ibuf, vbuf, 0};
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * Tn;
  int* rb = ridge + row0;
  constexpr int W = kTraceThreads * kScan;  // f per tile
  int r = block_argmin(pe + (row0 + Tn - 1) * F, F, red);
  if (tid == 0) rb[Tn - 1] = r;
  for (int t = Tn - 2; t >= 0; --t) {
    const size_t nxt = (row0 + t + 1) * F + r;
    const T val = sub_rn(pe[nxt], e[nxt]), vn = v[r];
    const T* row = pe + (row0 + t) * F;
    int last = -1;
    for (int hi = F; hi > 0 && last < 0; hi -= W) {
      const int lo = max(0, hi - W);
      T x[kScan], w[kScan];
#pragma unroll
      for (int j = 0; j < kScan; ++j) {
        const int f = min(lo + tid + kTraceThreads * j, hi - 1);
        x[j] = row[f];
        w[j] = v[f];
      }
      int mine = -1;
#pragma unroll
      for (int j = 0; j < kScan; ++j) {
        const int f = lo + tid + kTraceThreads * j;
        const T s = add_rn(x[j], penalty(pen, vn, w[j]));
        const bool ok = (abs_t(sub_rn(val, s)) < eps) & (f < hi);
        mine = ok ? f : mine;
      }
      last = red.ints<true>(mine);
    }
    if (last < 0) last = block_argmin(row, F, red);  // nothing qualifies
    r = last;
    if (tid == 0) rb[t] = r;
  }
}

// Launcher errors of the plan (the wrapper names them).
constexpr int kErrLayout = -2;     // the plan's shared bytes disagree
constexpr int kErrNoCluster = -3;  // no cluster of C CTAs fits the card

template <typename T, bool kRegs>
int forward_config(int B, int C, int warps, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto fn = ridge_forward_kernel<T, kRegs>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * C));
  cfg->blockDim = dim3((unsigned)(32 * warps));
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <typename T, bool kRegs>
int cluster_occupancy(int C, int warps, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = forward_config<T, kRegs>(1, C, warps, smem, 0, &cfg, attr);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, ridge_forward_kernel<T, kRegs>, &cfg);
}

template <typename T, bool kRegs>
int launch_forward(const T* e, const T* v, T pen, int B, int F, int Tn,
                   int C, int R, int warps, int smem, T* pe,
                   cudaStream_t stream) {
  if ((size_t)smem != forward_smem_bytes(F, R, sizeof(T)))
    return kErrLayout;
  int clusters = 0;
  int err = cluster_occupancy<T, kRegs>(C, warps, smem, &clusters);
  if (err) return err;
  if (clusters < 1) return kErrNoCluster;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = forward_config<T, kRegs>(B, C, warps, smem, stream, &cfg, attr);
  if (err) return err;
  err = (int)cudaLaunchKernelEx(&cfg, ridge_forward_kernel<T, kRegs>, e,
                                v, pen, F, Tn, R, pe);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* e, const void* v, double pen, int B, int F, int Tn,
            int C, int R, int resident, int warps, int smem, void* pe,
            void* stream) {
  if (B < 1 || F < 1 || Tn < 1 || C < 1 || C > 16 || R < 1 ||
      (long long)C * R < F || warps < 1 || warps > (resident ? 24 : 32) ||
      (resident && (pad4(F) > 128 * kQuads || 2 * warps < R)))
    return (int)cudaErrorInvalidValue;
  return resident
             ? launch_forward<T, true>((const T*)e, (const T*)v, (T)pen, B,
                                       F, Tn, C, R, warps, smem, (T*)pe,
                                       (cudaStream_t)stream)
             : launch_forward<T, false>((const T*)e, (const T*)v, (T)pen, B,
                                        F, Tn, C, R, warps, smem, (T*)pe,
                                        (cudaStream_t)stream);
}

template <typename T>
int trace(const void* pe, const void* e, const void* v, double pen,
          double eps, int B, int F, int Tn, int G, int dp, int de, int smem,
          void* ridge, void* stream) {
  if (B < 1 || F < 1 || Tn < 1 || G < 1 || dp < 2 || de < 1 ||
      ((uintptr_t)pe | (uintptr_t)e) % 16)
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != trace_smem_bytes(F, sizeof(T), G, dp, de))
    return kErrLayout;
  auto fn = F <= 32 * kScan ? ridge_trace_kernel<T, true>
                            : ridge_trace_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, 64, smem, (cudaStream_t)stream>>>((const T*)pe, (const T*)e,
                                            (const T*)v, (T)pen, (T)eps, F,
                                            Tn, G, dp, de, (int*)ridge);
  return (int)cudaGetLastError();
}

// Co-resident CTAs of the tiled forward on this card (its grid's most).
template <typename T>
int tiled_ctas(int* ctas) {
  auto fn = ridge_forward_tiled_kernel<T>;
  const int smem = (int)tiled_smem_bytes(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kTileThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  *ctas = per * sms;
  return 0;
}

template <typename T>
int forward_tiled(const void* e, const void* v, double pen, int B, int F,
                  int Tn, int S, int chunk, void* part, void* pe,
                  void* stream) {
  if (B < 1 || F < 1 || Tn < 1 || S < 1 || chunk < 1 ||
      (long long)S * chunk < F || (long long)(S - 1) * chunk >= F)
    return (int)cudaErrorInvalidValue;
  int ctas = 0;
  int err = tiled_ctas<T>(&ctas);
  if (err) return err;
  if (ctas < 1) return kErrNoCluster;
  const long long items =
      (long long)B * ((F + kTileRows - 1) / kTileRows) * S;
  const unsigned grid = (unsigned)(items < ctas ? items : ctas);
  const T* ep = (const T*)e;
  const T* vp = (const T*)v;
  T pn = (T)pen;
  T* qp = (T*)part;
  T* op = (T*)pe;
  void* args[] = {(void*)&ep, (void*)&vp, (void*)&pn, (void*)&B, (void*)&F,
                  (void*)&Tn, (void*)&S, (void*)&chunk, (void*)&qp,
                  (void*)&op};
  err = (int)cudaLaunchCooperativeKernel(
      (const void*)ridge_forward_tiled_kernel<T>, dim3(grid),
      dim3(kTileThreads), args, tiled_smem_bytes(sizeof(T)),
      (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T>
int trace_tiled(const void* pe, const void* e, const void* v, double pen,
                double eps, int B, int F, int Tn, void* ridge, void* stream) {
  if (B < 1 || F < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  ridge_trace_tiled_kernel<T><<<B, kTraceThreads, 0, (cudaStream_t)stream>>>(
      (const T*)pe, (const T*)e, (const T*)v, (T)pen, (T)eps, F, Tn,
      (int*)ridge);
  return (int)cudaGetLastError();
}

}  // namespace

// pe (B, T, F) from e (B, T, F) and v (F,); pen is rounded to the type.
// The launch plan (C, R, resident: P in registers, warps, smem) is
// ridge_plan's.
extern "C" int ridge_forward_f32(const void* e, const void* v, double pen,
                                 int B, int F, int Tn, int C, int R,
                                 int resident, int warps, int smem, void* pe,
                                 void* stream) {
  return forward<float>(e, v, pen, B, F, Tn, C, R, resident, warps, smem, pe,
                        stream);
}

extern "C" int ridge_forward_f64(const void* e, const void* v, double pen,
                                 int B, int F, int Tn, int C, int R,
                                 int resident, int warps, int smem, void* pe,
                                 void* stream) {
  return forward<double>(e, v, pen, B, F, Tn, C, R, resident, warps, smem,
                         pe, stream);
}

// How many clusters of the forward at this plan the card runs at once
// (cudaOccupancyMaxActiveClusters); itemsize 4 or 8.
extern "C" int ridge_forward_clusters(int itemsize, int C, int resident,
                                      int warps, int smem, int* clusters) {
  if (itemsize == 4)
    return resident ? cluster_occupancy<float, true>(C, warps, smem, clusters)
                    : cluster_occupancy<float, false>(C, warps, smem,
                                                      clusters);
  return resident ? cluster_occupancy<double, true>(C, warps, smem, clusters)
                  : cluster_occupancy<double, false>(C, warps, smem,
                                                     clusters);
}

// ridge (B, T) int32 from pe and e (B, T, F), 16-byte aligned, and v (F,);
// the rings (groups of G rows, dp and de slots, smem in all) are
// ridge_plan's.
extern "C" int ridge_trace_f32(const void* pe, const void* e, const void* v,
                               double pen, double eps, int B, int F, int Tn,
                               int G, int dp, int de, int smem, void* ridge,
                               void* stream) {
  return trace<float>(pe, e, v, pen, eps, B, F, Tn, G, dp, de, smem, ridge,
                      stream);
}

extern "C" int ridge_trace_f64(const void* pe, const void* e, const void* v,
                               double pen, double eps, int B, int F, int Tn,
                               int G, int dp, int de, int smem, void* ridge,
                               void* stream) {
  return trace<double>(pe, e, v, pen, eps, B, F, Tn, G, dp, de, smem, ridge,
                       stream);
}

// The row-tiled mode (ridge_plan's `tiled`): pe (B, T, F) from e and v,
// S chunks of `chunk` g, `part` a scratch of 2 B S F elements.
extern "C" int ridge_forward_tiled_f32(const void* e, const void* v,
                                       double pen, int B, int F, int Tn,
                                       int S, int chunk, void* part, void* pe,
                                       void* stream) {
  return forward_tiled<float>(e, v, pen, B, F, Tn, S, chunk, part, pe,
                              stream);
}

extern "C" int ridge_forward_tiled_f64(const void* e, const void* v,
                                       double pen, int B, int F, int Tn,
                                       int S, int chunk, void* part, void* pe,
                                       void* stream) {
  return forward_tiled<double>(e, v, pen, B, F, Tn, S, chunk, part, pe,
                               stream);
}

// How many CTAs of the tiled forward the card holds at once (its grid's
// largest size); itemsize 4 or 8.
extern "C" int ridge_forward_tiled_ctas(int itemsize, int* ctas) {
  return itemsize == 4 ? tiled_ctas<float>(ctas) : tiled_ctas<double>(ctas);
}

// ridge (B, T) int32 from pe and e (B, T, F) and v (F,), row-tiled.
extern "C" int ridge_trace_tiled_f32(const void* pe, const void* e,
                                     const void* v, double pen, double eps,
                                     int B, int F, int Tn, void* ridge,
                                     void* stream) {
  return trace_tiled<float>(pe, e, v, pen, eps, B, F, Tn, ridge, stream);
}

extern "C" int ridge_trace_tiled_f64(const void* pe, const void* e,
                                     const void* v, double pen, double eps,
                                     int B, int F, int Tn, void* ridge,
                                     void* stream) {
  return trace_tiled<double>(pe, e, v, pen, eps, B, F, Tn, ridge, stream);
}
