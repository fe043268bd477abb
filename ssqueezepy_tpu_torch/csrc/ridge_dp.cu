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
// Tiled forward: one cooperative launch (every CTA resident at once, one
// grid barrier per column). A work item is (b, a tile i of kTile = 64
// rows f); its CTA (8 warps) owns the tile's rows, writes each of their
// pe once and, with it, the tile's summary (the least pe of the column
// over the tile and v at its first least row) into summ[t % 2], a
// scratch of 2 B ceil(F / 64) x 2 elements; column 0 also writes each
// tile's v range [vlo, vhi]. The g axis is cut into the same tiles. Per
// column, a CTA reads the summaries of column t - 1 (through L2,
// ld.global.cg: they and pe[t-1] were written in this launch) and takes
// the column's least, m* at g* (torch.argmin's first occurrence), then
// bounds each of its rows from above by two real candidates, each with
// the plain version's arithmetic, UB_f = min(pe[t-1, f] + P(f, f), m* +
// P(f, g*)), and the tile from below: for a tile j of g with least m_j,
// LB_ij = m_j + pen (D_ij D_ij), D_ij the distance of the two tiles' v
// ranges (0 where they overlap), rounded. A CTA skips tile j iff LB_ij >
// max_f UB_f over its rows; its warps take the kept tiles (warp w the
// tiles j = w + 8 lane + 256 k, a ballot per k), each kept tile's
// pe[t-1] and v through the warp's two shared buffers, the next tile's
// loads in flight while the warp evaluates the current one (the tile of
// the CTA's own rows, nearly always kept, is fetched before the
// reduction), every pair by the plain arithmetic (2 rows a lane, 4
// partial minima a row); then warp 0 takes the 8 warps' partial minima,
// adds e and stores.
//
// Why the skip is exact. The bound is tried only where pen is finite and
// >= 0, every v is finite and the square of v's spread is finite (a flag
// the launch computes from the v ranges; else every pair is evaluated):
// then no P is NaN, and rounded sub, mul and add are monotone, so for f
// in tile i and g in tile j, |fl(v_f - v_g)| >= D_ij, P(f, g) >= pen (D_ij
// D_ij) and pe[t-1, g] + P(f, g) >= LB_ij. A skipped tile's candidates
// are all > UB_f >= the least candidate of the tile that holds UB_f's
// candidate, which is kept (its LB is at most that candidate), so the
// min, exact and order-free, is the plain loop's bit for bit. NaN: a NaN
// in pe[t-1] makes m_j and m* NaN, so UB and LB are NaN, the comparison
// false and nothing is skipped; -inf in a tile makes its LB -inf or NaN,
// never skipped. The flags keep subnormal results (no --use_fast_math,
// no -ftz). Tiles past F (the last tile's rows and g) are masked.
//
// Bound of the tiled forward: the all-pairs bound above; the work this
// kernel does on an input (its kept pairs, 2 operations each, and its
// tile tests, 8 each, or the bytes of e and pe) is what the torch
// replica tests/torch_ridge_tiled.py::ridge_forward_pairs counts; its
// floor per column is one grid barrier, a read of the summaries through
// L2 and a block-wide reduction, one kept tile per warp and the stores.
//
// Tiled trace: two launches. A prologue (one block per (b, t), all in
// parallel) writes each step's record: the least of pe[t] over each
// trace tile of G f (G = 256 up to F = 131072, more past it so that
// there are at most 512 tiles), pe[t, fw] - e[t, fw], v[fw] and fw, the
// first-occurrence argmin of pe[t] (the first NaN, else the first least
// value), which does not depend on the walk; block 0 writes the tiles' v
// ranges. The walk, one warp per batch row, takes the records from T - 1
// down by bulk copies (cp.async.bulk, complete-tx on a full mbarrier per
// slot) into a ring of 8 slots, so a step's tile minima are in shared
// memory when it starts. With n = r[t+1], val = pe[t+1, n] - e[t+1, n]
// and v[n] carried from the step before (the lane that found n computed
// them), a tile can hold a qualifying f only if not fl(val - LB) < -eps,
// LB = m_tile(t) + pen (D D), D the distance of v[n] to the tile's v
// range: fl(val - LB) < -eps means val - LB < -eps exactly, so for every
// f of the tile val - s_f < -eps and |fl(val - s_f)| >= eps. NaN in LB or
// val never skips (val NaN, or eps NaN or <= 0, qualifies nothing: fw);
// with pen NaN or negative every tile is scanned. Lanes test 32 tiles at
// a time from the high-f end; the kept ones are scanned in that order,
// 8 f a lane with their loads (pe, v, e) issued together, the first tile
// holding a qualifying f giving the last such f; if none does, fw. The
// ridge moves slowly, so the found f's tile of pe and e for the next 4
// rows is prefetched into L1. No step has a block-wide barrier; its
// chain is one scan's loads.
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
constexpr int kTile = 64;                      // rows per item = g per tile
constexpr int kTileWarps = 8;                  // forward CTA
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kTileStride = kTileThreads;  // tile j = w + 8 lane + 256 k
constexpr int kHeld = 2;          // tiles of a thread whose summaries it holds
constexpr int kWalkTiles = 512;   // trace tiles per row, at most
constexpr int kWalkSlot = kWalkTiles + 8;  // elements per ring slot
constexpr int kWalkRing = 8;      // step records in flight (trace)
constexpr int kWalkScan = 8;      // f per lane per load round (trace)
constexpr int kWalkAhead = 4;     // rows the walk prefetches into L1
constexpr int kProThreads = 256;  // trace prologue block
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg(const double* p) { return __ldcg(p); }

// NaN-propagating min and max of two, as torch.minimum and torch.maximum.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}
template <typename T>
__device__ __forceinline__ T warp_nan_min(T x) {
  for (int o = 16; o > 0; o >>= 1) x = nan_min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
template <typename T>
__device__ __forceinline__ T warp_nan_max(T x) {
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// A least element by torch.argmin's rule (the first NaN, else the first
// least value, -0 and +0 equal): value m, its index j (kNone: none yet)
// and a companion value w (v at the index). take() is commutative and
// associative, so any order of takes gives the same element.
template <typename T>
struct Least {
  T m, w;
  int j;
  __device__ __forceinline__ Least() : m(inf_t<T>()), w(T(0)), j(kNone) {}
  __device__ __forceinline__ void take(T m2, T w2, int j2) {
    const bool an = m != m, bn = m2 != m2;
    const bool better =
        an ? (bn && j2 < j) : (bn || m2 < m || (m2 == m && j2 < j));
    if (better) {
      m = m2;
      w = w2;
      j = j2;
    }
  }
  __device__ __forceinline__ void warp_reduce() {
    for (int o = 16; o > 0; o >>= 1) {
      const T m2 = __shfl_xor_sync(kFull, m, o);
      const T w2 = __shfl_xor_sync(kFull, w, o);
      const int j2 = __shfl_xor_sync(kFull, j, o);
      take(m2, w2, j2);
    }
  }
};

// Warp 0 of a forward item: the column's rows f0 + lane (x0) and f0 + 32 +
// lane (x1) to pe, and the tile's summary, its least value and v at its
// first least row, to dst.
template <typename T>
__device__ __forceinline__ void store_item(T x0, T x1, T v0, T v1, int f0,
                                           int F, T* col, T* dst, int lane) {
  const int fa = f0 + lane, fb = fa + 32;
  Least<T> s;
  if (fa < F) {
    col[fa] = x0;
    s.take(x0, v0, fa);
  }
  if (fb < F) {
    col[fb] = x1;
    s.take(x1, v1, fb);
  }
  s.warp_reduce();
  if (lane == 0) {
    dst[0] = s.m;
    dst[1] = s.w;
  }
}

// One tile of g of pe[t-1] and v, a lane's two elements of each, read
// through L2 (pe[t-1] was written in this launch); past F, pe +inf and v
// of the last row (the tail is masked where it is evaluated).
template <typename T>
struct TileRegs {
  T p0, p1, w0, w1;
  __device__ __forceinline__ void fetch(const T* prev, const T* v, int F,
                                        int g0, int lane) {
    const int g = g0 + lane, h = g + 32;
    p0 = g < F ? ldcg(prev + g) : inf_t<T>();
    p1 = h < F ? ldcg(prev + h) : inf_t<T>();
    w0 = v[min(g, F - 1)];
    w1 = v[min(h, F - 1)];
  }
  __device__ __forceinline__ void stash(T* s, int lane) const {
    s[lane] = p0;
    s[lane + 32] = p1;
    s[kTile + lane] = w0;
    s[kTile + lane + 32] = w1;
  }
};

// The candidates of rows a (v_a) and b (v_b) over one tile held in shared
// memory (pe[t-1] then v), the plain version's arithmetic; n < kTile: the
// tile at the end of the row, its first n g only.
template <typename T>
__device__ __forceinline__ void eval_tile(const T* s, int n, T pen, T va,
                                          T vb, MinAcc<T> (&a)[4],
                                          MinAcc<T> (&c)[4]) {
  const T* sv = s + kTile;
  if (n == kTile) {
#pragma unroll 4
    for (int g = 0; g < kTile; g += 4) {
      const Quad<T> p = load4(s + g);
      const Quad<T> w = load4(sv + g);
      a[0].add(add_rn(p.a, penalty(pen, va, w.a)));
      c[0].add(add_rn(p.a, penalty(pen, vb, w.a)));
      a[1].add(add_rn(p.b, penalty(pen, va, w.b)));
      c[1].add(add_rn(p.b, penalty(pen, vb, w.b)));
      a[2].add(add_rn(p.c, penalty(pen, va, w.c)));
      c[2].add(add_rn(p.c, penalty(pen, vb, w.c)));
      a[3].add(add_rn(p.d, penalty(pen, va, w.d)));
      c[3].add(add_rn(p.d, penalty(pen, vb, w.d)));
    }
  } else {
    for (int g = 0; g < n; ++g) {
      a[0].add(add_rn(s[g], penalty(pen, va, sv[g])));
      c[0].add(add_rn(s[g], penalty(pen, vb, sv[g])));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 2)
    ridge_forward_tiled_kernel(const T* __restrict__ e,
                               const T* __restrict__ v, T pen, int B, int F,
                               int Tn, T* summ, T* vr, T* __restrict__ pe) {
  __shared__ __align__(16) T buf[kTileWarps][2][2 * kTile];
  __shared__ T part[kTileWarps][kTile];
  __shared__ T red_m[kTileWarps], red_w[kTileWarps];
  __shared__ int red_j[kTileWarps];
  __shared__ int prune_s;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nT = (F + kTile - 1) / kTile;
  const int items = B * nT;
  const size_t plane = (size_t)B * nT * 2;  // one parity of summ

  // column 0: pe = e and its tiles' summaries; each tile's v range
  if (w == 0)
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / nT, i = it % nT, f0 = i * kTile;
      const int fa = f0 + lane, fb = fa + 32;
      const T va = v[min(fa, F - 1)], vb = v[min(fb, F - 1)];
      const T* col = e + (size_t)b * Tn * F;
      store_item(fa < F ? col[fa] : T(0), fb < F ? col[fb] : T(0), va, vb,
                 f0, F, pe + (size_t)b * Tn * F, summ + (size_t)it * 2, lane);
      if (b == 0) {  // rows past F repeat v[F - 1], which is in this tile
        const T lo = warp_nan_min(nan_min(va, vb));
        const T hi = warp_nan_max(nan_max(va, vb));
        if (lane == 0) {
          vr[2 * i] = lo;
          vr[2 * i + 1] = hi;
        }
      }
    }
  if (Tn == 1) return;
  grid.sync();

  // Whether the bound may skip: pen finite and >= 0, every v finite and
  // the square of its spread finite, so that no P is NaN and every
  // candidate of a tile is at least its bound (module note).
  {
    T lo = inf_t<T>(), hi = -inf_t<T>();
    for (int j = threadIdx.x; j < nT; j += kTileThreads) {
      lo = nan_min(lo, ldcg(vr + 2 * j));
      hi = nan_max(hi, ldcg(vr + 2 * j + 1));
    }
    lo = warp_nan_min(lo);
    hi = warp_nan_max(hi);
    if (lane == 0) {
      red_m[w] = lo;
      red_w[w] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 1; q < kTileWarps; ++q) {
        lo = nan_min(lo, red_m[q]);
        hi = nan_max(hi, red_w[q]);
      }
      const T s = sub_rn(hi, lo), inf = inf_t<T>();
      prune_s = pen >= T(0) && pen < inf && lo > -inf && hi < inf &&
                mul_rn(s, s) < inf;
    }
    __syncthreads();
  }
  const bool prune = prune_s != 0;
  // the v ranges of the thread's held tiles
  T hlo[kHeld], hhi[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const int j = w + 8 * lane + kTileStride * k;
    hlo[k] = j < nT ? ldcg(vr + 2 * j) : T(0);
    hhi[k] = j < nT ? ldcg(vr + 2 * j + 1) : T(0);
  }

  for (int t = 1; t < Tn; ++t) {
    const T* sin = summ + (size_t)((t - 1) & 1) * plane;
    T* sout = summ + (size_t)(t & 1) * plane;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int b = it / nT, i = it % nT, f0 = i * kTile;
      const int fa = f0 + lane, fb = fa + 32;
      const T* prev = pe + ((size_t)b * Tn + t - 1) * F;
      const T* sb = sin + (size_t)b * nT * 2;
      // loads: the held tiles' summaries, the item's rows and v range
      T hm[kHeld];
      Least<T> l;
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int j = w + 8 * lane + kTileStride * k;
        hm[k] = T(0);
        if (j < nT) {
          hm[k] = ldcg(sb + 2 * j);
          l.take(hm[k], ldcg(sb + 2 * j + 1), j);
        }
      }
      for (int j = w + 8 * lane + kTileStride * kHeld; j < nT;
           j += kTileStride)
        l.take(ldcg(sb + 2 * j), ldcg(sb + 2 * j + 1), j);
      const T pa = fa < F ? ldcg(prev + fa) : T(0);
      const T pb = fb < F ? ldcg(prev + fb) : T(0);
      const T va = v[min(fa, F - 1)], vb = v[min(fb, F - 1)];
      const T* ec = e + ((size_t)b * Tn + t) * F;
      const T ea = fa < F ? ec[fa] : T(0), eb = fb < F ? ec[fb] : T(0);
      const T lo_i = ldcg(vr + 2 * i), hi_i = ldcg(vr + 2 * i + 1);
      // the tile of g of the item's own rows, which the bound nearly
      // always keeps, in flight already: its warp (i % 8) takes it
      TileRegs<T> own;
      if (w == i % kTileWarps) own.fetch(prev, v, F, f0, lane);
      // the column's least (its first occurrence), over the block
      l.warp_reduce();
      if (lane == 0) {
        red_m[w] = l.m;
        red_w[w] = l.w;
        red_j[w] = l.j;
      }
      __syncthreads();
      Least<T> s;
#pragma unroll
      for (int q = 0; q < kTileWarps; ++q) s.take(red_m[q], red_w[q], red_j[q]);
      // the rows' upper bounds, real candidates: g = f and the least g
      T ub = -inf_t<T>();
      if (fa < F)
        ub = nan_min(add_rn(pa, penalty(pen, va, va)),
                     add_rn(s.m, penalty(pen, va, s.w)));
      if (fb < F)
        ub = nan_max(ub, nan_min(add_rn(pb, penalty(pen, vb, vb)),
                                 add_rn(s.m, penalty(pen, vb, s.w))));
      ub = warp_nan_max(ub);

      // the warp's tiles j = w + 8 lane + kTileStride k: a ballot of those
      // the bound keeps, then each kept tile by the whole warp, the next
      // one's loads in flight while the warp evaluates the current one
      MinAcc<T> a[4], c[4];
      T* wb = &buf[w][0][0];
      int p = 0;
      auto keep = [&](int j, T m, T lo, T hi) -> bool {
        if (j >= nT) return false;
        if (!prune) return true;
        const T D = nan_max(nan_max(sub_rn(lo, hi_i), sub_rn(lo_i, hi)), T(0));
        return !(add_rn(m, mul_rn(pen, mul_rn(D, D))) > ub);
      };
      auto run = [&](unsigned mask, int k) {
        TileRegs<T> r;
        if (mask) {
          const int j = w + 8 * (__ffs(mask) - 1) + kTileStride * k;
          if (j == i)
            r = own;
          else
            r.fetch(prev, v, F, j * kTile, lane);
        }
        while (mask) {
          const int j = w + 8 * (__ffs(mask) - 1) + kTileStride * k;
          mask &= mask - 1;
          T* sp = wb + p * 2 * kTile;
          r.stash(sp, lane);
          __syncwarp();
          if (mask)
            r.fetch(prev, v, F, (w + 8 * (__ffs(mask) - 1) +
                                 kTileStride * k) * kTile, lane);
          eval_tile(sp, min(kTile, F - j * kTile), pen, va, vb, a, c);
          p ^= 1;
        }
      };
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int j = w + 8 * lane + kTileStride * k;
        run(__ballot_sync(kFull, keep(j, hm[k], hlo[k], hhi[k])), k);
      }
      for (int k = kHeld; w + kTileStride * k < nT; ++k) {
        const int j = w + 8 * lane + kTileStride * k;
        const bool in = j < nT;
        run(__ballot_sync(kFull, keep(j, in ? ldcg(sb + 2 * j) : T(0),
                                      in ? ldcg(vr + 2 * j) : T(0),
                                      in ? ldcg(vr + 2 * j + 1) : T(0))),
            k);
      }
      a[0].merge(a[1]); a[2].merge(a[3]); a[0].merge(a[2]);
      c[0].merge(c[1]); c[2].merge(c[3]); c[0].merge(c[2]);
      part[w][lane] = a[0].value();
      part[w][lane + 32] = c[0].value();
      __syncthreads();
      if (w == 0) {  // the warps' partial minima, then e, to pe
        MinAcc<T> m0, m1;
#pragma unroll
        for (int q = 0; q < kTileWarps; ++q) {
          m0.add(part[q][lane]);
          m1.add(part[q][lane + 32]);
        }
        store_item(add_rn(ea, m0.value()), add_rn(eb, m1.value()), va, vb,
                   f0, F, pe + ((size_t)b * Tn + t) * F,
                   sout + (size_t)it * 2, lane);
      }
    }
    if (t + 1 < Tn) grid.sync();
  }
}

// The tiled trace's prologue, one block per (b, t): the step record of
// pe[t], its least over each trace tile of G f (NaN-propagating), then
// pe[t, fw] - e[t, fw], v[fw] and the bits of fw = argmin_f pe[t] (the
// first NaN, else the first least value), in a row of `stride` elements.
// Block 0 also writes each tile's v range.
template <typename T>
__device__ __forceinline__ T int_bits(int x);
template <>
__device__ __forceinline__ float int_bits<float>(int x) {
  return __int_as_float(x);
}
template <>
__device__ __forceinline__ double int_bits<double>(int x) {
  return __longlong_as_double((long long)x);
}
template <typename T>
__device__ __forceinline__ int bits_int(T x);
template <>
__device__ __forceinline__ int bits_int<float>(float x) {
  return __float_as_int(x);
}
template <>
__device__ __forceinline__ int bits_int<double>(double x) {
  return (int)__double_as_longlong(x);
}

template <typename T>
__global__ void __launch_bounds__(kProThreads)
    ridge_trace_prologue_kernel(const T* __restrict__ pe,
                                const T* __restrict__ e,
                                const T* __restrict__ v, int F, int G,
                                int nT, int stride, T* __restrict__ rec,
                                T* __restrict__ vr) {
  __shared__ T red_m[kProThreads / 32], red_w[kProThreads / 32];
  __shared__ int red_j[kProThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int nw = kProThreads / 32;
  const size_t row = blockIdx.x;  // b Tn + t
  const T* p = pe + row * F;
  T* out = rec + row * stride;
  Least<T> l;
  for (int q = w; q < nT; q += nw) {  // the warp's tiles
    const int g0 = q * G, n = min(G, F - g0);
    MinAcc<T> acc;
#pragma unroll 8
    for (int x = lane; x < n; x += 32) {
      const T y = p[g0 + x];
      acc.add(y);
      l.take(y, T(0), g0 + x);
    }
    const T m = acc.warp_min();
    if (lane == 0) out[q] = m;
    if (row == 0) {  // the tile's v range
      T lo = inf_t<T>(), hi = -inf_t<T>();
      for (int x = lane; x < n; x += 32) {
        lo = nan_min(lo, v[g0 + x]);
        hi = nan_max(hi, v[g0 + x]);
      }
      lo = warp_nan_min(lo);
      hi = warp_nan_max(hi);
      if (lane == 0) {
        vr[2 * q] = lo;
        vr[2 * q + 1] = hi;
      }
    }
  }
  l.warp_reduce();
  if (lane == 0) {
    red_m[w] = l.m;
    red_w[w] = l.w;
    red_j[w] = l.j;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Least<T> s;
    for (int q = 0; q < nw; ++q) s.take(red_m[q], red_w[q], red_j[q]);
    out[nT] = sub_rn(p[s.j], e[row * F + s.j]);
    out[nT + 1] = v[s.j];
    out[nT + 2] = int_bits<T>(s.j);
  }
}

// The tiled trace's walk: one warp per batch row, fed the step records
// (T-1 .. 0) by bulk copies into a ring of kWalkRing slots, each with a
// full mbarrier (the walker re-issues a slot's copy once it has read it).
template <typename T>
__global__ void __launch_bounds__(32)
    ridge_trace_tiled_kernel(const T* __restrict__ pe,
                             const T* __restrict__ e,
                             const T* __restrict__ v,
                             const T* __restrict__ rec,
                             const T* __restrict__ vr, T pen, T eps, int F,
                             int Tn, int G, int nT, int stride,
                             int* __restrict__ ridge) {
  __shared__ __align__(16) T ring[kWalkRing][kWalkSlot];
  __shared__ T svr[2 * kWalkTiles];
  __shared__ __align__(8) uint64_t full[kWalkRing];
  const int lane = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * Tn;
  const T* rb = rec + row0 * stride;
  int* out = ridge + row0;
  const unsigned bytes = (unsigned)(stride * sizeof(T));
  for (int q = lane; q < 2 * nT; q += 32) svr[q] = vr[q];
  // the record of step t into its slot (u = Tn - 1 - t: steps in order)
  auto issue = [&](int t) {
    const int u = Tn - 1 - t, s = u % kWalkRing;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_tx(full + s, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring[s])),
        "l"(rb + (size_t)t * stride), "r"(bytes), "r"(smem_u32(full + s))
        : "memory");
  };
  if (lane == 0) {
    for (int s = 0; s < kWalkRing; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = 0; u < kWalkRing && u < Tn; ++u) issue(Tn - 1 - u);
  }
  __syncwarp();
  // the bound holds for pen >= 0 (NaN or negative: every tile is scanned);
  // with eps NaN or <= 0 no f qualifies
  const bool prune = pen >= T(0), none = !(eps > T(0));
  T val = T(0), vn = T(0);
  for (int t = Tn - 1; t >= 0; --t) {
    const int u = Tn - 1 - t, s = u % kWalkRing;
    mbar_wait(full + s, (unsigned)((u / kWalkRing) & 1));
    const T* r = ring[s];
    int found = -1;
    T nval = T(0), nvn = T(0);
    // val NaN: no f qualifies, as none does with eps NaN or <= 0
    if (t < Tn - 1 && !none && val == val) {
      const T* pr = pe + (row0 + t) * F;
      const T* er = e + (row0 + t) * F;
      // tiles from the high-f end: lane l tests tile nT - 1 - l - 32 k
      for (int k = 0; 32 * k < nT && found < 0; ++k) {
        const int j = nT - 1 - lane - 32 * k;
        bool can = j >= 0;
        if (can && prune) {
          const T D = nan_max(
              nan_max(sub_rn(svr[2 * j], vn), sub_rn(vn, svr[2 * j + 1])),
              T(0));
          can = !(sub_rn(val, add_rn(r[j], mul_rn(pen, mul_rn(D, D)))) <
                  -eps);
        }
        unsigned mask = __ballot_sync(kFull, can);
        while (mask && found < 0) {  // the highest tile first
          const int jj = nT - 1 - (__ffs(mask) - 1) - 32 * k;
          mask &= mask - 1;
          const int g0 = jj * G, n = min(G, F - g0);
          int last = -1;
          T lval = T(0), lv = T(0);
          for (int x0 = 0; x0 < n; x0 += 32 * kWalkScan) {
            T y[kWalkScan], wv[kWalkScan], ee[kWalkScan];
#pragma unroll
            for (int q = 0; q < kWalkScan; ++q) {
              const int f = g0 + min(x0 + lane + 32 * q, n - 1);
              y[q] = pr[f];
              wv[q] = v[f];
              ee[q] = er[f];
            }
#pragma unroll
            for (int q = 0; q < kWalkScan; ++q) {
              const int x = x0 + lane + 32 * q;
              const T sc = add_rn(y[q], penalty(pen, vn, wv[q]));
              if ((abs_t(sub_rn(val, sc)) < eps) & (x < n)) {
                last = g0 + x;
                lval = sub_rn(y[q], ee[q]);
                lv = wv[q];
              }
            }
          }
          const int best = __reduce_max_sync(kFull, last);
          if (best >= 0) {  // f = g0 + lane + 32 q: its lane is f % 32
            nval = __shfl_sync(kFull, lval, best & 31);
            nvn = __shfl_sync(kFull, lv, best & 31);
            found = best;
          }
        }
      }
    }
    if (found < 0) {  // nothing qualifies (or the last column): fw
      found = bits_int<T>(r[nT + 2]);
      nval = r[nT];
      nvn = r[nT + 1];
    }
    __syncwarp();  // every lane has read the slot
    if (lane == 0) {
      out[t] = found;
      if (t - kWalkRing >= 0) issue(t - kWalkRing);
    }
    // the ridge moves slowly: the found f's tile of pe and e for the
    // next kWalkAhead rows into L1 (lines of 128 bytes, a few a lane)
    {
      constexpr int L = 128 / sizeof(T);  // elements per line
      const int g0 = found / G * G, n = min(G, F - g0);
      const int lines = (n + L - 1) / L;
      for (int q = lane; q < 2 * kWalkAhead * lines; q += 32) {
        const int row = t - 1 - q / (2 * lines);
        const int x = q % (2 * lines);
        if (row < 0) break;
        const T* base = (x < lines ? pe : e) + (row0 + row) * F + g0;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            base + min((x % lines) * L, n - 1)));
      }
    }
    val = nval;
    vn = nvn;
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
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, ridge_forward_tiled_kernel<T>, kTileThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *ctas = per * sms;
  return 0;
}

template <typename T>
int forward_tiled(const void* e, const void* v, double pen, int B, int F,
                  int Tn, void* summ, void* vr, void* pe, void* stream) {
  if (B < 1 || F < 1 || Tn < 1 ||
      (long long)B * ((F + kTile - 1) / kTile) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int ctas = 0;
  int err = tiled_ctas<T>(&ctas);
  if (err) return err;
  if (ctas < 1) return kErrNoCluster;
  const int items = B * ((F + kTile - 1) / kTile);
  const unsigned grid = (unsigned)(items < ctas ? items : ctas);
  const T* ep = (const T*)e;
  const T* vp = (const T*)v;
  T pn = (T)pen;
  T* sp = (T*)summ;
  T* rp = (T*)vr;
  T* op = (T*)pe;
  void* args[] = {(void*)&ep, (void*)&vp, (void*)&pn, (void*)&B,
                  (void*)&F,  (void*)&Tn, (void*)&sp, (void*)&rp,
                  (void*)&op};
  err = (int)cudaLaunchCooperativeKernel(
      (const void*)ridge_forward_tiled_kernel<T>, dim3(grid),
      dim3(kTileThreads), args, 0, (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The trace tiles' layout the plan states: G a multiple of 32, nT tiles
// of G covering F, at most kWalkTiles, records of `stride` elements (a
// multiple of 16 bytes) holding nT + 3.
template <typename T>
bool walk_layout(int F, int G, int nT, int stride) {
  constexpr int Q = 16 / sizeof(T);
  return G >= 32 && G % 32 == 0 && nT >= 1 && nT <= kWalkTiles &&
         (long long)nT * G >= F && (long long)(nT - 1) * G < F &&
         stride >= nT + 3 && stride <= kWalkSlot && stride % Q == 0;
}

template <typename T>
int trace_prologue(const void* pe, const void* e, const void* v, int B,
                   int F, int Tn, int G, int nT, int stride, void* rec,
                   void* vr, void* stream) {
  if (B < 1 || F < 1 || Tn < 1 || (long long)B * Tn > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (!walk_layout<T>(F, G, nT, stride)) return kErrLayout;
  ridge_trace_prologue_kernel<T>
      <<<(unsigned)(B * Tn), kProThreads, 0, (cudaStream_t)stream>>>(
          (const T*)pe, (const T*)e, (const T*)v, F, G, nT, stride, (T*)rec,
          (T*)vr);
  return (int)cudaGetLastError();
}

template <typename T>
int trace_tiled(const void* pe, const void* e, const void* v,
                const void* rec, const void* vr, double pen, double eps,
                int B, int F, int Tn, int G, int nT, int stride, void* ridge,
                void* stream) {
  if (B < 1 || F < 1 || Tn < 1 || (uintptr_t)rec % 16)
    return (int)cudaErrorInvalidValue;
  if (!walk_layout<T>(F, G, nT, stride)) return kErrLayout;
  ridge_trace_tiled_kernel<T><<<B, 32, 0, (cudaStream_t)stream>>>(
      (const T*)pe, (const T*)e, (const T*)v, (const T*)rec, (const T*)vr,
      (T)pen, (T)eps, F, Tn, G, nT, stride, (int*)ridge);
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

// The row-tiled mode (ridge_plan's `tiled`): pe (B, T, F) from e and v;
// summ a scratch of 2 B ceil(F / 64) 2 elements (the tiles' summaries in
// two parities), vr of ceil(F / 64) 2 (their v ranges).
extern "C" int ridge_forward_tiled_f32(const void* e, const void* v,
                                       double pen, int B, int F, int Tn,
                                       void* summ, void* vr, void* pe,
                                       void* stream) {
  return forward_tiled<float>(e, v, pen, B, F, Tn, summ, vr, pe, stream);
}

extern "C" int ridge_forward_tiled_f64(const void* e, const void* v,
                                       double pen, int B, int F, int Tn,
                                       void* summ, void* vr, void* pe,
                                       void* stream) {
  return forward_tiled<double>(e, v, pen, B, F, Tn, summ, vr, pe, stream);
}

// How many CTAs of the tiled forward the card holds at once (its grid's
// largest size); itemsize 4 or 8.
extern "C" int ridge_forward_tiled_ctas(int itemsize, int* ctas) {
  return itemsize == 4 ? tiled_ctas<float>(ctas) : tiled_ctas<double>(ctas);
}

// The tiled trace's prologue: rec (B, T, stride), each step's record (the
// least of pe[t] over each of nT tiles of G f, pe - e and v at the first
// argmin, its bits), and vr (nT, 2), the tiles' v ranges.
extern "C" int ridge_trace_prologue_f32(const void* pe, const void* e,
                                        const void* v, int B, int F, int Tn,
                                        int G, int nT, int stride, void* rec,
                                        void* vr, void* stream) {
  return trace_prologue<float>(pe, e, v, B, F, Tn, G, nT, stride, rec, vr,
                               stream);
}

extern "C" int ridge_trace_prologue_f64(const void* pe, const void* e,
                                        const void* v, int B, int F, int Tn,
                                        int G, int nT, int stride, void* rec,
                                        void* vr, void* stream) {
  return trace_prologue<double>(pe, e, v, B, F, Tn, G, nT, stride, rec, vr,
                                stream);
}

// ridge (B, T) int32 from pe and e (B, T, F), v (F,) and the prologue's
// rec (16-byte aligned) and vr, row-tiled.
extern "C" int ridge_trace_tiled_f32(const void* pe, const void* e,
                                     const void* v, const void* rec,
                                     const void* vr, double pen, double eps,
                                     int B, int F, int Tn, int G, int nT,
                                     int stride, void* ridge, void* stream) {
  return trace_tiled<float>(pe, e, v, rec, vr, pen, eps, B, F, Tn, G, nT,
                            stride, ridge, stream);
}

extern "C" int ridge_trace_tiled_f64(const void* pe, const void* e,
                                     const void* v, const void* rec,
                                     const void* vr, double pen, double eps,
                                     int B, int F, int Tn, int G, int nT,
                                     int stride, void* ridge, void* stream) {
  return trace_tiled<double>(pe, e, v, rec, vr, pen, eps, B, F, Tn, G, nT,
                             stride, ridge, stream);
}
