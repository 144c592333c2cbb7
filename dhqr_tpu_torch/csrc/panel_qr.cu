// Hopper panel factorization kernels for dhqr_tpu_torch (sm_90a).
//
// Replaces the two Pallas TPU kernels of dhqr_tpu/ops/pallas_panel.py:
//   K1  _panel_kernel      (float32;   reached from _panel_qr_pallas_jit)
//   K2  _panel_kernel_c64  (complex64; same entry, planar re/im planes)
// with _sumsq_compensated inlined in both. One templated body serves both
// (T = float, or float2 for PyTorch's interleaved complex64). Each launch
// factors one panel in place: the panel is held transposed, At (nb, m), one
// panel column per row of m contiguous elements, and the reflector of local
// column jl starts at row j = off + jl (rows above off hold R entries of
// earlier panels; they are never loaded and stay bit for bit). Per column:
//   s       = compensated ||At[jl, j:]||
//   alpha   = -sign(a_jj) s (complex: s * (-a_jj/|a_jj|); -s on a zero pivot)
//   f       = 1/sqrt(s (s + |a_jj|))  (0 when that is 0: a zero column gives v = 0)
//   v       = f (x - alpha e_j), so ||v||^2 = 2; written over At[jl, j:]
//   W[k]    = <v, At[k, j:]> = f (<x, At[k, j:]> - conj(alpha) At[k, j])  for k > jl
//   At[k]  -= W[k] v                                                      for k > jl
// with x = At[jl, j:] before it is overwritten. Full FP32 FMA, no TF32.
//
// What bounds it on an H100: the panel is read once and written once,
// 2*m*nb*4 bytes (c64: x2) against 3.35 TB/s, and the column sweep does
// about 2*m*nb^2 FP32 operations (c64: x4) against the 67 TFLOP/s FP32 SIMT
// rate; at (16384, 128) f32 that is 5.0 us of bytes against 8.0 us of
// operations, so the work is operation-bound. The column steps are serial,
// so in practice a panel pays nb grid-wide synchronisations on top.
//
// What this design does about it: the panel is spread over the whole card
// and kept on chip. One persistent cooperative grid, at most one CTA per SM
// (at least 32 rows per CTA, so a short panel takes a few CTAs), splits the
// active rows [off, m) into contiguous slices. Each CTA loads its slice of
// all nb columns into dynamic shared memory once, keeps it there for the
// whole panel and writes it back once at the end, so HBM sees the panel's
// bytes once each way (16384 x 128 f32: 125 rows x 512 B = 64 KB per CTA).
// A panel whose slices do not fit shared memory takes the same body with
// the slice left in place in At (the streamed variant, kResident = false):
// each column step then reads and writes the CTA's trailing rows through
// L2/HBM instead of shared memory. Per column there is ONE grid barrier:
// before it, each CTA publishes to a global scratch slot its compensated
// (s, err) over its rows >= j and its partial dots <x, At[k]> for every
// trailing column k, and the CTA owning row j publishes that row; after
// it, every CTA merges
// all slots in the same fixed CTA order (TwoSum for the norm), so every CTA
// derives bit-identical alpha, f and W, and applies v and y -= W v to its
// own rows. The rank-1 update of column jl and the partial dots of column
// jl+1 share one pass over the slice (the column jl+1 is updated first,
// then each warp updates its trailing columns and dots them with it). The
// scratch is double-buffered by column parity: a CTA that is one column
// ahead writes the other half. Co-residency of the grid, which the barrier
// needs, comes from cudaLaunchCooperativeKernel: a grid that cannot be
// resident is a launch error, never a hang. The grid is planned on the
// Python side (ops/hopper_panel: kernel_grid for the row partition,
// kernel_resident for the variant, kernel_flat_width for the leaf widths
// the blocked engine asks for); the launcher only checks the plan it is
// given (partition, SM count, shared-memory fit, occupancy) and returns
// cudaErrorInvalidValue for one it cannot run. The scratch layout is this
// file's alone: dhqr_panel_qr_scratch_floats sizes it for the wrapper.
//
// What is left: the steps stay serial, and each pays a grid barrier and a
// merge in which every CTA reads every CTA's partials (ctas^2 x nb words
// of L2 reads per column, 8.9 MB at 132 CTAs and nb = 128). On an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 7) a 16384 x 128 f32 panel takes
// about 6 us per column: ~2.0 us merge (L2-bandwidth-bound), ~1.9 us
// trailing pass, ~1.0 us barrier, ~0.4 us column pass. Pre-reducing the
// partials inside thread-block clusters is the next step. The streamed
// variant pays a pass over its trailing rows through L2/HBM per column; the
// blocked engine gives it only the narrowest leaf (16 columns), past the
// heights where any leaf's slices fit shared memory (~462k rows f32, ~231k
// c64 on an H100).
//
// Hazards handled:
//   * nvcc contracts a*b+c into an FMA by default, which would break a
//     Veltkamp split. The squares use the exact two-product instead,
//     p = x*x, e = fmaf(x, x, -p) (exact on Hopper), and every TwoSum step is
//     spelled with __fadd_rn/__fsub_rn/__fmul_rn so nothing is contracted.
//   * 1/sqrt uses the correctly rounded __fdiv_rn/__fsqrt_rn, not rsqrt.
//   * Cross-CTA data: scratch is written with __stcg and read with __ldcg
//     (L2, never a stale L1 line); the barrier is a device-scope
//     release/acquire counter that the wrapper zeroes before each launch.
//     A streamed slice is touched by its own CTA only, so __syncthreads
//     orders it as it orders shared memory.
//   * Determinism: merges run in a fixed order whose float additions are
//     the same on every CTA (and commutative where lanes swap operands), so
//     two launches on the same input give bit-identical results.
//   * Each launcher returns the launch's error (cudaGetLastError()).
//
// Built with -DDHQR_PANEL_PROFILE, thread 0 of each CTA also counts the SM
// cycles of four sections of every column step (merge, column pass,
// trailing pass, grid barrier); ops/hopper_panel.kernel_section_cycles
// reads them. The default build has no timers.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 128;              // widest panel one launch takes
constexpr int kColsPerWarp = kMaxWidth / kWarps;
constexpr int kMaxCtas = 144;               // grid cap (covers 132 SMs)
constexpr int kMergeGroups = kThreads / kMaxWidth;  // CTA groups in the merge
constexpr int kMergeBatch = kMaxCtas / kMergeGroups;  // loads in flight, f32
constexpr int kNormPerLane = (kMaxCtas + 31) / 32;
static_assert(kColsPerWarp == 8, "the trailing reduction halves 8 values");

struct Grid {
  int ctas;  // CTAs in the launch
  int rows;  // rows per CTA (the last CTA may hold fewer)
};

// Scratch, in floats: per column parity, one slot per CTA ((s, err) and the
// nb partial dots) and the pivot row's nb entries.
template <typename T>
__host__ __device__ long long slot_floats(int nb) {
  return 2 + static_cast<long long>(nb) * (sizeof(T) / sizeof(float));
}
template <typename T>
__host__ __device__ long long parity_floats(int ctas, int nb) {
  return ctas * slot_floats<T>(nb) + nb * (sizeof(T) / sizeof(float));
}

// -- compensated arithmetic -------------------------------------------------

// (s, err) += x exactly in the Knuth TwoSum sense.
__device__ __forceinline__ void two_sum_acc(float& s, float& err, float x) {
  const float t = __fadd_rn(s, x);
  const float z = __fsub_rn(t, s);
  const float c = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(x, z));
  s = t;
  err = __fadd_rn(err, c);
}

// (s, err) += x*x, the square made exact by the FMA two-product.
__device__ __forceinline__ void acc_square(float& s, float& err, float x) {
  const float p = __fmul_rn(x, x);
  const float e = fmaf(x, x, -p);
  two_sum_acc(s, err, p);
  err = __fadd_rn(err, e);
}

__device__ __forceinline__ void comp_merge(float& s, float& err, float s2,
                                           float e2) {
  two_sum_acc(s, err, s2);
  err = __fadd_rn(err, e2);
}

// (s, err) of one warp, merged into lane 0 in a fixed order.
__device__ __forceinline__ void warp_comp_merge(float& s, float& err) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_down_sync(0xffffffffu, s, o);
    const float e2 = __shfl_down_sync(0xffffffffu, err, o);
    comp_merge(s, err, s2, e2);
  }
}

__device__ __forceinline__ float inv_scale(float sn, float mag) {
  const float denom = __fmul_rn(sn, __fadd_rn(sn, mag));
  return denom > 0.f ? __fdiv_rn(1.f, __fsqrt_rn(denom)) : 0.f;
}

// -- element operations, real and complex -----------------------------------

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float shfl_xor(float a, int o) {
  return __shfl_xor_sync(0xffffffffu, a, o);
}
__device__ __forceinline__ float2 shfl_xor(float2 a, int o) {
  return make_float2(__shfl_xor_sync(0xffffffffu, a.x, o),
                     __shfl_xor_sync(0xffffffffu, a.y, o));
}

// One step of the warp's reduction of v[0..2H): lanes with bit 4H set keep
// the upper H values, the others the lower H, and each adds its partner's
// copy of what it keeps (lane ^ 4H). After H = 4, 2, 1 lane l holds, in
// v[0], the sum over the 8 lanes that differ in bits 2-4 of value l / 4.
template <int H, typename T>
__device__ __forceinline__ void halve(T (&v)[kColsPerWarp], int lane) {
  const bool upper = lane & (4 * H);
#pragma unroll
  for (int q = 0; q < H; ++q) {
    const T give = upper ? v[q] : v[q + H];
    const T keep = upper ? v[q + H] : v[q];
    v[q] = add(keep, shfl_xor(give, 4 * H));
  }
}

// (s, err) += |x|^2
__device__ __forceinline__ void acc_sq(float& s, float& err, float x) {
  acc_square(s, err, x);
}
__device__ __forceinline__ void acc_sq(float& s, float& err, float2 x) {
  acc_square(s, err, x.x);
  acc_square(s, err, x.y);
}

// d += conj(x) y
__device__ __forceinline__ void acc_dot(float& d, float x, float y) {
  d = fmaf(y, x, d);
}
__device__ __forceinline__ void acc_dot(float2& d, float2 x, float2 y) {
  d.x = fmaf(y.x, x.x, fmaf(y.y, x.y, d.x));
  d.y = fmaf(y.y, x.x, fmaf(-y.x, x.y, d.y));
}

// y - w v
__device__ __forceinline__ float sub_scaled(float y, float w, float v) {
  return fmaf(-w, v, y);
}
__device__ __forceinline__ float2 sub_scaled(float2 y, float2 w, float2 v) {
  return make_float2(__fsub_rn(y.x, fmaf(w.x, v.x, -__fmul_rn(w.y, v.y))),
                     __fsub_rn(y.y, fmaf(w.x, v.y, __fmul_rn(w.y, v.x))));
}

// f x, and f (x - alpha) for the pivot
__device__ __forceinline__ float scale(float x, float f) { return __fmul_rn(x, f); }
__device__ __forceinline__ float2 scale(float2 x, float f) {
  return make_float2(__fmul_rn(x.x, f), __fmul_rn(x.y, f));
}
__device__ __forceinline__ float pivot(float x, float alpha, float f) {
  return __fmul_rn(__fsub_rn(x, alpha), f);
}
__device__ __forceinline__ float2 pivot(float2 x, float2 alpha, float f) {
  return make_float2(__fmul_rn(__fsub_rn(x.x, alpha.x), f),
                     __fmul_rn(__fsub_rn(x.y, alpha.y), f));
}

// alpha from the column norm and the pivot; mag = |a_jj|
__device__ __forceinline__ float make_alpha(float sn, float a, float& mag) {
  mag = fabsf(a);
  return a >= 0.f ? -sn : sn;
}
__device__ __forceinline__ float2 make_alpha(float sn, float2 a, float& mag) {
  mag = __fsqrt_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
  if (mag > 0.f) {  // alpha = s (-a/|a|)
    const float inv = __fdiv_rn(1.f, mag);
    return make_float2(__fmul_rn(sn, __fmul_rn(-a.x, inv)),
                       __fmul_rn(sn, __fmul_rn(-a.y, inv)));
  }
  return make_float2(-sn, __fmul_rn(sn, 0.f));  // -s on a zero pivot
}

// W = f (d - conj(alpha) y_j), d = sum conj(x_i) y_i over rows >= j
__device__ __forceinline__ float w_coef(float d, float alpha, float yj, float f) {
  return __fmul_rn(f, fmaf(-alpha, yj, d));
}
__device__ __forceinline__ float2 w_coef(float2 d, float2 a, float2 y, float f) {
  const float cr = fmaf(a.x, y.x, __fmul_rn(a.y, y.y));
  const float ci = fmaf(a.x, y.y, -__fmul_rn(a.y, y.x));
  return make_float2(__fmul_rn(f, __fsub_rn(d.x, cr)),
                     __fmul_rn(f, __fsub_rn(d.y, ci)));
}

// -- the grid barrier -------------------------------------------------------

// Every CTA adds one to the counter and waits until it reaches ``target``
// (= ctas x barriers so far); the counter only grows within a launch.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*bar);
    count.fetch_add(1u, cuda::memory_order_release);
    while (count.load(cuda::memory_order_acquire) < target) {
    }
  }
  __syncthreads();
}

// -- optional section timers (built with -DDHQR_PANEL_PROFILE only) --------

#ifdef DHQR_PANEL_PROFILE
constexpr int kProfSections = 4;  // merge, column pass, trailing pass, barrier
__device__ unsigned long long g_prof[1024][kProfSections];
#define PROF_INIT()                                   \
  long long prof_t = clock64();                       \
  unsigned long long prof_acc[kProfSections] = {0, 0, 0, 0};
#define PROF_MARK(i)                                  \
  if (threadIdx.x == 0) {                             \
    const long long t = clock64();                    \
    prof_acc[i] += t - prof_t;                        \
    prof_t = t;                                       \
  }
#define PROF_STORE()                                  \
  if (threadIdx.x == 0)                               \
    for (int q = 0; q < kProfSections; ++q) g_prof[blockIdx.x][q] = prof_acc[q];
#else
#define PROF_INIT()
#define PROF_MARK(i)
#define PROF_STORE()
#endif

// -- the kernel -------------------------------------------------------------

// kResident: the slice lives in dynamic shared memory; otherwise it is
// streamed in place from At (a panel too tall for shared memory).
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
panel_qr_kernel(T* __restrict__ at, T* __restrict__ alpha_out,
                float* __restrict__ scratch, unsigned* __restrict__ bar,
                int m, int nb, int off, Grid g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sh_w[kMaxWidth];
  __shared__ T sh_red[kMergeGroups][kMaxWidth];
  __shared__ T sh_alpha;
  __shared__ float sh_f;
  __shared__ float sh_s[kWarps], sh_e[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x, ctas = gridDim.x;
  const int row0 = off + cta * g.rows;
  const int nrows = min(g.rows, m - row0);
  const long long slot = slot_floats<T>(nb);
  const long long half = parity_floats<T>(ctas, nb);
  // The slice: row r of column k at S[k * ld + r].
  T* S = kResident ? reinterpret_cast<T*>(smem_raw) : at + row0;
  const int ld = kResident ? g.rows : m;

  if constexpr (kResident) {  // load the slice of every column once
    for (int k = 0; k < nb; ++k)
      for (int r = tid; r < nrows; r += kThreads)
        S[k * ld + r] = at[static_cast<size_t>(k) * m + row0 + r];
    __syncthreads();
  }

  unsigned barriers = 0;
  PROF_INIT();
  // Step jl: merge column jl's partials (jl >= 0), apply its reflector to
  // this slice, and publish column jl+1's partials (jl + 1 < nb).
  for (int jl = -1; jl < nb; ++jl) {
    const bool apply = jl >= 0, next = jl + 1 < nb;
    const int j = off + jl, jn = j + 1;

    if (apply) {  // -- merge, in the same order on every CTA
      // Thread (grp, kk) sums column k = jl+1+kk over CTA group grp; the
      // last warp merges the norm. Every load is issued before its use.
      const float* part = scratch + (jl & 1) * half;
      const T* rowj = reinterpret_cast<const T*>(part + ctas * slot);
      const int kk = tid % kMaxWidth, grp = tid / kMaxWidth, k = jl + 1 + kk;
      const bool live = k < nb;
      const int cbeg = grp * ctas / kMergeGroups;
      const int cend = (grp + 1) * ctas / kMergeGroups;
      const T yj = live && grp == 0 ? __ldcg(rowj + k) : zero<T>();
      const bool norm_warp = warp == kWarps - 1;
      float ns[kNormPerLane], ne[kNormPerLane];
      T a_jj = zero<T>();
      if (norm_warp) {
        const int cb = lane * ctas / 32, ce = (lane + 1) * ctas / 32;
#pragma unroll
        for (int u = 0; u < kNormPerLane; ++u) {
          ns[u] = cb + u < ce ? __ldcg(part + (cb + u) * slot) : 0.f;
          ne[u] = cb + u < ce ? __ldcg(part + (cb + u) * slot + 1) : 0.f;
        }
        if (lane == 0) a_jj = __ldcg(rowj + jl);
      }
      constexpr int kBatch = kMergeBatch * sizeof(float) / sizeof(T);
      T d = zero<T>();
      for (int c0 = cbeg; c0 < cend; c0 += kBatch) {
        T vals[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          vals[u] = live && c0 + u < cend
              ? __ldcg(reinterpret_cast<const T*>(part + (c0 + u) * slot + 2) + k)
              : zero<T>();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) d = add(d, vals[u]);
      }
      sh_red[grp][kk] = d;
      if (norm_warp) {
        float s = 0.f, err = 0.f;
#pragma unroll
        for (int u = 0; u < kNormPerLane; ++u) comp_merge(s, err, ns[u], ne[u]);
        warp_comp_merge(s, err);
        if (lane == 0) {
          const float sn = __fsqrt_rn(__fadd_rn(s, err));
          float mag;
          const T alpha = make_alpha(sn, a_jj, mag);
          sh_alpha = alpha;
          sh_f = inv_scale(sn, mag);
          if (cta == 0) alpha_out[jl] = alpha;
        }
      }
      __syncthreads();
      if (grp == 0 && live) {
        T dsum = sh_red[0][kk];
#pragma unroll
        for (int g2 = 1; g2 < kMergeGroups; ++g2) dsum = add(dsum, sh_red[g2][kk]);
        sh_w[k] = w_coef(dsum, sh_alpha, yj, sh_f);
      }
      __syncthreads();
    }
    PROF_MARK(0);

    float* part_n = scratch + ((jl + 1) & 1) * half;  // column jl+1's half
    T* rowj_n = reinterpret_cast<T*>(part_n + ctas * slot);
    T* Sv = S + (apply ? jl : 0) * ld;  // column jl   (read when apply)
    T* Sx = S + (jl + 1) * ld;          // column jl+1 (read when next)
    const T alpha = apply ? sh_alpha : zero<T>();
    const float f = apply ? sh_f : 0.f;

    // -- v over column jl; update column jl+1 and its compensated norm
    const T w1 = apply && next ? sh_w[jl + 1] : zero<T>();
    float s = 0.f, err = 0.f;
    for (int r = tid; r < nrows; r += kThreads) {
      const int i = row0 + r;
      T v = zero<T>();
      if (apply && i >= j) {
        v = i == j ? pivot(Sv[r], alpha, f) : scale(Sv[r], f);
        Sv[r] = v;
      }
      if (next) {
        T x = Sx[r];
        if (apply && i >= j) {
          x = sub_scaled(x, w1, v);
          Sx[r] = x;
        }
        if (i >= jn) acc_sq(s, err, x);
        if (i == jn) __stcg(rowj_n + jl + 1, x);
      }
    }
    if (!next) break;  // last column: v is written, nothing trails it
    warp_comp_merge(s, err);
    if (lane == 0) {
      sh_s[warp] = s;
      sh_e[warp] = err;
    }
    __syncthreads();  // also publishes v and column jl+1 to every warp
    PROF_MARK(1);
    if (warp == 0) {
      s = lane < kWarps ? sh_s[lane] : 0.f;
      err = lane < kWarps ? sh_e[lane] : 0.f;
      warp_comp_merge(s, err);
      if (lane == 0) {
        __stcg(part_n + cta * slot, s);
        __stcg(part_n + cta * slot + 1, err);
      }
    }

    // -- each warp: y -= W v on its trailing columns, dotted with column jl+1
    T* dots_n = reinterpret_cast<T*>(part_n + cta * slot + 2);
    const int kbase = jl + 2 + warp;
    T wq[kColsPerWarp], dq[kColsPerWarp];
#pragma unroll
    for (int q = 0; q < kColsPerWarp; ++q) {
      const int k = kbase + q * kWarps;
      wq[q] = apply && k < nb ? sh_w[k] : zero<T>();
      dq[q] = zero<T>();
    }
    for (int r = lane; r < nrows; r += 32) {
      const int i = row0 + r;
      const bool upd = apply && i >= j;
      const T v = upd ? Sv[r] : zero<T>();
      const T x = Sx[r];
#pragma unroll
      for (int q = 0; q < kColsPerWarp; ++q) {
        const int k = kbase + q * kWarps;
        if (k < nb) {
          T y = S[k * ld + r];
          if (upd) {
            y = sub_scaled(y, wq[q], v);
            S[k * ld + r] = y;
          }
          if (i >= jn) acc_dot(dq[q], x, y);
          if (i == jn) __stcg(rowj_n + k, y);
        }
      }
    }
    halve<4>(dq, lane);
    halve<2>(dq, lane);
    halve<1>(dq, lane);
    T d = add(dq[0], shfl_xor(dq[0], 2));
    d = add(d, shfl_xor(d, 1));
    if ((lane & 3) == 0 && kbase + (lane >> 2) * kWarps < nb)
      __stcg(dots_n + kbase + (lane >> 2) * kWarps, d);
    PROF_MARK(2);
    grid_barrier(bar, ++barriers * static_cast<unsigned>(ctas));
    PROF_MARK(3);
  }
  __syncthreads();
  PROF_STORE();

  if constexpr (kResident) {  // write the slice back once
    for (int k = 0; k < nb; ++k)
      for (int r = tid; r < nrows; r += kThreads)
        at[static_cast<size_t>(k) * m + row0 + r] = S[k * ld + r];
  }
}

template <typename T>
const void* kernel_for(bool resident) {
  return resident ? reinterpret_cast<const void*>(panel_qr_kernel<T, true>)
                  : reinterpret_cast<const void*>(panel_qr_kernel<T, false>);
}

// A panel the kernel cannot take: width, offset, or int32 element indices.
bool bad_shape(int m, int nb, int off) {
  return nb < 1 || nb > kMaxWidth || m < nb || off < 0 || off > m - nb ||
         static_cast<long long>(m) * nb >= (1LL << 31);
}

// A grid that does not cut the active rows into g.ctas non-empty slices of
// at most g.rows rows, on at most one CTA per SM.
bool bad_grid(Grid g, int active, int sms) {
  return g.ctas < 1 || g.ctas > kMaxCtas || g.ctas > sms || g.rows < 1 ||
         static_cast<long long>(g.ctas - 1) * g.rows >= active ||
         static_cast<long long>(g.ctas) * g.rows < active;
}

// Check the caller's plan for panel_qr_kernel<T, resident> on the current
// device: its dynamic shared memory, whether the card takes it, and the
// kernel's attributes.
template <typename T>
cudaError_t check(int m, int nb, int off, Grid g, bool resident,
                  size_t* bytes, cudaFuncAttributes* fa, int* per_sm) {
  if (bad_shape(m, nb, off)) return cudaErrorInvalidValue;
  const void* fn = kernel_for<T>(resident);
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(fa, fn);
  if (err != cudaSuccess) return err;
  if (bad_grid(g, m - off, sms)) return cudaErrorInvalidValue;
  *bytes = resident ? static_cast<size_t>(g.rows) * nb * sizeof(T) : 0;
  if (*bytes + fa->sharedSizeBytes > static_cast<size_t>(optin))
    return cudaErrorInvalidValue;  // the slice does not fit on chip
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads,
                                                        *bytes);
  if (err != cudaSuccess) return err;
  if (!coop || *per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

template <typename T>
int launch(void* at, void* alpha, void* scratch, long long scratch_floats,
           void* bar, int m, int nb, int off, int ctas, int rows,
           int resident, void* stream) {
  Grid g{ctas, rows};
  size_t bytes = 0;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = check<T>(m, nb, off, g, resident, &bytes, &fa, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scratch_floats < 2 * parity_floats<T>(g.ctas, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  T* at_t = static_cast<T*>(at);
  T* alpha_t = static_cast<T*>(alpha);
  float* scratch_f = static_cast<float*>(scratch);
  unsigned* bar_u = static_cast<unsigned*>(bar);
  void* args[] = {&at_t, &alpha_t, &scratch_f, &bar_u, &m, &nb, &off, &g};
  err = cudaLaunchCooperativeKernel(kernel_for<T>(resident), dim3(g.ctas),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int m, int nb, int off, int ctas, int rows, int resident, int* out) {
  size_t bytes = 0;
  cudaFuncAttributes fa{};
  int per_sm = 0;
  const cudaError_t err = check<T>(m, nb, off, Grid{ctas, rows}, resident,
                                   &bytes, &fa, &per_sm);
  out[0] = static_cast<int>(bytes);
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = fa.numRegs;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launchers: raw device pointers, the scratch (its length in floats) and
// the zeroed barrier counter, the panel, the caller's grid (CTAs, rows per
// CTA, and 1 for the slice resident in shared memory, 0 for streamed), and
// the stream; each returns the cudaError_t of the launch (0 = cudaSuccess).
int dhqr_panel_qr_f32(void* at, void* alpha, void* scratch,
                      long long scratch_floats, void* bar, int m, int nb,
                      int off, int ctas, int rows, int resident,
                      void* stream) {
  return launch<float>(at, alpha, scratch, scratch_floats, bar, m, nb, off,
                       ctas, rows, resident, stream);
}

int dhqr_panel_qr_c64(void* at, void* alpha, void* scratch,
                      long long scratch_floats, void* bar, int m, int nb,
                      int off, int ctas, int rows, int resident,
                      void* stream) {
  return launch<float2>(at, alpha, scratch, scratch_floats, bar, m, nb, off,
                        ctas, rows, resident, stream);
}

// Floats of scratch a launch of ``ctas`` CTAs on an nb-wide panel needs.
long long dhqr_panel_qr_scratch_floats(int complex64, int ctas, int nb) {
  return complex64 ? 2 * parity_floats<float2>(ctas, nb)
                   : 2 * parity_floats<float>(ctas, nb);
}

// What a launch with the same arguments would get on the current device, in
// out[5]: dynamic and static shared bytes per CTA, registers per thread,
// local (spill) bytes per thread, resident CTAs per SM. Returns the
// cudaError_t the launch would meet before it runs.
int dhqr_panel_qr_info(int complex64, int m, int nb, int off, int ctas,
                       int rows, int resident, int* out) {
  return complex64 ? info<float2>(m, nb, off, ctas, rows, resident, out)
                   : info<float>(m, nb, off, ctas, rows, resident, out);
}

#ifdef DHQR_PANEL_PROFILE
// Cycles per section of the last launch, for each of its first ``ctas``
// CTAs: out[cta * 4 + section].
int dhqr_panel_qr_profile(unsigned long long* out, int ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_prof, sizeof(unsigned long long) * kProfSections * ctas));
}
#endif

const char* dhqr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
