// Hopper panel factorization kernels for dhqr_tpu_torch (sm_90a).
//
// Replaces the two Pallas TPU kernels of dhqr_tpu/ops/pallas_panel.py:
//   K1  _panel_kernel      (float32;   reached from _panel_qr_pallas_jit)
//   K2  _panel_kernel_c64  (complex64; same entry, planar re/im planes)
// with _sumsq_compensated inlined in both, and adds a third that replaces
// no TPU kernel (the JAX package's float64 panels are plain XLA ops):
//   panel_qr_f64           (float64)
// One templated body serves all three (T = float, float2 for PyTorch's
// interleaved complex64, or double); the norm's compensated pair, f and the
// scratch's words are T's real type (Real<T>: float, or double). Each launch
// factors one (m, nb) panel in place where it lies: element (row r, column
// k) at a[r * rs + k * cs] (Layout, both strides 64-bit). The wrapper's
// transposed buffer At (nb, m), one panel column per row of m contiguous
// elements, is rs = 1, cs = m; a view of the row-major matrix H (n columns)
// is rs = n, cs = 1, which the blocked engine factors in place. The
// reflector of local column jl starts at row j = off + jl (rows above off
// hold R entries of earlier panels; they are never loaded and stay bit for
// bit; columns outside the panel are never touched). Written below for
// At, the arithmetic being the same in either layout. Per column:
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
// float64 runs on the CUDA cores' FP64 units at half FP32's rate (34
// TFLOP/s) and moves twice f32's bytes; the step is latency-bound as the
// f32 one is (a few us per column against ~0.1 us of operations at
// 4400 x 128), so the slower arithmetic barely shows: its slices take c64's
// bytes with one value per element, and so c64's register and shared-memory
// capacity.
//
// What this design does about it: the panel is spread over the whole card
// and kept on chip. One persistent cooperative grid, at most one CTA per SM
// (at least 32 rows per CTA, so a short panel takes a few CTAs), splits the
// active rows [off, m) into contiguous slices. Each CTA loads its slice of
// all nb columns once, keeps it on chip for the whole panel and writes it
// back once at the end, so HBM sees the panel's bytes once each way (with
// the column fastest across the threads where the rows are contiguous, cs
// == 1, so that a warp moves whole rows: 128 B at nb = 32 f32). Where
// it keeps the slice is the variant, chosen by the slice's size (Python
// plans it: ops/hopper_panel.kernel_variant; the launcher's int):
//   * registers (2), where the slice fits 64 floats per thread (48 in the
//     float64 one-column kernel, register_floats): warp w owns
//     the contiguous rows [w R, (w + 1) R), R = ceil(rows / 16) rounded up
//     to 4, and lane c of every warp columns c, c + 32, ... of them, in
//     registers from load to write-back (staged through shared memory both
//     ways for coalesced loads and stores). 131072 x 32 f32 (the tall
//     lstsq's leaf): 993 rows per CTA, 64 x 1 per thread; 16384 x 128: 125
//     rows, 8 x 4; 8192 x 128 c64: 63 rows, 4 x 4 x 2; 16384 x 128 capped
//     at 66 CTAs: 249 rows, 16 x 4; 65536 x 64: 497 rows, 32 x 2.
//   * shared (1), a taller slice that fits dynamic shared memory (100000 x
//     64 f32: 758 rows x 256 B): all 512 threads walk the slice there.
//   * streamed (0), a slice too tall for shared memory: the same body with
//     the slice left in place in At, each column step reading and writing
//     the CTA's trailing rows through L2/HBM (65536 x 128 f32, 524288 x 16).
//     It walks whole columns on every step, so it takes contiguous columns
//     only (rs = 1); the launcher refuses any other layout for it.
// Per column there is ONE grid barrier: before it, each CTA publishes to a
// global scratch slot its compensated (s, err) over its rows >= j and its
// partial dots <x, At[k]> for every trailing column k, and the CTA owning
// row j publishes that row; after it, every CTA merges all slots in the
// same fixed CTA order (TwoSum for the norm), so every CTA derives
// bit-identical alpha, f and W, and applies v and y -= W v to its own rows.
// The rank-1 update of column jl and the partial dots of column jl+1 share
// one pass over the slice: in the shared and streamed variants the column
// jl+1 is updated first by all threads, then each warp updates 8 trailing
// columns over every row of the slice and dots them with it, and a shuffle
// tree sums each column's dots over the warp's lanes. In the register
// variant the owner lane of column jl+1 writes it to a per-warp row of
// shared memory, the warp's lanes (a row or two each) form v, the updated
// column jl+1 and its norm and write both to the staging copy (which so
// holds each finished column for the write-back), and then every lane
// runs one pass over its warp's rows from registers, v and x read four
// rows at a time from the warp's broadcast rows: y -= W v on each column it
// owns and <x, y> summed in its own registers, then one sum per column over
// the 16 warps in warp order. The scratch is double-buffered by column
// parity: a CTA that is one column ahead writes the other half.
// Co-residency of the grid, which the barrier needs, comes from
// cudaLaunchCooperativeKernel: a grid that cannot be resident is a launch
// error, never a hang. The grid is planned on the Python side
// (ops/hopper_panel: kernel_grid for the row partition, kernel_variant for
// the variant, kernel_flat_width for the leaf widths the blocked engine
// asks for); the launcher only checks the plan it is given (partition, SM
// count, register and shared-memory fit, occupancy) and returns
// cudaErrorInvalidValue for one it cannot run. The scratch layout is this
// file's alone: dhqr_panel_qr_scratch_floats sizes it for the wrapper.
//
// What is left: the steps stay serial, and each pays a grid barrier and a
// merge in which every CTA reads every CTA's partials (ctas^2 x nb words
// of L2 reads per column, 8.9 MB at 132 CTAs and nb = 128). On an H100
// 80GB HBM3 at 700 W, SM clock 1980 MHz (chip_smoke.py phase 7, panel_ab.py
// --sections), cycles per column, merge / column pass / trailing or
// register pass / barrier (the register variant stages the next column
// inside the barrier's wait):
//   131072 x 32 f32, registers  4712 / 1168 / 2132 / 2498 = 10511 (5.3 us)
//                    shared     3875 / 1332 / 14337 / 2342 = 21885
//   16384 x 128 f32, registers  4923 / 1020 / 1084 / 2618 = 9645 (4.9 us)
//                    shared     4119 / 990 / 3864 / 2091 = 11065
// so the merge is now the largest section, and in the register variant
// it reads ~800 cycles (c64 ~1300) more than the same code in the shared
// one, the slice holding 64 of each thread's 128 registers. Pre-reducing
// the partials inside thread-block clusters was tried and did not resolve:
// on the 4400 x 4000 float64 solve, 3,405.0 -> 3,485.7 GFLOP/s (+2.4%,
// 5 of 6 pairs won) and the f64 panel's roofline share 0.248 -> 0.270%;
// what is left per column is a fixed chain of latency (barrier, L2 round
// trips, divide and square root) that needs a larger redesign. The streamed
// variant pays a pass over its trailing rows through L2/HBM per column
// (524288 x 16: 88k of 110k cycles); the blocked engine gives it only the
// narrowest leaf (16 columns), past the heights where any leaf's slices
// fit shared memory (~462k rows f32, ~231k c64 on an H100).
//
// Hazards handled:
//   * nvcc contracts a*b+c into an FMA by default, which would break a
//     Veltkamp split. The squares use the exact two-product instead,
//     p = x*x, e = fmaf(x, x, -p) (exact on Hopper), and every TwoSum step is
//     spelled with __fadd_rn/__fsub_rn/__fmul_rn so nothing is contracted.
//     float64 has no wider type to square in, so its pair is the same
//     two-product in doubles, e = fma(x, x, -p), accumulated by the same
//     TwoSum spelled with __dadd_rn/__dsub_rn/__dmul_rn.
//   * 1/sqrt uses the correctly rounded __fdiv_rn/__fsqrt_rn (float64:
//     __ddiv_rn/__dsqrt_rn), not rsqrt.
//   * Cross-CTA data: scratch is written with __stcg and read with __ldcg
//     (L2, never a stale L1 line); the barrier is a device-scope
//     release/acquire counter that the wrapper zeroes before each launch.
//     A streamed slice is touched by its own CTA only, so __syncthreads
//     orders it as it orders shared memory.
//   * Determinism: merges run in a fixed order whose float additions are
//     the same on every CTA (and commutative where lanes swap operands), so
//     two launches on the same input give bit-identical results.
//   * Indices: the panel's height and offset, each CTA's first row and
//     both strides (a streamed slice's column stride is the height) are
//     64-bit, so a panel
//     past 2^31 elements or 2^31 rows (8.6 GB of f32: it fits the card)
//     runs like any other. A CTA's own rows, the column index and the
//     resident slice's offsets stay 32-bit (a CTA holds at most
//     ceil(m / 132) rows), and rows are compared with the pivot in the
//     slice's own 32-bit coordinates, so the row loops gain no 64-bit
//     arithmetic beyond the streamed slice's column offsets.
//   * Each launcher returns the launch's error (cudaGetLastError()).
//
// Built with -DDHQR_PANEL_PROFILE, thread 0 of each CTA also counts the SM
// cycles of four sections of every column step (merge, column pass,
// trailing pass, grid barrier; in the register variant the column pass is
// the lanes' pass over columns jl and jl+1, the trailing pass the one
// register pass with the CTA's sums, and the barrier holds the next
// column's staging); ops/hopper_panel.kernel_section_cycles reads them.
// The default build has no timers.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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
// The register variant: slice floats one thread holds (rows x columns x
// floats per element), and so the floats of each warp's broadcast row.
constexpr int kRegFloats = 64;

// Where a CTA keeps its slice; the launchers' int names it.
enum Variant : int { kStreamed = 0, kShared = 1, kRegisters = 2 };

struct Grid {
  int ctas;  // CTAs in the launch
  int rows;  // rows per CTA (the last CTA may hold fewer)
};

// Where the panel's elements lie: (row r, column k) at a[r * rs + k * cs].
struct Layout {
  long long rs;  // row stride: 1 in the transposed buffer, n in a view of H
  long long cs;  // column stride: m in the transposed buffer, 1 in a view of H
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The real type of an element: the word of the norm's compensated pair, of
// f and of the scratch (float for float and float2, double for double).
template <typename T> struct RealOf { using type = float; };
template <> struct RealOf<double> { using type = double; };
template <typename T> using Real = typename RealOf<T>::type;

// The register variant's split of a CTA's slice: lane c of every warp owns
// columns c, c + 32, ... (cols_per_lane of them: 1, 2 or 4, one kernel
// each), warp w the contiguous rows [w * R, (w + 1) * R) with R = warp_rows
// (a multiple of 4, so the warp's broadcast rows load four at a time).
__host__ __device__ constexpr int cols_per_lane(int nb) {
  return nb <= 32 ? 1 : nb <= 64 ? 2 : 4;
}
__host__ __device__ constexpr int warp_rows(int rows) {
  return (ceil_div(rows, kWarps) + 3) & ~3;
}
// The slice floats per thread of the kernel with ``cols`` columns per
// lane: kRegFloats, but 48 (24 rows) in the float64 one-column kernel,
// whose 32 rows of doubles spill 96 bytes (ptxas, sm_90a; 48 spill none).
template <typename T>
__host__ __device__ constexpr int register_floats(int cols) {
  return std::is_same<T, double>::value && cols == 1 ? 48 : kRegFloats;
}
template <typename T>
__host__ __device__ constexpr bool fits_registers(int rows, int nb) {
  return warp_rows(rows) * cols_per_lane(nb) *
             static_cast<int>(sizeof(T) / sizeof(float)) <=
         register_floats<T>(cols_per_lane(nb));
}
// Its dynamic shared memory: the slice's staging copy (column stride
// rows | 1, odd, so lane c reading S[c * ld + r] hits 32 banks), each
// warp's two broadcast rows (v, x) and the warps' partial dots.
__host__ __device__ constexpr int register_ld(int rows) { return rows | 1; }
template <typename T>
__host__ __device__ constexpr size_t register_smem_staging(int rows, int nb) {
  return (static_cast<size_t>(nb) * register_ld(rows) * sizeof(T) + 15) & ~size_t{15};
}
template <typename T>
__host__ __device__ constexpr size_t register_smem_bytes(int rows, int nb) {
  return register_smem_staging<T>(rows, nb) +
         static_cast<size_t>(kWarps) * 2 * kRegFloats * sizeof(float) +
         static_cast<size_t>(kWarps) * nb * sizeof(T);
}

// Scratch, in words of Real<T>: per column parity, one slot per CTA ((s,
// err) and the nb partial dots) and the pivot row's nb entries.
template <typename T>
__host__ __device__ long long slot_words(int nb) {
  return 2 + static_cast<long long>(nb) * (sizeof(T) / sizeof(Real<T>));
}
template <typename T>
__host__ __device__ long long parity_words(int ctas, int nb) {
  return ctas * slot_words<T>(nb) + nb * (sizeof(T) / sizeof(Real<T>));
}
// The whole scratch (both parities) in floats, the unit the wrapper sizes.
template <typename T>
long long scratch_floats_for(int ctas, int nb) {
  return 2 * parity_words<T>(ctas, nb) *
         static_cast<long long>(sizeof(Real<T>) / sizeof(float));
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

// The same three in doubles (float64 panels).
__device__ __forceinline__ void two_sum_acc(double& s, double& err, double x) {
  const double t = __dadd_rn(s, x);
  const double z = __dsub_rn(t, s);
  const double c = __dadd_rn(__dsub_rn(s, __dsub_rn(t, z)), __dsub_rn(x, z));
  s = t;
  err = __dadd_rn(err, c);
}

__device__ __forceinline__ void acc_square(double& s, double& err, double x) {
  const double p = __dmul_rn(x, x);
  const double e = fma(x, x, -p);
  two_sum_acc(s, err, p);
  err = __dadd_rn(err, e);
}

__device__ __forceinline__ void comp_merge(double& s, double& err, double s2,
                                           double e2) {
  two_sum_acc(s, err, s2);
  err = __dadd_rn(err, e2);
}

// (s, err) of one warp, merged into lane 0 in a fixed order.
template <typename R>
__device__ __forceinline__ void warp_comp_merge(R& s, R& err) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const R s2 = __shfl_down_sync(0xffffffffu, s, o);
    const R e2 = __shfl_down_sync(0xffffffffu, err, o);
    comp_merge(s, err, s2, e2);
  }
}

__device__ __forceinline__ float inv_scale(float sn, float mag) {
  const float denom = __fmul_rn(sn, __fadd_rn(sn, mag));
  return denom > 0.f ? __fdiv_rn(1.f, __fsqrt_rn(denom)) : 0.f;
}
__device__ __forceinline__ double inv_scale(double sn, double mag) {
  const double denom = __dmul_rn(sn, __dadd_rn(sn, mag));
  return denom > 0.0 ? __ddiv_rn(1.0, __dsqrt_rn(denom)) : 0.0;
}

// sqrt(s + err), the column norm from its compensated pair.
__device__ __forceinline__ float comp_sqrt(float s, float err) {
  return __fsqrt_rn(__fadd_rn(s, err));
}
__device__ __forceinline__ double comp_sqrt(double s, double err) {
  return __dsqrt_rn(__dadd_rn(s, err));
}

// -- element operations, real and complex -----------------------------------

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float shfl_xor(float a, int o) {
  return __shfl_xor_sync(0xffffffffu, a, o);
}
__device__ __forceinline__ float2 shfl_xor(float2 a, int o) {
  return make_float2(__shfl_xor_sync(0xffffffffu, a.x, o),
                     __shfl_xor_sync(0xffffffffu, a.y, o));
}
__device__ __forceinline__ double shfl_xor(double a, int o) {
  return __shfl_xor_sync(0xffffffffu, a, o);
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

// Four consecutive elements through one or two 16-byte accesses.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const float2* p, float2 (&v)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = make_float2(a.x, a.y); v[1] = make_float2(a.z, a.w);
  v[2] = make_float2(b.x, b.y); v[3] = make_float2(b.z, b.w);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(float2* p, const float2 (&v)[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[2].x, v[2].y, v[3].x, v[3].y);
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// (s, err) += |x|^2
__device__ __forceinline__ void acc_sq(float& s, float& err, float x) {
  acc_square(s, err, x);
}
__device__ __forceinline__ void acc_sq(float& s, float& err, float2 x) {
  acc_square(s, err, x.x);
  acc_square(s, err, x.y);
}
__device__ __forceinline__ void acc_sq(double& s, double& err, double x) {
  acc_square(s, err, x);
}

// d += conj(x) y
__device__ __forceinline__ void acc_dot(float& d, float x, float y) {
  d = fmaf(y, x, d);
}
__device__ __forceinline__ void acc_dot(float2& d, float2 x, float2 y) {
  d.x = fmaf(y.x, x.x, fmaf(y.y, x.y, d.x));
  d.y = fmaf(y.y, x.x, fmaf(-y.x, x.y, d.y));
}
__device__ __forceinline__ void acc_dot(double& d, double x, double y) {
  d = fma(y, x, d);
}

// y - w v
__device__ __forceinline__ float sub_scaled(float y, float w, float v) {
  return fmaf(-w, v, y);
}
__device__ __forceinline__ float2 sub_scaled(float2 y, float2 w, float2 v) {
  return make_float2(__fsub_rn(y.x, fmaf(w.x, v.x, -__fmul_rn(w.y, v.y))),
                     __fsub_rn(y.y, fmaf(w.x, v.y, __fmul_rn(w.y, v.x))));
}
__device__ __forceinline__ double sub_scaled(double y, double w, double v) {
  return fma(-w, v, y);
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
__device__ __forceinline__ double scale(double x, double f) { return __dmul_rn(x, f); }
__device__ __forceinline__ double pivot(double x, double alpha, double f) {
  return __dmul_rn(__dsub_rn(x, alpha), f);
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
__device__ __forceinline__ double make_alpha(double sn, double a,
                                             double& mag) {
  mag = fabs(a);
  return a >= 0.0 ? -sn : sn;
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
__device__ __forceinline__ double w_coef(double d, double alpha, double yj,
                                         double f) {
  return __dmul_rn(f, fma(-alpha, yj, d));
}

// -- the grid barrier -------------------------------------------------------

// Every CTA adds one to the counter and waits until it reaches ``target``
// (= ctas x barriers so far); the counter only grows within a launch.
// Between grid_arrive and grid_wait a CTA may work on what no other CTA
// reads before the barrier.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*bar);
    count.fetch_add(1u, cuda::memory_order_release);
  }
}
__device__ __forceinline__ void grid_wait(unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(*bar);
    while (count.load(cuda::memory_order_acquire) < target) {
    }
  }
  __syncthreads();
}
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  grid_arrive(bar);
  grid_wait(bar, target);
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

// -- the merge --------------------------------------------------------------

// Merge column jl's partials from ``part`` (its parity's half of the
// scratch), in the same order on every CTA: alpha and f of column jl, and
// W of every trailing column, into shared memory (alpha_out[jl] from CTA
// 0). Thread (grp, kk) sums column k = jl+1+kk over CTA group grp; the last
// warp merges the norm. Every load is issued before its use.
template <typename T, typename Word = Real<T>>
__device__ __forceinline__ void merge_column(
    const Word* __restrict__ part, long long slot, int jl, int nb,
    T* __restrict__ alpha_out, T* sh_w, T (*sh_red)[kMaxWidth], T& sh_alpha,
    Word& sh_f) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x, ctas = gridDim.x;
  const T* rowj = reinterpret_cast<const T*>(part + ctas * slot);
  const int kk = tid % kMaxWidth, grp = tid / kMaxWidth, k = jl + 1 + kk;
  const bool live = k < nb;
  const int cbeg = grp * ctas / kMergeGroups;
  const int cend = (grp + 1) * ctas / kMergeGroups;
  const T yj = live && grp == 0 ? __ldcg(rowj + k) : zero<T>();
  const bool norm_warp = warp == kWarps - 1;
  Word ns[kNormPerLane], ne[kNormPerLane];
  T a_jj = zero<T>();
  if (norm_warp) {
    const int cb = lane * ctas / 32, ce = (lane + 1) * ctas / 32;
#pragma unroll
    for (int u = 0; u < kNormPerLane; ++u) {
      ns[u] = cb + u < ce ? __ldcg(part + (cb + u) * slot) : Word(0);
      ne[u] = cb + u < ce ? __ldcg(part + (cb + u) * slot + 1) : Word(0);
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
    Word s = 0, err = 0;
#pragma unroll
    for (int u = 0; u < kNormPerLane; ++u) comp_merge(s, err, ns[u], ne[u]);
    warp_comp_merge(s, err);
    if (lane == 0) {
      const Word sn = comp_sqrt(s, err);
      Word mag;
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

// The CTA's compensated norm over the warps' (s, err), merged by the last
// warp in warp order and published to its scratch slot.
template <typename R>
__device__ __forceinline__ void publish_norm(R* __restrict__ slot_p,
                                             const R* sh_s, const R* sh_e) {
  const int lane = threadIdx.x & 31;
  R s = lane < kWarps ? sh_s[lane] : R(0);
  R err = lane < kWarps ? sh_e[lane] : R(0);
  warp_comp_merge(s, err);
  if (lane == 0) {
    __stcg(slot_p, s);
    __stcg(slot_p + 1, err);
  }
}

// -- the slice's one load and one write-back ----------------------------------

// Move the CTA's slice, rows [row0, row0 + nrows) of every column, between
// the panel and its on-chip copy S (row r of column k at S[k * ld + r]):
// from the panel with kLoad, else back to it; each element once. One loop
// nest serves both layouts: the inner index runs along the panel's unit
// stride (the rows of a column where rs == 1, the columns of a row where
// cs == 1) over 2^shift consecutive threads, the outer one over the groups
// of 2^shift threads. Where the columns are contiguous that is every
// thread along a column; where the rows are, a warp (nb <= 32) or two or
// four moves each row, so a warp moves whole rows (128 B at nb = 32 f32).
// The empty asm statements here, and the register variant's before its
// write-back, make the write-back form its indices anew from the launch's
// parameters: otherwise the compiler carries values it shares with the
// load across the column steps, whose 128 registers are full, and a
// register kernel spills (4-88 bytes, ptxas sm_90a) or runs its steps
// slower (c64 8192 x 128 on an H100: 1.29 ms a launch against 0.75).
template <bool kLoad, typename T>
__device__ __forceinline__ void move_slice(T* S, int ld, T* __restrict__ a,
                                           Layout lay, long long row0,
                                           int nrows, int nb) {
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
  asm volatile("" : "+r"(nb), "+r"(nrows), "+r"(ld));
  const bool rows = lay.cs == 1;
  const int inner = rows ? nb : nrows, outer = rows ? nrows : nb;
  const long long step = rows ? lay.rs : lay.cs;  // outer stride in a
  const int s_in = rows ? ld : 1, s_out = rows ? 1 : ld;  // strides in S
  const int shift = rows ? (nb <= 32 ? 5 : nb <= 64 ? 6 : 7) : 9;
  T* base = a + row0 * lay.rs;
  for (int o = tid >> shift; o < outer; o += kThreads >> shift) {
    T* line = base + o * step;
    for (int i = tid & ((1 << shift) - 1); i < inner; i += 1 << shift) {
      if constexpr (kLoad) S[o * s_out + i * s_in] = line[i];
      else line[i] = S[o * s_out + i * s_in];
    }
  }
}

// -- the register variant -----------------------------------------------------

// Column q of row rr of a thread's registers, q picked at run time by an
// unrolled select (a dynamically indexed register array would go to local
// memory).
template <int NC, int N, typename T>
__device__ __forceinline__ T pick(const T (&y)[N], int rr, int q) {
  T v = y[rr * NC];
#pragma unroll
  for (int p = 1; p < NC; ++p)
    if (q == p) v = y[rr * NC + p];
  return v;
}

// One pass over the warp's rows from registers: y -= W v on every column
// this lane owns, and <x, y> summed per column in the lane's own
// registers. v and x come four rows at a time from the warp's broadcast
// rows: v is 0 above the pivot and past the slice, x (column jl+1, already
// updated) 0 at and above it and past the slice. kEdge: the warp holds
// rows at or above the next pivot, so a row is updated only at or past
// the pivot (rows above it are R's and stay bit for bit), and the entries
// of the next pivot row jp (-1 when it is not in the slice) are
// published; off the edge every row takes both.
template <bool kEdge, int NC, int kRows, typename T>
__device__ __forceinline__ void register_pass(
    T (&y)[kRows * NC], T (&dq)[NC], const T (&wq)[NC], const T* bv,
    const T* bx, int R, int wrow, int jr, int jp, int jl, int nb, int lane,
    T* __restrict__ rowj_n) {
#pragma unroll
  for (int rr = 0; rr < kRows; rr += 4) {
    if (rr >= R) break;
    T v4[4], x4[4];
    load4(bv + rr, v4);
    load4(bx + rr, x4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wrow + rr + i;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        T& yy = y[(rr + i) * NC + q];
        if (!kEdge || r >= jr) yy = sub_scaled(yy, wq[q], v4[i]);
        acc_dot(dq[q], x4[i], yy);
        if (kEdge && r == jp) {
          const int k = lane + 32 * q;
          if (k >= jl + 2 && k < nb) __stcg(rowj_n + k, yy);
        }
      }
    }
  }
}

// Column k leaves its owner's registers (lane k % 32, column k / 32 of the
// lane's): the owner writes its warp's rows of it to the warp's broadcast
// row x, four at a time.
template <int NC, int kRows, typename T>
__device__ __forceinline__ void stage_column(const T (&y)[kRows * NC], T* bx,
                                             int k, int R, int lane) {
  if (lane != (k & 31)) return;
  const int q = k >> 5;
#pragma unroll
  for (int rr = 0; rr < kRows; rr += 4) {
    if (rr >= R) break;
    T x4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x4[i] = pick<NC>(y, rr + i, q);
    store4(bx + rr, x4);
  }
}

// The register variant of the kernel's body (NC = columns per lane, 1, 2
// or 4): the CTA's slice is staged through shared memory with coalesced
// loads, moved into registers once, and each column step makes one pass
// over the warp's rows from registers. Columns leave the registers as they
// are reached: the owner of column jl+1 writes it to its warp's broadcast
// row x (during the barrier before the step), the warp's lanes (a row or
// two each) form v over column jl, the updated column jl+1 and its norm,
// and write both into the staging copy, which so holds every finished
// column and is written back at the end. A register of a finished column
// is never read again, so the pass may update it with W = 0.
template <typename T, int NC, typename Word = Real<T>>
__device__ __forceinline__ void register_slice(
    T* __restrict__ a, T* __restrict__ alpha_out, Word* __restrict__ scratch,
    unsigned* __restrict__ bar, long long m, int nb, long long off, Grid g,
    Layout lay, T* sh_w, T (*sh_red)[kMaxWidth], T& sh_alpha, Word& sh_f, Word* sh_s,
    Word* sh_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kEl = sizeof(T) / sizeof(float);
  // most rows per warp
  constexpr int kRows = (register_floats<T>(NC) / kEl / NC) & ~3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x, ctas = gridDim.x;
  const long long row0 = off + static_cast<long long>(cta) * g.rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(g.rows),
                                         m - row0));
  const int first = static_cast<int>(
      min(static_cast<long long>(cta) * g.rows,
          static_cast<long long>(kMaxWidth) + 2));
  const long long slot = slot_words<T>(nb);
  const long long half = parity_words<T>(ctas, nb);
  const int ld = register_ld(g.rows);
  const int R = warp_rows(g.rows), wrow = warp * R;
  T* S = reinterpret_cast<T*>(smem_raw);
  float* bcast = reinterpret_cast<float*>(
      smem_raw + register_smem_staging<T>(g.rows, nb));
  T* bv = reinterpret_cast<T*>(bcast + warp * 2 * kRegFloats);
  T* bx = bv + kRegFloats / kEl;
  T* sh_dot = reinterpret_cast<T*>(bcast + kWarps * 2 * kRegFloats);

  move_slice<true>(S, ld, a, lay, row0, nrows, nb);  // load it once
  __syncthreads();
  T y[kRows * NC];
#pragma unroll
  for (int i = 0; i < kRows * NC; ++i) y[i] = zero<T>();
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (rr >= R) break;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int k = lane + 32 * q, r = wrow + rr;
      if (k < nb && r < nrows) y[rr * NC + q] = S[k * ld + r];
    }
  }

  stage_column<NC, kRows>(y, bx, 0, R, lane);
  __syncwarp();

  unsigned barriers = 0;
  PROF_INIT();
  for (int jl = -1; jl < nb; ++jl) {
    const bool apply = jl >= 0, next = jl + 1 < nb;
    const int jr = min(max(jl - first, -2), nrows);  // see slice_body
    if (apply)
      merge_column<T>(scratch + (jl & 1) * half, slot, jl, nb, alpha_out,
                      sh_w, sh_red, sh_alpha, sh_f);
    PROF_MARK(0);

    Word* part_n = scratch + ((jl + 1) & 1) * half;  // column jl+1's half
    T* rowj_n = reinterpret_cast<T*>(part_n + ctas * slot);
    const T alpha = apply ? sh_alpha : zero<T>();
    const Word f = apply ? sh_f : Word(0);
    const T w1 = apply && next ? sh_w[jl + 1] : zero<T>();

    // -- v over column jl; column jl+1 (staged in bx) updated, its norm;
    // a row or two per lane
    Word s = 0, err = 0;
#pragma unroll
    for (int h = 0; h < kRows; h += 32) {
      const int rr = lane + h, r = wrow + rr;
      if (rr >= R) break;
      T v = zero<T>(), x = zero<T>();
      if (r < nrows) {
        if (apply && r >= jr) {
          const T a = S[jl * ld + r];
          v = r == jr ? pivot(a, alpha, f) : scale(a, f);
          S[jl * ld + r] = v;
        }
        if (next) {
          x = bx[rr];
          if (apply && r >= jr) x = sub_scaled(x, w1, v);
          S[(jl + 1) * ld + r] = x;
          if (r > jr) acc_sq(s, err, x);
          if (r == jr + 1) __stcg(rowj_n + jl + 1, x);
        }
      }
      bv[rr] = v;
      bx[rr] = r > jr ? x : zero<T>();
    }
    if (!next) break;  // last column: v is written, nothing trails it
    warp_comp_merge(s, err);
    if (lane == 0) {
      sh_s[warp] = s;
      sh_e[warp] = err;
    }
    __syncwarp();  // the broadcast rows, to every lane of the warp
    PROF_MARK(1);

    // -- the register pass over the columns past jl+1
    T wq[NC], dq[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int k = lane + 32 * q;
      wq[q] = apply && k >= jl + 2 && k < nb ? sh_w[k] : zero<T>();
      dq[q] = zero<T>();
    }
    const int jp = jr + 1 < nrows ? jr + 1 : -1;
    if (wrow > jr + 1)
      register_pass<false, NC, kRows>(y, dq, wq, bv, bx, R, wrow, jr, jp, jl,
                                      nb, lane, rowj_n);
    else
      register_pass<true, NC, kRows>(y, dq, wq, bv, bx, R, wrow, jr, jp, jl,
                                     nb, lane, rowj_n);

    // -- the CTA's partials: each column's dots summed over the warps in
    // warp order, the norm by the last warp
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int k = lane + 32 * q;
      if (k >= jl + 2 && k < nb) sh_dot[warp * nb + k] = dq[q];
    }
    __syncthreads();
    if (tid >= jl + 2 && tid < nb) {
      T d = sh_dot[tid];
      for (int w = 1; w < kWarps; ++w) d = add(d, sh_dot[w * nb + tid]);
      __stcg(reinterpret_cast<T*>(part_n + cta * slot + 2) + tid, d);
    }
    if (warp == kWarps - 1) publish_norm(part_n + cta * slot, sh_s, sh_e);
    PROF_MARK(2);
    grid_arrive(bar);
    // column jl+2, the next step's x, leaves the registers while the grid
    // gathers
    if (jl + 2 < nb) stage_column<NC, kRows>(y, bx, jl + 2, R, lane);
    grid_wait(bar, ++barriers * static_cast<unsigned>(ctas));
    PROF_MARK(3);
  }
  __syncthreads();
  PROF_STORE();

  // write the slice back once, its rows formed anew from the launch's
  // parameters (see move_slice)
  int cta_w = blockIdx.x;
  asm volatile("" : "+r"(cta_w));
  const long long row0_w = off + static_cast<long long>(cta_w) * g.rows;
  move_slice<false>(S, register_ld(g.rows), a, lay, row0_w,
                    static_cast<int>(min(static_cast<long long>(g.rows),
                                         m - row0_w)), nb);
}

// -- the shared and streamed variants -----------------------------------------

// kResident: the slice lives in dynamic shared memory; otherwise it is
// streamed in place from the panel (a panel too tall for shared memory,
// its columns contiguous: rs = 1).
template <typename T, bool kResident, typename Word = Real<T>>
__device__ __forceinline__ void slice_body(
    T* __restrict__ a, T* __restrict__ alpha_out, Word* __restrict__ scratch,
    unsigned* __restrict__ bar, long long m, int nb, long long off, Grid g,
    Layout lay, T* sh_w, T (*sh_red)[kMaxWidth], T& sh_alpha, Word& sh_f, Word* sh_s,
    Word* sh_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x, ctas = gridDim.x;
  const long long row0 = off + static_cast<long long>(cta) * g.rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(g.rows),
                                         m - row0));
  // The slice's first row counted from the panel's first active row, capped
  // where it no longer matters (every pivot row off + jl then lies above).
  const int first = static_cast<int>(
      min(static_cast<long long>(cta) * g.rows,
          static_cast<long long>(kMaxWidth) + 2));
  const long long slot = slot_words<T>(nb);
  const long long half = parity_words<T>(ctas, nb);
  // The slice: row r of column k at S[k * ld + r]; a streamed slice's
  // column stride is the panel's (at least its height), so its offsets are
  // 64-bit.
  using Index = std::conditional_t<kResident, int, long long>;
  T* S = kResident ? reinterpret_cast<T*>(smem_raw) : a + row0;
  const Index ld = kResident ? static_cast<Index>(g.rows)
                             : static_cast<Index>(lay.cs);

  if constexpr (kResident) {  // load the slice of every column once
    move_slice<true>(S, static_cast<int>(ld), a, lay, row0, nrows, nb);
    __syncthreads();
  }

  unsigned barriers = 0;
  PROF_INIT();
  // Step jl: merge column jl's partials (jl >= 0), apply its reflector to
  // this slice, and publish column jl+1's partials (jl + 1 < nb).
  for (int jl = -1; jl < nb; ++jl) {
    const bool apply = jl >= 0, next = jl + 1 < nb;
    // The pivot row off + jl as a row of this slice, clamped into
    // [-2, nrows]: row r is at or past the pivot when r >= jr, the pivot
    // when r == jr, past it when r > jr, the next pivot when r == jr + 1.
    const int jr = min(max(jl - first, -2), nrows);

    if (apply)
      merge_column<T>(scratch + (jl & 1) * half, slot, jl, nb, alpha_out,
                      sh_w, sh_red, sh_alpha, sh_f);
    PROF_MARK(0);

    Word* part_n = scratch + ((jl + 1) & 1) * half;  // column jl+1's half
    T* rowj_n = reinterpret_cast<T*>(part_n + ctas * slot);
    T* Sv = S + static_cast<Index>(apply ? jl : 0) * ld;  // column jl
    T* Sx = S + static_cast<Index>(jl + 1) * ld;  // column jl+1 (if next)
    const T alpha = apply ? sh_alpha : zero<T>();
    const Word f = apply ? sh_f : Word(0);

    // -- v over column jl; update column jl+1 and its compensated norm
    const T w1 = apply && next ? sh_w[jl + 1] : zero<T>();
    Word s = 0, err = 0;
    for (int r = tid; r < nrows; r += kThreads) {
      T v = zero<T>();
      if (apply && r >= jr) {
        v = r == jr ? pivot(Sv[r], alpha, f) : scale(Sv[r], f);
        Sv[r] = v;
      }
      if (next) {
        T x = Sx[r];
        if (apply && r >= jr) {
          x = sub_scaled(x, w1, v);
          Sx[r] = x;
        }
        if (r > jr) acc_sq(s, err, x);
        if (r == jr + 1) __stcg(rowj_n + jl + 1, x);
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
    if (warp == 0) publish_norm(part_n + cta * slot, sh_s, sh_e);

    // -- each warp: y -= W v on its trailing columns, dotted with column jl+1
    T* dots_n = reinterpret_cast<T*>(part_n + cta * slot + 2);
    const int kbase = jl + 2 + warp;
    T wq[kColsPerWarp], dq[kColsPerWarp];
    // A streamed slice's columns lie 64-bit strides apart: each trailing
    // column's base is formed once per step, so a row adds only its r.
    T* col[kColsPerWarp];
#pragma unroll
    for (int q = 0; q < kColsPerWarp; ++q) {
      const int k = kbase + q * kWarps;
      wq[q] = apply && k < nb ? sh_w[k] : zero<T>();
      dq[q] = zero<T>();
      col[q] = S + static_cast<Index>(k) * ld;
    }
    for (int r = lane; r < nrows; r += 32) {
      const bool upd = apply && r >= jr;
      const T v = upd ? Sv[r] : zero<T>();
      const T x = Sx[r];
#pragma unroll
      for (int q = 0; q < kColsPerWarp; ++q) {
        const int k = kbase + q * kWarps;
        if (k < nb) {
          T* yp = kResident ? S + (k * ld + r) : col[q] + r;
          T y = *yp;
          if (upd) {
            y = sub_scaled(y, wq[q], v);
            *yp = y;
          }
          if (r > jr) acc_dot(dq[q], x, y);
          if (r == jr + 1) __stcg(rowj_n + k, y);
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

  if constexpr (kResident)  // write the slice back once
    move_slice<false>(S, static_cast<int>(ld), a, lay, row0, nrows, nb);
}

// -- the kernel -------------------------------------------------------------

// One body per variant (kVariant: a Variant); the register variant has a
// kernel per column count per lane (kCols: 1, 2 or 4; 0 for the others),
// each allocating the registers of its own body alone.
template <typename T, int kVariant, int kCols>
__global__ void __launch_bounds__(kThreads, 1)
panel_qr_kernel(T* __restrict__ a, T* __restrict__ alpha_out,
                Real<T>* __restrict__ scratch, unsigned* __restrict__ bar,
                long long m, int nb, long long off, Grid g, Layout lay) {
  __shared__ T sh_w[kMaxWidth];
  __shared__ T sh_red[kMergeGroups][kMaxWidth];
  __shared__ T sh_alpha;
  __shared__ Real<T> sh_f;
  __shared__ Real<T> sh_s[kWarps], sh_e[kWarps];
  if constexpr (kVariant == kRegisters) {
    register_slice<T, kCols>(a, alpha_out, scratch, bar, m, nb, off, g, lay,
                             sh_w, sh_red, sh_alpha, sh_f, sh_s, sh_e);
  } else {
    slice_body<T, kVariant == kShared>(a, alpha_out, scratch, bar, m, nb,
                                       off, g, lay, sh_w, sh_red, sh_alpha,
                                       sh_f, sh_s, sh_e);
  }
}

template <typename T>
const void* kernel_for(int variant, int nb) {
  if (variant == kRegisters) {
    switch (cols_per_lane(nb)) {
      case 1:
        return reinterpret_cast<const void*>(panel_qr_kernel<T, kRegisters, 1>);
      case 2:
        return reinterpret_cast<const void*>(panel_qr_kernel<T, kRegisters, 2>);
      default:
        return reinterpret_cast<const void*>(panel_qr_kernel<T, kRegisters, 4>);
    }
  }
  return variant == kShared
             ? reinterpret_cast<const void*>(panel_qr_kernel<T, kShared, 0>)
             : reinterpret_cast<const void*>(panel_qr_kernel<T, kStreamed, 0>);
}

// A panel the kernel cannot take: its width or its offset. Its height has
// no limit of its own: every index that can pass 2^31 is 64-bit.
bool bad_shape(long long m, int nb, long long off) {
  return nb < 1 || nb > kMaxWidth || m < nb || off < 0 || off > m - nb;
}

// A layout the kernel cannot take: neither the columns (rs == 1, cs >= m)
// nor the rows (cs == 1, rs >= nb) contiguous, or a streamed slice whose
// columns are not (it walks them through L2 and HBM on every column step).
bool bad_layout(long long m, int nb, Layout lay, int variant) {
  const bool columns = lay.rs == 1 && lay.cs >= m;
  const bool rows = lay.cs == 1 && lay.rs >= nb;
  return !(columns || rows) || (variant == kStreamed && lay.rs != 1);
}

// A grid that does not cut the active rows into g.ctas non-empty slices of
// at most g.rows rows, on at most one CTA per SM.
bool bad_grid(Grid g, long long active, int sms) {
  return g.ctas < 1 || g.ctas > kMaxCtas || g.ctas > sms || g.rows < 1 ||
         static_cast<long long>(g.ctas - 1) * g.rows >= active ||
         static_cast<long long>(g.ctas) * g.rows < active;
}

// Check the caller's plan for panel_qr_kernel<T, variant> on the current
// device: a register slice that fits the registers, its dynamic shared
// memory, whether the card takes it, and the kernel's attributes.
template <typename T>
cudaError_t check(long long m, int nb, long long off, Grid g, int variant,
                  size_t* bytes, cudaFuncAttributes* fa, int* per_sm) {
  if (bad_shape(m, nb, off) || variant < kStreamed || variant > kRegisters)
    return cudaErrorInvalidValue;
  const void* fn = kernel_for<T>(variant, nb);
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
  if (variant == kRegisters && !fits_registers<T>(g.rows, nb))
    return cudaErrorInvalidValue;
  *bytes = variant == kRegisters ? register_smem_bytes<T>(g.rows, nb)
           : variant == kShared  ? static_cast<size_t>(g.rows) * nb * sizeof(T)
                                 : 0;
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
int launch(void* a, void* alpha, void* scratch, long long scratch_floats,
           void* bar, long long m, int nb, long long off, long long rs,
           long long cs, int ctas, int rows, int variant, void* stream) {
  Grid g{ctas, rows};
  Layout lay{rs, cs};
  size_t bytes = 0;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = check<T>(m, nb, off, g, variant, &bytes, &fa, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_layout(m, nb, lay, variant) ||
      scratch_floats < scratch_floats_for<T>(g.ctas, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  T* a_t = static_cast<T*>(a);
  T* alpha_t = static_cast<T*>(alpha);
  Real<T>* scratch_f = static_cast<Real<T>*>(scratch);
  unsigned* bar_u = static_cast<unsigned*>(bar);
  void* args[] = {&a_t, &alpha_t, &scratch_f, &bar_u, &m, &nb, &off, &g,
                  &lay};
  err = cudaLaunchCooperativeKernel(kernel_for<T>(variant, nb), dim3(g.ctas),
                                    dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(long long m, int nb, long long off, int ctas, int rows,
         int variant, int* out) {
  size_t bytes = 0;
  cudaFuncAttributes fa{};
  int per_sm = 0;
  const cudaError_t err = check<T>(m, nb, off, Grid{ctas, rows}, variant,
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
// the zeroed barrier counter, the panel (its height and offset 64-bit, and
// its row and column strides in elements: 1 and m for the transposed
// buffer, n and 1 for a view of the row-major matrix), the caller's grid
// (CTAs, rows per CTA, and the variant: 2 for the slice in registers, 1 in
// shared memory, 0 streamed, which takes rs = 1 only), and the stream;
// each returns the cudaError_t of the launch (0 = cudaSuccess).
int dhqr_panel_qr_f32(void* a, void* alpha, void* scratch,
                      long long scratch_floats, void* bar, long long m,
                      int nb, long long off, long long rs, long long cs,
                      int ctas, int rows, int variant, void* stream) {
  return launch<float>(a, alpha, scratch, scratch_floats, bar, m, nb, off,
                       rs, cs, ctas, rows, variant, stream);
}

int dhqr_panel_qr_c64(void* a, void* alpha, void* scratch,
                      long long scratch_floats, void* bar, long long m,
                      int nb, long long off, long long rs, long long cs,
                      int ctas, int rows, int variant, void* stream) {
  return launch<float2>(a, alpha, scratch, scratch_floats, bar, m, nb, off,
                        rs, cs, ctas, rows, variant, stream);
}

int dhqr_panel_qr_f64(void* a, void* alpha, void* scratch,
                      long long scratch_floats, void* bar, long long m,
                      int nb, long long off, long long rs, long long cs,
                      int ctas, int rows, int variant, void* stream) {
  return launch<double>(a, alpha, scratch, scratch_floats, bar, m, nb, off,
                        rs, cs, ctas, rows, variant, stream);
}

// ``dtype`` in the two calls below names the element type: 0 float32, 1
// complex64, 2 float64.

// Floats of scratch a launch of ``ctas`` CTAs on an nb-wide panel needs (-1
// for an unknown dtype).
long long dhqr_panel_qr_scratch_floats(int dtype, int ctas, int nb) {
  switch (dtype) {
    case 0: return scratch_floats_for<float>(ctas, nb);
    case 1: return scratch_floats_for<float2>(ctas, nb);
    case 2: return scratch_floats_for<double>(ctas, nb);
    default: return -1;
  }
}

// What a launch with the same arguments would get on the current device, in
// out[5]: dynamic and static shared bytes per CTA, registers per thread,
// local (spill) bytes per thread, resident CTAs per SM. Returns the
// cudaError_t the launch would meet before it runs.
int dhqr_panel_qr_info(int dtype, long long m, int nb, long long off,
                       int ctas, int rows, int variant, int* out) {
  switch (dtype) {
    case 0: return info<float>(m, nb, off, ctas, rows, variant, out);
    case 1: return info<float2>(m, nb, off, ctas, rows, variant, out);
    case 2: return info<double>(m, nb, off, ctas, rows, variant, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
