// Hopper panel factorization kernels for dhqr_tpu_torch (sm_90a).
//
// Replaces the two Pallas TPU kernels of dhqr_tpu/ops/pallas_panel.py:
//   K1  _panel_kernel      (float32;   reached from _panel_qr_pallas_jit)
//   K2  _panel_kernel_c64  (complex64; same entry, planar re/im planes)
// with _sumsq_compensated inlined in both. Each kernel factors one panel in
// place: the panel is held transposed, At (nb, m), one panel column per row
// of m contiguous elements, and the reflector of local column jl starts at
// row j = off + jl (rows above it hold R entries of earlier panels and are
// preserved bit for bit). Per column jl:
//   s       = compensated ||At[jl, j:]||
//   alpha   = -sign(a_jj) s (complex: s * (-a_jj/|a_jj|); -s on a zero pivot)
//   f       = 1/sqrt(s (s + |a_jj|))  (0 when that is 0: a zero column gives v = 0)
//   v       = f (row - alpha e_j), so ||v||^2 = 2; written over At[jl, j:]
//   W[jj]   = <v, At[jj, j:]>        for jj > jl, full FP32 FMA (no TF32)
//   At[jj] -= W[jj] v                for jj > jl
//
// What bounds it on an H100: the panel is read once and written once,
// 2*m*nb*4 bytes (c64: x2) against 3.35 TB/s, and the column sweep does
// about 2*m*nb^2 FP32 operations (c64: x4) against the 67 TFLOP/s FP32 SIMT
// rate; at (16384, 128) f32 that is 5.0 us of bytes against 8.0 us of
// operations, so the work is operation-bound.
//
// What this design does about it: little, on purpose — it is the simple,
// correct first kernel. One CTA of 1024 threads loops over the nb columns,
// so it uses 1 of the 132 SMs, and the panel stays in global memory (a
// 16384 x 128 f32 panel is 8 MiB, resident in the 50 MB L2). Thread t owns
// the elements i = t + k*1024 of every row, so the norm, the reflector, the
// partial dots and the rank-1 update of its elements never need another
// thread's data; only the two reductions per column (the compensated sum of
// squares, and the nb partial dots) cross threads, through warp shuffles
// and shared memory. The kernel is therefore bound by one SM's L2 traffic
// (~3 * m * nb^2 / 2 words per panel), far above the card's bound above;
// keeping the panel on chip across a cluster (distributed shared memory)
// is the redesign that attacks it.
//
// Hazards handled:
//   * nvcc contracts a*b+c into an FMA by default, which would break a
//     Veltkamp split. The squares use the exact two-product instead,
//     p = x*x, e = fma(x, x, -p) (exact on Hopper), and every TwoSum step is
//     spelled with __fadd_rn/__fsub_rn/__fmul_rn so nothing is contracted.
//   * 1/sqrt uses the correctly rounded __fdiv_rn/__fsqrt_rn, not rsqrt.
//   * Complex storage: PyTorch's interleaved complex64 is read as float2.
//   * Each launcher returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 128;  // widest panel one launch takes

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

// Block-wide compensated sum of every thread's (s, err); all threads get
// the rounded total. Holds two __syncthreads().
__device__ float block_comp_sum(float s, float err, float* sh_s, float* sh_e,
                                float* sh_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_down_sync(0xffffffffu, s, o);
    const float e2 = __shfl_down_sync(0xffffffffu, err, o);
    comp_merge(s, err, s2, e2);
  }
  if (lane == 0) {
    sh_s[warp] = s;
    sh_e[warp] = err;
  }
  __syncthreads();
  if (warp == 0) {
    s = sh_s[lane];
    err = sh_e[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, s, o);
      const float e2 = __shfl_down_sync(0xffffffffu, err, o);
      comp_merge(s, err, s2, e2);
    }
    if (lane == 0) *sh_out = __fadd_rn(s, err);
  }
  __syncthreads();
  return *sh_out;
}

__device__ __forceinline__ float inv_scale(float sn, float mag) {
  const float denom = __fmul_rn(sn, __fadd_rn(sn, mag));
  return denom > 0.f ? __fdiv_rn(1.f, __fsqrt_rn(denom)) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
panel_qr_f32_kernel(float* __restrict__ at, float* __restrict__ alpha_out,
                    int m, int nb, int off) {
  __shared__ float sh_s[kWarps], sh_e[kWarps], sh_out, sh_ajj;
  __shared__ float sh_part[kWarps][kMaxWidth];
  __shared__ float sh_w[kMaxWidth];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int jl = 0; jl < nb; ++jl) {
    const int j = off + jl;
    float* row = at + static_cast<size_t>(jl) * m;
    // 1. compensated ||row[j:]||^2 over this thread's elements
    float s = 0.f, err = 0.f;
    for (int i = tid; i < m; i += kThreads)
      if (i >= j) acc_square(s, err, row[i]);
    if (tid == j % kThreads) sh_ajj = row[j];
    const float sn = __fsqrt_rn(block_comp_sum(s, err, sh_s, sh_e, &sh_out));
    const float a_jj = sh_ajj;
    const float alpha = a_jj >= 0.f ? -sn : sn;
    const float f = inv_scale(sn, fabsf(a_jj));
    // 2. v = f (row - alpha e_j), written over row[j:]
    for (int i = tid; i < m; i += kThreads) {
      if (i >= j) {
        const float x = i == j ? __fsub_rn(row[i], alpha) : row[i];
        row[i] = __fmul_rn(x, f);
      }
    }
    // 3. partial dots W[jj] = <At[jj, j:], v>, reduced per warp
    for (int jj = jl + 1; jj < nb; ++jj) {
      const float* r2 = at + static_cast<size_t>(jj) * m;
      float d = 0.f;
      for (int i = tid; i < m; i += kThreads)
        if (i >= j) d = fmaf(r2[i], row[i], d);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
      if (lane == 0) sh_part[warp][jj] = d;
    }
    __syncthreads();
    if (tid > jl && tid < nb) {
      float w = 0.f;
      for (int k = 0; k < kWarps; ++k) w += sh_part[k][tid];
      sh_w[tid] = w;
    }
    __syncthreads();
    // 4. rank-1 update of the trailing rows
    for (int jj = jl + 1; jj < nb; ++jj) {
      float* r2 = at + static_cast<size_t>(jj) * m;
      const float w = sh_w[jj];
      for (int i = tid; i < m; i += kThreads)
        if (i >= j) r2[i] = fmaf(-w, row[i], r2[i]);
    }
    if (tid == 0) alpha_out[jl] = alpha;
  }
}

__global__ void __launch_bounds__(kThreads)
panel_qr_c64_kernel(float2* __restrict__ at, float2* __restrict__ alpha_out,
                    int m, int nb, int off) {
  __shared__ float sh_s[kWarps], sh_e[kWarps], sh_out;
  __shared__ float2 sh_ajj;
  __shared__ float2 sh_part[kWarps][kMaxWidth];
  __shared__ float2 sh_w[kMaxWidth];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int jl = 0; jl < nb; ++jl) {
    const int j = off + jl;
    float2* row = at + static_cast<size_t>(jl) * m;
    // 1. compensated sum of both planes' squares over row[j:]
    float s = 0.f, err = 0.f;
    for (int i = tid; i < m; i += kThreads) {
      if (i >= j) {
        const float2 x = row[i];
        acc_square(s, err, x.x);
        acc_square(s, err, x.y);
      }
    }
    if (tid == j % kThreads) sh_ajj = row[j];
    const float sn = __fsqrt_rn(block_comp_sum(s, err, sh_s, sh_e, &sh_out));
    const float2 a = sh_ajj;
    const float mag =
        __fsqrt_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
    // alpha = s (-a/|a|), -s on a zero pivot
    float2 alpha;
    if (mag > 0.f) {
      const float inv = __fdiv_rn(1.f, mag);
      alpha.x = __fmul_rn(sn, __fmul_rn(-a.x, inv));
      alpha.y = __fmul_rn(sn, __fmul_rn(-a.y, inv));
    } else {
      alpha.x = -sn;
      alpha.y = __fmul_rn(sn, 0.f);
    }
    const float f = inv_scale(sn, mag);
    // 2. v = f (row - alpha e_j)
    for (int i = tid; i < m; i += kThreads) {
      if (i >= j) {
        float2 x = row[i];
        if (i == j) {
          x.x = __fsub_rn(x.x, alpha.x);
          x.y = __fsub_rn(x.y, alpha.y);
        }
        row[i] = make_float2(__fmul_rn(x.x, f), __fmul_rn(x.y, f));
      }
    }
    // 3. W[jj] = conj(v) . At[jj, j:]: Wr = ar vr + ai vi, Wi = ai vr - ar vi
    for (int jj = jl + 1; jj < nb; ++jj) {
      const float2* r2 = at + static_cast<size_t>(jj) * m;
      float dr = 0.f, di = 0.f;
      for (int i = tid; i < m; i += kThreads) {
        if (i >= j) {
          const float2 x = r2[i], v = row[i];
          dr = fmaf(x.x, v.x, fmaf(x.y, v.y, dr));
          di = fmaf(x.y, v.x, fmaf(-x.x, v.y, di));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dr += __shfl_down_sync(0xffffffffu, dr, o);
        di += __shfl_down_sync(0xffffffffu, di, o);
      }
      if (lane == 0) sh_part[warp][jj] = make_float2(dr, di);
    }
    __syncthreads();
    if (tid > jl && tid < nb) {
      float wr = 0.f, wi = 0.f;
      for (int k = 0; k < kWarps; ++k) {
        wr += sh_part[k][tid].x;
        wi += sh_part[k][tid].y;
      }
      sh_w[tid] = make_float2(wr, wi);
    }
    __syncthreads();
    // 4. x -= W v (two real outer-product pairs)
    for (int jj = jl + 1; jj < nb; ++jj) {
      float2* r2 = at + static_cast<size_t>(jj) * m;
      const float2 w = sh_w[jj];
      for (int i = tid; i < m; i += kThreads) {
        if (i >= j) {
          const float2 v = row[i];
          float2 x = r2[i];
          x.x = __fsub_rn(x.x, fmaf(w.x, v.x, -__fmul_rn(w.y, v.y)));
          x.y = __fsub_rn(x.y, fmaf(w.x, v.y, __fmul_rn(w.y, v.x)));
          r2[i] = x;
        }
      }
    }
    if (tid == 0) alpha_out[jl] = alpha;
  }
}

bool bad_shape(int m, int nb, int off) {
  return nb < 1 || nb > kMaxWidth || m < nb || off < 0 || off > m - nb;
}

}  // namespace

extern "C" {

// Launchers: raw device pointers and the stream; each returns the
// cudaError_t of the launch (0 = cudaSuccess).
int dhqr_panel_qr_f32(void* at, void* alpha, int m, int nb, int off,
                      void* stream) {
  if (bad_shape(m, nb, off)) return static_cast<int>(cudaErrorInvalidValue);
  panel_qr_f32_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(at), static_cast<float*>(alpha), m, nb, off);
  return static_cast<int>(cudaGetLastError());
}

int dhqr_panel_qr_c64(void* at, void* alpha, int m, int nb, int off,
                      void* stream) {
  if (bad_shape(m, nb, off)) return static_cast<int>(cudaErrorInvalidValue);
  panel_qr_c64_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(at), static_cast<float2*>(alpha), m, nb, off);
  return static_cast<int>(cudaGetLastError());
}

const char* dhqr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
