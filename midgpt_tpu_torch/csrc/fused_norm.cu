// Fused RMSNorm for Hopper (sm_90a): the forward and the backward over
// x [N, D], D % 128 == 0, bf16 or f32.
//
// Replaces the Pallas TPU kernels of midgpt_tpu/ops/fused_norm.py:
//   rms_norm_fwd_kernel <- `_fwd_kernel` (:35, called from `_run_fwd`)
//   rms_norm_bwd_kernel <- `_bwd_kernel` (:45, called from `_vjp_bwd`)
//
// What each computes, per row, in f32:
//   forward:  r = 1 / sqrt(sum(x^2) / D + eps); y = x * r [* w], rounded once
//             to the input type; r saved to rstd [N] (f32).
//   backward: g = dy [* w]; proj = sum(g * x) / D;
//             dx = r * g - x * (r * r * r) * proj, rounded once.
//   The weight is optional (a null pointer); its gradient is a plain
//   reduction outside the kernel, as in the JAX package.
//
// What bounds them on this card: bytes. At the 124M shapes ([8192, 768]
// bf16) the forward reads 12.6 MB and writes as much, the backward reads
// twice that; a few operations a byte, far below the card's ridge. The
// design keeps every read and write one pass over device memory at 16 or
// 8 bytes a lane:
//   - The TPU runs 256-row blocks padded with ones; here one warp owns one
//     row (8 rows a 256-thread block, no padding: a warp past the last row
//     returns), so no cross-warp reduction is needed, only shuffles.
//   - A lane reads 4 neighbouring values at a time (float4 / 4 bf16), the
//     warp 128 values, so D % 128 == 0 is the JAX package's rule too.
//   - The second pass (writing y or dx) reads the row again; at 1.5 KB a
//     row it comes back from L1, so device memory sees each byte once.
// Plain C interface (route (b) of the build): the launchers return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four neighbouring values, as f32
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  // round to nearest even, like a cast
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<uint32_t*>(&lo);
  a.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rms_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
    float* __restrict__ rstd, int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane * 4; c < d; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss = __fmaf_rn(v[e], v[e], ss);
  }
  const float mean = __fdiv_rn(warp_sum(ss), static_cast<float>(d));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));
  for (int c = lane * 4; c < d; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __fmul_rn(v[e], r);
      if (w != nullptr) v[e] = __fmul_rn(v[e], w[c + e]);
    }
    store4(yr + c, v);
  }
  if (lane == 0) rstd[row] = r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rms_norm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ rstd, const T* __restrict__ dy,
    T* __restrict__ dx, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + (size_t)row * d;
  const T* gr = dy + (size_t)row * d;
  T* dr = dx + (size_t)row * d;
  float s = 0.f;
  for (int c = lane * 4; c < d; c += 128) {
    float v[4], g[4];
    load4(xr + c, v);
    load4(gr + c, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (w != nullptr) g[e] = __fmul_rn(g[e], w[c + e]);
      s = __fmaf_rn(g[e], v[e], s);
    }
  }
  const float proj = __fdiv_rn(warp_sum(s), static_cast<float>(d));
  const float r = rstd[row];
  const float r3 = __fmul_rn(__fmul_rn(r, r), r);
  for (int c = lane * 4; c < d; c += 128) {
    float v[4], g[4];
    load4(xr + c, v);
    load4(gr + c, g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (w != nullptr) g[e] = __fmul_rn(g[e], w[c + e]);
      v[e] = __fsub_rn(__fmul_rn(r, g[e]),
                       __fmul_rn(__fmul_rn(v[e], r3), proj));
    }
    store4(dr + c, v);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* w, void* y, float* rstd,
                       int n, int d, float eps, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rms_norm_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), rstd, n, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* w, const float* rstd,
                       const void* dy, void* dx, int n, int d,
                       cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rms_norm_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; `w` may be null (no weight).
// Return a cudaError_t (0 = ok).
int rms_norm_fwd_launch(const void* x, const void* w, void* y, void* rstd,
                        int n, int d, int dtype, float eps, void* stream) {
  if (n < 1 || d % 128 != 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  float* rf = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, wf, y, rf, n, d, eps, st);
  if (dtype == 1) return launch_fwd<bf16>(x, wf, y, rf, n, d, eps, st);
  return cudaErrorInvalidValue;
}

int rms_norm_bwd_launch(const void* x, const void* w, const void* rstd,
                        const void* dy, void* dx, int n, int d, int dtype,
                        void* stream) {
  if (n < 1 || d % 128 != 0) return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* rf = static_cast<const float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, wf, rf, dy, dx, n, d, st);
  if (dtype == 1) return launch_bwd<bf16>(x, wf, rf, dy, dx, n, d, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
