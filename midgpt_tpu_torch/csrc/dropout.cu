// Keyed inverted dropout for Hopper (sm_90a): y = keep(i) ? x * (1 / keep)
// : 0 over a contiguous x of n elements, bf16 or f32, the keep-mask a
// counter hash of (site key, global element index i). x is rows of
// `inner` elements, each a slice of a global row of `inner_stride`:
//   i = offset + (flat / inner) * inner_stride + flat % inner
// (inner == inner_stride: i = offset + flat). A data-parallel rank passes
// the offset of its first batch row, a sequence-parallel rank also its
// columns' start, with inner = its T/S * D and inner_stride = T * D, so
// its elements draw the masks they would draw in the whole global batch.
//
// Replaces no TPU kernel: the JAX package draws its residual and embedding
// dropout with jax.random.bernoulli inside the jitted step. The port needs
// the mask to be a pure function of a key that lives in device memory, so
// that a captured CUDA graph of the train step draws each step's masks
// from the keys that step's inputs wrote there, and so that a checkpointed
// block's recompute draws the masks its forward drew. The backward is this
// kernel again on dy with the same key: nothing is saved between them.
//
// The hash (models/layers.py holds its plain version):
//   s = key_lo + key_hi * 0xC2B2AE35      (the 64-bit key's two words)
//   h = fmix32((i * 0x9E3779B1) ^ s)      (murmur3's finalizer, mod 2^32)
//   keep iff (h & 0xFFFFFF) < thresh,     thresh = int(keep * 2^24)
// which is the attention kernels' hash with the row term over the flat
// index and no column term.
//
// What bounds it on this card: bytes. At shakespeare_char's residual
// ([64, 256, 384] bf16, 6.3 M elements) it reads 12.6 MB and writes as
// much, ~7.5 us at 3.35 TB/s, with ~10 integer operations an element. The
// design is one pass at 16 bytes a thread (8 bf16 or 4 f32 values, a
// grid-stride loop); a pointer not 16-byte aligned takes the same loop one
// element at a time. The key is read once per thread, from device memory.
// A sliced row (inner < inner_stride) takes the strided loop: one 64-bit
// division a vector when inner is a multiple of the vector, else one an
// element.
// Plain C interface (route (b) of the build): the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool keep_at(uint32_t i, uint32_t s,
                                        uint32_t thresh) {
  uint32_t x = (i * 0x9E3779B1u) ^ s;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return (x & 0x00FFFFFFu) < thresh;
}

__device__ __forceinline__ float drop1(float v, bool keep, float inv_keep) {
  return keep ? __fmul_rn(v, inv_keep) : 0.f;
}
__device__ __forceinline__ bf16 drop1(bf16 v, bool keep, float inv_keep) {
  return __float2bfloat16_rn(keep ? __fmul_rn(__bfloat162float(v), inv_keep)
                                  : 0.f);
}

// the global index of flat element f (mod 2^32)
template <bool kStrided>
__device__ __forceinline__ uint32_t global_index(long long f, uint32_t base,
                                                 long long inner,
                                                 uint32_t inner_stride) {
  if constexpr (kStrided) {
    const long long row = f / inner;
    return base + static_cast<uint32_t>(row) * inner_stride +
           static_cast<uint32_t>(f - row * inner);
  } else {
    return base + static_cast<uint32_t>(f);
  }
}

// kVec: 16 bytes a step (x and y 16-byte aligned; strided, inner a
// multiple of the vector, so a vector never straddles two rows); else one
// element a step. kStrided: rows of `inner` elements at `inner_stride`.
template <typename T, bool kVec, bool kStrided>
__global__ void __launch_bounds__(kThreads) keyed_dropout_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long n,
    const uint32_t* __restrict__ key, uint32_t base, uint32_t thresh,
    float inv_keep, long long inner, uint32_t inner_stride) {
  const uint32_t s = __ldg(key) + __ldg(key + 1) * 0xC2B2AE35u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  constexpr int kV = kVec ? 16 / sizeof(T) : 1;
  const long long nv = n / kV;
  for (long long v = first; v < nv; v += stride) {
    const uint32_t i0 =
        global_index<kStrided>(v * kV, base, inner, inner_stride);
    if constexpr (kVec) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + v);
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kV; ++j)
        e[j] = drop1(e[j], keep_at(i0 + static_cast<uint32_t>(j), s, thresh),
                     inv_keep);
      reinterpret_cast<uint4*>(y)[v] = raw;
    } else {
      y[v] = drop1(x[v], keep_at(i0, s, thresh), inv_keep);
    }
  }
  // the tail past the last whole vector
  for (long long f = nv * kV + first; f < n; f += stride)
    y[f] = drop1(x[f],
                 keep_at(global_index<kStrided>(f, base, inner, inner_stride),
                         s, thresh),
                 inv_keep);
}

template <typename T, bool kStrided>
cudaError_t launch(const void* x, void* y, long long n, const void* key,
                   unsigned base, unsigned thresh, float inv_keep,
                   long long inner, unsigned inner_stride,
                   cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   (!kStrided || inner % kV == 0);
  const long long per_block = static_cast<long long>(kThreads) *
                              (vec ? kV : 1);
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const uint32_t* k = static_cast<const uint32_t*>(key);
  if (vec)
    keyed_dropout_kernel<T, true, kStrided><<<blocks, kThreads, 0, stream>>>(
        xt, yt, n, k, base, thresh, inv_keep, inner, inner_stride);
  else
    keyed_dropout_kernel<T, false, kStrided><<<blocks, kThreads, 0, stream>>>(
        xt, yt, n, k, base, thresh, inv_keep, inner, inner_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* x, void* y, long long n, const void* key,
                        unsigned base, unsigned thresh, float inv_keep,
                        long long inner, long long inner_stride,
                        cudaStream_t stream) {
  const unsigned stride32 = static_cast<unsigned>(inner_stride & 0xFFFFFFFFll);
  if (inner == inner_stride)  // contiguous: today's one-pass loop
    return launch<T, false>(x, y, n, key, base, thresh, inv_keep, inner,
                            stride32, stream);
  return launch<T, true>(x, y, n, key, base, thresh, inv_keep, inner,
                         stride32, stream);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `key` points to the site's
// 64-bit key (an int64 in device memory, read as two 32-bit words);
// `offset` is the global index of element 0 (taken mod 2^32, as the
// index is); x is rows of `inner` elements whose starts lie
// `inner_stride` apart in the global index (n a multiple of inner,
// inner <= inner_stride). Return a cudaError_t (0 = ok).
int keyed_dropout_launch(const void* x, void* y, long long n, const void* key,
                         long long offset, unsigned thresh, float inv_keep,
                         int dtype, long long inner, long long inner_stride,
                         void* stream) {
  if (n < 1 || n > 0xFFFFFFFFll || key == nullptr || offset < 0 ||
      inner < 1 || inner_stride < inner || n % inner != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned base = static_cast<unsigned>(offset & 0xFFFFFFFFll);
  if (dtype == 0)
    return launch_rows<float>(x, y, n, key, base, thresh, inv_keep, inner,
                              inner_stride, st);
  if (dtype == 1)
    return launch_rows<bf16>(x, y, n, key, base, thresh, inv_keep, inner,
                             inner_stride, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
