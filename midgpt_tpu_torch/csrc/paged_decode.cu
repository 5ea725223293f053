// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel midgpt_tpu/ops/paged_attn.py
// `_decode_kernel` (driven by `paged_decode_attention`, float pools): one
// decode step's attention per (slot, KV head) over the slot's block-table
// pages plus the decode window's recent rows, with ONE flat f32 softmax.
//
// What bounds it: bytes. Each step reads the live K and V pages of every
// slot (pooled_len tokens x C x 2 per KV head) plus the R recent rows and
// does ~4 flops per byte read, far below the card's ~295 flops/byte ridge.
// The design reads each live K and V element from device memory exactly
// once and keeps everything else on chip: the G x (W + R) f32 score row
// lives in shared memory, the block table row is staged there, pad
// entries of the table are never dereferenced (the walk stops at
// ceil(pooled_len / PS) pages), and nothing page-shaped is written back.
//
// Arithmetic mirrors the JAX decode choreography (models/gpt.py
// decode_paged_at): f32 products and sums, scores divided by sqrt(C),
// one max / exp / sum softmax over [pool | recent], f32 probabilities
// through the value sums, one cast to the output dtype at the end.
// Summation order differs from the plain PyTorch version, so results
// agree to rounding, not bit for bit.
//
// Layout: one thread block per (slot, KV head), kThreads threads.
//   pass 1: thread t scores pool column t (its page from the staged
//           table, K read along C at stride PS, the C loads unrolled so
//           many are in flight), then the recent rows;
//   softmax over each of the G query rows, block-wide reductions;
//   pass 2: thread (c, part) owns output channel c and the pages
//           part, part + nparts, ...: it reads its channel's PS-long
//           time row of each page (contiguous in the time-minor layout),
//           then the parts are summed through shared memory.
// A first cut gave pass 2 one warp per channel with lanes striding the
// columns; that left a few dependent loads per lane in flight and ran at
// about 1% of the byte bound at the openwebtext serve shapes.
// Plain C interface (route (b) of the build): the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGChunk = 8;  // query rows of a KV head handled per pass

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) out = kMax ? fmaxf(out, red[w]) : out + red[w];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

template <typename TQ, typename TKV, int C>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,          // [S, Hkv, G, C]
    const TKV* __restrict__ pool_k,    // [L, NP, Hkv, C, PS]
    const TKV* __restrict__ pool_v,    // [L, NP, Hkv, C, PS]
    const int* __restrict__ bt,        // [S, Pmax]
    const int* __restrict__ pooled_len,  // [S]
    const TKV* __restrict__ rk,        // [S, Hkv, R, C] this layer
    const TKV* __restrict__ rv,        // [S, Hkv, R, C]
    TQ* __restrict__ out,              // [S, Hkv, G, C]
    int hkv, int groups, int num_pages, int ps, int pmax, int rr, int r,
    int layer) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float part_s[kGChunk][kThreads];  // pass 2's partial sums
  const int s = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int w = pmax * ps;
  const int stride = w + rr;  // one score row: [pool W | recent R]
  float* q_s = smem;                          // [G, C]
  float* sc = q_s + groups * C;               // [G, W + R]
  int* bt_s = reinterpret_cast<int*>(sc + (size_t)groups * stride);  // [Pmax]

  const int n = min(max(pooled_len[s], 0), w);  // live pool columns
  const int npages = (n + ps - 1) / ps;
  const int nrec = min(r + 1, rr);  // recent row j is valid iff j <= r
  const int ncol = n + nrec;

  const size_t head = (size_t)s * hkv + j;
  const TQ* qb = q + head * groups * C;
  for (int i = tid; i < groups * C; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < npages; i += kThreads) {
    // page ids of live pages are always valid; the clamp mirrors the
    // reference gather's clip and keeps a corrupt table in bounds
    bt_s[i] = min(max(bt[(size_t)s * pmax + i], 0), num_pages - 1);
  }
  __syncthreads();

  const size_t page_stride = (size_t)hkv * C * ps;
  const size_t layer_off = ((size_t)layer * num_pages * hkv + j) * C * ps;
  const TKV* kbase = pool_k + layer_off;
  const TKV* vbase = pool_v + layer_off;
  const TKV* rkb = rk + head * rr * C;
  const TKV* rvb = rv + head * rr * C;
  const float root_c = sqrtf(static_cast<float>(C));

  // pass 1: scores of the pool columns, then of the valid recent rows
  for (int t = tid; t < n; t += kThreads) {
    const TKV* kp = kbase + (size_t)bt_s[t / ps] * page_stride + (t % ps);
    for (int g0 = 0; g0 < groups; g0 += kGChunk) {
      const int gn = min(kGChunk, groups - g0);
      float acc[kGChunk];
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) acc[g] = 0.f;
#pragma unroll 16
      for (int c = 0; c < C; ++c) {
        const float kv = to_f32(kp[(size_t)c * ps]);
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn) acc[g] += q_s[(g0 + g) * C + c] * kv;
      }
#pragma unroll
      for (int g = 0; g < kGChunk; ++g)
        if (g < gn) sc[(size_t)(g0 + g) * stride + t] = acc[g] / root_c;
    }
  }
  for (int i = tid; i < groups * nrec; i += kThreads) {
    const int g = i / nrec, jr = i % nrec;
    const TKV* kp = rkb + (size_t)jr * C;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) acc += q_s[g * C + c] * to_f32(kp[c]);
    sc[(size_t)g * stride + n + jr] = acc / root_c;
  }
  __syncthreads();

  // one flat softmax per query row over [pool | recent]
  for (int g = 0; g < groups; ++g) {
    float* row = sc + (size_t)g * stride;
    float m = -CUDART_INF_F;
    for (int t = tid; t < ncol; t += kThreads) m = fmaxf(m, row[t]);
    m = block_reduce<true>(m, red);
    float sum = 0.f;
    for (int t = tid; t < ncol; t += kThreads) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    for (int t = tid; t < ncol; t += kThreads) row[t] = row[t] / sum;
  }
  __syncthreads();

  // pass 2: probabilities through V; thread (c, part) owns channel c
  // over every nparts-th live page, and part 0 adds the recent rows
  constexpr int kParts = kThreads / C;
  const int c = tid % C, part = tid / C;
  TQ* ob = out + head * groups * C;
  for (int g0 = 0; g0 < groups; g0 += kGChunk) {
    const int gn = min(kGChunk, groups - g0);
    float acc[kGChunk];
#pragma unroll
    for (int g = 0; g < kGChunk; ++g) acc[g] = 0.f;
    for (int p = part; p < npages; p += kParts) {
      const TKV* vp = vbase + (size_t)bt_s[p] * page_stride + (size_t)c * ps;
      const int t0 = p * ps, tn = min(ps, n - t0);
#pragma unroll 8
      for (int i = 0; i < tn; ++i) {
        const float vv = to_f32(vp[i]);
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn) acc[g] += sc[(size_t)(g0 + g) * stride + t0 + i] * vv;
      }
    }
    if (part == 0) {
      for (int jr = 0; jr < nrec; ++jr) {
        const float vv = to_f32(rvb[(size_t)jr * C + c]);
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn) acc[g] += sc[(size_t)(g0 + g) * stride + n + jr] * vv;
      }
    }
#pragma unroll
    for (int g = 0; g < kGChunk; ++g) part_s[g][tid] = acc[g];
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) {
        if (g < gn) {
          float o = part_s[g][c];
#pragma unroll
          for (int k = 1; k < kParts; ++k) o += part_s[g][k * C + c];
          ob[(g0 + g) * C + c] = from_f32<TQ>(o);
        }
      }
    }
    __syncthreads();  // part_s is reused by the next chunk of query rows
  }
}

template <typename TQ, typename TKV, int C>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int* bt, const int* pooled_len, const void* rk,
                   const void* rv, void* out, int s, int hkv, int groups,
                   int num_pages, int ps, int pmax, int rr, int r, int layer,
                   size_t smem, cudaStream_t stream) {
  auto kern = paged_decode_kernel<TQ, TKV, C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(s, hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), bt, pooled_len,
      static_cast<const TKV*>(rk), static_cast<const TKV*>(rv),
      static_cast<TQ*>(out), hkv, groups, num_pages, ps, pmax, rr, r, layer);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_c(int c, const void* q, const void* pool_k,
                     const void* pool_v, const int* bt, const int* pooled_len,
                     const void* rk, const void* rv, void* out, int s, int hkv,
                     int groups, int num_pages, int ps, int pmax, int rr, int r,
                     int layer, size_t smem, cudaStream_t stream) {
  if (c == 64)
    return launch<TQ, TKV, 64>(q, pool_k, pool_v, bt, pooled_len, rk, rv, out,
                               s, hkv, groups, num_pages, ps, pmax, rr, r,
                               layer, smem, stream);
  if (c == 128)
    return launch<TQ, TKV, 128>(q, pool_k, pool_v, bt, pooled_len, rk, rv, out,
                                s, hkv, groups, num_pages, ps, pmax, rr, r,
                                layer, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
int paged_decode_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* bt,
    const void* pooled_len, const void* rk, const void* rv, void* out, int s,
    int hkv, int groups, int c, int num_pages, int ps, int pmax, int rr, int r,
    int layer, int q_dtype, int kv_dtype, long long smem, void* stream) {
  const int* bti = static_cast<const int*>(bt);
  const int* lens = static_cast<const int*>(pooled_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_c<float, float>(c, q, pool_k, pool_v, bti, lens, rk, rv, out,
                                  s, hkv, groups, num_pages, ps, pmax, rr, r,
                                  layer, sm, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_c<__nv_bfloat16, __nv_bfloat16>(
        c, q, pool_k, pool_v, bti, lens, rk, rv, out, s, hkv, groups,
        num_pages, ps, pmax, rr, r, layer, sm, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_c<float, __nv_bfloat16>(
        c, q, pool_k, pool_v, bti, lens, rk, rv, out, s, hkv, groups,
        num_pages, ps, pmax, rr, r, layer, sm, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_c<__nv_bfloat16, float>(
        c, q, pool_k, pool_v, bti, lens, rk, rv, out, s, hkv, groups,
        num_pages, ps, pmax, rr, r, layer, sm, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
