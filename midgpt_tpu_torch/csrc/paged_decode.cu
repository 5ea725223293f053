// Paged decode and verify attention for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of midgpt_tpu/ops/paged_attn.py, float
// and int8 pools, with one templated body and two C entry points:
//   `_decode_kernel` (driven by `paged_decode_attention`): one decode
//     step's attention per (slot, KV head) over the slot's block-table
//     pages plus the decode window's recent rows 0..r;
//   `_verify_kernel` (driven by `paged_verify_attention`): a speculative
//     verify dispatch, T candidate rows per slot over the same pages plus
//     the rows' own K/V, row t seeing self rows 0..t.
// Both take ONE flat f32 softmax per query row over [pool | self rows].
//
// Int8 pools (the int8 branch of both TPU kernels, `_dequant_band`): the
// pages hold int8 codes with one f32 power-of-two scale per (page, KV
// head), passed gathered per slot as [S, Pmax, Hkv]; the self rows are
// bf16 (the pool's row dtype). Each code is read, turned into f32 and
// multiplied by its page's scale before it is used, exactly as the plain
// version dequantizes the gathered view; the product is exact (|code| <=
// 127 times a power of two), so the int8 branch computes bit for bit what
// the float branch computes on an f32 pool holding the dequantized values.
// Scale pointers are null for float pools (a compile-time branch).
// A verify row t and decode step t see the same columns and are summed in
// the same order, so on the same pages and inputs they agree bit for bit.
//
// What bounds it: bytes. Each launch reads the live K and V pages of every
// slot (pooled_len tokens x C x 2 per KV head; one byte an element for an
// int8 pool, plus two f32 scales a page) plus the self rows and does
// ~4 flops per byte read per query row, far below the card's ~295
// flops/byte ridge. The design reads each live K and V element from device
// memory once per chunk of 8 query rows and keeps everything else on chip:
// the rows x (W + R) f32 score rows live in shared memory, the block table
// row is staged there, pad entries of the table are never dereferenced
// (the walk stops at ceil(pooled_len / PS) pages), and nothing page-shaped
// is written back.
//
// Arithmetic mirrors the JAX decode choreography (models/gpt.py
// decode_paged_at / verify_paged_at): f32 products and sums, scores
// divided by sqrt(C), one max / exp / sum softmax over [pool | self], f32
// probabilities through the value sums, one cast to the output dtype at
// the end. A masked column contributes exactly zero there, so the kernel
// skips it. Summation order differs from the plain PyTorch version, so
// results agree to rounding, not bit for bit.
//
// Layout: one thread block per (slot, KV head), kThreads threads; the
// query rows of a block are the G heads of the group (decode) or the G x T
// (head, candidate) pairs, row = g * T + t (verify).
//   pass 1: thread t scores pool column t (its page from the staged
//           table, K read along C at stride PS, the C loads unrolled so
//           many are in flight), then the visible self rows;
//   softmax over each query row, block-wide reductions;
//   pass 2: thread (c, part) owns output channel c and the pages
//           part, part + nparts, ...: it reads its channel's PS-long
//           time row of each page (contiguous in the time-minor layout),
//           then the parts are summed through shared memory.
// A first cut gave pass 2 one warp per channel with lanes striding the
// columns; that left a few dependent loads per lane in flight and ran at
// about 1% of the byte bound at the openwebtext serve shapes.
// Plain C interface (route (b) of the build): the launchers return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

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

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// The self rows' type: the pool's own, or bf16 for an int8 pool.
template <typename TKV>
struct RowType {
  using type = TKV;
};
template <>
struct RowType<int8_t> {
  using type = __nv_bfloat16;
};

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

template <typename TQ, typename TKV, int C, bool kVerify>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(
    const TQ* __restrict__ q,          // [S, Hkv, rows, C]
    const TKV* __restrict__ pool_k,    // [L, NP, Hkv, C, PS]
    const TKV* __restrict__ pool_v,    // [L, NP, Hkv, C, PS]
    const int* __restrict__ bt,        // [S, Pmax]
    const int* __restrict__ pooled_len,  // [S] resident tokens (verify: start)
    const typename RowType<TKV>::type* __restrict__ rk,  // [S, Hkv, R, C]
    const typename RowType<TKV>::type* __restrict__ rv,  // self K / V rows
    const float* __restrict__ scale_k,  // [S, Pmax, Hkv] (int8 pools)
    const float* __restrict__ scale_v,
    TQ* __restrict__ out,              // [S, Hkv, rows, C]
    int hkv, int rows, int num_pages, int ps, int pmax, int rr, int r,
    int layer) {
  using TR = typename RowType<TKV>::type;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float part_s[kGChunk][kThreads];  // pass 2's partial sums
  const int s = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int w = pmax * ps;
  const int stride = w + rr;  // one score row: [pool W | self R]
  float* q_s = smem;                          // [rows, C]
  float* sc = q_s + rows * C;                 // [rows, W + R]
  int* bt_s = reinterpret_cast<int*>(sc + (size_t)rows * stride);  // [Pmax]

  const int n = min(max(pooled_len[s], 0), w);  // live pool columns
  const int npages = (n + ps - 1) / ps;
  // self rows a query row sees: decode, the recent rows 0..r (every row
  // alike); verify, the candidate rows 0..t of its own position t (rr = T).
  // kVerify is a template constant, so the decode body carries no
  // per-row test: a first cut that counted per row there slowed the
  // decode kernel by a quarter on the H100.
  const int maxself = kVerify ? rr : min(r + 1, rr);

  const size_t head = (size_t)s * hkv + j;
  const TQ* qb = q + head * rows * C;
  for (int i = tid; i < rows * C; i += kThreads) q_s[i] = to_f32(qb[i]);
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
  const TR* rkb = rk + head * rr * C;
  const TR* rvb = rv + head * rr * C;
  // this (slot, KV head)'s page scales: entry p at sk_row[p * hkv]
  const float* sk_row = kQuant ? scale_k + (size_t)s * pmax * hkv + j : nullptr;
  const float* sv_row = kQuant ? scale_v + (size_t)s * pmax * hkv + j : nullptr;
  const float root_c = sqrtf(static_cast<float>(C));

  // pass 1: scores of the pool columns, then of the visible self rows
  for (int t = tid; t < n; t += kThreads) {
    const TKV* kp = kbase + (size_t)bt_s[t / ps] * page_stride + (t % ps);
    const float ksc = kQuant ? sk_row[(size_t)(t / ps) * hkv] : 1.f;
    for (int g0 = 0; g0 < rows; g0 += kGChunk) {
      const int gn = min(kGChunk, rows - g0);
      float acc[kGChunk];
#pragma unroll
      for (int g = 0; g < kGChunk; ++g) acc[g] = 0.f;
#pragma unroll 16
      for (int c = 0; c < C; ++c) {
        float kv = to_f32(kp[(size_t)c * ps]);
        if (kQuant) kv *= ksc;  // exact: the plain version's dequantized view
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn) acc[g] += q_s[(g0 + g) * C + c] * kv;
      }
#pragma unroll
      for (int g = 0; g < kGChunk; ++g)
        if (g < gn) sc[(size_t)(g0 + g) * stride + t] = acc[g] / root_c;
    }
  }
  for (int i = tid; i < rows * maxself; i += kThreads) {
    const int g = i / maxself, jr = i % maxself;
    if (kVerify && jr > g % rr) continue;
    const TR* kp = rkb + (size_t)jr * C;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) acc += q_s[g * C + c] * to_f32(kp[c]);
    sc[(size_t)g * stride + n + jr] = acc / root_c;
  }
  __syncthreads();

  // one flat softmax per query row over [pool | visible self rows]
  for (int g = 0; g < rows; ++g) {
    float* row = sc + (size_t)g * stride;
    const int ncol = n + (kVerify ? g % rr + 1 : maxself);
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
  // over every nparts-th live page, and part 0 adds the self rows
  constexpr int kParts = kThreads / C;
  const int c = tid % C, part = tid / C;
  TQ* ob = out + head * rows * C;
  for (int g0 = 0; g0 < rows; g0 += kGChunk) {
    const int gn = min(kGChunk, rows - g0);
    float acc[kGChunk];
#pragma unroll
    for (int g = 0; g < kGChunk; ++g) acc[g] = 0.f;
    for (int p = part; p < npages; p += kParts) {
      const TKV* vp = vbase + (size_t)bt_s[p] * page_stride + (size_t)c * ps;
      const float vsc = kQuant ? sv_row[(size_t)p * hkv] : 1.f;
      const int t0 = p * ps, tn = min(ps, n - t0);
#pragma unroll 8
      for (int i = 0; i < tn; ++i) {
        float vv = to_f32(vp[i]);
        if (kQuant) vv *= vsc;
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn) acc[g] += sc[(size_t)(g0 + g) * stride + t0 + i] * vv;
      }
    }
    if (part == 0) {
      for (int jr = 0; jr < maxself; ++jr) {
        const float vv = to_f32(rvb[(size_t)jr * C + c]);
#pragma unroll
        for (int g = 0; g < kGChunk; ++g)
          if (g < gn && (!kVerify || jr <= (g0 + g) % rr))
            acc[g] += sc[(size_t)(g0 + g) * stride + n + jr] * vv;
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

// The launch arguments both entry points share.
struct Args {
  const void *q, *pool_k, *pool_v;
  const int *bt, *lens;
  const void *rk, *rv;
  const float *sk, *sv;
  void* out;
  int s, hkv, rows, num_pages, ps, pmax, rr, r, layer;
  size_t smem;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int C, bool kVerify>
cudaError_t launch(const Args& a) {
  auto kern = paged_attn_kernel<TQ, TKV, C, kVerify>;
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(a.s, a.hkv);
  kern<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
      static_cast<const TKV*>(a.pool_v), a.bt, a.lens,
      static_cast<const typename RowType<TKV>::type*>(a.rk),
      static_cast<const typename RowType<TKV>::type*>(a.rv), a.sk, a.sv,
      static_cast<TQ*>(a.out), a.hkv, a.rows, a.num_pages, a.ps, a.pmax,
      a.rr, a.r, a.layer);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kVerify>
cudaError_t launch_c(int c, const Args& a) {
  if (c == 64) return launch<TQ, TKV, 64, kVerify>(a);
  if (c == 128) return launch<TQ, TKV, 128, kVerify>(a);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only, with
// scales and bf16 self rows)
template <bool kVerify>
cudaError_t launch_typed(int q_dtype, int kv_dtype, int c, const Args& a) {
  if (kv_dtype == 2 && (a.sk == nullptr || a.sv == nullptr))
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 2)
    return launch_c<float, int8_t, kVerify>(c, a);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_c<__nv_bfloat16, int8_t, kVerify>(c, a);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_c<float, float, kVerify>(c, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_c<__nv_bfloat16, __nv_bfloat16, kVerify>(c, a);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_c<float, __nv_bfloat16, kVerify>(c, a);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_c<__nv_bfloat16, float, kVerify>(c, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One decode step: q [S, Hkv, G, C], recent rows [S, Hkv, R, C] of this
// layer, rows 0..r valid; scale_k / scale_v [S, Pmax, Hkv] for an int8
// pool, null otherwise. Returns a cudaError_t (0 = ok).
int paged_decode_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* bt,
    const void* pooled_len, const void* rk, const void* rv, void* out,
    const void* scale_k, const void* scale_v, int s,
    int hkv, int groups, int c, int num_pages, int ps, int pmax, int rr, int r,
    int layer, int q_dtype, int kv_dtype, long long smem, void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const int*>(bt),
               static_cast<const int*>(pooled_len), rk, rv,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v), out, s, hkv,
               groups, num_pages, ps, pmax, rr, r, layer,
               static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  return launch_typed<false>(q_dtype, kv_dtype, c, a);
}

// One verify dispatch: q [S, Hkv, G, T, C], the candidate rows' K/V
// kc, vc [S, Hkv, T, C], start [S] resident tokens, scales as above.
// Returns a cudaError_t.
int paged_verify_attention_launch(
    const void* q, const void* kc, const void* vc, const void* pool_k,
    const void* pool_v, const void* bt, const void* start, void* out,
    const void* scale_k, const void* scale_v, int s,
    int hkv, int groups, int t, int c, int num_pages, int ps, int pmax,
    int layer, int q_dtype, int kv_dtype, long long smem, void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const int*>(bt),
               static_cast<const int*>(start), kc, vc,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v), out, s, hkv,
               groups * t, num_pages, ps, pmax, t, 0, layer,
               static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  return launch_typed<true>(q_dtype, kv_dtype, c, a);
}

}  // extern "C"
