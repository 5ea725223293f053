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
// Each entry point is one launch of one kernel, paged_split_kernel, whose
// grid is (slot, KV head, split). A split is a fixed run of pages,
// kSplitTokens / PS of them (at least one): a function of the page size
// alone, never of the query rows, so decode and verify cut the same
// columns at the same places, as JAX's band plan does (`band_pages`).
// Splits past a slot's live pages exit at once.
//   The split: a block reads its pages' table entries with the slot's
//     length, brings each live page's [C, PS] K and V slabs (contiguous
//     per KV head) and the self rows into shared memory with 16-byte
//     cp.async copies, V's overlapping the scores (of the split's columns
//     and of the self rows, a thread a column and a chunk of rows), and
//     writes, for each query row, its own softmax state over the split's
//     live columns: max m_i, sum l_i = sum exp(z - m_i) and the f32
//     partial O_i = sum exp(z - m_i) v, into a scratch buffer.
//   The merge: the last split block of a (slot, KV head) to finish, chosen
//     by a ticket (an atomic count, the only atomic: no sum goes through
//     one), merges every query row: over the row's visible self rows
//     (decode: the recent rows 0..r; verify: the candidate rows 0..t; the
//     same code for both) and the live splits it takes the max M, forms
//     each split's weight e^(m_i - M) once, folds the splits in ascending
//     order (L += l_i w_i, O += O_i w_i), then adds the self rows, divides
//     once and casts once. A second kernel for the merge cost a launch and
//     its own load chain: 0.0133 against 0.0116 ms a decode call at the
//     serve shapes, in turns on one H100.
// No atomic enters a sum: every sum runs in a fixed order, so the same
// inputs give the same bits on every call. A verify row t and decode step
// t see the same columns, cut the same way and summed in the same order by
// the same code, so on the same pages and inputs they agree bit for bit.
//
// Int8 pools (the int8 branch of both TPU kernels, `_dequant_band`): the
// pages hold int8 codes with one f32 power-of-two scale per (page, KV
// head), passed gathered per slot as [S, Pmax, Hkv]; the self rows are
// bf16 (the pool's row dtype). Each code is turned into f32 and multiplied
// by its page's scale (one rounded multiply, exact: |code| <= 127 times a
// power of two) before it is used, so the int8 branch computes bit for bit
// what the float branch computes on an f32 pool holding the dequantized
// values. Scale pointers are null for float pools (a compile-time branch).
//
// What bounds it: bytes. Each call reads the live K and V pages of every
// slot (pooled_len tokens x C x 2 per KV head; one byte an element for an
// int8 pool, plus two f32 scales a page) plus the self rows, and does ~4
// flops per byte read per query row, far below the card's ~295 flops/byte
// ridge. At the serve shapes those bytes take about a microsecond, so the
// call is bound by latency. Cut short at each stage on one H100 (a decode
// call at the serve shapes, 9.2 us whole): the launch of its 1,536
// blocks 1.5 us; the table, the length and the slabs in shared memory 3.7
// us; the split's arithmetic (scores, row max, exponent, value sums: short
// dependent chains through shared memory) to 6.7 us; the ticket and the
// merge's two round trips to the partials in L2 the rest. The design
// spreads the columns over many small blocks (about 250 live ones at the
// serve shapes, where one block a (slot, KV head) gave 96) and reads
// every live K and V element once with 16-byte copies. Shared memory
// holds one split's slabs, queries and scores, so it does not grow with
// the context: a 100k-token table takes the same block as a 1k one.
//
// Arithmetic mirrors the JAX decode choreography (models/gpt.py
// decode_paged_at / verify_paged_at): f32 products and sums (explicit
// fmaf, so every instantiation sums alike), scores divided by sqrt(C), a
// masked column skipped (it contributes exactly zero there), f32
// probabilities through the value sums, one cast to the output dtype at
// the end. The plain PyTorch version takes one flat softmax; the split
// softmax sums in another order, so the two agree to rounding, not bit
// for bit.
// Plain C interface (route (b) of the build): the launchers return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;     // a split block: four warps
constexpr int kWarps = kThreads / 32;
constexpr int kSplitTokens = 64;  // tokens of a split (pages of <= 64)
constexpr int kRowChunk = 8;      // query rows a thread scores at once

// Pages of one split: a function of the page size alone.
__host__ __device__ inline int split_pages(int ps) {
  return ps >= kSplitTokens ? 1 : kSplitTokens / ps;
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A page's pool value as f32: an int8 code times its page's scale in one
// rounded multiply (exact), else the value itself.
template <typename TKV>
__device__ __forceinline__ float pool_value(TKV x, float scale) {
  if constexpr (std::is_same<TKV, int8_t>::value)
    return __fmul_rn(to_f32(x), scale);
  else
    return to_f32(x);
}

// out[g * ostride] = (sum over c in order of q[g C + c] * key[c * kstride]
// (times the page scale for an int8 pool)) / root_c for the G rows of a
// chunk: one sequential f32 chain a row, the rows side by side.
template <int G, int C, typename TK>
__device__ __forceinline__ void rows_dot_n(const float* q, const TK* key,
                                           int kstride, float ksc,
                                           float root_c, float* out,
                                           int ostride) {
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const float kv = pool_value(key[c * kstride], ksc);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(q[g * C + c], kv, acc[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) out[g * ostride] = acc[g] / root_c;
}

// rows_dot_n for a chunk of gn (1..kRowChunk) rows.
template <int C, typename TK>
__device__ __forceinline__ void rows_dot(int gn, const float* q,
                                         const TK* key, int kstride,
                                         float ksc, float root_c, float* out,
                                         int ostride) {
  static_assert(kRowChunk == 8, "one case a chunk size");
  switch (gn) {
    case 1: return rows_dot_n<1, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 2: return rows_dot_n<2, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 3: return rows_dot_n<3, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 4: return rows_dot_n<4, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 5: return rows_dot_n<5, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 6: return rows_dot_n<6, C>(q, key, kstride, ksc, root_c, out, ostride);
    case 7: return rows_dot_n<7, C>(q, key, kstride, ksc, root_c, out, ostride);
    default: return rows_dot_n<8, C>(q, key, kstride, ksc, root_c, out, ostride);
  }
}

// One split of one (slot, KV head), and for the last split of a (slot, KV
// head) to finish, the merge of all of its query rows. `rows` query rows
// [rows, C] per (slot, KV head) (row g T + t for verify); pools [L, NP,
// Hkv, C, PS]; self rows [S, Hkv, rr, C]: row `row` sees self rows
// 0..(row % rr) (verify) or 0..r (decode). Scratch: part_o [S, Hkv, NS,
// rows, C] f32, part_ml [S, Hkv, NS, rows] (m, l), NS = gridDim.z, and
// `tickets` [S Hkv] int32, zero before the call and zero after it (the
// merging block resets its own).
template <typename TQ, typename TKV, int C>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ pool_k,
    const TKV* __restrict__ pool_v, const int* __restrict__ bt,
    const int* __restrict__ lens,
    const typename RowType<TKV>::type* __restrict__ rk,
    const typename RowType<TKV>::type* __restrict__ rv,
    const float* __restrict__ scale_k, const float* __restrict__ scale_v,
    float* __restrict__ part_o, float2* __restrict__ part_ml,
    int* __restrict__ tickets, TQ* __restrict__ out, int hkv, int rows,
    int num_pages, int ps, int pmax, int rr, int r, int verify, int layer) {
  using TR = typename RowType<TKV>::type;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  const int s = blockIdx.x, j = blockIdx.y, sp = blockIdx.z;
  const int ns = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int spp = split_pages(ps);
  const int p0 = sp * spp;
  const int wcol = spp * ps;  // a score row's stride
  const int slab = C * ps;    // one page's [C, PS] slab
  const size_t head = (size_t)s * hkv + j;
  // the slot's length and the split's table entries (and page scales) do
  // not depend on each other: both are read at once, before the length
  // decides whether the split has work
  int pid = 0;
  float ks = 1.f, vs = 1.f;
  if (tid < spp && p0 + tid < pmax) {
    const size_t e = (size_t)s * pmax + p0 + tid;
    pid = bt[e];
    if (kQuant) {
      ks = scale_k[e * hkv + j];
      vs = scale_v[e * hkv + j];
    }
  }
  const int n = min(max(lens[s], 0), pmax * ps);  // live pool columns
  const int npages = (n + ps - 1) / ps;
  const int nlive = (npages + spp - 1) / spp;  // splits with columns
  // split 0 of an empty slot has no columns but still merges the self rows
  if (sp >= max(nlive, 1)) return;
  const int np = max(min(spp, npages - p0), 0);
  const int ncol = max(min(np * ps, n - p0 * ps), 0);

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* k_s = reinterpret_cast<TKV*>(smem);         // [spp][C][PS]
  TKV* v_s = k_s + (size_t)spp * slab;             // [spp][C][PS]
  TR* rk_s = reinterpret_cast<TR*>(v_s + (size_t)spp * slab);  // [rr][C]
  TR* rv_s = rk_s + rr * C;                        // [rr][C]
  float* q_s = reinterpret_cast<float*>(rv_s + rr * C);  // [rows][C]
  float* sc = q_s + rows * C;                      // [rows][wcol]
  float* zs = sc + rows * wcol;                    // [rows][rr] self scores
  float* big_s = zs + rows * rr;                   // [rows] merged maxima
  float* sks = big_s + rows;                       // [spp] page scales
  float* svs = sks + spp;
  int* pg = reinterpret_cast<int*>(svs + spp);     // [spp] page ids
  int* last_s = pg + spp;

  if (tid < np) {
    // page ids of live pages are always valid; the clamp mirrors the
    // reference gather's clip and keeps a corrupt table in bounds
    pg[tid] = min(max(pid, 0), num_pages - 1);
    sks[tid] = ks;
    svs[tid] = vs;
  }
  __syncthreads();

  // the slabs, K then V, each with the self rows' K or V, as two cp.async
  // groups of 16-byte copies
  const size_t head_off = ((size_t)layer * num_pages * hkv + j) * slab;
  const size_t page_stride = (size_t)hkv * slab;
  const int chunks = slab * (int)sizeof(TKV) / 16;  // per slab
  for (int half = 0; half < 2; ++half) {
    const TKV* src = (half == 0 ? pool_k : pool_v) + head_off;
    unsigned char* dst = reinterpret_cast<unsigned char*>(half == 0 ? k_s
                                                                    : v_s);
    for (int i = tid; i < np * chunks; i += kThreads) {
      const int p = i / chunks, o = i - p * chunks;
      cp_async16(dst + ((size_t)p * chunks + o) * 16,
                 reinterpret_cast<const unsigned char*>(
                     src + (size_t)pg[p] * page_stride) + (size_t)o * 16);
    }
    const int rchunks = rr * C * (int)sizeof(TR) / 16;
    const unsigned char* rsrc = reinterpret_cast<const unsigned char*>(
        (half == 0 ? rk : rv) + head * rr * C);
    unsigned char* rdst = reinterpret_cast<unsigned char*>(half == 0 ? rk_s
                                                                     : rv_s);
    for (int i = tid; i < rchunks; i += kThreads)
      cp_async16(rdst + (size_t)i * 16, rsrc + (size_t)i * 16);
    cp_async_commit();
  }
  // the query rows, while the slabs are in flight
  const TQ* qb = q + head * rows * C;
  for (int i = tid; i < rows * C; i += kThreads) q_s[i] = to_f32(qb[i]);
  cp_async_wait<1>();  // K and the self rows' K are in
  __syncthreads();

  // scores of the split's live columns and of the self rows (every block
  // scores them; the merging block uses its own): a thread takes one
  // column and a chunk of up to kRowChunk rows, each (row, column) one
  // sequential f32 sum over C (rows_dot, unrolled for the chunk's exact
  // size: no predicated rows)
  const float root_c = sqrtf(static_cast<float>(C));
  const int nrg = (rows + kRowChunk - 1) / kRowChunk;
  const int ncs = ncol + rr;  // pool columns, then self rows
  for (int w = tid; w < ncs * nrg; w += kThreads) {
    const int col = w % ncs, g0 = (w / ncs) * kRowChunk;
    const int gn = min(kRowChunk, rows - g0);
    if (col < ncol) {
      const int p = col / ps;
      rows_dot<C>(gn, q_s + g0 * C, k_s + (size_t)p * slab + (col - p * ps),
                  ps, kQuant ? sks[p] : 1.f, root_c,
                  sc + g0 * wcol + col, wcol);
    } else {
      rows_dot<C>(gn, q_s + g0 * C, rk_s + (col - ncol) * C, 1, 1.f, root_c,
                  zs + g0 * rr + col - ncol, rr);
    }
  }
  cp_async_wait<0>();  // V and the self rows are in
  __syncthreads();

  // the split's softmax state, a warp a row: max, then exp and sum
  const size_t part = (head * ns + sp) * rows;
  for (int row = warp; ncol > 0 && row < rows; row += kWarps) {
    float* zr = sc + row * wcol;
    float m = -CUDART_INF_F;
    for (int col = lane; col < ncol; col += 32) m = fmaxf(m, zr[col]);
    m = warp_max(m);
    float l = 0.f;
    for (int col = lane; col < ncol; col += 32) {
      const float e = expf(zr[col] - m);
      zr[col] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) part_ml[part + row] = make_float2(m, l);
  }
  __syncthreads();

  // O_i: thread (row, c), one sequential sum over the live columns,
  // reading V 16 bytes at a time along the page's time axis
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  const bool vec = ps % kVec == 0;
  for (int w = tid; ncol > 0 && w < rows * C; w += kThreads) {
    const int row = w / C, c = w % C;
    const float* er = sc + row * wcol;
    float acc = 0.f;
    for (int p = 0; p < np; ++p) {
      const TKV* vp = v_s + (size_t)p * slab + c * ps;
      const float vsc = kQuant ? svs[p] : 1.f;
      const int tn = min(ps, ncol - p * ps);
      if (vec) {
        for (int t0 = 0; t0 < tn; t0 += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(vp + t0);
          const TKV* x = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (t0 + e < tn)
              acc = fmaf(er[p * ps + t0 + e], pool_value(x[e], vsc), acc);
        }
      } else {
        for (int t = 0; t < tn; ++t)
          acc = fmaf(er[p * ps + t], pool_value(vp[t], vsc), acc);
      }
    }
    part_o[(part + row) * C + c] = acc;
  }

  // the ticket: the last of the (slot, KV head)'s splits to get here
  // merges; its partials are visible to it after the fences
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *last_s = atomicAdd(tickets + head, 1) == max(nlive, 1) - 1;
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  if (tid == 0) tickets[head] = 0;  // zero again for the next call

  // the merge (the self rows' scores are in zs)
  // a warp a row: M over the row's live splits and visible self rows (a
  // max is exact in any order), then each split's weight e^(m_i - M)
  // once, over its maximum in place (the first 64 splits' states kept in
  // registers between the two)
  float2* mlw = part_ml + head * ns * rows;
  for (int row = warp; row < rows; row += kWarps) {
    const int nself = verify ? row % rr + 1 : min(r + 1, rr);
    float2 held[2];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      held[k] = i < nlive ? __ldcg(mlw + (size_t)i * rows + row)
                          : make_float2(-CUDART_INF_F, 0.f);
      mx = fmaxf(mx, held[k].x);
    }
    for (int i = lane + 64; i < nlive; i += 32)
      mx = fmaxf(mx, __ldcg(mlw + (size_t)i * rows + row).x);
    for (int jr = lane; jr < nself; jr += 32) mx = fmaxf(mx, zs[row * rr + jr]);
    mx = warp_max(mx);
    if (lane == 0) big_s[row] = mx;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      if (i < nlive)
        mlw[(size_t)i * rows + row] =
            make_float2(expf(held[k].x - mx), held[k].y);
    }
    for (int i = lane + 64; i < nlive; i += 32) {
      const float2 a = __ldcg(mlw + (size_t)i * rows + row);
      mlw[(size_t)i * rows + row] = make_float2(expf(a.x - mx), a.y);
    }
  }
  __syncthreads();  // the block's own global writes are seen after it
  // thread (row, c): the splits in ascending order, then the self rows;
  // every thread of a row forms the same L
  for (int w = tid; w < rows * C; w += kThreads) {
    const int row = w / C, c = w % C;
    const int nself = verify ? row % rr + 1 : min(r + 1, rr);
    const float* po = part_o + head * ns * rows * C + (size_t)row * C + c;
    float l_sum = 0.f, o_sum = 0.f;
#pragma unroll 4
    for (int i = 0; i < nlive; ++i) {
      const float2 a = __ldcg(mlw + (size_t)i * rows + row);
      l_sum = fmaf(a.y, a.x, l_sum);
      o_sum = fmaf(__ldcg(po + (size_t)i * rows * C), a.x, o_sum);
    }
    for (int jr = 0; jr < nself; ++jr) {
      const float wgt = expf(zs[row * rr + jr] - big_s[row]);
      l_sum += wgt;
      o_sum = fmaf(wgt, to_f32(rv_s[jr * C + c]), o_sum);
    }
    out[(head * rows + row) * C + c] = from_f32<TQ>(o_sum / l_sum);
  }
}

// The launch arguments both entry points share.
struct Args {
  const void *q, *pool_k, *pool_v;
  const int *bt, *lens;
  const void *rk, *rv;
  const float *sk, *sv;
  float* part_o;
  float2* part_ml;
  int* tickets;
  void* out;
  int s, hkv, rows, num_pages, ps, pmax, rr, r, layer, verify;
  size_t smem;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int C>
cudaError_t launch(const Args& a) {
  using TR = typename RowType<TKV>::type;
  auto kern = paged_split_kernel<TQ, TKV, C>;
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
  }
  const int ns = (a.pmax + split_pages(a.ps) - 1) / split_pages(a.ps);
  kern<<<dim3(a.s, a.hkv, ns), kThreads, a.smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.pool_k),
      static_cast<const TKV*>(a.pool_v), a.bt, a.lens,
      static_cast<const TR*>(a.rk), static_cast<const TR*>(a.rv), a.sk, a.sv,
      a.part_o, a.part_ml, a.tickets, static_cast<TQ*>(a.out), a.hkv, a.rows,
      a.num_pages, a.ps, a.pmax, a.rr, a.r, a.verify, a.layer);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_c(int c, const Args& a) {
  if (c == 64) return launch<TQ, TKV, 64>(a);
  if (c == 128) return launch<TQ, TKV, 128>(a);
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only, with
// scales and bf16 self rows)
cudaError_t launch_typed(int q_dtype, int kv_dtype, int c, const Args& a) {
  if (kv_dtype == 2 && (a.sk == nullptr || a.sv == nullptr))
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 2) return launch_c<float, int8_t>(c, a);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_c<__nv_bfloat16, int8_t>(c, a);
  if (q_dtype == 0 && kv_dtype == 0) return launch_c<float, float>(c, a);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_c<__nv_bfloat16, __nv_bfloat16>(c, a);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_c<float, __nv_bfloat16>(c, a);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_c<__nv_bfloat16, float>(c, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One decode step: q [S, Hkv, G, C], recent rows [S, Hkv, R, C] of this
// layer, rows 0..r valid; scale_k / scale_v [S, Pmax, Hkv] for an int8
// pool, null otherwise; part_o [S, Hkv, NS, G, C] and part_ml [S, Hkv,
// NS, G, 2] f32 scratch, NS = ceil(Pmax / split pages), and tickets [S
// Hkv] int32, zero (the kernel leaves them zero). Returns a cudaError_t
// (0 = ok).
int paged_decode_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* bt,
    const void* pooled_len, const void* rk, const void* rv, void* out,
    const void* scale_k, const void* scale_v, void* part_o, void* part_ml,
    void* tickets, int s, int hkv, int groups, int c, int num_pages, int ps,
    int pmax, int rr, int r, int layer, int q_dtype, int kv_dtype,
    long long smem, void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const int*>(bt),
               static_cast<const int*>(pooled_len), rk, rv,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<float*>(part_o), static_cast<float2*>(part_ml),
               static_cast<int*>(tickets), out, s, hkv, groups, num_pages,
               ps, pmax, rr, r, layer, 0,
               static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  return launch_typed(q_dtype, kv_dtype, c, a);
}

// One verify dispatch: q [S, Hkv, G, T, C], the candidate rows' K/V
// kc, vc [S, Hkv, T, C], start [S] resident tokens, scales and scratch as
// above with G x T query rows (row g T + t). Returns a cudaError_t.
int paged_verify_attention_launch(
    const void* q, const void* kc, const void* vc, const void* pool_k,
    const void* pool_v, const void* bt, const void* start, void* out,
    const void* scale_k, const void* scale_v, void* part_o, void* part_ml,
    void* tickets, int s, int hkv, int groups, int t, int c, int num_pages,
    int ps, int pmax, int layer, int q_dtype, int kv_dtype, long long smem,
    void* stream) {
  const Args a{q, pool_k, pool_v, static_cast<const int*>(bt),
               static_cast<const int*>(start), kc, vc,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<float*>(part_o), static_cast<float2*>(part_ml),
               static_cast<int*>(tickets), out, s, hkv, groups * t,
               num_pages, ps, pmax, t, 0, layer, 1,
               static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)};
  return launch_typed(q_dtype, kv_dtype, c, a);
}

// Pages of one split at page size `ps` (the plan the wrappers mirror).
int paged_split_pages(int ps) { return ps > 0 ? split_pages(ps) : -1; }

}  // extern "C"
