// Causal GQA flash attention with counter-hash attention dropout for Hopper
// (sm_90a): the forward, the dq backward and the dk/dv backward.
//
// Replaces the Pallas TPU kernels of midgpt_tpu/ops/flash.py:
//   flash_fwd_wgmma_kernel (bf16), flash_fwd_kernel (f32)
//       <- `_fwd_kernel` (:156, called from `_flash_forward` :271)
//   flash_dq_tile_kernel (bf16), flash_dq_kernel (f32)
//       <- `_bwd_dq_kernel` (:300, called from `_flash_backward` :485)
//   flash_dkv_tile_kernel (bf16), flash_dkv_kernel (f32)
//       <- `_bwd_dkv_kernel` (:367, called from `_flash_backward` :508)
//
// What each computes, per (batch b, query head h, kv head h / G), with
// q [B, H, T, C], k and v [B, Hkv, T, C] (any strides whose last is 1):
//   forward: z = (q . k) * scale with f32 sums, future columns set to -1e30
//            after the scale; online max m and UNDROPPED sum l; the value
//            sums see p * mask / keep, rounded to the input type; out =
//            acc / l in the input type, lse = m + log l in f32.
//   dq:      p = exp(z - lse); dp = dO V^T, masked and scaled by 1 / keep;
//            ds = p (dp - delta) scale, rounded to the input type;
//            dq = ds K (f32 sums).
//   dk, dv:  the same p, dp, ds on the transposed walk; dv = (p mask /
//            keep)^T dO with the dropped p rounded to the input type, dk =
//            ds^T Q; written per q head (the GQA sum runs outside).
// delta = rowsum(dO * O) - dlse, which JAX leaves to XLA outside the
// Pallas kernels, is computed by the dq kernel for its q tile from O (and
// dlse) and written for the dk/dv launch; the dq kernel also takes a given
// delta (the kernel checks). The dropout mask is the counter hash of
// attn_tiles.cuh, regenerated in every kernel from (seed, flat q head,
// global row, global column).
//
// What bounds them on this card: at the shakespeare_char microbatch (B=64,
// H=6, T=256, C=64, bf16) the forward moves ~51 MB and does ~3.2 GFLOP,
// the backward ~88 MB and ~11 GFLOP, so all three are bound by bytes
// (tens of microseconds). The f32 kernels keep FMA loops: the f32 checks
// need f32 products, which the tensor cores do not give.
//   - The bf16 kernels are the `wgmma` tile cores of attn_tiles.cuh,
//     shared with fused_attn.cu: S, P and the output sums (forward), S,
//     dP, dS and the dQ sums (dq) or S^T, dP^T, P^T, dS^T and the dK/dV
//     sums (dk/dv) in registers, operand tiles double-buffered by
//     cp.async, so no shared-memory round trip. What bounds them is the
//     CUDA-core work
//     per score between the products: the exponent, the mask on the
//     diagonal tile, and with dropout the counter hash (about a dozen
//     integer operations an element, its row and column terms hoisted),
//     which the warpgroups of an SM overlap with each other's products;
//     the dk/dv kernel also pays each tile pair's serial chain (two
//     products, the elementwise pass, two products), and dq the same chain
//     per k tile (two products, the elementwise pass, one product), over
//     short walks at T=256 (one to four k tiles), so its prologue (the q
//     tile, and the delta rows from O and dO) is a large share of a block.
// What the design does instead of the TPU's:
//   - The TPU grid walks its last axis in order and carries m, l and the
//     accumulators in VMEM scratch across grid steps; here each block
//     loops over the other axis itself, keeping the sums in registers
//     (forward: the wgmma accumulators, rescaled in place; dq and dk/dv:
//     the wgmma accumulators, which nothing rescales).
//   - Blocks run in no order: the heavy tiles of the causal triangle are
//     scheduled first (last q tiles for the forward and dq); a causal
//     dk/dv block takes the k tile pair (g, nk - 1 - g), equal work.
//   - The TPU's in-kernel PRNG is not used by the JAX kernels either: the
//     hash is plain integer arithmetic, so the mask here is the JAX mask.
// Thread layouts: FMA kernels use 256 threads as a 16 x 16 grid (tx, ty),
// a thread owning rows ty + 16 i and columns tx + 16 j of each 64-row
// tile; the wgmma kernels give each warpgroup 64 rows in the
// accumulator layout of hopper.cuh (two rows, 16 of 64 columns a thread).
// Plain C interface: the launchers return cudaGetLastError() so the Python
// wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "hopper.cuh"

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using namespace hopper;
using namespace attn_tiles;

constexpr int kThreads = 256;
constexpr int kPP = kTile + 1;  // padded row of an f32 [64, 64] tile

// reductions over the 16 lanes that share a tile row (tx = lane % 16)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [0, 64) of src (row stride `stride`) -> dst [64][C + 1], f32
template <int C>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride) {
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[r * (C + 1) + c] = src[r * stride + c];
  }
}

// 64 f32 values of a [B, H, T] row vector -> dst
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// f32: FMA loops. One block per (q-tile, head, batch) for the forward and dq
// (heavy late q-tiles first), per (k-tile, head, batch) for dk/dv.
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
    float* __restrict__ out, float* __restrict__ lse, Dims d, Drop dr) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [64][C+1]
  float* k_s = q_s + kTile * kCP;  // [64][C+1]
  float* v_s = k_s + kTile * kCP;  // [64][C+1]
  float* p_s = v_s + kTile * kCP;  // [64][65] dropped probabilities

  const int nq = d.t / kTile;
  const int iq = nq - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = iq * kTile;
  const float* qb = q + b * sq.b + head * sq.h + t0 * sq.t;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const uint32_t bh = flat_head(dr, b, head);

  load_tile<C>(q_s, qb, sq.t);

  float m[4], l[4], acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int last = d.causal ? iq : nq - 1;
  for (int jk = 0; jk <= last; ++jk) {
    const int s0 = jk * kTile;
    load_tile<C>(k_s, kb + s0 * sk.t, sk.t);
    load_tile<C>(v_s, vb + s0 * sv.t, sv.t);
    __syncthreads();

    float z[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * kCP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * kCP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(a[i], bk[j], z[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float zz = z[i][j] * d.scale;
        if (d.causal && jk == iq && tx + 16 * j > r) zz = kNegInf;
        z[i][j] = zz;
        mx = fmaxf(mx, zz);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = expf(z[i][j] - m_new);
        rs += p;  // l sums the undropped probabilities
        float pa = p;
        if (dr.on)
          pa = keep_at(dr, bh, dr.row_off + t0 + r, dr.col_off + s0 + col)
                   ? p * dr.inv_keep
                   : 0.f;
        p_s[r * kPP + col] = pa;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) vv[j] = v_s[kk * kCP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // k_s, v_s and p_s are refilled by the next k-tile
  }

  float* ob = out + ((static_cast<long long>(b) * d.h + head) * d.t + t0) * C;
  float* lb = lse + (static_cast<long long>(b) * d.h + head) * d.t + t0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) ob[r * C + tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0) lb[r] = m[i] + logf(l[i]);
  }
}

// S = Q K^T and dP = dO V^T for this thread's 4 x 4 entries, one pass over C
template <int C>
__device__ __forceinline__ void scores_fma(const float* q_s, const float* k_s,
                                           const float* do_s, const float* v_s,
                                           float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int kCP = C + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty + 16 * i) * kCP + c];
      g[i] = do_s[(ty + 16 * i) * kCP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = k_s[(tx + 16 * j) * kCP + c];
      bv[j] = v_s[(tx + 16 * j) * kCP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, Strides sq,
    Strides sk, Strides sv, Strides sd, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ out,
    Strides so, const float* __restrict__ dlse,
    float* __restrict__ delta_out, float* __restrict__ dq, Dims d,
    Drop dr) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][C+1]
  float* do_s = q_s + kTile * kCP;    // [64][C+1]
  float* k_s = do_s + kTile * kCP;    // [64][C+1]
  float* v_s = k_s + kTile * kCP;     // [64][C+1]
  float* ds_s = v_s + kTile * kCP;    // [64][65]
  float* lse_s = ds_s + kTile * kPP;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int nq = d.t / kTile;
  const int iq = nq - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = iq * kTile;
  const long long row = (static_cast<long long>(b) * d.h + head) * d.t + t0;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const uint32_t bh = flat_head(dr, b, head);

  load_tile<C>(q_s, q + b * sq.b + head * sq.h + t0 * sq.t, sq.t);
  load_tile<C>(do_s, dout + b * sd.b + head * sd.h + t0 * sd.t, sd.t);
  load_rows(lse_s, lse + row);
  if (out == nullptr) {
    load_rows(delta_s, delta + row);
  } else {
    // delta = rowsum(dO * O) - dlse, four threads a row
    __syncthreads();  // do_s is whole
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const float* orow = out + b * so.b + head * so.h + (t0 + r) * so.t;
    float dsum = 0.f;
    for (int c = part; c < C; c += 4)
      dsum = fmaf(do_s[r * kCP + c], orow[c], dsum);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    if (dlse != nullptr) dsum -= dlse[row + r];
    if (part == 0) {
      delta_s[r] = dsum;  // seen after the k-tile loop's first barrier
      delta_out[row + r] = dsum;
    }
  }

  float acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

  const int last = d.causal ? iq : nq - 1;
  for (int jk = 0; jk <= last; ++jk) {
    const int s0 = jk * kTile;
    load_tile<C>(k_s, kb + s0 * sk.t, sk.t);
    load_tile<C>(v_s, vb + s0 * sv.t, sv.t);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_fma<C>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse_r = lse_s[r], delta_r = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float z = s[i][j] * d.scale;
        if (d.causal && jk == iq && col > r) z = kNegInf;
        const float p = expf(z - lse_r);
        float g = dp[i][j];
        if (dr.on)
          g = keep_at(dr, bh, dr.row_off + t0 + r, dr.col_off + s0 + col)
                  ? g * dr.inv_keep
                  : 0.f;
        ds_s[r * kPP + col] = p * (g - delta_r) * d.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kc = 0; kc < kTile; ++kc) {
      float dd[4], kk[kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dd[i] = ds_s[(ty + 16 * i) * kPP + kc];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) kk[j] = k_s[kc * kCP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(dd[i], kk[j], acc[i][j]);
    }
    __syncthreads();  // k_s, v_s and ds_s are refilled by the next k-tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      dq[(row + ty + 16 * i) * C + tx + 16 * j] = acc[i][j];
}

template <int C>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, Strides sq,
    Strides sk, Strides sv, Strides sd, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, Dims d, Drop dr) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [64][C+1]
  float* v_s = k_s + kTile * kCP;     // [64][C+1]
  float* q_s = v_s + kTile * kCP;     // [64][C+1]
  float* do_s = q_s + kTile * kCP;    // [64][C+1]
  float* p_s = do_s + kTile * kCP;    // [64][65] dropped p
  float* ds_s = p_s + kTile * kPP;    // [64][65]
  float* lse_s = ds_s + kTile * kPP;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int nq = d.t / kTile;
  const int jk = blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int s0 = jk * kTile;
  const long long bhrow = (static_cast<long long>(b) * d.h + head) * d.t;
  const float* qb = q + b * sq.b + head * sq.h;
  const float* db = dout + b * sd.b + head * sd.h;
  const uint32_t bh = flat_head(dr, b, head);

  load_tile<C>(k_s, k + b * sk.b + kvh * sk.h + s0 * sk.t, sk.t);
  load_tile<C>(v_s, v + b * sv.b + kvh * sv.h + s0 * sv.t, sv.t);

  float dka[4][kNJ], dva[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int iq = d.causal ? jk : 0; iq < nq; ++iq) {
    const int t0 = iq * kTile;
    load_tile<C>(q_s, qb + t0 * sq.t, sq.t);
    load_tile<C>(do_s, db + t0 * sd.t, sd.t);
    load_rows(lse_s, lse + bhrow + t0);
    load_rows(delta_s, delta + bhrow + t0);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_fma<C>(q_s, k_s, do_s, v_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse_r = lse_s[r], delta_r = delta_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float z = s[i][j] * d.scale;
        if (d.causal && iq == jk && col > r) z = kNegInf;
        const float p = expf(z - lse_r);
        float pv = p, g = dp[i][j];
        if (dr.on) {
          const bool kp =
              keep_at(dr, bh, dr.row_off + t0 + r, dr.col_off + s0 + col);
          pv = kp ? p * dr.inv_keep : 0.f;
          g = kp ? g * dr.inv_keep : 0.f;
        }
        p_s[r * kPP + col] = pv;
        ds_s[r * kPP + col] = p * (g - delta_r) * d.scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for this thread's k rows
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pp[4], dd[4], gg[kNJ], qq[kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = p_s[r * kPP + ty + 16 * i];
        dd[i] = ds_s[r * kPP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        gg[j] = do_s[r * kCP + tx + 16 * j];
        qq[j] = q_s[r * kCP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          dva[i][j] = fmaf(pp[i], gg[j], dva[i][j]);
          dka[i][j] = fmaf(dd[i], qq[j], dka[i][j]);
        }
    }
    __syncthreads();  // q_s, do_s, p_s, ds_s are refilled next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = (bhrow + s0 + ty + 16 * i) * C + tx;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      dk[o + 16 * j] = dka[i][j];
      dv[o + 16 * j] = dva[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three functions with the matrix products on the tensor
// cores (the wgmma cores of attn_tiles.cuh; bf16 operands, f32 sums). The
// operands the products read are exactly the values the FMA kernels use,
// rounded where the JAX kernels round (P and dS to the input type), so
// only the order of the f32 sums differs (and the forward's exponent,
// taken in base 2).
// ---------------------------------------------------------------------------

// Forward, bf16: the forward core of attn_tiles.cuh, dropout where dr.on;
// one block of two warpgroups per 128 q rows, out contiguous [B, H, T, C].
template <int C>
__global__ void __launch_bounds__(2 * kWgThreads) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
    bf16* __restrict__ out, float* __restrict__ lse, Dims d, Drop dr) {
  extern __shared__ unsigned char smem_raw[];
  const Strides so{static_cast<long long>(d.h) * d.t * C,
                   static_cast<long long>(d.t) * C, C};
  fwd_block<C, true>(q, k, v, sq, sk, sv, out, so, lse, d, dr, smem_raw);
}

// dq, bf16: the q-tile core of attn_tiles.cuh on raw q, k, v and dO, with
// the dropout mask (kDrop). One warpgroup and one 64-row q tile a block
// (causal: heavy late tiles first); dQ goes out as bf16 [B, H, T, C]
// straight from the accumulator registers. kDelta: the block first
// computes its tile's delta = rowsum(dO * O) - dlse in f32 (two threads a
// row, 16-byte loads of O and dO), uses it and writes it, [B, H, T] f32,
// for the dk/dv launch that follows on the same stream; without it the
// delta rows are read. At C=64 held to 128 registers without dropout, so
// that four blocks share an SM (about 50 KB of shared memory each), as
// the fused dq kernel is; with dropout (the hash's terms) to 168, three
// blocks: at 128 it spilled 84 bytes and ran 3% slower.
template <int C, bool kDrop, bool kDelta>
__global__ void __launch_bounds__(kWgThreads, C == 64 ? (kDrop ? 3 : 4) : 1)
    flash_dq_tile_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout, Strides sq,
    Strides sk, Strides sv, Strides sd, const float* __restrict__ lse,
    const float* __restrict__ delta_in, const bf16* __restrict__ out,
    Strides so, const float* __restrict__ dlse,
    float* __restrict__ delta_out, bf16* __restrict__ dq, Dims d, Drop dr) {
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // dQ floats a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  // Q, dO; two stages of K and of V; the lse and delta rows
  const uint32_t q_s = base, do_s = base + kTileB;
  const uint32_t k_s = base + 2 * kTileB, v_s = base + 4 * kTileB;
  const uint32_t rows_s = base + 6 * kTileB;
  float* rows_g = reinterpret_cast<float*>(gbase + 6 * kTileB);

  const int nq = d.t / kTile;
  const int iq = d.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int tid = threadIdx.x;
  const int t0 = iq * kTile;
  const long long row = (static_cast<long long>(b) * d.h + head) * d.t + t0;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const bf16* dob = dout + b * sd.b + head * sd.h + t0 * sd.t;

  // the q tile's Q, dO and lse (and delta) rows, then K/V tile 0
  load_tile_async<C>(q_s, q + b * sq.b + head * sq.h + t0 * sq.t, sq.t,
                     kTile, tid, kWgThreads);
  load_tile_async<C>(do_s, dob, sd.t, kTile, tid, kWgThreads);
  if (tid < 16)
    cp_async16(rows_s + tid * 16, lse + row + tid * 4);
  else if (!kDelta && tid < 32)
    cp_async16(rows_s + kTile * 4 + (tid - 16) * 16,
               delta_in + row + (tid - 16) * 4);
  load_tile_async<C>(k_s, kb, sk.t, kTile, tid, kWgThreads);
  load_tile_async<C>(v_s, vb, sv.t, kTile, tid, kWgThreads);
  cp_async_commit();

  if constexpr (kDelta) {
    // thread pair (r, half) sums columns [half C / 2, (half + 1) C / 2)
    const int r = tid >> 1, half = tid & 1;
    const bf16* orow = out + b * so.b + head * so.h + (t0 + r) * so.t +
                       half * (C / 2);
    const bf16* grow = dob + r * sd.t + half * (C / 2);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C / 2; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (dlse != nullptr) acc -= dlse[row + r];
    if (half == 0) {
      rows_g[kTile + r] = acc;  // seen after the walk's first barrier
      delta_out[row + r] = acc;
    }
  }

  float dqa[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) dqa[i] = 0.f;
  const DqTiles sm{q_s, do_s, k_s, v_s, rows_g};
  const DqOperands in{kb, sk.t, vb, sv.t};
  const DropTile dt{dr.seed + flat_head(dr, b, head) * 0xC2B2AE35u,
                    dr.row_off + t0, dr.col_off, dr.thresh, dr.inv_keep};
  dq_walk<C, kDrop>(sm, in, iq, d.causal ? iq + 1 : nq, d.causal, d.scale,
                    dt, dqa);

  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2), cbase = (lane & 3) * 2;
  bf16* dqb = dq + row * C;
#pragma unroll
  for (int i = 0; i < kNO; i += 2) {
    const int rr = r0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + cbase;
    *reinterpret_cast<uint32_t*>(dqb + rr * C + col) =
        pack_bf16(dqa[i], dqa[i + 1]);
  }
}

// dk/dv, bf16: the backward's k-tile core of attn_tiles.cuh on raw q, k,
// v and dO, with the dropout mask (kDrop). Causal: one block per k tile
// pair (g, nk - 1 - g), equal causal work (the middle tile alone where nk
// is odd), (nk + 1) / 2 blocks a (b, head); non-causal: one k tile a
// block, walking every q tile. dK and dV go out per q head, [B, H, T, C]
// bf16, straight from the accumulator registers (the GQA sum runs
// outside). At C=64 held to 168 registers so that three blocks share an
// SM (at 218 two fit): 9% faster at the char shape for 16 bytes of
// spill; at C=128 the cap spills hundreds of bytes, so none.
template <int C, bool kDrop>
__global__ void __launch_bounds__(kWgThreads, C == 64 ? 3 : 1)
    flash_dkv_tile_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout, Strides sq,
    Strides sk, Strides sv, Strides sd, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Dims d, Drop dr) {
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // dK / dV floats a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  // K, V; two stages of Q and of dO; two of lse and of delta
  const KvTiles sm{base, base + kTileB, base + 2 * kTileB, base + 4 * kTileB,
                   0u, base + 6 * kTileB,
                   reinterpret_cast<const float*>(gbase + 6 * kTileB)};

  const int g = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int nk = d.t / kTile;
  const long long bhrow = (static_cast<long long>(b) * d.h + head) * d.t;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  KvOperands in{nullptr, sk.t, nullptr, sv.t, q + b * sq.b + head * sq.h,
                sq.t, dout + b * sd.b + head * sd.h, sd.t, lse + bhrow,
                delta + bhrow};
  DropTile dt{dr.seed + flat_head(dr, b, head) * 0xC2B2AE35u, dr.row_off, 0u,
              dr.thresh, dr.inv_keep};
  const int n_tiles = d.causal && g != nk - 1 - g ? 2 : 1;
  const int r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int cbase = (threadIdx.x & 3) * 2;

  for (int n = 0; n < n_tiles; ++n) {
    const int jk = n == 0 ? g : nk - 1 - g;
    const int s0 = jk * kTile;
    in.k = kb + s0 * sk.t;
    in.v = vb + s0 * sv.t;
    dt.col = dr.col_off + s0;
    float dka[kNO], dva[kNO];
    dkv_walk<C, false, kDrop>(sm, in, jk, nk, d.causal, d.scale, dt, nullptr,
                              false, dka, dva);
    bf16* dkb = dk + (bhrow + s0) * C;
    bf16* dvb = dv + (bhrow + s0) * C;
#pragma unroll
    for (int i = 0; i < kNO; i += 2) {
      const int row = r0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + cbase;
      *reinterpret_cast<uint32_t*>(dvb + row * C + col) =
          pack_bf16(dva[i], dva[i + 1]);
      *reinterpret_cast<uint32_t*>(dkb + row * C + col) =
          pack_bf16(dka[i], dka[i + 1]);
    }
  }
}

// Dynamic shared memory of one block, by kernel (0 forward, 1 dq, 2 dkv).
// bf16 forward: attn_tiles.cuh's fwd_smem_bytes. bf16 dq: six swizzled
// [64, C] tiles (Q, dO, two stages of K and of V), the lse and delta rows
// and 1024 bytes of alignment slack. bf16 dk/dv: six swizzled [64, C]
// tiles (K, V, two stages of Q and of dO), two stages of the lse and delta
// rows and the slack.
template <typename T, int C>
constexpr int smem_bytes(int which) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (which == 0) return fwd_smem_bytes<C>();
    if (which == 2) return 6 * kTile * C * 2 + 4 * kTile * 4 + 1024;
    return 6 * kTile * C * 2 + 2 * kTile * 4 + 1024;
  } else {
    const int tiles = which == 0 ? 3 : 4;  // f32 [64][C+1] operand tiles
    const int pp = which == 2 ? 2 : 1;     // f32 [64][65] p / ds tiles
    const int rows = which == 0 ? 0 : 2 * kTile;
    return 4 * (tiles * kTile * (C + 1) + pp * kTile * kPP + rows);
  }
}

template <typename T, int C>
auto fwd_kernel() {
  if constexpr (std::is_same<T, bf16>::value)
    return flash_fwd_wgmma_kernel<C>;
  else
    return flash_fwd_kernel<C>;
}
template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const Strides* st, void* out, float* lse, int b,
                       Dims d, Drop dr, cudaStream_t stream) {
  const bool wg = std::is_same<T, bf16>::value;
  auto kern = fwd_kernel<T, C>();
  const int smem = smem_bytes<T, C>(0);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // bf16: one block of two warpgroups per 128 q rows; f32: per 64 rows
  const int rows = wg ? 2 * kTile : kTile;
  dim3 grid((d.t + rows - 1) / rows, d.h, b);
  kern<<<grid, wg ? 2 * kWgThreads : kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], static_cast<T*>(out), lse,
      d, dr);
  return cudaGetLastError();
}

// What one dq launch reads besides q, k, v and dO: the lse rows and
// either the delta rows (`out` null) or O, with an optional dlse, from
// which the kernel computes delta and writes it to `delta_out`.
struct DqRows {
  const float* lse;
  const float* delta;
  const void* out;
  const float* dlse;
  float* delta_out;
};

// bf16: the q-tile core, one warpgroup a q tile, dropout and the delta
// computation compiled in only where the call needs them; f32: 256
// threads a q tile.
template <typename T, int C>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const Strides* st, const DqRows& rw,
                      void* dq, int b, Dims d, Drop dr, cudaStream_t stream) {
  const int smem = smem_bytes<T, C>(1);
  dim3 grid(d.t / kTile, d.h, b);
  if constexpr (std::is_same<T, bf16>::value) {
    const bool own = rw.out != nullptr;
    auto kern = dr.on ? (own ? flash_dq_tile_kernel<C, true, true>
                             : flash_dq_tile_kernel<C, true, false>)
                      : (own ? flash_dq_tile_kernel<C, false, true>
                             : flash_dq_tile_kernel<C, false, false>);
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kWgThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), st[0], st[1],
        st[2], st[3], rw.lse, rw.delta, static_cast<const T*>(rw.out), st[4],
        rw.dlse, rw.delta_out, static_cast<T*>(dq), d, dr);
  } else {
    cudaError_t err = set_smem(flash_dq_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    flash_dq_kernel<C><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), st[0], st[1],
        st[2], st[3], rw.lse, rw.delta, static_cast<const T*>(rw.out), st[4],
        rw.dlse, rw.delta_out, static_cast<T*>(dq), d, dr);
  }
  return cudaGetLastError();
}

// bf16: the k-tile core, one block per k tile pair (causal) or k tile
// (non-causal), dropout compiled in only where the call draws it; f32: one
// block per k tile.
template <typename T, int C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const Strides* st, const float* lse,
                       const float* delta, void* dk, void* dv, int b, Dims d,
                       Drop dr, cudaStream_t stream) {
  const int smem = smem_bytes<T, C>(2);
  const int nk = d.t / kTile;
  if constexpr (std::is_same<T, bf16>::value) {
    auto kern = dr.on ? flash_dkv_tile_kernel<C, true>
                      : flash_dkv_tile_kernel<C, false>;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(d.causal ? (nk + 1) / 2 : nk, d.h, b);
    kern<<<grid, kWgThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), st[0], st[1],
        st[2], st[3], lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        d, dr);
  } else {
    cudaError_t err = set_smem(flash_dkv_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<C><<<dim3(nk, d.h, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), st[0], st[1],
        st[2], st[3], lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        d, dr);
  }
  return cudaGetLastError();
}

// strides: [3 * n] element strides (batch, head, row) of the n operands
Strides* unpack(const long long* s, Strides* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  return out;
}

bool bad_dims(int t, int h, int hkv) {
  return t <= 0 || t % kTile != 0 || hkv <= 0 || h % hkv != 0;
}

Drop make_drop(int on, unsigned seed, unsigned row_off, unsigned col_off,
               unsigned bh_off, int n_head_total, unsigned thresh,
               float inv_keep) {
  return Drop{seed, row_off, col_off, bh_off, thresh, n_head_total, on,
              inv_keep};
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `strides` holds (batch, head,
// row) element strides of q, k, v (and dO for the backward, and O for dq). Outputs are
// contiguous [B, H, T, C] (lse [B, H, T] f32). Return a cudaError_t (0 =
// ok).
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const long long* strides, void* out, void* lse, int b,
                     int t, int h, int hkv, int c, int dtype, int causal,
                     float scale, int drop_on, unsigned seed, unsigned row_off,
                     unsigned col_off, unsigned bh_off, int n_head_total,
                     unsigned thresh, float inv_keep, void* stream) {
  if (bad_dims(t, h, hkv)) return cudaErrorInvalidValue;
  Strides st[3];
  unpack(strides, st, 3);
  const Dims d{t, h, hkv, causal, scale};
  const Drop dr = make_drop(drop_on, seed, row_off, col_off, bh_off,
                            n_head_total, thresh, inv_keep);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, C) return launch_fwd<T, C>(q, k, v, st, out, lse_f, b, d, dr, s)
  if (dtype == 0 && c == 64) FWD(float, 64);
  if (dtype == 0 && c == 128) FWD(float, 128);
  if (dtype == 1 && c == 64) FWD(bf16, 64);
  if (dtype == 1 && c == 128) FWD(bf16, 128);
#undef FWD
  return cudaErrorInvalidValue;
}

// dq: `strides` holds those of q, k, v, dO and O. With `out` null the
// kernel reads `delta`; else it computes delta = rowsum(dO * O) (less
// `dlse` where that is not null) and writes it to `delta_out`, [B, H, T]
// f32.
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dout, const void* out,
                    const long long* strides, const void* lse,
                    const void* delta, const void* dlse, void* delta_out,
                    void* dq, int b, int t, int h, int hkv, int c, int dtype,
                    int causal, float scale, int drop_on, unsigned seed,
                    unsigned row_off, unsigned col_off, unsigned bh_off,
                    int n_head_total, unsigned thresh, float inv_keep,
                    void* stream) {
  if (bad_dims(t, h, hkv)) return cudaErrorInvalidValue;
  if (out == nullptr ? delta == nullptr : delta_out == nullptr)
    return cudaErrorInvalidValue;
  Strides st[5];
  unpack(strides, st, 5);
  const Dims d{t, h, hkv, causal, scale};
  const Drop dr = make_drop(drop_on, seed, row_off, col_off, bh_off,
                            n_head_total, thresh, inv_keep);
  const DqRows rw{static_cast<const float*>(lse),
                  static_cast<const float*>(delta), out,
                  static_cast<const float*>(dlse),
                  static_cast<float*>(delta_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, C) return launch_dq<T, C>(q, k, v, dout, st, rw, dq, b, d, dr, s)
  if (dtype == 0 && c == 64) DQ(float, 64);
  if (dtype == 0 && c == 128) DQ(float, 128);
  if (dtype == 1 && c == 64) DQ(bf16, 64);
  if (dtype == 1 && c == 128) DQ(bf16, 128);
#undef DQ
  return cudaErrorInvalidValue;
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dout, const long long* strides,
                     const void* lse, const void* delta, void* dk, void* dv,
                     int b, int t, int h, int hkv, int c, int dtype,
                     int causal, float scale, int drop_on, unsigned seed,
                     unsigned row_off, unsigned col_off, unsigned bh_off,
                     int n_head_total, unsigned thresh, float inv_keep,
                     void* stream) {
  if (bad_dims(t, h, hkv)) return cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st, 4);
  const Dims d{t, h, hkv, causal, scale};
  const Drop dr = make_drop(drop_on, seed, row_off, col_off, bh_off,
                            n_head_total, thresh, inv_keep);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, C)                                                           \
  return launch_dkv<T, C>(q, k, v, dout, st, lse_f, delta_f, dk, dv, b, d, \
                          dr, s)
  if (dtype == 0 && c == 64) DKV(float, 64);
  if (dtype == 0 && c == 128) DKV(float, 128);
  if (dtype == 1 && c == 64) DKV(bf16, 64);
  if (dtype == 1 && c == 128) DKV(bf16, 128);
#undef DKV
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a bf16 kernel launches with, for reports: `which`
// 0 the forward, 1 dq, 2 dk/dv; -1 for a shape no launcher takes.
int flash_smem_bytes(int c, int which) {
  if ((c != 64 && c != 128) || which < 0 || which > 2) return -1;
  return c == 64 ? smem_bytes<bf16, 64>(which) : smem_bytes<bf16, 128>(which);
}

}  // extern "C"
