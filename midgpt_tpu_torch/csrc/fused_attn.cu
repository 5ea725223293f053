// Fused QK-LayerNorm + RoPE + causal attention for Hopper (sm_90a): the
// forward and the backward (combined and split routes), read straight out
// of the packed qkv projection [B, T, (H + 2 Hkv) C].
//
// Replaces the Pallas TPU kernels of midgpt_tpu/ops/fused_attn.py:
//   fused_fwd_prep_kernel + fused_fwd_wgmma_kernel (bf16, one route of
//   two launches), fused_fwd_kernel (f32)
//       <- `_fwd_kernel` (:137, called from `_fused_forward`, :238)
//   fused_bwd_prep_kernel + fused_bwd_tile_kernel<C, true> +
//   fused_bwd_post_kernel (bf16, one route of three launches),
//   fused_bwd_kernel (f32)
//       <- `_bwd_combined_kernel` (:444, called from
//          `_fused_backward_combined`, :556)
//   fused_dq_tile_kernel (bf16, after fused_bwd_prep_kernel),
//   fused_dq_kernel (f32)
//       <- `_bwd_dq_kernel` (:292, called from `_fused_backward`, :657)
//   fused_bwd_tile_kernel<C, false> (bf16, after the same pre-pass),
//   fused_dkv_kernel (f32)
//       <- `_bwd_dkv_kernel` (:365, called from `_fused_backward`, :704)
//   The combined backward takes T up to the JAX package's cap (1024 at
//   C=64, 2048 at C=128); the split route takes the longer sequences.
//
// What each computes, per (batch b, query head h):
//   forward:  LN in f32 (mean-subtract, rsqrt(var + eps), times wq / wk),
//             interleaved RoPE in f32 from [T, C] tables, q and k rounded
//             to the input type; z = (q . k) * scale with f32 sums, future
//             columns set to -1e30; online max / sum; P rounded to the
//             input type before PV; out = acc / l, lse = m + log l.
//   backward: recompute LN + RoPE; p = exp(z - lse); delta = sum_c dO * O;
//             dv = P^T dO; dp = dO V^T; ds = p (dp - delta) scale, rounded
//             to the input type; dq_rot = ds K and dk_rot = ds^T Q in f32;
//             then back through RoPE (d_ln = d cos + R^T (d sin)) and the
//             LayerNorm (dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat
//             xhat))), with the LN weights' row products summed per block.
//
// What bounds them on this card: the forward moves ~51 MB and does ~13
// GFLOP at the 124M train shapes (B=8, T=1024, H=12, C=64), the backward
// ~102 MB and ~32 GFLOP, so both sit near the card's ridge; either bound
// is tens of microseconds. The f32 kernels keep FMA loops: the f32 checks
// need f32 products, which the tensor cores do not give.
//   - Every bf16 route starts with one pre-pass that does LayerNorm and
//     RoPE once per q and k row into bf16 q^ and k^ (bound by bytes). The
//     bf16 forward then runs the flash forward's `wgmma` core
//     (attn_tiles.cuh, shared with flash.cu: two warpgroups a 128-row
//     block, S, P and O in registers, a cp.async K/V ring) on q^, k^ and
//     v read in place from qkv, writing out [B, T, H C] from registers;
//     it is bounded by the CUDA-core work between its two products (the
//     exponent, the mask on the diagonal tile).
//   - Both bf16 backward routes start with the same pre-pass (with
//     delta) and run every product on `wgmma` (hopper.cuh) with S, dP, P
//     and dS in registers. The
//     combined tile kernel (attn_tiles.cuh's k-tile core, shared with
//     flash.cu's dk/dv kernel) keeps dK and dV in registers and stages dS
//     through shared memory once, as the operand of dQ; it is bounded by
//     the serial chain of each tile pair (two products, the elementwise
//     pass, two products, the dQ product and the f32 read-add-write of
//     the group's dq partial), which blocks of (group, head, batch)
//     overlap: 4 x 96 = 384 blocks at the train shape. The split route's
//     dq kernel keeps dQ^ in registers for a q tile's whole walk (three
//     products a tile pair, no partials) and its dk/dv kernel is the
//     combined tile core without the dQ half (four products); both are
//     bounded by the same per-tile-pair chain, spread over B H T / 64
//     and B H T / 128 blocks (1536 / 768 at B=4, T=2048, H=12). The
//     pre- and post-passes are bound by bytes: q^, k^, delta and the
//     combined route's G dq partials written and read.
// What the design does instead of the TPU's:
//   - The TPU grid runs in order and carries the LN weights' gradient
//     across heads in VMEM scratch; here blocks run in parallel, so each
//     block writes its own [C] partial (per (b, head) in the f32 kernel,
//     per (b, head, block) and (b, head, q tile) in the bf16 routes); the
//     sum over partials runs outside the kernels, in a fixed order (no
//     atomics, so the result is deterministic).
//   - The TPU keeps a whole [T, T] f32 score block in VMEM (4 MB at
//     T=1024). Here everything is tiled 64 x 64: the forward is one block
//     per (b, head, q tile) (f32) or pair of q tiles (bf16) walking the
//     k tiles up to its own; the combined
//     backward walks k-tiles (outer) and q-tiles >= the k-tile (inner),
//     computing S and P once per tile pair (five products, not the split
//     route's seven), dK and dV kept on chip for the current k-tile. The
//     f32 kernel is one block per (b, head), dq_rot accumulated in an f32
//     scratch only that block touches; the bf16 route splits a (b, head)'s
//     k tiles into groups of equal causal work, one block each, and keeps
//     one f32 dq partial per group, summed in group order by the
//     post-pass: deterministic without atomics. The split route pays S
//     and dP twice, as the JAX kernels do, and needs no partials: each dq
//     block owns its q tiles' rows, each dk/dv block its k tiles' rows.
//   - The TPU recomputes LayerNorm and RoPE of every tile it loads; the
//     bf16 routes do it once per row in the pre-pass, and read the raw q
//     and k rows again only in the epilogues that go back through them.
//   - RoPE's [C, C] signed-permutation matmul (an MXU trick) becomes a pair
//     swap, bit for bit the same; its transpose is the inverse swap.
//   - Two C=64 heads sharing a 128-lane block (a TPU lane artefact) become
//     one head per block.
// FMA kernels' thread layout: 256 threads as a 16 x 16 grid (tx, ty); a
// thread owns rows ty + 16 i (i < 4) and columns tx + 16 j of each 64-row
// tile. The wgmma kernels are one warpgroup a 64-row tile, in the
// accumulator layout of hopper.cuh. LayerNorm passes give each warp whole
// rows (C / 32 values a lane).
// Plain C interface (route (b) of the build): the launchers return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "hopper.cuh"

#include <cstddef>

namespace {

using namespace hopper;
using attn_tiles::bf16;
using attn_tiles::kNegInf;
using attn_tiles::kTile;
using attn_tiles::kWgThreads;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDqGroupsMax = 4;  // dq partial groups (fused_attn.DQ_GROUPS)
constexpr int kPP = kTile + 1;  // padded row of a [64, 64] tile

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like a cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// rows [0, 64) of src (row stride `stride` elements) -> dst [64][C + 1]
template <int C>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride) {
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dst[r * (C + 1) + c] = src[(size_t)r * stride + c];
  }
}

// One row's LayerNorm statistics from this lane's C/32 values `v`:
// centres `v` in place and returns rstd. Sums are warp-wide.
template <int C>
__device__ __forceinline__ float ln_stats(float* v, float eps) {
  constexpr int kPer = C / 32;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) s += v[e];
  const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(C));
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    v[e] = __fsub_rn(v[e], mean);
    sq = __fadd_rn(sq, __fmul_rn(v[e], v[e]));
  }
  const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(C));
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// LayerNorm + RoPE of the 64 rows of `x` (raw values, [64][C + 1]) in
// place; row r sits at sequence position t0 + r.
template <int C>
__device__ void ln_rope_tile(float* x, const float* __restrict__ w,
                             const float* __restrict__ sn_tab,
                             const float* __restrict__ cs_tab, int t0,
                             float eps) {
  constexpr int kPer = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTile; r += kWarps) {
    float* row = x + r * (C + 1) + lane * kPer;
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = row[e];
    const float rstd = ln_stats<C>(v, eps);
    const int c0 = lane * kPer;
    const float* sn = sn_tab + (size_t)(t0 + r) * C + c0;
    const float* cs = cs_tab + (size_t)(t0 + r) * C + c0;
#pragma unroll
    for (int e = 0; e < kPer; e += 2) {
      const float l0 = __fmul_rn(__fmul_rn(v[e], rstd), w[c0 + e]);
      const float l1 = __fmul_rn(__fmul_rn(v[e + 1], rstd), w[c0 + e + 1]);
      // y[2i] = l[2i] cos - l[2i+1] sin ; y[2i+1] = l[2i+1] cos + l[2i] sin
      row[e] = __fadd_rn(__fmul_rn(l0, cs[e]), __fmul_rn(-l1, sn[e]));
      row[e + 1] = __fadd_rn(__fmul_rn(l1, cs[e + 1]), __fmul_rn(l0, sn[e + 1]));
    }
  }
}

// Back through RoPE and the LayerNorm for one row, one warp: `x` holds
// this lane's raw input values, `d` the gradient at the roped output.
// Writes dx (rounded to T) to `dst` and adds d_ln * xhat to `dw`.
template <typename T, int C>
__device__ __forceinline__ void ln_rope_bwd_row(
    float* x, const float* d, const float* __restrict__ w,
    const float* __restrict__ sn, const float* __restrict__ cs, float eps,
    T* dst, float* dw) {
  constexpr int kPer = C / 32;
  const int c0 = (threadIdx.x & 31) * kPer;
  const float rstd = ln_stats<C>(x, eps);
  float xhat[kPer], dxhat[kPer];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    const float es0 = __fmul_rn(d[e], sn[e]);
    const float es1 = __fmul_rn(d[e + 1], sn[e + 1]);
    const float dln0 = __fadd_rn(__fmul_rn(d[e], cs[e]), es1);
    const float dln1 = __fsub_rn(__fmul_rn(d[e + 1], cs[e + 1]), es0);
    xhat[e] = __fmul_rn(x[e], rstd);
    xhat[e + 1] = __fmul_rn(x[e + 1], rstd);
    dw[e] += __fmul_rn(dln0, xhat[e]);
    dw[e + 1] += __fmul_rn(dln1, xhat[e + 1]);
    dxhat[e] = __fmul_rn(dln0, w[c0 + e]);
    dxhat[e + 1] = __fmul_rn(dln1, w[c0 + e + 1]);
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    s1 += dxhat[e];
    s2 = __fadd_rn(s2, __fmul_rn(dxhat[e], xhat[e]));
  }
  const float m1 = __fdiv_rn(warp_sum(s1), static_cast<float>(C));
  const float m2 = __fdiv_rn(warp_sum(s2), static_cast<float>(C));
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const float g = __fsub_rn(__fsub_rn(dxhat[e], m1), __fmul_rn(xhat[e], m2));
    dst[e] = from_f32<T>(__fmul_rn(rstd, g));
  }
}

// Sum each warp's per-lane [C] partial over the block's kNW warps, in warp
// order, and write the [C] result to `dst`. `red` holds kNW * C floats.
template <int C, int kNW = kWarps>
__device__ void block_sum_columns(const float* part, float* red, float* dst) {
  constexpr int kPer = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kPer; ++e) red[warp * C + lane * kPer + e] = part[e];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kNW * 32) {
    float s = red[c];
    for (int k = 1; k < kNW; ++k) s += red[k * C + c];
    dst[c] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// f32 forward: one block per (q-tile, head, batch); the heavy (late)
// q-tiles are scheduled first.
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads) fused_fwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, float* __restrict__ out,
    float* __restrict__ lse, int t_len, int h, int hkv, float scale,
    float eps) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // [64][C+1] roped, rounded q
  float* k_s = q_s + kTile * kCP;  // [64][C+1] roped, rounded k
  float* v_s = k_s + kTile * kCP;  // [64][C+1] v
  float* p_s = v_s + kTile * kCP;  // [64][65] probabilities, rounded

  const int nq = t_len / kTile;
  const int iq = nq - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* base = qkv + (size_t)b * t_len * f;
  const int t0 = iq * kTile;

  load_tile<C>(q_s, base + (size_t)t0 * f + (size_t)head * C, f);
  __syncthreads();
  ln_rope_tile<C>(q_s, wq, sin_tab, cos_tab, t0, eps);

  float m[4], l[4], acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  for (int jk = 0; jk <= iq; ++jk) {
    const int s0 = jk * kTile;
    load_tile<C>(k_s, base + (size_t)s0 * f + (size_t)(h + kvh) * C, f);
    load_tile<C>(v_s, base + (size_t)s0 * f + (size_t)(h + hkv + kvh) * C,
                    f);
    __syncthreads();
    ln_rope_tile<C>(k_s, wk, sin_tab, cos_tab, s0, eps);
    __syncthreads();

    float z[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < C; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * kCP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * kCP + d];
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
        float zz = z[i][j] * scale;
        if (jk == iq && tx + 16 * j > r) zz = kNegInf;
        z[i][j] = zz;
        mx = fmaxf(mx, zz);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(z[i][j] - m_new);
        rs += p;
        p_s[r * kPP + tx + 16 * j] = p;
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

  const size_t orow = (size_t)h * C;
  float* ob = out + ((size_t)b * t_len + t0) * orow + (size_t)head * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      ob[(size_t)r * orow + tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0)
      lse[((size_t)b * h + head) * t_len + t0 + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// f32 combined backward: one block per (head, batch).
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads) fused_bwd_kernel(
    const float* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const float* __restrict__ out,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq_out, float* __restrict__ dk_out, float* __restrict__ dv_out,
    float* __restrict__ dq_acc, float* __restrict__ dwq_part,
    float* __restrict__ dwk_part, int t_len, int h, int hkv, int f_row,
    int kv_row, float scale, float eps) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  constexpr int kPer = C / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [64][C+1] roped, rounded k
  float* v_s = k_s + kTile * kCP;     // [64][C+1] v
  float* q_s = v_s + kTile * kCP;     // [64][C+1] roped, rounded q
  float* do_s = q_s + kTile * kCP;    // [64][C+1] dO
  float* p_s = do_s + kTile * kCP;    // [64][65] p, rounded
  float* ds_s = p_s + kTile * kPP;    // [64][65] ds, rounded
  float* lse_s = ds_s + kTile * kPP;  // [T]
  float* delta_s = lse_s + t_len;     // [T]

  const int head = blockIdx.x, b = blockIdx.y;
  const int kvh = head / (h / hkv);
  const size_t f = (size_t)f_row;
  const size_t orow = (size_t)h * C;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int nq = t_len / kTile;
  const float* base = qkv + (size_t)b * t_len * f;
  const float* ob = out + (size_t)b * t_len * orow + (size_t)head * C;
  const float* dob = dout + (size_t)b * t_len * orow + (size_t)head * C;
  float* dqa = dq_acc + ((size_t)b * h + head) * t_len * C;

  // lse and delta = rowsum(dO * O) for every row of this (b, head)
  for (int t = tid; t < t_len; t += kThreads)
    lse_s[t] = lse[((size_t)b * h + head) * t_len + t];
  for (int t = warp; t < t_len; t += kWarps) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32)
      s += dob[(size_t)t * orow + c] * ob[(size_t)t * orow + c];
    s = warp_sum(s);
    if (lane == 0) delta_s[t] = s;
  }

  float dwq[kPer], dwk[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwq[e] = dwk[e] = 0.f;

  for (int jk = 0; jk < nq; ++jk) {
    const int s0 = jk * kTile;
    const float* kraw = base + (size_t)s0 * f + (size_t)(h + kvh) * C;
    load_tile<C>(k_s, kraw, f);
    load_tile<C>(v_s, base + (size_t)s0 * f + (size_t)(h + hkv + kvh) * C,
                    f);
    __syncthreads();
    ln_rope_tile<C>(k_s, wk, sin_tab, cos_tab, s0, eps);

    float dk[4][kNJ], dv[4][kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) dk[i][j] = dv[i][j] = 0.f;

    for (int iq = jk; iq < nq; ++iq) {
      const int t0 = iq * kTile;
      load_tile<C>(q_s, base + (size_t)t0 * f + (size_t)head * C, f);
      load_tile<C>(do_s, dob + (size_t)t0 * orow, orow);
      __syncthreads();
      ln_rope_tile<C>(q_s, wq, sin_tab, cos_tab, t0, eps);
      __syncthreads();

      // S = Q K^T and dP = dO V^T in one pass over C
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < C; ++d) {
        float a[4], g[4], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = q_s[(ty + 16 * i) * kCP + d];
          g[i] = do_s[(ty + 16 * i) * kCP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = k_s[(tx + 16 * j) * kCP + d];
          bv[j] = v_s[(tx + 16 * j) * kCP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float lse_r = lse_s[t0 + r], delta_r = delta_s[t0 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float z = s[i][j] * scale;
          if (jk == iq && col > r) z = kNegInf;
          const float p = expf(z - lse_r);
          const float ds = (p * (dp[i][j] - delta_r)) * scale;
          p_s[r * kPP + col] = p;
          ds_s[r * kPP + col] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK_rot += dS^T Q for this thread's k rows
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
            dv[i][j] = fmaf(pp[i], gg[j], dv[i][j]);
            dk[i][j] = fmaf(dd[i], qq[j], dk[i][j]);
          }
      }

      // dQ_rot += dS K for this thread's q rows, into the block's scratch
      float dq[4][kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) dq[i][j] = 0.f;
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
          for (int j = 0; j < kNJ; ++j) dq[i][j] = fmaf(dd[i], kk[j], dq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = dqa + (size_t)(t0 + ty + 16 * i) * C + tx;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          // the first k-tile visits every q-tile: it writes, later ones add
          row[16 * j] = jk == 0 ? dq[i][j] : row[16 * j] + dq[i][j];
        }
      }
      __syncthreads();  // q_s, do_s, p_s, ds_s are refilled next
    }

    // this k-tile is done: dv out, and dk back through RoPE and LN
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t t = (size_t)b * t_len + s0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        dv_out[t * kv_row + (size_t)head * C + tx + 16 * j] =
            dv[i][j];
        do_s[(ty + 16 * i) * kCP + tx + 16 * j] = dk[i][j];
      }
    }
    load_tile<C>(k_s, kraw, f);  // raw k again, for xhat and rstd
    __syncthreads();
    for (int r = warp; r < kTile; r += kWarps) {
      float x[kPer], d[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] = k_s[r * kCP + lane * kPer + e];
        d[e] = do_s[r * kCP + lane * kPer + e];
      }
      const size_t tab = (size_t)(s0 + r) * C + lane * kPer;
      float* dst = dk_out + ((size_t)b * t_len + s0 + r) * kv_row +
               (size_t)head * C + lane * kPer;
      ln_rope_bwd_row<float, C>(x, d, wk, sin_tab + tab, cos_tab + tab, eps, dst,
                            dwk);
    }
    __syncthreads();  // k_s, v_s, do_s are refilled by the next k-tile
  }

  // dq back through RoPE and LN, every row of this (b, head)
  for (int t = warp; t < t_len; t += kWarps) {
    float x[kPer], d[kPer];
    const float* qrow = base + (size_t)t * f + (size_t)head * C + lane * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      x[e] = qrow[e];
      d[e] = dqa[(size_t)t * C + lane * kPer + e];
    }
    const size_t tab = (size_t)t * C + lane * kPer;
    float* dst = dq_out + ((size_t)b * t_len + t) * f + (size_t)head * C +
             lane * kPer;
    ln_rope_bwd_row<float, C>(x, d, wq, sin_tab + tab, cos_tab + tab, eps, dst,
                          dwq);
  }
  __syncthreads();
  block_sum_columns<C>(dwq, p_s, dwq_part + ((size_t)b * h + head) * C);
  block_sum_columns<C>(dwk, p_s, dwk_part + ((size_t)b * h + head) * C);
}

// ---------------------------------------------------------------------------
// Split backward, f32 (sequences above the combined kernel's cap): dq and
// dk/dv in two kernels, each one block per (64-row tile, head, batch), so
// the card gets B * H * T / 64 blocks where the combined kernel has B * H.
// `delta = rowsum(dO * O)` [B, H, T] f32 comes from the wrapper (PyTorch),
// as the JAX package computes it in jnp; lse and delta rows are loaded per
// tile (64 values), not per sequence. Each block sums the LN weight's row
// products of its own 64 rows into one [C] partial; the wrapper sums the
// partials in a fixed order (no atomics). (The bf16 split route, further
// down, normalises each row once in a pre-pass instead.)
//   dq kernel:  q tile fixed; walks k tiles 0..iq (the diagonal masked),
//               recomputing LN + RoPE of each; dq_rot [64, C] stays in
//               registers; then the LN/RoPE backward of q.
//   dkv kernel: k tile fixed; walks q tiles ik..nq-1, recomputing LN + RoPE
//               of each; dk_rot and dv stay in registers; then dv out and
//               the LN/RoPE backward of k. Per q head: MHA writes the
//               packed slots, GQA per-q-head buffers summed by the wrapper.
// Three products a tile pair in dq (S, dP, dS K) and four in dkv (S, dP,
// P^T dO, dS^T Q): the split pays S and dP twice, as the JAX kernels do.
// ---------------------------------------------------------------------------

// f32 dq: one block per (q-tile, head, batch); heavy (late) q tiles first.
template <int C>
__global__ void __launch_bounds__(kThreads) fused_dq_kernel(
    const float* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dq_out, float* __restrict__ dwq_part, int t_len,
    int h, int hkv, int dq_row, float scale, float eps) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  constexpr int kPer = C / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][C+1] roped q
  float* do_s = q_s + kTile * kCP;    // [64][C+1] dO
  float* k_s = do_s + kTile * kCP;    // [64][C+1] roped k; then dq_rot
  float* v_s = k_s + kTile * kCP;     // [64][C+1] v
  float* ds_s = v_s + kTile * kCP;    // [64][65] ds
  float* lse_s = ds_s + kTile * kPP;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int nq = t_len / kTile;
  const int iq = nq - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t orow = (size_t)h * C;
  const size_t bh = (size_t)b * h + head;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const float* base = qkv + (size_t)b * t_len * f;
  const int t0 = iq * kTile;

  load_tile<C>(q_s, base + (size_t)t0 * f + (size_t)head * C, f);
  load_tile<C>(do_s, dout + ((size_t)b * t_len + t0) * orow + (size_t)head * C,
               orow);
  for (int i = tid; i < kTile; i += kThreads) {
    lse_s[i] = lse[bh * t_len + t0 + i];
    delta_s[i] = delta[bh * t_len + t0 + i];
  }
  __syncthreads();
  ln_rope_tile<C>(q_s, wq, sin_tab, cos_tab, t0, eps);

  float dq[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dq[i][j] = 0.f;

  for (int jk = 0; jk <= iq; ++jk) {
    const int s0 = jk * kTile;
    load_tile<C>(k_s, base + (size_t)s0 * f + (size_t)(h + kvh) * C, f);
    load_tile<C>(v_s, base + (size_t)s0 * f + (size_t)(h + hkv + kvh) * C,
                 f);
    __syncthreads();
    ln_rope_tile<C>(k_s, wk, sin_tab, cos_tab, s0, eps);
    __syncthreads();

    // S = Q K^T and dP = dO V^T in one pass over C
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < C; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty + 16 * i) * kCP + d];
        g[i] = do_s[(ty + 16 * i) * kCP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = k_s[(tx + 16 * j) * kCP + d];
        bv[j] = v_s[(tx + 16 * j) * kCP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float z = sc[i][j] * scale;
        if (jk == iq && col > r) z = kNegInf;
        const float p = expf(z - lse_s[r]);
        ds_s[r * kPP + col] = (p * (dp[i][j] - delta_s[r])) * scale;
      }
    }
    __syncthreads();

    // dQ_rot += dS K for this thread's q rows
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
        for (int j = 0; j < kNJ; ++j) dq[i][j] = fmaf(dd[i], kk[j], dq[i][j]);
    }
    __syncthreads();  // k_s, v_s and ds_s are refilled by the next k-tile
  }

  // dq_rot through shared memory, then back through RoPE and LN by rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      k_s[(ty + 16 * i) * kCP + tx + 16 * j] = dq[i][j];
  __syncthreads();
  float dwq[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwq[e] = 0.f;
  for (int r = warp; r < kTile; r += kWarps) {
    float x[kPer], d[kPer];
    const float* qrow =
        base + (size_t)(t0 + r) * f + (size_t)head * C + lane * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      x[e] = qrow[e];
      d[e] = k_s[r * kCP + lane * kPer + e];
    }
    const size_t tab = (size_t)(t0 + r) * C + lane * kPer;
    float* dst = dq_out + ((size_t)b * t_len + t0 + r) * dq_row +
                 (size_t)head * C + lane * kPer;
    ln_rope_bwd_row<float, C>(x, d, wq, sin_tab + tab, cos_tab + tab, eps,
                              dst, dwq);
  }
  __syncthreads();
  block_sum_columns<C>(dwq, ds_s, dwq_part + (bh * nq + iq) * C);
}

// f32 dk/dv: one block per (k-tile, head, batch); heavy (early) k tiles,
// which walk the most q tiles, first.
template <int C>
__global__ void __launch_bounds__(kThreads) fused_dkv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dk_out, float* __restrict__ dv_out,
    float* __restrict__ dwk_part, int t_len, int h, int hkv, int kv_row,
    float scale, float eps) {
  constexpr int kCP = C + 1;
  constexpr int kNJ = C / 16;
  constexpr int kPer = C / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [64][C+1] roped k
  float* v_s = k_s + kTile * kCP;     // [64][C+1] v
  float* q_s = v_s + kTile * kCP;     // [64][C+1] roped q
  float* do_s = q_s + kTile * kCP;    // [64][C+1] dO; at the end dk_rot
  float* p_s = do_s + kTile * kCP;    // [64][65] p
  float* ds_s = p_s + kTile * kPP;    // [64][65] ds
  float* lse_s = ds_s + kTile * kPP;  // [64]
  float* delta_s = lse_s + kTile;     // [64]

  const int nq = t_len / kTile;
  const int ik = blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t orow = (size_t)h * C;
  const size_t bh = (size_t)b * h + head;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const float* base = qkv + (size_t)b * t_len * f;
  const int s0 = ik * kTile;
  const float* kraw = base + (size_t)s0 * f + (size_t)(h + kvh) * C;

  load_tile<C>(k_s, kraw, f);
  load_tile<C>(v_s, base + (size_t)s0 * f + (size_t)(h + hkv + kvh) * C, f);
  __syncthreads();
  ln_rope_tile<C>(k_s, wk, sin_tab, cos_tab, s0, eps);

  float dk[4][kNJ], dv[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int iq = ik; iq < nq; ++iq) {
    const int t0 = iq * kTile;
    load_tile<C>(q_s, base + (size_t)t0 * f + (size_t)head * C, f);
    load_tile<C>(do_s,
                 dout + ((size_t)b * t_len + t0) * orow + (size_t)head * C,
                 orow);
    for (int i = tid; i < kTile; i += kThreads) {
      lse_s[i] = lse[bh * t_len + t0 + i];
      delta_s[i] = delta[bh * t_len + t0 + i];
    }
    __syncthreads();
    ln_rope_tile<C>(q_s, wq, sin_tab, cos_tab, t0, eps);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < C; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty + 16 * i) * kCP + d];
        g[i] = do_s[(ty + 16 * i) * kCP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = k_s[(tx + 16 * j) * kCP + d];
        bv[j] = v_s[(tx + 16 * j) * kCP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float z = sc[i][j] * scale;
        if (iq == ik && col > r) z = kNegInf;
        const float p = expf(z - lse_s[r]);
        p_s[r * kPP + col] = p;
        ds_s[r * kPP + col] = (p * (dp[i][j] - delta_s[r])) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK_rot += dS^T Q for this thread's k rows
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
          dv[i][j] = fmaf(pp[i], gg[j], dv[i][j]);
          dk[i][j] = fmaf(dd[i], qq[j], dk[i][j]);
        }
    }
    __syncthreads();  // q_s, do_s, p_s, ds_s, lse_s, delta_s refilled next
  }

  // dv out; dk_rot through shared memory, back through RoPE and LN by rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t t = (size_t)b * t_len + s0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      dv_out[t * kv_row + (size_t)head * C + tx + 16 * j] = dv[i][j];
      do_s[(ty + 16 * i) * kCP + tx + 16 * j] = dk[i][j];
    }
  }
  __syncthreads();
  float dwk[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwk[e] = 0.f;
  for (int r = warp; r < kTile; r += kWarps) {
    float x[kPer], d[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      x[e] = kraw[(size_t)r * f + lane * kPer + e];
      d[e] = do_s[r * kCP + lane * kPer + e];
    }
    const size_t tab = (size_t)(s0 + r) * C + lane * kPer;
    float* dst = dk_out + ((size_t)b * t_len + s0 + r) * kv_row +
                 (size_t)head * C + lane * kPer;
    ln_rope_bwd_row<float, C>(x, d, wk, sin_tab + tab, cos_tab + tab, eps,
                              dst, dwk);
  }
  __syncthreads();
  block_sum_columns<C>(dwk, p_s, dwk_part + (bh * nq + ik) * C);
}

// ---------------------------------------------------------------------------
// bf16: the same functions with every matrix product on `wgmma` (bf16
// operands, f32 accumulation), in the tile cores of attn_tiles.cuh shared
// with flash.cu. The operands the products read are exactly the values
// the FMA kernels use (q and k rounded after the f32 LayerNorm and RoPE,
// P and dS rounded before their products), so only the order of the f32
// sums differs (and the forward's exponent, taken in base 2). Every bf16
// route starts with one pre-pass that normalises and ropes each q and k
// row once into q^ and k^.
// ---------------------------------------------------------------------------

// LayerNorm + RoPE of one row read from device memory (sequence position
// t), rounded to bf16 into `dst`, one warp: the arithmetic of ln_rope_tile.
template <int C>
__device__ __forceinline__ void ln_rope_row_bf16(
    bf16* dst, const bf16* src, const float* __restrict__ w,
    const float* __restrict__ sn_tab, const float* __restrict__ cs_tab, int t,
    float eps) {
  constexpr int kPer = C / 32;
  const int c0 = (threadIdx.x & 31) * kPer;
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = __bfloat162float(src[c0 + e]);
  const float rstd = ln_stats<C>(v, eps);
  const float* sn = sn_tab + (size_t)t * C + c0;
  const float* cs = cs_tab + (size_t)t * C + c0;
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    const float l0 = __fmul_rn(__fmul_rn(v[e], rstd), w[c0 + e]);
    const float l1 = __fmul_rn(__fmul_rn(v[e + 1], rstd), w[c0 + e + 1]);
    dst[c0 + e] = __float2bfloat16(
        __fadd_rn(__fmul_rn(l0, cs[e]), __fmul_rn(-l1, sn[e])));
    dst[c0 + e + 1] = __float2bfloat16(
        __fadd_rn(__fmul_rn(l1, cs[e + 1]), __fmul_rn(l0, sn[e + 1])));
  }
}

// Forward, bf16: two launches.
//   fused_fwd_prep_kernel: the pre-pass without delta (ln_rope_prep below),
//      q^ [B, H, T, C] and k^ [B, Hkv, T, C];
//   fused_fwd_wgmma_kernel: the flash forward's core (attn_tiles.cuh
//      fwd_block: two warpgroups a 128-row block, S, P and O in registers,
//      a cp.async K/V ring) on q^, k^ and v read in place from qkv, no
//      dropout; out is written straight into [B, T, H C] and lse [B, H, T]
//      in natural-log units.
template <int C>
__global__ void __launch_bounds__(2 * kWgThreads) fused_fwd_wgmma_kernel(
    const bf16* __restrict__ qhat, const bf16* __restrict__ khat,
    const bf16* __restrict__ qkv, bf16* __restrict__ out,
    float* __restrict__ lse, int t_len, int h, int hkv, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const long long f = static_cast<long long>(h + 2 * hkv) * C;
  const long long tc = static_cast<long long>(t_len) * C;
  const long long hc = static_cast<long long>(h) * C;
  const attn_tiles::Strides sq{h * tc, tc, C}, sk{hkv * tc, tc, C},
      sv{t_len * f, C, f}, so{t_len * hc, C, hc};
  const attn_tiles::Dims d{t_len, h, hkv, 1, scale};
  const attn_tiles::Drop off{0u, 0u, 0u, 0u, 0u, h, 0, 1.f};
  attn_tiles::fwd_block<C, false>(qhat, khat, qkv + (size_t)(h + hkv) * C, sq,
                                  sk, sv, out, so, lse, d, off, smem_raw);
}


// Backward, bf16, on the warpgroup tensor-core path (wgmma). Both routes
// start with one pre-pass and share one tile core.
//   fused_bwd_prep_kernel: LayerNorm + RoPE of every q and k row once,
//      rounded to bf16 into q^ [B, H, T, C] and k^ [B, Hkv, T, C], and
//      (given O) delta = rowsum(dO * O) into [B, H, T]; one warp a row.
//   fused_bwd_tile_kernel<C, kDq>: one warpgroup per (block g, head,
//      batch). The k tiles of a (b, head) are paired (j with nk - 1 - j,
//      equal causal work) and pair p goes to block p % G; the block walks
//      its k tiles in increasing order and, for each, the q tiles at or
//      after it (attn_tiles.cuh's dkv_walk, the core flash.cu's dk/dv
//      kernel runs too), keeping dK^ and dV in wgmma register
//      accumulators:
//        S^T = K^ Q^T and dP^T = V dO^T (K-major operands),
//        P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale in
//        registers, both rounded to bf16,
//        dV += P^T dO and dK^ += dS^T Q^ with P^T and dS^T as register A
//        operands (dO and Q^ MN-major),
//        kDq (the combined route only): dQ^ = dS K^ from dS^T staged once
//        in shared memory (MN-major A), added into block g's own f32
//        partial [G, B, H, T, C]: its first k tile (tile g) writes, later
//        ones add, in order.
//      Q^, dO, lse and delta tiles come double-buffered by cp.async. At a
//      k tile's end dV is written and dK^ goes back through RoPE and the
//      LayerNorm (ln_rope_bwd_row), with the dwk partial [B, H, G, C].
// The combined route (T <= the cap) is pre-pass, tile kernel<C, true> over
// G = dq_groups(T) blocks a (b, head), and
//   fused_bwd_post_kernel: dQ^ summed over the groups that reached the
//      q tile (groups g <= q tile), in group order, then back through RoPE
//      and the LayerNorm into dqkv's q slot, with dwq partials
//      [B, H, T / 64, C].
// The split route (longer T) is pre-pass, then
//   fused_dq_tile_kernel<C>: one warpgroup and one q tile a block
//      (heavy late tiles first), walking a cp.async ring of K^ and V
//      tiles (attn_tiles.cuh's dq_walk, which the flash dq kernel runs
//      too); Q^, dO, lse and delta load once. Per k tile
//      S = Q^ K^T and dP = dO V^T (SS), P and dS = P (dP - delta) scale in
//      registers, dQ^ += dS K^ (RS: dS from the accumulator layout, K^
//      MN-major). dQ^ stays in f32 registers for the whole walk, then goes
//      back through RoPE and the LayerNorm into dqkv's q slot, with dwq
//      partials [B, H, T / 64, C];
//   tile kernel<C, false> over G = (nk + 1) / 2 blocks a (b, head), one k
//      tile pair each: dK/dV alone, no dS staging and no partials.
// No float atomics anywhere: every sum runs in a fixed order, so the same
// inputs give the same bits on every call.

// LayerNorm + RoPE of every q and k row once into q^ and k^ and, given O,
// delta = rowsum(dO * O); one block per (64 rows, q or k head, batch), one
// warp a row.
template <int C>
__device__ __forceinline__ void ln_rope_prep(
    const bf16* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const bf16* __restrict__ out,
    const bf16* __restrict__ dout, bf16* __restrict__ qhat,
    bf16* __restrict__ khat, float* __restrict__ delta, int t_len, int h,
    int hkv, float eps) {
  const int head = blockIdx.y, b = blockIdx.z;  // q heads, then kv heads
  const bool is_q = head < h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t orow = (size_t)h * C;
  // a k head's raw columns sit at (h + kvh) C = head C, as a q head's do
  const bf16* src = qkv + (size_t)b * t_len * f + (size_t)head * C;
  bf16* dst = is_q ? qhat + ((size_t)b * h + head) * t_len * C
                   : khat + ((size_t)b * hkv + head - h) * t_len * C;
  for (int r = warp; r < kTile; r += kWarps) {
    const int t = blockIdx.x * kTile + r;
    ln_rope_row_bf16<C>(dst + (size_t)t * C, src + (size_t)t * f,
                        is_q ? wq : wk, sin_tab, cos_tab, t, eps);
    if (is_q && out != nullptr) {
      const bf16* ob = out + ((size_t)b * t_len + t) * orow + (size_t)head * C;
      const bf16* dob =
          dout + ((size_t)b * t_len + t) * orow + (size_t)head * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32)
        s += __bfloat162float(dob[c]) * __bfloat162float(ob[c]);
      s = warp_sum(s);
      if (lane == 0) delta[((size_t)b * h + head) * t_len + t] = s;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) fused_bwd_prep_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, const bf16* __restrict__ out,
    const bf16* __restrict__ dout, bf16* __restrict__ qhat,
    bf16* __restrict__ khat, float* __restrict__ delta, int t_len, int h,
    int hkv, float eps) {
  ln_rope_prep<C>(qkv, wq, wk, sin_tab, cos_tab, out, dout, qhat, khat, delta,
                  t_len, h, hkv, eps);
}

// The forward's pre-pass: the same rows without delta, under its own name
// so that a profile tells the forward's share from the backward's.
template <int C>
__global__ void __launch_bounds__(kThreads) fused_fwd_prep_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ wk, const float* __restrict__ sin_tab,
    const float* __restrict__ cos_tab, bf16* __restrict__ qhat,
    bf16* __restrict__ khat, int t_len, int h, int hkv, float eps) {
  ln_rope_prep<C>(qkv, wq, wk, sin_tab, cos_tab, nullptr, nullptr, qhat, khat,
                  nullptr, t_len, h, hkv, eps);
}

template <int C, bool kDq>
__global__ void __launch_bounds__(kWgThreads) fused_bwd_tile_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ wk,
    const float* __restrict__ sin_tab, const float* __restrict__ cos_tab,
    const bf16* __restrict__ qhat, const bf16* __restrict__ khat,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, float* __restrict__ dq_part,
    float* __restrict__ dwk_part, int t_len, int h, int hkv, int groups,
    int kv_row, float scale, float eps) {
  using namespace hopper;
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // dK / dV floats a thread
  constexpr int kPer = C / 32;
  constexpr int kSt = C + 4;  // row of the f32 dK staging tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base;               // [64, C] k^ of this k tile
  const uint32_t v_s = k_s + kTileB;       // [64, C] v
  const uint32_t q_s = v_s + kTileB;       // [2 stages][64, C] q^
  const uint32_t do_s = q_s + 2 * kTileB;  // [2 stages][64, C] dO
  const uint32_t ds_s = do_s + 2 * kTileB; // [64 keys, 64 q] dS^T (kDq)
  const uint32_t rows_s = ds_s + (kDq ? kPanelBytes : 0);  // lse, delta
  float* rows_g = reinterpret_cast<float*>(gbase + (rows_s - base));
  float* red = rows_g + 4 * kTile;  // [4 warps][C]
  // the f32 dK^ staging tile [64][C + 4] reuses the q^ / dO stages
  float* stage = reinterpret_cast<float*>(gbase + (q_s - base));
  const attn_tiles::KvTiles sm{k_s, v_s, q_s, do_s, ds_s, rows_s, rows_g};

  const int g = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int nk = t_len / kTile;
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t orow = (size_t)h * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int cbase = (lane & 3) * 2;
  const bf16* kraw = qkv + (size_t)b * t_len * f + (size_t)(h + kvh) * C;
  const bf16* vb = qkv + (size_t)b * t_len * f + (size_t)(h + hkv + kvh) * C;
  const bf16* kh = khat + ((size_t)b * hkv + kvh) * t_len * C;
  // q^ and dO rows of this (b, head); the k tile's rows are set per tile
  attn_tiles::KvOperands in{
      nullptr, C, nullptr, static_cast<long long>(f),
      qhat + ((size_t)b * h + head) * t_len * C, C,
      dout + (size_t)b * t_len * orow + (size_t)head * C,
      static_cast<long long>(orow), lse + ((size_t)b * h + head) * t_len,
      delta + ((size_t)b * h + head) * t_len};
  const attn_tiles::DropTile no_drop{0u, 0u, 0u, 0u, 1.f};
  float* dqp = nullptr;
  if constexpr (kDq)
    dqp = dq_part + (((size_t)g * gridDim.z + b) * h + head) * t_len * C;

  float dwk[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwk[e] = 0.f;

  for (int jk = g; jk < nk; ++jk) {
    if (min(jk, nk - 1 - jk) % groups != g) continue;
    const int s0 = jk * kTile;
    in.k = kh + (size_t)s0 * C;
    in.v = vb + (size_t)s0 * f;
    float dk[kNO], dv[kNO];
    attn_tiles::dkv_walk<C, kDq, false>(sm, in, jk, nk, true, scale, no_drop,
                                        dqp, jk == g, dk, dv);

    // this k tile is done: dV out, dK^ back through RoPE and LN
    bf16* dvb = dv_out + ((size_t)b * t_len + s0) * kv_row + (size_t)head * C;
#pragma unroll
    for (int i = 0; i < kNO; i += 2) {
      const int row = r0 + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + cbase;
      *reinterpret_cast<uint32_t*>(dvb + (size_t)row * kv_row + col) =
          pack_bf16(dv[i], dv[i + 1]);
      *reinterpret_cast<float2*>(stage + row * kSt + col) =
          make_float2(dk[i], dk[i + 1]);
    }
    __syncthreads();
    for (int rr = warp; rr < kTile; rr += kWgThreads / 32) {
      float x[kPer], d[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[e] = __bfloat162float(kraw[(size_t)(s0 + rr) * f + lane * kPer + e]);
        d[e] = stage[rr * kSt + lane * kPer + e];
      }
      const size_t tab = (size_t)(s0 + rr) * C + lane * kPer;
      bf16* o = dk_out + ((size_t)b * t_len + s0 + rr) * kv_row +
                (size_t)head * C + lane * kPer;
      ln_rope_bwd_row<bf16, C>(x, d, wk, sin_tab + tab, cos_tab + tab, eps, o,
                               dwk);
    }
    __syncthreads();  // the staging tile is the next k tile's q^ / dO
  }
  block_sum_columns<C, kWgThreads / 32>(
      dwk, red, dwk_part + (((size_t)b * h + head) * groups + g) * C);
}

template <int C>
__global__ void __launch_bounds__(kThreads) fused_bwd_post_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ sin_tab, const float* __restrict__ cos_tab,
    const float* __restrict__ dq_part, bf16* __restrict__ dq_out,
    float* __restrict__ dwq_part, int t_len, int h, int hkv, int groups,
    float eps) {
  constexpr int kPer = C / 32;
  __shared__ float red[kWarps * C];
  const int iq = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t gstride = (size_t)gridDim.z * h * t_len * C;
  const float* dqp = dq_part + ((size_t)b * h + head) * t_len * C;
  const int ng = min(iq + 1, groups);  // group g first reaches q tile g
  float dwq[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwq[e] = 0.f;
  constexpr int kRows = 2;  // rows a warp loads before it computes
  for (int r0 = warp; r0 < kTile; r0 += kRows * kWarps) {
    float x[kRows][kPer], d[kRows][kPer];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t t = iq * kTile + r0 + i * kWarps;
      const bf16* qrow = qkv + ((size_t)b * t_len + t) * f +
                         (size_t)head * C + lane * kPer;
      const float* part = dqp + t * C + lane * kPer;
      float p[kDqGroupsMax][kPer];
#pragma unroll
      for (int gg = 0; gg < kDqGroupsMax; ++gg)
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          p[gg][e] = gg < ng ? part[gg * gstride + e] : 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        x[i][e] = __bfloat162float(qrow[e]);
        d[i][e] = p[0][e];
#pragma unroll
        for (int gg = 1; gg < kDqGroupsMax; ++gg)
          if (gg < ng) d[i][e] += p[gg][e];  // in group order
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = iq * kTile + r0 + i * kWarps;
      const size_t tab = (size_t)t * C + lane * kPer;
      bf16* dst = dq_out + ((size_t)b * t_len + t) * f + (size_t)head * C +
                  lane * kPer;
      ln_rope_bwd_row<bf16, C>(x[i], d[i], wq, sin_tab + tab, cos_tab + tab,
                               eps, dst, dwq);
    }
  }
  block_sum_columns<C>(dwq, red,
                       dwq_part + (((size_t)b * h + head) * gridDim.x + iq) * C);
}

// One warpgroup at C=64 is held to 128 registers so that four blocks
// share an SM (its 51.7 KB of shared memory allows four; at 139
// registers three fit): 6-7% faster at the train shapes for a few bytes
// of spill. At C=128 shared memory allows two blocks, so no cap.
template <int C>
__global__ void __launch_bounds__(kWgThreads, C == 64 ? 4 : 1)
    fused_dq_tile_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ wq,
    const float* __restrict__ sin_tab, const float* __restrict__ cos_tab,
    const bf16* __restrict__ qhat, const bf16* __restrict__ khat,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ dout, bf16* __restrict__ dq_out,
    float* __restrict__ dwq_part, int t_len, int h, int hkv, int dq_row,
    float scale, float eps) {
  using namespace hopper;
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // dQ^ floats a thread
  constexpr int kPer = C / 32;
  constexpr int kSt = C + 4;  // row of the f32 dQ^ staging tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base;                 // [64, C] q^
  const uint32_t do_s = q_s + kTileB;        // [64, C] dO
  const uint32_t k_s = do_s + kTileB;        // [2 stages][64, C] k^
  const uint32_t v_s = k_s + 2 * kTileB;     // [2 stages][64, C] v
  const uint32_t rows_s = v_s + 2 * kTileB;  // [64] lse, [64] delta
  float* rows_g = reinterpret_cast<float*>(gbase + (rows_s - base));
  float* red = rows_g + 2 * kTile;  // [4 warps][C]
  // the f32 dQ^ staging tile [64][C + 4] reuses the tiles above
  float* stage = reinterpret_cast<float*>(gbase);

  const int nq = t_len / kTile;
  const int iq = nq - 1 - blockIdx.x;  // heavy (late) q tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const size_t f = (size_t)(h + 2 * hkv) * C;
  const size_t orow = (size_t)h * C;
  const size_t bh = (size_t)b * h + head;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wwarp = tid >> 5;
  const int r0 = wwarp * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int cbase = (lane & 3) * 2;
  const bf16* kh = khat + ((size_t)b * hkv + kvh) * t_len * C;
  const bf16* vb = qkv + (size_t)b * t_len * f + (size_t)(h + hkv + kvh) * C;

  // the q tile's q^, dO, lse and delta rows, then k tile 0
  {
    const int t0 = iq * kTile;
    const bf16* dob = dout + ((size_t)b * t_len + t0) * orow + (size_t)head * C;
    load_tile_async<C>(q_s, qhat + (bh * t_len + t0) * C, C, kTile, tid,
                       kWgThreads);
    load_tile_async<C>(do_s, dob, orow, kTile, tid, kWgThreads);
    for (int i = tid; i < kTile / 4; i += kWgThreads) {
      cp_async16(rows_s + i * 16, lse + bh * t_len + t0 + i * 4);
      cp_async16(rows_s + kTile * 4 + i * 16, delta + bh * t_len + t0 + i * 4);
    }
  }
  load_tile_async<C>(k_s, kh, C, kTile, tid, kWgThreads);
  load_tile_async<C>(v_s, vb, f, kTile, tid, kWgThreads);
  cp_async_commit();

  float dq[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) dq[i] = 0.f;
  // k tiles 0..iq: the shared q-tile walk of attn_tiles.cuh
  const attn_tiles::DqTiles sm{q_s, do_s, k_s, v_s, rows_g};
  const attn_tiles::DqOperands in{kh, C, vb, static_cast<long long>(f)};
  const attn_tiles::DropTile no_drop{0u, 0u, 0u, 0u, 1.f};
  attn_tiles::dq_walk<C, false>(sm, in, iq, iq + 1, true, scale, no_drop, dq);

  // dQ^ through shared memory (the tiles are free now), then back through
  // RoPE and the LayerNorm by rows
#pragma unroll
  for (int i = 0; i < kNO; i += 2) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + cbase;
    *reinterpret_cast<float2*>(stage + row * kSt + col) =
        make_float2(dq[i], dq[i + 1]);
  }
  __syncthreads();
  float dwq[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) dwq[e] = 0.f;
  const int t0 = iq * kTile;
  for (int rr = wwarp; rr < kTile; rr += kWgThreads / 32) {
    float x[kPer], d[kPer];
    const bf16* qrow = qkv + ((size_t)b * t_len + t0 + rr) * f +
                       (size_t)head * C + lane * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      x[e] = __bfloat162float(qrow[e]);
      d[e] = stage[rr * kSt + lane * kPer + e];
    }
    const size_t tab = (size_t)(t0 + rr) * C + lane * kPer;
    bf16* dst = dq_out + ((size_t)b * t_len + t0 + rr) * dq_row +
                (size_t)head * C + lane * kPer;
    ln_rope_bwd_row<bf16, C>(x, d, wq, sin_tab + tab, cos_tab + tab, eps,
                             dst, dwq);
  }
  block_sum_columns<C, kWgThreads / 32>(dwq, red,
                                        dwq_part + (bh * nq + iq) * C);
}

// Dynamic shared memory of one f32 forward block: q, k, v tiles [64][C+1]
// and the probabilities [64][65].
template <int C>
constexpr int fwd_f32_smem_bytes() {
  return 4 * (3 * kTile * (C + 1) + kTile * kPP);
}

// f32 backward: k, v, q, dO tiles [64][C+1], p and ds [64][65], with the
// lse and delta rows of the sequence.
template <int C>
int bwd_smem_bytes(int t) {
  return 4 * (4 * kTile * (C + 1) + 2 * kTile * kPP + 2 * t);
}

// bf16 tile kernel: six swizzled [64, C] tiles (k^, v, two q^ and two dO
// stages), the dS^T panel (combined route only), two stages of lse and
// delta, the dwk reduction and 1024 bytes of alignment slack. It does not
// grow with T.
template <int C>
constexpr int bwd_tile_smem_bytes(bool dq) {
  return 6 * kTile * C * 2 + (dq ? kPanelBytes : 0) + 4 * kTile * 4 +
         (kWgThreads / 32) * C * 4 + 1024;
}

// bf16 split dq kernel: the q^ and dO tiles, two stages of k^ and v, the
// lse and delta rows, the dwq reduction and the alignment slack.
template <int C>
constexpr int dq_tile_smem_bytes() {
  static_assert(kTile * (C + 4) * 4 <= 6 * kTile * C * 2,
                "the dQ^ staging tile must fit the operand tiles");
  return 6 * kTile * C * 2 + 2 * kTile * 4 + (kWgThreads / 32) * C * 4 +
         1024;
}

// f32 split backward, per block: dq: q, dO, k, v tiles [64][C+1] and ds
// [64][65]; dkv: the same four tiles and p, ds [64][65]; both with the lse
// and delta rows of one 64-row tile.
template <int C>
constexpr int split_smem_bytes(bool dkv) {
  return 4 * (4 * kTile * (C + 1) + (dkv ? 2 : 1) * kTile * kPP + 2 * kTile);
}

// f32: one launch of fused_fwd_kernel, one block per (q tile, head, batch).
template <int C>
cudaError_t launch_fwd_f32(const float* qkv, const float* wq, const float* wk,
                           const float* sn, const float* cs, float* out,
                           float* lse, int b, int t, int h, int hkv,
                           float scale, float eps, cudaStream_t stream) {
  const int smem = fwd_f32_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_fwd_kernel<C><<<dim3(t / kTile, h, b), kThreads, smem, stream>>>(
      qkv, wq, wk, sn, cs, out, lse, t, h, hkv, scale, eps);
  return cudaGetLastError();
}

// bf16: the forward pre-pass into q^ / k^, then the forward core over
// (128-row block, head, batch), in order on one stream.
template <int C>
cudaError_t launch_fwd_bf16(const bf16* qkv, const float* wq, const float* wk,
                            const float* sn, const float* cs, bf16* out,
                            float* lse, bf16* qhat, bf16* khat, int b, int t,
                            int h, int hkv, float scale, float eps,
                            cudaStream_t stream) {
  fused_fwd_prep_kernel<C><<<dim3(t / kTile, h + hkv, b), kThreads, 0,
                             stream>>>(qkv, wq, wk, sn, cs, qhat, khat, t, h,
                                       hkv, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = attn_tiles::fwd_smem_bytes<C>();
  err = cudaFuncSetAttribute(fused_fwd_wgmma_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_fwd_wgmma_kernel<C><<<dim3((t / kTile + 1) / 2, h, b),
                              2 * kWgThreads, smem, stream>>>(
      qhat, khat, qkv, out, lse, t, h, hkv, scale);
  return cudaGetLastError();
}

// f32: one launch of fused_bwd_kernel, one block per (head, batch).
template <int C>
cudaError_t launch_bwd_f32(const float* qkv, const float* wq, const float* wk,
                           const float* sn, const float* cs, const float* out,
                           const float* lse, const float* dout, float* dq,
                           float* dk, float* dv, float* dq_acc, float* dwq,
                           float* dwk, int b, int t, int h, int hkv,
                           int f_row, int kv_row, float scale, float eps,
                           cudaStream_t stream) {
  const int smem = bwd_smem_bytes<C>(t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_bwd_kernel<C><<<dim3(h, b), kThreads, smem, stream>>>(
      qkv, wq, wk, sn, cs, out, lse, dout, dq, dk, dv, dq_acc, dwq, dwk, t, h,
      hkv, f_row, kv_row, scale, eps);
  return cudaGetLastError();
}

// The pre-pass of both bf16 routes; `out` may be null (no delta).
template <int C>
cudaError_t launch_prep(const bf16* qkv, const float* wq, const float* wk,
                        const float* sn, const float* cs, const bf16* out,
                        const bf16* dout, bf16* qhat, bf16* khat,
                        float* delta, int b, int t, int h, int hkv, float eps,
                        cudaStream_t stream) {
  fused_bwd_prep_kernel<C><<<dim3(t / kTile, h + hkv, b), kThreads, 0,
                             stream>>>(qkv, wq, wk, sn, cs, out, dout, qhat,
                                       khat, delta, t, h, hkv, eps);
  return cudaGetLastError();
}

// The tile kernel over (block, head, batch): G dq groups (combined route,
// with dq partials) or one k tile pair a block (split route, none).
template <int C, bool kDq>
cudaError_t launch_tile(const bf16* qkv, const float* wk, const float* sn,
                        const float* cs, const bf16* qhat, const bf16* khat,
                        const float* lse, const float* delta,
                        const bf16* dout, bf16* dk, bf16* dv, float* dq_part,
                        float* dwk, int b, int t, int h, int hkv, int groups,
                        int kv_row, float scale, float eps,
                        cudaStream_t stream) {
  const int smem = bwd_tile_smem_bytes<C>(kDq);
  cudaError_t err =
      cudaFuncSetAttribute(fused_bwd_tile_kernel<C, kDq>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_bwd_tile_kernel<C, kDq><<<dim3(groups, h, b), kWgThreads, smem,
                                  stream>>>(
      qkv, wk, sn, cs, qhat, khat, lse, delta, dout, dk, dv, dq_part, dwk, t,
      h, hkv, groups, kv_row, scale, eps);
  return cudaGetLastError();
}

// bf16 combined: the pre-pass, the tile kernel over (group, head, batch)
// and the post-pass, in order on one stream.
template <int C>
cudaError_t launch_bwd_bf16(const bf16* qkv, const float* wq, const float* wk,
                            const float* sn, const float* cs, const bf16* out,
                            const float* lse, const bf16* dout, bf16* dq,
                            bf16* dk, bf16* dv, bf16* qhat, bf16* khat,
                            float* delta, float* dq_part, float* dwq,
                            float* dwk, int b, int t, int h, int hkv,
                            int groups, int kv_row, float scale, float eps,
                            cudaStream_t stream) {
  const int nq = t / kTile;
  if (groups < 1 || groups > kDqGroupsMax || groups > (nq + 1) / 2)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_prep<C>(qkv, wq, wk, sn, cs, out, dout, qhat, khat,
                                   delta, b, t, h, hkv, eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_tile<C, true>(qkv, wk, sn, cs, qhat, khat, lse, delta, dout,
                             dk, dv, dq_part, dwk, b, t, h, hkv, groups,
                             kv_row, scale, eps, stream);
  if (err != cudaSuccess) return err;
  fused_bwd_post_kernel<C><<<dim3(nq, h, b), kThreads, 0, stream>>>(
      qkv, wq, sn, cs, dq_part, dq, dwq, t, h, hkv, groups, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dq_f32(const float* qkv, const float* wq, const float* wk,
                          const float* sn, const float* cs, const float* lse,
                          const float* delta, const float* dout, float* dq,
                          float* dwq, int b, int t, int h, int hkv,
                          int dq_row, float scale, float eps,
                          cudaStream_t stream) {
  const int smem = split_smem_bytes<C>(false);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_dq_kernel<C><<<dim3(t / kTile, h, b), kThreads, smem, stream>>>(
      qkv, wq, wk, sn, cs, lse, delta, dout, dq, dwq, t, h, hkv, dq_row,
      scale, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dq_bf16(const bf16* qkv, const float* wq, const float* sn,
                           const float* cs, const bf16* qhat,
                           const bf16* khat, const float* lse,
                           const float* delta, const bf16* dout, bf16* dq,
                           float* dwq, int b, int t, int h, int hkv,
                           int dq_row, float scale, float eps,
                           cudaStream_t stream) {
  const int smem = dq_tile_smem_bytes<C>();
  cudaError_t err =
      cudaFuncSetAttribute(fused_dq_tile_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_dq_tile_kernel<C><<<dim3(t / kTile, h, b), kWgThreads, smem,
                            stream>>>(qkv, wq, sn, cs, qhat, khat, lse, delta,
                                      dout, dq, dwq, t, h, hkv, dq_row, scale,
                                      eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_dkv_f32(const float* qkv, const float* wq, const float* wk,
                           const float* sn, const float* cs, const float* lse,
                           const float* delta, const float* dout, float* dk,
                           float* dv, float* dwk, int b, int t, int h,
                           int hkv, int kv_row, float scale, float eps,
                           cudaStream_t stream) {
  const int smem = split_smem_bytes<C>(true);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dkv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_dkv_kernel<C><<<dim3(t / kTile, h, b), kThreads, smem, stream>>>(
      qkv, wq, wk, sn, cs, lse, delta, dout, dk, dv, dwk, t, h, hkv, kv_row,
      scale, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Return a cudaError_t (0 = ok).
// The forward: f32 one kernel (qhat, khat unused); bf16 the pre-pass into
// the scratch qhat [B, H, T, C] and khat [B, Hkv, T, C], then the core.
int fused_attn_fwd_launch(const void* qkv, const void* wq, const void* wk,
                          const void* sn, const void* cs, void* out,
                          void* lse, void* qhat, void* khat, int b, int t,
                          int h, int hkv, int c, int dtype, float scale,
                          float eps, void* stream) {
  const float* wq_f = static_cast<const float*>(wq);
  const float* wk_f = static_cast<const float*>(wk);
  const float* sn_f = static_cast<const float*>(sn);
  const float* cs_f = static_cast<const float*>(cs);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t % kTile != 0 || h % hkv != 0) return cudaErrorInvalidValue;
  if (dtype == 1 && (qhat == nullptr || khat == nullptr))
    return cudaErrorInvalidValue;
#define F32(C)                                                             \
  return launch_fwd_f32<C>(static_cast<const float*>(qkv), wq_f, wk_f, sn_f, \
                           cs_f, static_cast<float*>(out), lse_f, b, t, h,  \
                           hkv, scale, eps, st)
#define BF16(C)                                                            \
  return launch_fwd_bf16<C>(static_cast<const bf16*>(qkv), wq_f, wk_f, sn_f, \
                            cs_f, static_cast<bf16*>(out), lse_f,           \
                            static_cast<bf16*>(qhat),                       \
                            static_cast<bf16*>(khat), b, t, h, hkv, scale,  \
                            eps, st)
  if (dtype == 0 && c == 64) F32(64);
  if (dtype == 0 && c == 128) F32(128);
  if (dtype == 1 && c == 64) BF16(64);
  if (dtype == 1 && c == 128) BF16(128);
#undef F32
#undef BF16
  return cudaErrorInvalidValue;
}

// The combined backward. f32: one kernel; dq_acc is [B, H, T, C] f32 and
// dwq_part / dwk_part [B, H, C]; qhat, khat, delta and groups are unused.
// bf16: three kernels; qhat [B, H, T, C] and khat [B, Hkv, T, C] bf16 and
// delta [B, H, T] f32 are scratch, dq_acc is the [groups, B, H, T, C] f32
// dq partials, dwq_part [B, H, T / 64, C] and dwk_part [B, H, groups, C].
int fused_attn_bwd_launch(const void* qkv, const void* wq, const void* wk,
                          const void* sn, const void* cs, const void* out,
                          const void* lse, const void* dout, void* dq,
                          void* dk, void* dv, void* qhat, void* khat,
                          void* delta, void* dq_acc, void* dwq_part,
                          void* dwk_part, int b, int t, int h, int hkv, int c,
                          int f_row, int kv_row, int groups, int dtype,
                          float scale, float eps, void* stream) {
  const float* wq_f = static_cast<const float*>(wq);
  const float* wk_f = static_cast<const float*>(wk);
  const float* sn_f = static_cast<const float*>(sn);
  const float* cs_f = static_cast<const float*>(cs);
  const float* lse_f = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* dwq = static_cast<float*>(dwq_part);
  float* dwk = static_cast<float*>(dwk_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t % kTile != 0 || h % hkv != 0) return cudaErrorInvalidValue;
  if (f_row != (h + 2 * hkv) * c) return cudaErrorInvalidValue;
#define F32(C)                                                               \
  return launch_bwd_f32<C>(                                                  \
      static_cast<const float*>(qkv), wq_f, wk_f, sn_f, cs_f,                \
      static_cast<const float*>(out), lse_f, static_cast<const float*>(dout), \
      static_cast<float*>(dq), static_cast<float*>(dk),                      \
      static_cast<float*>(dv), acc, dwq, dwk, b, t, h, hkv, f_row, kv_row,   \
      scale, eps, st)
#define BF16(C)                                                              \
  return launch_bwd_bf16<C>(                                                 \
      static_cast<const bf16*>(qkv), wq_f, wk_f, sn_f, cs_f,                 \
      static_cast<const bf16*>(out), lse_f, static_cast<const bf16*>(dout),  \
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
      static_cast<bf16*>(qhat), static_cast<bf16*>(khat),                    \
      static_cast<float*>(delta), acc, dwq, dwk, b, t, h, hkv, groups,       \
      kv_row, scale, eps, st)
  if (dtype == 0 && c == 64) F32(64);
  if (dtype == 0 && c == 128) F32(128);
  if (dtype == 1 && c == 64) BF16(64);
  if (dtype == 1 && c == 128) BF16(128);
#undef F32
#undef BF16
  return cudaErrorInvalidValue;
}

// The bf16 pre-pass alone (the split route's first launch): q^ [B, H, T,
// C] and k^ [B, Hkv, T, C] bf16 and, where `out` is given, delta [B, H, T]
// f32.
int fused_attn_bwd_prep_launch(const void* qkv, const void* wq,
                               const void* wk, const void* sn, const void* cs,
                               const void* out, const void* dout, void* qhat,
                               void* khat, void* delta, int b, int t, int h,
                               int hkv, int c, float eps, void* stream) {
  if (t % kTile != 0 || h % hkv != 0) return cudaErrorInvalidValue;
  if (out != nullptr && (dout == nullptr || delta == nullptr))
    return cudaErrorInvalidValue;
#define PREP(C)                                                              \
  return launch_prep<C>(                                                     \
      static_cast<const bf16*>(qkv), static_cast<const float*>(wq),          \
      static_cast<const float*>(wk), static_cast<const float*>(sn),          \
      static_cast<const float*>(cs), static_cast<const bf16*>(out),          \
      static_cast<const bf16*>(dout), static_cast<bf16*>(qhat),              \
      static_cast<bf16*>(khat), static_cast<float*>(delta), b, t, h, hkv,    \
      eps, static_cast<cudaStream_t>(stream))
  if (c == 64) PREP(64);
  if (c == 128) PREP(128);
#undef PREP
  return cudaErrorInvalidValue;
}

// The split backward's two kernels. dq / dk / dv rows are `dq_row` /
// `kv_row` elements apart (the packed qkv width for slots of dqkv), head h
// at column h * C. f32 kernels normalise and rope in their walks (qhat,
// khat unused); dwq_part / dwk_part are [B, H, T / 64, C]. bf16 kernels
// read the pre-pass's qhat / khat; the dq kernel runs one q tile a block,
// dwq_part [B, H, T / 64, C]; the dk/dv kernel one k tile pair a block,
// dwk_part [B, H, (T / 64 + 1) / 2, C].
int fused_attn_bwd_dq_launch(const void* qkv, const void* wq, const void* wk,
                             const void* sn, const void* cs, const void* lse,
                             const void* delta, const void* dout,
                             const void* qhat, const void* khat, void* dq,
                             void* dwq_part, int b, int t, int h, int hkv,
                             int c, int dq_row, int dtype, float scale,
                             float eps, void* stream) {
  const float* wq_f = static_cast<const float*>(wq);
  const float* wk_f = static_cast<const float*>(wk);
  const float* sn_f = static_cast<const float*>(sn);
  const float* cs_f = static_cast<const float*>(cs);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dwq = static_cast<float*>(dwq_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t % kTile != 0 || h % hkv != 0) return cudaErrorInvalidValue;
#define DQ32(C)                                                              \
  return launch_dq_f32<C>(static_cast<const float*>(qkv), wq_f, wk_f, sn_f,  \
                          cs_f, lse_f, delta_f,                             \
                          static_cast<const float*>(dout),                  \
                          static_cast<float*>(dq), dwq, b, t, h, hkv, dq_row, \
                          scale, eps, st)
#define DQ16(C)                                                              \
  return launch_dq_bf16<C>(                                                  \
      static_cast<const bf16*>(qkv), wq_f, sn_f, cs_f,                       \
      static_cast<const bf16*>(qhat), static_cast<const bf16*>(khat), lse_f, \
      delta_f, static_cast<const bf16*>(dout), static_cast<bf16*>(dq), dwq,  \
      b, t, h, hkv, dq_row, scale, eps, st)
  if (dtype == 0 && c == 64) DQ32(64);
  if (dtype == 0 && c == 128) DQ32(128);
  if (dtype == 1 && (qhat == nullptr || khat == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1 && c == 64) DQ16(64);
  if (dtype == 1 && c == 128) DQ16(128);
#undef DQ32
#undef DQ16
  return cudaErrorInvalidValue;
}

int fused_attn_bwd_dkv_launch(const void* qkv, const void* wq, const void* wk,
                              const void* sn, const void* cs, const void* lse,
                              const void* delta, const void* dout,
                              const void* qhat, const void* khat, void* dk,
                              void* dv, void* dwk_part, int b, int t, int h,
                              int hkv, int c, int kv_row, int dtype,
                              float scale, float eps, void* stream) {
  const float* wq_f = static_cast<const float*>(wq);
  const float* wk_f = static_cast<const float*>(wk);
  const float* sn_f = static_cast<const float*>(sn);
  const float* cs_f = static_cast<const float*>(cs);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dwk = static_cast<float*>(dwk_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t % kTile != 0 || h % hkv != 0) return cudaErrorInvalidValue;
  const int pairs = (t / kTile + 1) / 2;
#define DKV32(C)                                                             \
  return launch_dkv_f32<C>(static_cast<const float*>(qkv), wq_f, wk_f, sn_f, \
                           cs_f, lse_f, delta_f,                            \
                           static_cast<const float*>(dout),                 \
                           static_cast<float*>(dk), static_cast<float*>(dv), \
                           dwk, b, t, h, hkv, kv_row, scale, eps, st)
#define DKV16(C)                                                             \
  return launch_tile<C, false>(                                              \
      static_cast<const bf16*>(qkv), wk_f, sn_f, cs_f,                       \
      static_cast<const bf16*>(qhat), static_cast<const bf16*>(khat), lse_f, \
      delta_f, static_cast<const bf16*>(dout), static_cast<bf16*>(dk),       \
      static_cast<bf16*>(dv), nullptr, dwk, b, t, h, hkv, pairs, kv_row,     \
      scale, eps, st)
  if (dtype == 0 && c == 64) DKV32(64);
  if (dtype == 0 && c == 128) DKV32(128);
  if (dtype == 1 && (qhat == nullptr || khat == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1 && c == 64) DKV16(64);
  if (dtype == 1 && c == 128) DKV16(128);
#undef DKV32
#undef DKV16
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a bf16 wgmma kernel launches with, for reports:
// `which` 0 the forward core, 1 the split dq kernel, 2 the tile kernel
// without dQ (split dk/dv), 3 the tile kernel with it (combined); -1 for a
// shape no launcher takes.
int fused_attn_smem_bytes(int c, int which) {
  if (c != 64 && c != 128) return -1;
  const bool c64 = c == 64;
  switch (which) {
    case 0:
      return c64 ? attn_tiles::fwd_smem_bytes<64>()
                 : attn_tiles::fwd_smem_bytes<128>();
    case 1:
      return c64 ? dq_tile_smem_bytes<64>() : dq_tile_smem_bytes<128>();
    case 2:
    case 3:
      return c64 ? bwd_tile_smem_bytes<64>(which == 3)
                 : bwd_tile_smem_bytes<128>(which == 3);
    default:
      return -1;
  }
}

}  // extern "C"
