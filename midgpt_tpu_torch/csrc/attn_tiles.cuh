// The two attention tile cores on `wgmma` (hopper.cuh) that both attention
// sources instantiate: flash.cu (flash attention with counter-hash
// dropout) and fused_attn.cu (QK-LayerNorm + RoPE + attention from packed
// qkv, whose bf16 routes first normalise and rope every q and k row once).
//
//   fwd_block<C, kMayDrop>: the forward of one block of two warpgroups and
//     128 q rows. flash_fwd_wgmma_kernel (flash.cu) runs it on q, k, v;
//     fused_fwd_wgmma_kernel (fused_attn.cu) on the pre-pass's q^ and k^
//     and v read in place from qkv. Each reads its operands and writes its
//     output through (batch, head, row) element strides, so the fused
//     forward writes [B, T, H C] straight from registers. lse [B, H, T] is
//     in natural-log units, as both backward routes read it.
//   dkv_walk<C, kDq, kDrop>: one k tile's walk over its q tiles in the
//     backward, dK and dV in registers. fused_bwd_tile_kernel (fused_attn.cu,
//     both bf16 routes: with the dQ half for the combined route, without
//     for the split one) runs it on q^, k^, v and dO; flash_dkv_tile_kernel
//     (flash.cu) on raw q, k, v and dO, with the dropout mask. Each kernel
//     chooses its blocks' k tiles and writes dK and dV itself.
//   dq_walk<C, kDrop>: one q tile's walk over its k tiles in the backward,
//     dQ in registers. fused_dq_tile_kernel (fused_attn.cu, the split
//     route) runs it on q^, k^, v and dO; flash_dq_tile_kernel (flash.cu)
//     on raw q, k, v and dO, with the dropout mask, after computing the
//     tile's delta itself. Each kernel loads its q tile and writes dQ.
//
// The dropout mask is a counter hash of (seed, flat q head, global row,
// global column): keep iff the low 24 bits of a murmur3-style finalizer
// fall under floor(keep * 2^24). All of it is uint32 arithmetic with
// logical shifts, bit for bit the JAX kernels' int32 wrapping arithmetic
// with shift_right_logical; the forward, dq and dk/dv kernels evaluate it
// per element from the same terms, so they drop the same entries.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace attn_tiles {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // rows of a q or k tile
constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;

// Element strides of one [B, heads, T, C] operand (the last stride is 1).
struct Strides {
  long long b, h, t;
};

struct Dims {
  int t, h, hkv, causal;
  float scale;
};

// The dropout payload: seed and the global anchors of this call's local
// (row 0, column 0, flat head 0), the flat head stride, the keep threshold
// over 2^24 and 1 / keep. `on` is 0 for a call without dropout. The seed
// lives in device memory (the low 32 bits of the word at `seed_ptr`): a
// kernel reads it into `seed` at its start (load_seed), so a captured
// CUDA graph's replay draws the mask of the seed its step wrote there.
struct Drop {
  uint32_t seed, row_off, col_off, bh_off, thresh;
  int n_head_total, on;
  float inv_keep;
  const uint32_t* seed_ptr;
};

// `d.seed` from device memory, once at a block's start (a call without
// dropout reads nothing)
__device__ __forceinline__ void load_seed(Drop& d) {
  if (d.on) d.seed = __ldg(d.seed_ptr);
}

// The hash's finalizer and keep test on x = (row A + col B) ^ (seed + bh C)
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t thresh) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return (x & 0x00FFFFFFu) < thresh;
}

// keep(row, col) of flat q head `bh`: the JAX kernels' _dropout_keep_block
__device__ __forceinline__ bool keep_at(const Drop& d, uint32_t bh,
                                        uint32_t row, uint32_t col) {
  return keep_mixed((row * 0x9E3779B1u + col * 0x85EBCA77u) ^
                        (d.seed + bh * 0xC2B2AE35u),
                    d.thresh);
}

__device__ __forceinline__ uint32_t flat_head(const Drop& d, int b, int head) {
  return d.bh_off + static_cast<uint32_t>(b) * d.n_head_total + head;
}

// 2^x on the special-function unit (flush to zero below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The forward core.
// ---------------------------------------------------------------------------

// One k tile's online softmax for a thread's two rows (r0, r0 + 8) and
// 16 columns. s holds the raw scores; the exponent runs in base 2, with
// log2(e) folded into the scale (`scale2`) and m kept in those units.
// Writes the dropped, 1 / keep-scaled probabilities as bf16 pairs in the
// A-operand order of the PV product, updates m and the undropped sum l,
// and returns each row's rescale factor in alpha. `sd` is the hash's
// per-head term seed + bh C.
template <bool kDrop>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&p)[16], float (&m)[2], float (&l)[2],
    float (&alpha)[2], float scale2, bool diag, int r0, int cbase,
    const Drop& dr, uint32_t sd, uint32_t grow, uint32_t gcol) {
  using hopper::pack_bf16;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + cbase + (i & 1);
    float z = s[i] * scale2;
    if (diag && col > row) z = kNegInf;
    s[i] = z;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], z);
  }
  float rs[2] = {0.f, 0.f};
  uint32_t rowa[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr]);
    alpha[hr] = ex2(m[hr] - m_new);
    m[hr] = m_new;
    rowa[hr] = (grow + r0 + hr * 8) * 0x9E3779B1u;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int hr = (i >> 1) & 1;
    const float p0 = ex2(s[i] - m[hr]);
    const float p1 = ex2(s[i + 1] - m[hr]);
    rs[hr] += p0;  // l sums the undropped probabilities
    rs[hr] += p1;
    float a0 = p0, a1 = p1;
    if (kDrop) {
      const uint32_t colb = (gcol + (i >> 2) * 8 + cbase) * 0x85EBCA77u;
      a0 = keep_mixed((rowa[hr] + colb) ^ sd, dr.thresh) ? p0 * dr.inv_keep
                                                         : 0.f;
      a1 = keep_mixed((rowa[hr] + colb + 0x85EBCA77u) ^ sd, dr.thresh)
               ? p1 * dr.inv_keep
               : 0.f;
    }
    // (i >> 2) is the 8-column block; blocks 2 kk, 2 kk + 1 make up the
    // A registers of depth slice kk: {block 2kk row 0, row 8, block 2kk+1
    // row 0, row 8}
    const int blk = i >> 2;
    p[(blk >> 1) * 4 + (blk & 1) * 2 + hr] = pack_bf16(a0, a1);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    l[hr] = alpha[hr] * l[hr] + rs[hr];
  }
}

// Dynamic shared memory of a forward block: six swizzled [64, C] tiles (Q
// of both warpgroups, two K and two V stages) and 1024 bytes of alignment
// slack.
template <int C>
constexpr int fwd_smem_bytes() {
  return 6 * kTile * C * 2 + 1024;
}

// The forward of one block of 2 x 128 threads: two warpgroups per 128 q
// rows (heavy causal blocks first); warpgroup g owns q tile 2 * block + g
// and idles where that tile lies past T (T % 128 == 64). Both share each
// K/V tile, which 16-byte cp.async copies bring into a double-buffered ring
// while the previous tile is multiplied.
//   S = Q K^T: m64n64k16 products, Q and K read K-major from swizzled
//     shared memory; S stays in registers.
//   softmax: each thread holds two rows' 16 columns; row max and sum run
//     over the four lanes of a row by shuffles; the causal mask touches
//     the diagonal tile only; the dropout hash (kMayDrop, where dr.on) is
//     evaluated per element from its (row, column) and applied by a select.
//   O += P V: P (dropped, scaled, rounded to bf16) is the register A
//     operand of m64nCk16 products, V is read MN-major; O stays in
//     registers and is rescaled there.
// out row t of (b, head) is at out + b so.b + head so.h + t so.t; lse is
// [B, H, T] f32, m ln 2 + log l.
template <int C, bool kMayDrop>
__device__ __forceinline__ void fwd_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
    bf16* __restrict__ out, Strides so, float* __restrict__ lse, Dims d,
    Drop dr, unsigned char* smem_raw) {
  using namespace hopper;
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // O accumulator floats a thread
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t q_s = base;               // [2][64, C]: one per warpgroup
  const uint32_t k_s = base + 2 * kTileB;  // [2 stages][64, C]
  const uint32_t v_s = k_s + 2 * kTileB;   // [2 stages][64, C]

  const int nq = d.t / kTile;
  const int nblk = (nq + 1) / 2;
  const int blk = nblk - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (d.h / d.hkv);
  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int lane = tid & 31, wwarp = (tid % kWgThreads) >> 5;
  const int iq = 2 * blk + wg;  // this warpgroup's q tile
  const bool active = iq < nq;
  const int n_kt = d.causal ? min(2 * blk + 1, nq - 1) + 1 : nq;
  const int my_kt = d.causal ? iq + 1 : nq;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const uint32_t sd = dr.seed + flat_head(dr, b, head) * 0xC2B2AE35u;
  const float scale2 = d.scale * 1.4426950408889634f;  // log2(e)

  // Q rows of both warpgroups (those inside T), then K/V tile 0
  {
    const int rows = min(2 * kTile, d.t - 2 * blk * kTile);
    const bf16* qb = q + b * sq.b + head * sq.h + 2 * blk * kTile * sq.t;
    for (int i = tid; i < rows * (C / 8); i += 2 * kWgThreads) {
      const int r = i / (C / 8), j = i % (C / 8);
      cp_async16(q_s + (r / kTile) * kTileB + sw128(r % kTile, j, kTile),
                 qb + r * sq.t + j * 8);
    }
  }
  load_tile_async<C>(k_s, kb, sk.t, kTile, tid, 2 * kWgThreads);
  load_tile_async<C>(v_s, vb, sv.t, kTile, tid, 2 * kWgThreads);
  cp_async_commit();

  float o[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r0 = wwarp * 16 + (lane >> 2);  // rows r0, r0 + 8 of the tile
  const int cbase = (lane & 3) * 2;
  const uint32_t my_q = q_s + wg * kTileB;
  const int t0 = iq * kTile;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      const int s1 = (j + 1) * kTile;
      load_tile_async<C>(k_s + (st ^ 1) * kTileB, kb + s1 * sk.t, sk.t, kTile,
                         tid, 2 * kWgThreads);
      load_tile_async<C>(v_s + (st ^ 1) * kTileB, vb + s1 * sv.t, sv.t, kTile,
                         tid, 2 * kWgThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    if (active && j < my_kt) {
      float s[32];
      const uint32_t kt = k_s + st * kTileB, vt = v_s + st * kTileB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        wgmma_ss_n64<0, 0>(s, desc_k(my_q, kk), desc_k(kt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      uint32_t p[16];
      float alpha[2];
      const bool diag = d.causal && j == iq;
      if (kMayDrop && dr.on)
        softmax_tile<true>(s, p, m, l, alpha, scale2, diag, r0, cbase, dr, sd,
                           dr.row_off + t0, dr.col_off + j * kTile);
      else
        softmax_tile<false>(s, p, m, l, alpha, scale2, diag, r0, cbase, dr,
                            sd, 0, 0);
#pragma unroll
      for (int i = 0; i < kNO; ++i) o[i] *= alpha[(i >> 1) & 1];

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<1>(o, a, desc_mn(vt, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  if (!active) return;
  bf16* ob = out + b * so.b + head * so.h;
  const long long lrow = (static_cast<long long>(b) * d.h + head) * d.t + t0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + hr * 8;
    const float inv = 1.f / l[hr];
    bf16* orow = ob + (t0 + r) * so.t + cbase;
#pragma unroll
    for (int i = 0; i < C / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          pack_bf16(o[4 * i + 2 * hr] * inv, o[4 * i + 2 * hr + 1] * inv);
    if ((lane & 3) == 0)
      lse[lrow + r] = m[hr] * 0.6931471805599453f + logf(l[hr]);  // ln 2
  }
}

// ---------------------------------------------------------------------------
// The backward's k-tile core.
// ---------------------------------------------------------------------------

// Shared-memory addresses of one walk's tiles (swizzled [64, C] bf16): the
// k tile's K (or K^) and V, two stages each of Q (or Q^) and dO, the dS^T
// panel (kDq only) and two stages each of the lse and delta rows
// (`rows`, 4 x 64 f32; `rows_g` is its generic address).
struct KvTiles {
  uint32_t k, v, q, dout, ds, rows;
  const float* rows_g;
};

// What one walk reads from device memory: the k tile's 64 rows of K and
// V, row 0 of the (b, q head)'s Q and dO, all with row strides in
// elements (16-byte aligned rows), and row 0 of its lse and delta (f32,
// contiguous).
struct KvOperands {
  const bf16* k;
  long long sk;
  const bf16* v;
  long long sv;
  const bf16* q;
  long long sq;
  const bf16* dout;
  long long sd;
  const float* lse;
  const float* delta;
};

// The hash's terms for one walk (kDrop): seed + flat head C, the global
// row of q row 0 and the global column of the k tile's row 0, the
// threshold and 1 / keep.
struct DropTile {
  uint32_t sd, row, col, thresh;
  float inv_keep;
};

// One warpgroup's walk of k tile `jk` over q tiles [iq0, nq), iq0 = jk
// (causal) or 0, leaving dK and dV of the tile's 64 keys in registers (the
// accumulator layout of hopper.cuh: keys r0, r0 + 8, C / 2 floats a
// thread). Per q tile, with rows of S^T keys and columns q rows:
//   S^T = K Q^T and dP^T = V dO^T (SS products, K-major operands);
//   P^T = exp(S^T scale - lse) (a key after the q row masked on the
//     diagonal tile); with kDrop the keep-mask M and 1 / keep applied to
//     the P^T that dV reads and to dP^T;
//   dS^T = P^T (dP^T - delta) scale; P^T and dS^T rounded to bf16;
//   dV += P^T dO and dK += dS^T Q (RS: P^T and dS^T from the accumulator
//     layout, dO and Q MN-major);
//   kDq: dS^T staged into `sm.ds` and dQ = dS K added into the f32 partial
//     at `dq_dst` (q row 0 of the (b, head)), written where `first`.
// Q, dO, lse and delta tiles come double-buffered by cp.async. The walk
// ends on a barrier, after which its tiles are free.
template <int C, bool kDq, bool kDrop>
__device__ __forceinline__ void dkv_walk(const KvTiles& sm,
                                         const KvOperands& in, int jk, int nq,
                                         bool causal, float scale,
                                         const DropTile& dt, float* dq_dst,
                                         bool first, float (&dk)[C / 2],
                                         float (&dv)[C / 2]) {
  using namespace hopper;
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  constexpr int kNO = C / 2;             // dK / dV floats a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int cbase = (lane & 3) * 2;
  const int iq0 = causal ? jk : 0;

  // q tile iq's Q, dO, lse and delta into stage st (the row offsets are
  // formed in 64 bits: an int product widened afterwards cost the fused
  // tile kernel 24 registers at C=64)
  auto load_q = [&](int iq, int st) {
    const long long r = static_cast<long long>(iq) * kTile;
    load_tile_async<C>(sm.q + st * kTileB, in.q + r * in.sq, in.sq, kTile,
                       tid, kWgThreads);
    load_tile_async<C>(sm.dout + st * kTileB, in.dout + r * in.sd, in.sd,
                       kTile, tid, kWgThreads);
    if (tid < 32) {
      const float* src = (tid < 16 ? in.lse : in.delta) + iq * kTile;
      cp_async16(sm.rows + ((tid < 16 ? 0 : 2) + st) * kTile * 4 +
                     (tid & 15) * 16,
                 src + (tid & 15) * 4);
    }
  };

  load_tile_async<C>(sm.k, in.k, in.sk, kTile, tid, kWgThreads);
  load_tile_async<C>(sm.v, in.v, in.sv, kTile, tid, kWgThreads);
  load_q(iq0, 0);
  cp_async_commit();

#pragma unroll
  for (int i = 0; i < kNO; ++i) dk[i] = dv[i] = 0.f;
  // the hash's column terms of this thread's two keys
  uint32_t keyb[2] = {0u, 0u};
  if (kDrop) {
    keyb[0] = (dt.col + r0) * 0x85EBCA77u;
    keyb[1] = (dt.col + r0 + 8) * 0x85EBCA77u;
  }

  for (int iq = iq0; iq < nq; ++iq) {
    const int st = (iq - iq0) & 1;
    if (iq + 1 < nq) {
      load_q(iq + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t qt = sm.q + st * kTileB, dt_s = sm.dout + st * kTileB;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, desc_k(sm.k, kk), desc_k(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_n64<0, 0>(dp, desc_k(sm.v, kk), desc_k(dt_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // rows of S^T are keys, columns q rows: a key after the q row is
    // masked on the diagonal tile
    const float* ls = sm.rows_g + st * kTile;
    const float* dl = sm.rows_g + (2 + st) * kTile;
    const bool diag = causal && iq == jk;
    uint32_t pp[16], dsp[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i >> 1) & 1, blk = i >> 2;
      const int key = r0 + hr * 8, col = blk * 8 + cbase;
      // the hash's row term of q row col (col + 1 adds one more A)
      const uint32_t qa =
          kDrop ? (dt.row + iq * kTile + col) * 0x9E3779B1u : 0u;
      float p[2], pv[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float z = s[i + e] * scale;
        if (diag && key > col + e) z = kNegInf;
        p[e] = expf(z - ls[col + e]);
        float g = dp[i + e];
        pv[e] = p[e];
        if (kDrop) {
          const bool kp = keep_mixed(
              (qa + e * 0x9E3779B1u + keyb[hr]) ^ dt.sd, dt.thresh);
          pv[e] = kp ? p[e] * dt.inv_keep : 0.f;
          g = kp ? g * dt.inv_keep : 0.f;
        }
        ds[e] = (p[e] * (g - dl[col + e])) * scale;
      }
      const int a = (blk >> 1) * 4 + (blk & 1) * 2 + hr;
      pp[a] = pack_bf16(pv[0], pv[1]);
      dsp[a] = pack_bf16(ds[0], ds[1]);
      if constexpr (kDq)
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         sm.ds + sw128_pair(key, col, kTile)),
                     "r"(dsp[a])
                     : "memory");
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                             pp[4 * kk + 3]};
      wgmma_rs<1>(dv, a, desc_mn(dt_s, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {dsp[4 * kk], dsp[4 * kk + 1], dsp[4 * kk + 2],
                             dsp[4 * kk + 3]};
      wgmma_rs<1>(dk, a, desc_mn(qt, kk), 1);
    }
    wgmma_commit();
    if constexpr (kDq) fence_async_shared();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);

    if constexpr (kDq) {
      __syncthreads();  // dS^T is whole
      // dQ rows of this q tile, 64 columns at a time, into the partial
      float* dst = dq_dst + static_cast<size_t>(iq) * kTile * C;
#pragma unroll
      for (int pc = 0; pc < C / 64; ++pc) {
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_ss_n64<1, 1>(dq, desc_mn(sm.ds, kk),
                             desc_mn(sm.k + pc * kPanelBytes, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = r0 + ((i >> 1) & 1) * 8;
          const int col = pc * 64 + (i >> 2) * 8 + cbase;
          float2* p = reinterpret_cast<float2*>(dst + (size_t)row * C + col);
          float2 v = make_float2(dq[i], dq[i + 1]);
          if (!first) {
            const float2 o = *p;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *p = v;
        }
      }
    }
    __syncthreads();  // the stage (and dS^T) are refilled next
  }
}

// ---------------------------------------------------------------------------
// The backward's q-tile core.
// ---------------------------------------------------------------------------

// Shared-memory addresses of one dq walk's tiles (swizzled [64, C] bf16):
// the q tile's Q (or Q^) and dO, two stages each of K (or K^) and V, and
// the q tile's lse and delta rows (f32 [64] each, generic address).
struct DqTiles {
  uint32_t q, dout, k, v;
  const float* rows_g;
};

// Row 0 of the (b, kv head)'s K and V, with row strides in elements
// (16-byte aligned rows).
struct DqOperands {
  const bf16* k;
  long long sk;
  const bf16* v;
  long long sv;
};

// One warpgroup's walk of q tile `iq` over k tiles [0, n_kt), leaving
// dQ of the tile's 64 rows in registers (the accumulator layout of
// hopper.cuh: rows r0, r0 + 8, C / 2 floats a thread). The caller has
// issued the copies of Q, dO, the lse and delta rows (or written the
// delta row) and K/V tile 0 into stage 0 as one cp.async group. Per k
// tile, with rows q rows and columns keys:
//   S = Q K^T and dP = dO V^T (SS products, K-major operands);
//   P = exp(S scale - lse), taken as 2^(S scale log2 e - lse log2 e) (a
//     key after the q row masked on the causal diagonal tile); with kDrop
//     the keep-mask M and 1 / keep applied to dP, the hash's row terms
//     hoisted per thread (its two q rows) and its column term formed per
//     k tile, through the forward's keep_mixed, so the forward, dq and
//     dk/dv drop the same entries;
//   dS = P (dP - delta) scale, rounded to bf16 in the A-operand order;
//   dQ += dS K (RS: dS from the accumulator layout, K MN-major).
// K and V come double-buffered by cp.async. The walk ends on a barrier,
// after which its tiles are free.
template <int C, bool kDrop>
__device__ __forceinline__ void dq_walk(const DqTiles& sm,
                                        const DqOperands& in, int iq,
                                        int n_kt, bool causal, float scale,
                                        const DropTile& dt,
                                        float (&dq)[C / 2]) {
  using namespace hopper;
  constexpr int kTileB = kTile * C * 2;  // one swizzled [64, C] bf16 tile
  const int tid = threadIdx.x, lane = tid & 31, wwarp = tid >> 5;
  const int r0 = wwarp * 16 + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int cbase = (lane & 3) * 2;
  const float* ls = sm.rows_g;
  const float* dl = sm.rows_g + kTile;
  // the exponent in base 2, log2(e) folded into the scale and the lse (as
  // the forward takes it): 15% of the flash dq's time and of the split
  // route's against expf
  const float scale2 = scale * 1.4426950408889634f;
  // the hash's row terms of this thread's two q rows
  uint32_t rowa[2] = {0u, 0u};
  if (kDrop) {
    rowa[0] = (dt.row + r0) * 0x9E3779B1u;
    rowa[1] = (dt.row + r0 + 8) * 0x9E3779B1u;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      // the row offset formed in 64 bits (see dkv_walk)
      const long long s1 = static_cast<long long>(j + 1) * kTile;
      load_tile_async<C>(sm.k + (st ^ 1) * kTileB, in.k + s1 * in.sk, in.sk,
                         kTile, tid, kWgThreads);
      load_tile_async<C>(sm.v + (st ^ 1) * kTileB, in.v + s1 * in.sv, in.sv,
                         kTile, tid, kWgThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const uint32_t kt = sm.k + st * kTileB, vt = sm.v + st * kTileB;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, desc_k(sm.q, kk), desc_k(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_n64<0, 0>(dp, desc_k(sm.dout, kk), desc_k(vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // rows are q rows, columns keys: a key after the q row is masked
    // on the diagonal tile
    const bool diag = causal && j == iq;
    const uint32_t colj =
        kDrop ? (dt.col + j * kTile + cbase) * 0x85EBCA77u : 0u;
    uint32_t dsp[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hr = (i >> 1) & 1, blk8 = i >> 2;
      const int row = r0 + hr * 8, col = blk8 * 8 + cbase;
      const float lr = ls[row] * 1.4426950408889634f, dr = dl[row];
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float z = s[i + e] * scale2;
        if (diag && col + e > row) z = kNegInf;
        const float p = ex2(z - lr);
        float g = dp[i + e];
        if (kDrop) {
          const bool kp = keep_mixed(
              (rowa[hr] + colj + (blk8 * 8 + e) * 0x85EBCA77u) ^ dt.sd,
              dt.thresh);
          g = kp ? g * dt.inv_keep : 0.f;
        }
        ds[e] = (p * (g - dr)) * scale;
      }
      dsp[(blk8 >> 1) * 4 + (blk8 & 1) * 2 + hr] = pack_bf16(ds[0], ds[1]);
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {dsp[4 * kk], dsp[4 * kk + 1], dsp[4 * kk + 2],
                             dsp[4 * kk + 3]};
      wgmma_rs<1>(dq, a, desc_mn(kt, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncthreads();  // this stage is refilled two tiles on
  }
}

}  // namespace attn_tiles
