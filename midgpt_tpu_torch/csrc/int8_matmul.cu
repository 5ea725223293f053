// Int8-weight matrix product for Hopper (sm_90a): y[M, N] = (x[M, K] @
// codes[K, N]) * scale[N], x bf16 or f32, codes int8 in the [in, out]
// layout of QuantLinear, one f32 scale per output channel.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA,
// which fuses the int8 -> bf16 convert into the dot (midgpt_tpu/quant.py
// QuantLinear.__call__, :100; its `no-dequant-materialization` audit rule
// pins that no full-precision weight is written). Eager PyTorch would
// write a bf16 copy of every weight before cuBLAS reads it again: this
// kernel reads the codes once and never writes a dequantized weight.
//
// What bounds it on this card: bytes at the serving path's small M
// (decode M = slots = 8, verify M = 40): a decode step's projections read
// 127.3 MB of codes at 124M, a few operations a byte, far below the
// card's ridge; operations at prefill M (up to 512 rows). Two instances,
// picked by the host plan from M:
//   - M <= 48 (int8_mm_bf16_kernel<MT>, MT m16 tiles a block): codes tiles
//     [64 k x 64 n] and x tiles [16 MT rows x 64 k] stream through a ring
//     of 16-byte cp.async copies (a zero-filled copy past the edges of M,
//     N or K), five stages deep at decode M, three above. Each landed
//     codes tile is converted to bf16 in shared memory (exact: |code| <=
//     127; integer and f32 arithmetic at the full rate, see
//     int8x4_to_bf16x4) and read as the B operand by ldmatrix.trans; x is
//     the A operand by ldmatrix. bf16 tensor-core products (mma.sync
//     m16n8k16) sum in f32; four warps a block, 16 columns each.
//   - M > 48 (int8_mm_wgmma_kernel): two warpgroups a [128 x 128] output
//     tile, so a converted codes tile serves 128 rows (the mma.sync
//     instance converts it again for every 48). x lands by cp.async in the
//     128-byte-swizzled layout of hopper.cuh (the K-major A operand), the
//     codes tile is converted, 16 codes a thread a step, into the same
//     layout (the MN-major B operand, two 64-column panels), and each
//     warpgroup runs one wgmma m64n128k16 a 16-deep slice, both operands
//     from shared memory. Stores go two columns at a time.
//   - At small M the work is a GEMV: the (M tile, N tile) grid alone would
//     leave most of the 132 SMs idle (12 tiles for a 768-wide output), so
//     the host plan splits K, at most eight ways, into splits of a few K
//     tiles (ops/int8_matmul.py plan). A tile's splits form one thread
//     block cluster: each leaves its f32 partial tile in its shared
//     memory, and after a cluster barrier each block sums its share of the
//     tile, four elements a read, over the cluster's shared memories in
//     split order (cluster_sum). No partial goes through device memory,
//     no atomic orders the sum, and the result does not depend on which
//     block finishes first.
//   - The epilogue rounds as the plain version does: the f32 sum to bf16,
//     then its product with the scale rounded to bf16 (exact in f32: two
//     8-bit significands) to bf16 again. So it computes the plain
//     version's function for every scale, the po2 quantizer's and absmax's.
//   - f32 x (the f32 checks): a CUDA-core FMA loop, a thread a column and
//     eight rows, sums in k order; y = sum * scale, one f32 rounding, as
//     the plain version.
// Plain C interface (route (b) of the build): the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;  // the portable thread block cluster size

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 64;        // output columns a block: 16 a warp
constexpr int kBK = 64;        // depth of one ring stage
constexpr int kPad = 8;  // bf16 a shared row: 144-byte rows, no conflicts

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 codes (one 32-bit word) as four bf16, exactly, in full-rate
// integer and f32 operations (no int-to-float conversion instruction):
// byte b + 128 goes into the low mantissa bits of 2^23, an f32 subtract
// leaves b, and |b| <= 128 has at most eight significant bits, so the
// f32's top half is its bf16.
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t v) {
  const uint32_t u = v ^ 0x80808080u;  // each byte b + 128, unsigned
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.0f;  // 2^23 + 128
  uint2 out;
  out.x = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  out.y = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  return out;
}

// The plain version's two roundings: the f32 sum to bf16, then its product
// with the scale rounded to bf16 (exact in f32) to bf16.
__device__ __forceinline__ bf16 scaled_bf16(float acc, float s) {
  return __float2bfloat16_rn(__bfloat162float(__float2bfloat16_rn(acc)) *
                             __bfloat162float(__float2bfloat16_rn(s)));
}

// y[row, col .. col + 1] = (a, b) scaled, or as much of it as lies inside
// [M, N]; one 4-byte store where N is even (then col even is aligned).
__device__ __forceinline__ void store_pair(bf16* __restrict__ y,
                                           const float* __restrict__ scale,
                                           int M, int N, int row, int col,
                                           float a, float b) {
  if (row >= M || col >= N) return;
  bf16* dst = y + (size_t)row * N + col;
  const bf16 v0 = scaled_bf16(a, scale[col]);
  if (col + 1 >= N) {
    dst[0] = v0;
    return;
  }
  const bf16 v1 = scaled_bf16(b, scale[col + 1]);
  if (N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v0, v1);
  } else {
    dst[0] = v0;
    dst[1] = v1;
  }
}

// Both instances' accumulators come in quads: elements 4 g .. 4 g + 3 of a
// thread are (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1)
// of one m16 x n8 block; put(g, quad) stores quad g.
//
// The K splits of one output tile, a thread block cluster of `splits`
// blocks: each thread leaves its G quads (get(g), g a constant) in its
// block's shared memory at `part` (G * blockDim.x float4), and block
// `split` sums quads g = split, split + splits, ... over the cluster's
// blocks in split order and stores them (put(g, sum), g at run time). The
// caller's copies into `part` must have landed and its products finished.
template <int G, typename Get, typename Put>
__device__ __forceinline__ void cluster_sum(float4* part, int split,
                                            int splits, Get get, Put put) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) part[g * nt + tid] = get(g);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float4* src[kMaxSplits];
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp)
    src[sp] = sp < splits ? cluster.map_shared_rank(part, sp) : part;
#pragma unroll 4
  for (int g = split; g < G; g += splits) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        const float4 p = src[sp][g * nt + tid];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    put(g, v);
  }
  cluster.sync();  // the partials stay until every block has read them
}

// kVec: N % 16 == 0, so a 16-byte chunk of a codes row is wholly inside or
// wholly past N and starts aligned; otherwise bytes are copied one by one.
template <int MT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_mm_bf16_kernel(const bf16* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        bf16* __restrict__ y, int M, int N, int K,
                        int k_tiles_per_split, int splits) {
  constexpr int BM = 16 * MT;
  // ring stages: five at decode M (one m16 tile: a split's k tiles all in
  // flight at once, in 41 KB of static shared memory), three above
  constexpr int kStages = MT == 1 ? 5 : 3;
  __shared__ __align__(16) int8_t s_codes[kStages][kBK][kBN];
  __shared__ __align__(16) bf16 s_x[kStages][BM][kBK + kPad];
  __shared__ __align__(16) bf16 s_b[kBK][kBN + kPad];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile_n = blockIdx.x, tile_m = blockIdx.y, split = blockIdx.z;
  const int n0 = tile_n * kBN, m0 = tile_m * BM;
  const int nk = (K + kBK - 1) / kBK;
  const int kt0 = split * k_tiles_per_split;
  const int ntiles = min(nk, kt0 + k_tiles_per_split) - kt0;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    if (kVec) {
      for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
        const int r = c / (kBN / 16), j = (c % (kBN / 16)) * 16;
        const bool ok = k0 + r < K && n0 + j < N;
        cp_async16(&s_codes[stage][r][j],
                   ok ? w + (size_t)(k0 + r) * N + n0 + j : w, ok);
      }
    } else {
      for (int c = tid; c < kBK * kBN; c += kThreads) {
        const int r = c / kBN, j = c % kBN;
        const bool ok = k0 + r < K && n0 + j < N;
        s_codes[stage][r][j] = ok ? w[(size_t)(k0 + r) * N + n0 + j] : 0;
      }
    }
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), j = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + j < K;  // K % 8 == 0
      cp_async16(&s_x[stage][r][j], ok ? x + (size_t)(m0 + r) * K + k0 + j : x,
                 ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    const int nxt = i + kStages - 1;
    if (nxt < ntiles) load(nxt % kStages, kt0 + nxt);
    cp_async_commit();
    const int st = i % kStages;
    // the codes as bf16, four a thread a step
    for (int c = tid; c < kBK * kBN / 4; c += kThreads) {
      const int r = c / (kBN / 4), j = (c % (kBN / 4)) * 4;
      *reinterpret_cast<uint2*>(&s_b[r][j]) = int8x4_to_bf16x4(
          *reinterpret_cast<const uint32_t*>(&s_codes[st][r][j]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // B: k16 x n16 of this warp's columns, four 8 x 8 matrices
      // (k 0-7 | 8-15) x (n 0-7 | 8-15), transposed into mma's col layout
      uint32_t b[4];
      const int mat = lane >> 3;
      ldmatrix_x4_trans(
          b, &s_b[kk + (mat & 1) * 8 + (lane & 7)][warp * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, &s_x[st][mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
        mma_bf16(acc[mt][0], a, b[0], b[1]);
        mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // quad 2 mt + nt: rows g, g + 8 of m16 tile mt, columns 2 t, 2 t + 1 of
  // n8 tile nt (of this warp's 16)
  const int g = lane >> 2, t = lane & 3;
  auto put = [&](int q, float4 v) {
    const int row = m0 + (q >> 1) * 16 + g;
    const int col = n0 + warp * 16 + (q & 1) * 8 + 2 * t;
    store_pair(y, scale, M, N, row, col, v.x, v.y);
    store_pair(y, scale, M, N, row + 8, col, v.z, v.w);
  };
  auto get = [&](int q) {
    const float* a = acc[q >> 1][q & 1];
    return make_float4(a[0], a[1], a[2], a[3]);
  };
  if (splits > 1) {
    // the partial tiles in the codes ring, free now
    static_assert(sizeof(s_codes) >= sizeof(float) * BM * kBN, "partial");
    cluster_sum<MT * 2>(reinterpret_cast<float4*>(&s_codes[0][0][0]), split,
                        splits, get, put);
    return;
  }
#pragma unroll
  for (int q = 0; q < MT * 2; ++q) put(q, get(q));
}

// Prefill M: two warpgroups a [128 x 128] output tile on the wgmma cores,
// 64 rows each. Dynamic shared memory, 1024-byte aligned: the converted
// codes tile (two swizzled [64 k, 64 n] bf16 panels), then the ring's x
// tiles (swizzled [128 rows, 64 k]) and codes tiles ([64 k][128 n]).
constexpr int kWgThreads = 256;
constexpr int kWgBM = 128, kWgBN = 128, kWgStages = 3;
constexpr int kWgTileB = kBK * kWgBN * 2;
constexpr int kWgTileX = kWgBM * kBK * 2;
constexpr int kWgTileC = kBK * kWgBN;
constexpr int kWgSmem = kWgTileB + kWgStages * (kWgTileX + kWgTileC) + 1024;

__device__ __forceinline__ void st_shared16(unsigned char* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

template <bool kVec>
__global__ void __launch_bounds__(kWgThreads)
    int8_mm_wgmma_kernel(const bf16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         bf16* __restrict__ y, int M, int N, int K,
                         int k_tiles_per_split, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = hopper::aligned_smem_base(smem_raw);
  unsigned char* b_p = smem_raw + (base - hopper::smem_u32(smem_raw));
  unsigned char* x_p = b_p + kWgTileB;
  int8_t* c_p = reinterpret_cast<int8_t*>(x_p + kWgStages * kWgTileX);
  const uint32_t b_s = base, x_s = base + kWgTileB;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int tile_n = blockIdx.x, tile_m = blockIdx.y, split = blockIdx.z;
  const int n0 = tile_n * kWgBN, m0 = tile_m * kWgBM;
  const int nk = (K + kBK - 1) / kBK;
  const int kt0 = split * k_tiles_per_split;
  const int ntiles = min(nk, kt0 + k_tiles_per_split) - kt0;
  // a warpgroup whose 64 rows all lie past M runs no product
  const bool live = m0 + 64 * wg < M;

  // this thread's share of a tile: rows r0 + 32 u, 16-byte chunk j of an
  // x row (8 bf16 of k) and of a codes row (16 columns)
  const int r0 = tid >> 3, j = tid & 7;
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    int8_t* cs = c_p + stage * kWgTileC;
    if (kVec) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + 32 * u;
        const bool ok = k0 + r < K && n0 + 16 * j < N;
        cp_async16(cs + r * kWgBN + 16 * j,
                   ok ? w + (size_t)(k0 + r) * N + n0 + 16 * j : w, ok);
      }
    } else {
      for (int c = tid; c < kBK * kWgBN; c += kWgThreads) {
        const int r = c / kWgBN, jj = c % kWgBN;
        const bool ok = k0 + r < K && n0 + jj < N;
        cs[r * kWgBN + jj] = ok ? w[(size_t)(k0 + r) * N + n0 + jj] : 0;
      }
    }
    unsigned char* xs = x_p + stage * kWgTileX;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 32 * u;
      const bool ok = m0 + r < M && k0 + 8 * j < K;  // K % 8 == 0
      cp_async16(xs + hopper::sw128(r, j, kWgBM),
                 ok ? x + (size_t)(m0 + r) * K + k0 + 8 * j : x, ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < ntiles) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kWgStages - 2>();
    // tile i landed; tile i - 1's products are done (every thread waited)
    __syncthreads();
    const int nxt = i + kWgStages - 1;
    if (nxt < ntiles) load(nxt % kWgStages, kt0 + nxt);
    cp_async_commit();
    const int st = i % kWgStages;
    // 16 codes a copy: columns 16 j .. 16 j + 15 are the bf16 chunks 2 j
    // and 2 j + 1; the upper half of each eight threads (one row) stores
    // its odd chunk first, so each store's eight chunks take distinct banks
    const int8_t* cs = c_p + st * kWgTileC;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 32 * u;
      const uint4 v = *reinterpret_cast<const uint4*>(cs + r * kWgBN + 16 * j);
      const uint2 a = int8x4_to_bf16x4(v.x), b = int8x4_to_bf16x4(v.y);
      const uint2 c = int8x4_to_bf16x4(v.z), d = int8x4_to_bf16x4(v.w);
      const uint4 lo = make_uint4(a.x, a.y, b.x, b.y);
      const uint4 hi = make_uint4(c.x, c.y, d.x, d.y);
      const uint32_t olo = hopper::sw128(r, 2 * j, kBK);
      const uint32_t ohi = hopper::sw128(r, 2 * j + 1, kBK);
      const bool odd_first = j >= 4;
      st_shared16(b_p + (odd_first ? ohi : olo), odd_first ? hi : lo);
      st_shared16(b_p + (odd_first ? olo : ohi), odd_first ? lo : hi);
    }
    hopper::fence_async_shared();  // the converted tile and x for wgmma
    __syncthreads();
    if (live) {
      const uint32_t xt = x_s + st * kWgTileX + wg * (64 * 128);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_ss_n128<0, 1>(acc, hopper::desc_k(xt, kk),
                                    hopper::desc_mn(b_s, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }
  cp_async_wait<0>();

  // quad i: rows 16 warp + lane / 4 and + 8 of this warpgroup's 64,
  // columns 8 i + 2 (lane % 4), + 1
  const int row0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  auto put = [&](int i, float4 v) {
    store_pair(y, scale, M, N, row0, col0 + 8 * i, v.x, v.y);
    store_pair(y, scale, M, N, row0 + 8, col0 + 8 * i, v.z, v.w);
  };
  auto get = [&](int i) {
    return make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                       acc[4 * i + 3]);
  };
  if (splits > 1) {
    // the partial tiles in the ring (x and codes stages), free now
    static_assert(kWgStages * (kWgTileX + kWgTileC) >=
                      64 * kWgThreads * (int)sizeof(float), "partial");
    cluster_sum<16>(reinterpret_cast<float4*>(x_p), split, splits, get, put);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) put(i, get(i));
}

constexpr int kF32Rows = 8;
constexpr int kF32Cols = 128;
constexpr int kF32Depth = 256;

// f32 x: a thread a column, eight rows, the sums in k order.
__global__ void __launch_bounds__(kF32Cols)
    int8_mm_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ y,
                       int M, int N, int K) {
  __shared__ float xs[kF32Rows][kF32Depth];
  const int n = blockIdx.x * kF32Cols + threadIdx.x;
  const int m0 = blockIdx.y * kF32Rows;
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kF32Depth) {
    const int kn = min(kF32Depth, K - k0);
    for (int i = threadIdx.x; i < kF32Rows * kF32Depth; i += kF32Cols) {
      const int r = i / kF32Depth, c = i % kF32Depth;
      xs[r][c] = (m0 + r < M && c < kn) ? x[(size_t)(m0 + r) * K + k0 + c]
                                        : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int8_t* col = w + (size_t)k0 * N + n;
      for (int kk = 0; kk < kn; ++kk) {
        const float c = static_cast<float>(col[(size_t)kk * N]);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) acc[r] = fmaf(xs[r][kk], c, acc[r]);
      }
    }
    __syncthreads();
  }
  if (n >= N) return;
  const float s = scale[n];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
    if (m0 + r < M) y[(size_t)(m0 + r) * N + n] = acc[r] * s;
}

// One launch with a tile's K splits as one cluster (1, 1, splits); MT 1-3
// the mma.sync instance ([16 MT x 64] tiles), 4 the wgmma one ([128 x
// 128]).
template <int MT>
cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        void* y, int M, int N, int K, int kps, int splits,
                        cudaStream_t st) {
  constexpr bool kWg = MT == 4;
  constexpr int bm = kWg ? kWgBM : 16 * MT, bn = kWg ? kWgBN : kBN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + bn - 1) / bn, (M + bm - 1) / bm, splits);
  cfg.blockDim = dim3(kWg ? kWgThreads : kThreads);
  cfg.dynamicSmemBytes = kWg ? kWgSmem : 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* wb = static_cast<const int8_t*>(w);
  bf16* yb = static_cast<bf16*>(y);
  const bool vec = N % 16 == 0;
  cudaError_t err;
  if constexpr (kWg) {
    auto kern = vec ? int8_mm_wgmma_kernel<true> : int8_mm_wgmma_kernel<false>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, kern, xb, wb, scale, yb, M, N, K, kps,
                               splits);
  } else {
    auto kern = vec ? int8_mm_bf16_kernel<MT, true>
                    : int8_mm_bf16_kernel<MT, false>;
    err = cudaLaunchKernelEx(&cfg, kern, xb, wb, scale, yb, M, N, K, kps,
                             splits);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (x and y). mt (1, 2, 3: the
// mma.sync instance's m16 tiles a block; 4: the wgmma instance),
// k_tiles_per_split and splits (1..8) are the host plan's, for bf16.
// Returns a cudaError_t (0 = ok).
int int8_matmul_launch(const void* x, const void* w, const void* scale,
                       void* y, int M, int N, int K, int dtype, int mt,
                       int k_tiles_per_split, int splits, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    const dim3 grid((N + kF32Cols - 1) / kF32Cols,
                    (M + kF32Rows - 1) / kF32Rows);
    int8_mm_f32_kernel<<<grid, kF32Cols, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w), sc,
        static_cast<float*>(y), M, N, K);
    return cudaGetLastError();
  }
  if (dtype != 1 || splits < 1 || splits > kMaxSplits ||
      k_tiles_per_split < 1)
    return cudaErrorInvalidValue;
  if (mt == 1)
    return launch_bf16<1>(x, w, sc, y, M, N, K, k_tiles_per_split, splits,
                          st);
  if (mt == 2)
    return launch_bf16<2>(x, w, sc, y, M, N, K, k_tiles_per_split, splits,
                          st);
  if (mt == 3)
    return launch_bf16<3>(x, w, sc, y, M, N, K, k_tiles_per_split, splits,
                          st);
  if (mt == 4)
    return launch_bf16<4>(x, w, sc, y, M, N, K, k_tiles_per_split, splits,
                          st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
