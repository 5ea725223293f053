// Int8-weight matrix product for Hopper (sm_90a): y[M, N] = (x[M, K] @
// codes[K, N]) * scale[N], x bf16 or f32, codes int8 in the [in, out]
// layout of QuantLinear, one f32 scale per output channel.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA,
// which fuses the int8 -> bf16 convert into the dot (midgpt_tpu/quant.py
// QuantLinear.__call__, :100; its `no-dequant-materialization` audit rule
// pins that no full-precision weight is written). Eager PyTorch would
// write a bf16 copy of every weight before cuBLAS reads it again: this
// kernel reads the codes once, as they lie, and writes no dequantized or
// repacked weight.
//
// What bounds it on this card: bytes at the serving path's small M
// (decode M = slots = 8, verify M = 40): a decode step's projections read
// 127.3 MB of codes at 124M, a few operations a byte, far below the
// card's ridge, and most of its 49 launches are too small to leave the
// latency of one trip to memory; operations at prefill M (up to 1024
// rows). Both bf16 instances swap the operands' roles, y^T = codes^T x^T:
// the codes are the A operand of the tensor cores, taken from registers,
// so each code is converted once, in registers, straight into the A
// fragment, and x's rows sit on the product's narrow side (n8 at decode).
// The conversion (codes_to_bf16x2) is exact: b = c - 128 s with c = b &
// 0x7f and s its sign bit, and (128 + c) - (128 + 128 s) in bf16, both
// operands built by bit operations, the difference an integer of at most
// eight bits.
//   - M <= 48 (int8_gemv_kernel<MT>, MT = ceil(M / 8) m8 tiles): a
//     streaming GEMV. A block is four warps on one output tile of 64
//     columns, each warp on its own K steps of 16 rows (steps w, w + 4,
//     ...), summed in shared memory in warp order. A thread copies, by
//     cp.async, exactly the codes it converts (four K rows of 8 columns)
//     and the x it multiplies (8 bytes a m8 tile) into its own slots of its
//     warp's ring (six steps deep up to MT = 2, four above): no thread
//     reads another's copy, so the main loop has no barrier. K rows 4t ..
//     4t + 3 of a step feed logical columns 2t, 2t + 1, 2t + 8, 2t + 9 of
//     mma.sync m16n8k16's A, and x's 8 bytes at 4t its B: a permutation
//     of the sum over K that both operands share. The grid is sized to
//     the card: a tile's K is split over a thread block cluster only
//     where the tiles alone leave SMs idle, and blocks past what the
//     card holds at once loop over tiles (the head at M = 8: 786 tiles on
//     396 blocks), their rings running on across tiles. (Tiles of 128 columns, 16 bytes a thread a
//     row, ran slower at M = 8 and 16 on an H100 SXM.)
//   - M > 48 (int8_mm_wgmma_kernel): two warpgroups a [128 rows x 128
//     columns] tile, four wgmma m64n128k16 a 64-deep stage each: A the
//     warpgroup's 64 output columns of codes^T from registers
//     (hopper::wgmma_rs_n128), B x's 128 rows. One thread copies each
//     stage with two TMA tile loads (x into the 128-byte-swizzled K-major
//     layout wgmma reads, the [64 k x 128] codes tile 128-byte-swizzled,
//     so ldmatrix.trans reads it without bank conflicts), two stages
//     ahead through a four-stage ring with full and empty mbarriers: no
//     block barrier and no thread copies in the loop. A warp reads a
//     stage's codes with two ldmatrix.trans, converts them into the four
//     slices' A fragments and issues the four products as one group; the
//     other warpgroup and the SM's second block keep the tensor cores busy
//     while it converts. Tiles run m fastest, so the blocks at work share
//     codes tiles in L2 and the head's codes pass the memory once.
//   - The K splits of a tile form one cluster and sum in split order
//     through the cluster's shared memory (the GEMV: each block writes its
//     values into the block that owns them, then one cluster barrier; the
//     wgmma instance: cluster_sum). No partial goes through device memory,
//     no atomic orders a sum, and the result does not depend on which
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
#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;  // the portable thread block cluster size

// 8 bytes global -> shared, or 8 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
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

// Two int8 codes as a bf16 pair, exactly: bytes 0 (low half) and 2 (high
// half) of v; bytes 1 and 3 are ignored. A code b is c - 128 s (c = b &
// 0x7f, s its sign bit); 0x4300 | c is the bf16 128 + c and 0x4300 | s << 7
// the bf16 128 + 128 s, so one bf16x2 subtract gives b, exactly.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  const uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (v & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The selector of __byte_perm that puts byte i of its first operand in
// byte 0 and byte j (of both operands, 4 .. 7 the second) in byte 2.
__host__ __device__ constexpr uint32_t pair_sel(int i, int j) {
  return i | i << 4 | j << 8 | j << 12;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// The halves of a cluster barrier: arrive without ordering memory, wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

__device__ __forceinline__ float4& operator+=(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// The K splits of one output tile, a thread block cluster of `splits`
// blocks: each thread leaves its G values (get(g), g a constant) in its
// block's shared memory at `part` (G * blockDim.x of T), and block `split`
// sums values g = split, split + splits, ... over the cluster's blocks in
// split order and stores them (put(g, sum), g at run time). The caller's
// copies into `part` must have landed and its products finished.
template <int G, typename T, typename Get, typename Put>
__device__ __forceinline__ void cluster_sum(T* part, int split, int splits,
                                            Get get, Put put) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) part[g * nt + tid] = get(g);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const T* src[kMaxSplits];
#pragma unroll
  for (int sp = 0; sp < kMaxSplits; ++sp)
    src[sp] = sp < splits ? cluster.map_shared_rank(part, sp) : part;
#pragma unroll 4
  for (int g = split; g < G; g += splits) {
    T v = src[0][g * nt + tid];
#pragma unroll
    for (int sp = 1; sp < kMaxSplits; ++sp)
      if (sp < splits) v += src[sp][g * nt + tid];
    put(g, v);
  }
  cluster.sync();  // the partials stay until every block has read them
}

// -- M <= 48: the streaming GEMV ---------------------------------------------

constexpr int kGvWarps = 4;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvStep = 16;  // K rows of one step of a warp's ring

// Shapes of the instance with MT m8 tiles of x rows. A thread's codes of a
// step: four K rows of 8 bytes (columns 8 g .. 8 g + 7), converted into
// the A fragments of four m16 tiles of output columns.
template <int MT>
struct Gv {
  static constexpr int kCols = 64;     // output columns a tile
  static constexpr int kRows = 8 * MT;  // x rows a tile
  static constexpr int kStages = MT <= 2 ? 6 : 4;
  static constexpr int kCodeBytes = 4 * 32 * 8;  // a warp's, a step
  static constexpr int kStageBytes = kCodeBytes + MT * 32 * 8;
  static constexpr int kRedStride = kCols + 4;  // floats a row of a partial
  static constexpr int kRingBytes = kGvWarps * kStages * kStageBytes;
  static constexpr int kRedBytes = kGvWarps * kRows * kRedStride * 4;
  // `part`: a tile's values (kRows kCols) in slots of up to kMaxSplits
  static constexpr int kPartBytes =
      (kRows * kCols + (kMaxSplits - 1) * kGvThreads) * 4;
  static constexpr int kSmem = kRingBytes + kRedBytes + kPartBytes;
};

// kVec: N % 16 == 0, so a thread's chunk of a codes row is wholly inside or
// wholly past N and starts aligned; otherwise bytes are copied one by one.
template <int MT, bool kVec>
__global__ void __launch_bounds__(kGvThreads)
    int8_gemv_kernel(const bf16* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale, bf16* __restrict__ y,
                     int M, int N, int K, int steps_per_split, int splits) {
  using G = Gv<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + warp * G::kStages * G::kStageBytes;
  float* red = reinterpret_cast<float*>(smem + G::kRingBytes);
  float* part = red + kGvWarps * G::kRows * G::kRedStride;

  const int split = blockIdx.z;
  const int tiles = (N + G::kCols - 1) / G::kCols;
  const int nsteps = (K + kGvStep - 1) / kGvStep;
  const int s0 = split * steps_per_split;
  const int len = min(nsteps, s0 + steps_per_split) - s0;
  // this warp's steps of each tile: s0 + warp, s0 + warp + 4, ...
  const int per_tile = len > warp ? (len - warp + kGvWarps - 1) / kGvWarps
                                  : 0;
  const int my_tiles = (tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int items = per_tile * my_tiles;
  constexpr int kVals = G::kRows * G::kCols / kGvThreads;  // of a tile
  if (splits > 1) cluster_arrive_relaxed();  // waited for at the sum

  // the items in order: steps s0 + warp, + 4, ... (per_tile of them) of
  // tiles blockIdx.x, + gridDim.x, ...; item q into ring stage q % kStages
  int iq = 0, i_tile = blockIdx.x, i_step = 0;  // the next item to copy
  auto issue = [&]() {
    if (iq < items) {
      const int k0 = (s0 + warp + i_step * kGvWarps) * kGvStep + 4 * t;
      const int n = i_tile * G::kCols + 8 * g;
      unsigned char* st = ring + (iq % G::kStages) * G::kStageBytes;
      if (++i_step == per_tile) {
        i_step = 0;
        i_tile += gridDim.x;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        unsigned char* dst = st + (i * 32 + lane) * 8;
        if (kVec) {
          const bool ok = k < K && n < N;
          cp_async8(dst, ok ? w + (size_t)k * N + n : w, ok);
        } else {
          for (int c = 0; c < 8; ++c)
            dst[c] = k < K && n + c < N ? w[(size_t)k * N + n + c] : 0;
        }
      }
      unsigned char* xs = st + G::kCodeBytes;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const bool ok = m < M && k0 < K;  // K % 8 == 0: 4 columns in or out
        cp_async8(xs + (mt * 32 + lane) * 8, ok ? x + (size_t)m * K + k0 : x,
                  ok);
      }
    }
    ++iq;
    hopper::cp_async_commit();
  };

  float acc[4][MT][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][mt][r] = 0.f;

#pragma unroll
  for (int q = 0; q < G::kStages - 1; ++q) issue();
  int stage = 0;  // item q's: q % kStages
  for (int j = 0; j < my_tiles; ++j) {
    for (int i = 0; i < per_tile; ++i) {
      hopper::cp_async_wait<G::kStages - 2>();  // item q landed
      issue();  // item q + kStages - 1, into the stage item q - 1 left
      const unsigned char* st = ring + stage * G::kStageBytes;
      stage = stage + 1 == G::kStages ? 0 : stage + 1;
      uint2 cw[4];  // row i: columns 8 g .. 8 g + 3 (x), 8 g + 4 .. (y)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cw[r] = *reinterpret_cast<const uint2*>(st + (r * 32 + lane) * 8);
      uint2 xv[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        xv[mt] = *reinterpret_cast<const uint2*>(st + G::kCodeBytes +
                                                 (mt * 32 + lane) * 8);
      // m16 tile p: its rows g and g + 8 are columns 8 g + 2 p and + 1
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int b = 2 * (p & 1);
        const uint32_t s0 = pair_sel(b, 4 + b), s1 = pair_sel(b + 1, 5 + b);
        auto word = [&](int r) { return p < 2 ? cw[r].x : cw[r].y; };
        const uint32_t a[4] = {
            codes_to_bf16x2(__byte_perm(word(0), word(1), s0)),
            codes_to_bf16x2(__byte_perm(word(0), word(1), s1)),
            codes_to_bf16x2(__byte_perm(word(2), word(3), s0)),
            codes_to_bf16x2(__byte_perm(word(2), word(3), s1))};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[p][mt], a, xv[mt].x, xv[mt].y);
      }
    }
    // the warp's partial tile: acc[p][mt] holds (row 8 mt + 2 t, + 1) x
    // (column 8 g + 2 p, + 1), as (r0, r2) and (r1, r3)
    float* rw = red + warp * G::kRows * G::kRedStride;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* o = rw + (8 * mt + 2 * t) * G::kRedStride + 8 * g + 2 * p;
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[p][mt][0], acc[p][mt][2]);
        *reinterpret_cast<float2*>(o + G::kRedStride) =
            make_float2(acc[p][mt][1], acc[p][mt][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[p][mt][r] = 0.f;
      }
    __syncthreads();
    const int n0 = (blockIdx.x + j * gridDim.x) * G::kCols;
    const int count = M * G::kCols;  // the tile's live elements, row-major
    auto warp_sum = [&](int e) {
      const int off = (e / G::kCols) * G::kRedStride + e % G::kCols;
      float s = red[off];
#pragma unroll
      for (int ww = 1; ww < kGvWarps; ++ww)
        s += red[ww * G::kRows * G::kRedStride + off];
      return s;
    };
    auto put = [&](int e, float s) {
      const int col = n0 + e % G::kCols;
      if (col < N) y[(size_t)(e / G::kCols) * N + col] = scaled_bf16(s, scale[col]);
    };
    if (splits > 1) {
      // one tile a block (the plan's rule where K is split). Value i of
      // this thread (element i kGvThreads + tid) belongs to rank i %
      // splits: written into that block's `part`, slot (i / splits)
      // splits + split, then one cluster barrier, and each block sums its
      // values' slots in split order from its own shared memory
      cg::cluster_group cluster = cg::this_cluster();
      cluster_wait();  // every block of the cluster has started
#pragma unroll
      for (int i = 0; i < kVals; ++i) {
        const int e = i * kGvThreads + tid;
        float* dst = cluster.map_shared_rank(part, i % splits);
        dst[((i / splits) * splits + split) * kGvThreads + tid] =
            e < count ? warp_sum(e) : 0.f;
      }
      cluster.sync();
      for (int i = split; i < kVals; i += splits) {
        const float* src = part + (i / splits) * splits * kGvThreads + tid;
        float v = src[0];
        for (int sp = 1; sp < splits; ++sp) v += src[sp * kGvThreads];
        const int e = i * kGvThreads + tid;
        if (e < count) put(e, v);
      }
    } else {
      for (int e = tid; e < count; e += kGvThreads) put(e, warp_sum(e));
      __syncthreads();  // red is written again for the next tile
    }
  }
  hopper::cp_async_wait<0>();
}

// -- M > 48: the wgmma instance ----------------------------------------------

constexpr int kWgThreads = 256;  // two warpgroups, 64 output columns each
constexpr int kWgWarps = kWgThreads / 32;
constexpr int kWgBM = 128;  // x rows a tile: the products' N
constexpr int kWgBN = 128;  // output columns a tile
constexpr int kWgBK = 64;   // depth of one ring stage
constexpr int kWgStages = 4;
constexpr int kWgAhead = kWgStages - 2;  // items copied ahead of the one in use
constexpr int kWgTileX = kWgBM * kWgBK * 2;
constexpr int kWgTileC = kWgBK * kWgBN;
constexpr int kWgSmem =
    kWgStages * (kWgTileX + kWgTileC + 2 * (int)sizeof(uint64_t)) + 1024;

// x_map: x as a [M, K] tensor, [128, 64] tiles; w_map: the codes as a [K,
// N] tensor, [64, 128] tiles (kVec only); both land 128-byte-swizzled.
template <bool kVec>
__global__ void __launch_bounds__(kWgThreads, 2)
    int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         bf16* __restrict__ y, int M, int N, int K,
                         int k_tiles_per_split, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = hopper::aligned_smem_base(smem_raw);
  unsigned char* x_p = smem_raw + (base - hopper::smem_u32(smem_raw));
  unsigned char* c_p = x_p + kWgStages * kWgTileX;
  uint64_t* full = reinterpret_cast<uint64_t*>(c_p + kWgStages * kWgTileC);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.z;
  const int mtiles = (M + kWgBM - 1) / kWgBM;
  const int tiles = mtiles * ((N + kWgBN - 1) / kWgBN);
  const int nk = (K + kWgBK - 1) / kWgBK;
  const int kt0 = split * k_tiles_per_split;
  const int per_tile = min(nk, kt0 + k_tiles_per_split) - kt0;
  const int my_tiles = (tiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int items = per_tile * my_tiles;
  auto tile_m0 = [&](int tile) { return (tile % mtiles) * kWgBM; };
  auto tile_n0 = [&](int tile) { return (tile / mtiles) * kWgBN; };

  // a stage is full once its copies landed (and, without kVec, every
  // thread's codes stores), empty once every warp is done with it
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], kVec ? 1 : 1 + kWgThreads);
      hopper::mbar_init(&empty[s], kWgWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the items in order: K tiles kt0, ... (per_tile of them) of tiles
  // blockIdx.x, + gridDim.x, ...; item p into stage p % kWgStages once
  // the stage's previous item is released. Thread 0 issues the copies;
  // without kVec every thread also stores its share of the codes.
  int ip = 0, i_step = 0, i_tile = blockIdx.x;  // the next item to copy
  auto issue = [&]() {
    if (ip < items) {
      const int st = ip % kWgStages, use = ip / kWgStages;
      const int k0 = (kt0 + i_step) * kWgBK;
      const int m0 = tile_m0(i_tile), n0 = tile_n0(i_tile);
      if (kVec) {
        if (tid == 0) {
          if (use > 0) hopper::mbar_wait(&empty[st], (use - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[st], kWgTileX + kWgTileC);
          hopper::tma_load_2d(x_p + st * kWgTileX, &x_map, &full[st], k0, m0);
          hopper::tma_load_2d(c_p + st * kWgTileC, &w_map, &full[st], n0, k0);
        }
      } else {
        if (use > 0) hopper::mbar_wait(&empty[st], (use - 1) & 1);
        if (tid == 0) {
          hopper::mbar_arrive_expect_tx(&full[st], kWgTileX);
          hopper::tma_load_2d(x_p + st * kWgTileX, &x_map, &full[st], k0, m0);
        }
        unsigned char* cs = c_p + st * kWgTileC;
        for (int c = tid; c < kWgBK * kWgBN; c += kWgThreads) {
          const int r = c / kWgBN, jj = c % kWgBN;
          const bool ok = k0 + r < K && n0 + jj < N;
          cs[hopper::sw128(r, jj >> 4, kWgBK) + (jj & 15)] =
              ok ? w[(size_t)(k0 + r) * N + n0 + jj] : 0;
        }
        hopper::mbar_arrive(&full[st]);
      }
      if (++i_step == per_tile) {
        i_step = 0;
        i_tile += gridDim.x;
      }
    }
    ++ip;
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // rows g and g + 8 of this warp's m16 slab of A are output columns col
  // and col + 1 of the tile: 16-byte chunk 4 wg + warp of a codes row
  const int col = 64 * wg + 16 * warp + 2 * g, chunk = 4 * wg + warp;
#pragma unroll
  for (int q = 0; q < kWgAhead; ++q) issue();
  int q = 0;
  for (int j = 0; j < my_tiles; ++j) {
    for (int i = 0; i < per_tile; ++i, ++q) {
      issue();  // item q + kWgAhead, into the stage item q - 2 released
      const int st = q % kWgStages;
      hopper::mbar_wait(&full[st], (q / kWgStages) & 1);
      const uint32_t xt = base + st * kWgTileX;
      // the tile's codes as A fragments, slice s in a[s]: ldmatrix.trans
      // of codes rows 32 h + lane (h < 2), this warp's chunk, gives v[m] =
      // rows 32 h + 8 m + 2 t, + 1 (halves) of columns col, col + 1
      // (bytes 0 and 1 of each half)
      const unsigned char* cs = c_p + st * kWgTileC;
      uint32_t a[kWgBK / 16][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4];
        ldmatrix_x4_trans(v, cs + hopper::sw128(32 * h + lane, chunk, kWgBK));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          a[2 * h + m / 2][2 * (m & 1)] =
              codes_to_bf16x2(__byte_perm(v[m], 0, pair_sel(0, 2)));
          a[2 * h + m / 2][2 * (m & 1) + 1] =
              codes_to_bf16x2(__byte_perm(v[m], 0, pair_sel(1, 3)));
        }
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int s = 0; s < kWgBK / 16; ++s)
        hopper::wgmma_rs_n128<0>(acc, a[s], hopper::desc_k(xt, s), 1);
      hopper::wgmma_commit();
      // retired before the next tile's conversion: the products read a[]
      // until then (the other warpgroup and block keep the cores busy)
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    hopper::fence_regs(acc);
    // quad i: rows 8 i + 2 t and + 1, columns col and col + 1: (acc[4 i],
    // acc[4 i + 2]) and (acc[4 i + 1], acc[4 i + 3])
    const int tile = blockIdx.x + j * gridDim.x;
    const int row0 = tile_m0(tile) + 2 * t, col0 = tile_n0(tile) + col;
    auto put = [&](int i, float4 v) {
      store_pair(y, scale, M, N, row0 + 8 * i, col0, v.x, v.z);
      store_pair(y, scale, M, N, row0 + 8 * i + 1, col0, v.y, v.w);
    };
    auto get = [&](int i) {
      return make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                         acc[4 * i + 3]);
    };
    if (splits > 1) {
      // one tile a block (the plan's rule where K is split): the partial
      // tiles in the x stages, every copy into them consumed
      static_assert(kWgStages * kWgTileX >= 64 * kWgThreads * 4, "partial");
      cluster_sum<16>(reinterpret_cast<float4*>(x_p), split, splits, get,
                      put);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) put(i, get(i));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
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

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library links no driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `esz`-byte elements at `ptr` (16-byte
// aligned, rows a multiple of 16 bytes), read in [box_rows, box_cols]
// tiles (box_cols esz = 128 bytes) that land 128-byte-swizzled, zeros past
// the edges.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int rows, int cols, int esz, int box_rows, int box_cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised:
// once per kernel instance and device (`done` holds a bit a device), not
// on every launch, where it would be host time on every projection.
cudaError_t allow_smem(const void* kern, int bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return err;
}

// One launch: `blocks` blocks along x (each looping over tiles blockIdx.x,
// + blocks, ...), a tile's K splits as one cluster (1, 1, splits).
template <typename... Args, typename... Act>
cudaError_t launch(void (*kern)(Args...), std::atomic<uint64_t>& done,
                   int threads, int smem, int blocks, int splits,
                   cudaStream_t st, Act... args) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), smem,
                               done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int MT>
cudaError_t launch_gemv(const bf16* x, const int8_t* w, const float* scale,
                        bf16* y, int M, int N, int K, int sps, int splits,
                        int blocks, cudaStream_t st) {
  static std::atomic<uint64_t> done[2];
  const bool vec = N % 16 == 0;
  return launch(vec ? int8_gemv_kernel<MT, true> : int8_gemv_kernel<MT, false>,
                done[vec], kGvThreads, Gv<MT>::kSmem, blocks, splits, st, x,
                w, scale, y, M, N, K, sps, splits);
}

cudaError_t launch_wgmma(const bf16* x, const int8_t* w, const float* scale,
                         bf16* y, int M, int N, int K, int kps, int splits,
                         int blocks, cudaStream_t st) {
  static std::atomic<uint64_t> done[2];
  const bool vec = N % 16 == 0;
  CUtensorMap x_map, w_map = {};
  if (!tile_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, kWgBM,
                kWgBK) ||
      (vec && !tile_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, 1,
                        kWgBK, kWgBN)))
    return cudaErrorInvalidValue;
  return launch(vec ? int8_mm_wgmma_kernel<true>
                    : int8_mm_wgmma_kernel<false>,
                done[vec], kWgThreads, kWgSmem, blocks, splits, st, x_map,
                w_map, w, scale, y, M, N, K, kps, splits);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (x and y). For bf16, the host
// plan's instance `mt` (1 .. 6: the GEMV with mt m8 tiles of rows, M <= 8
// mt; 16: the wgmma instance), its K steps a split (16 rows a step for
// the GEMV, 64 for wgmma), the splits (1 .. 8) and the blocks along x (at
// most the tiles; all of them where K is split). Returns a cudaError_t
// (0 = ok).
int int8_matmul_launch(const void* x, const void* w, const void* scale,
                       void* y, int M, int N, int K, int dtype, int mt,
                       int steps_per_split, int splits, int blocks,
                       void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int8_t* wb = static_cast<const int8_t*>(w);
  if (dtype == 0) {
    const dim3 grid((N + kF32Cols - 1) / kF32Cols,
                    (M + kF32Rows - 1) / kF32Rows);
    int8_mm_f32_kernel<<<grid, kF32Cols, 0, st>>>(
        static_cast<const float*>(x), wb, sc, static_cast<float*>(y), M, N,
        K);
    return cudaGetLastError();
  }
  const bool wgmma = mt == 16;
  if (dtype != 1 || !(wgmma || (mt >= 1 && mt <= 6 && M <= 8 * mt)))
    return cudaErrorInvalidValue;
  const int step = wgmma ? kWgBK : kGvStep;
  const int cols = wgmma ? kWgBN : Gv<1>::kCols;
  const int tiles =
      (wgmma ? (M + kWgBM - 1) / kWgBM : 1) * ((N + cols - 1) / cols);
  const int nsteps = (K + step - 1) / step;
  // every split non-empty, K covered, every tile on some block, and one
  // tile a block where K is split
  if (splits < 1 || splits > kMaxSplits || steps_per_split < 1 ||
      (splits - 1) * steps_per_split >= nsteps ||
      splits * steps_per_split < nsteps || blocks < 1 || blocks > tiles ||
      (splits > 1 && blocks != tiles))
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const int sps = steps_per_split;
  switch (mt) {
    case 1:
      return launch_gemv<1>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    case 2:
      return launch_gemv<2>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    case 3:
      return launch_gemv<3>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    case 4:
      return launch_gemv<4>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    case 5:
      return launch_gemv<5>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    case 6:
      return launch_gemv<6>(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
    default:
      return launch_wgmma(xb, wb, sc, yb, M, N, K, sps, splits, blocks, st);
  }
}

}  // extern "C"
