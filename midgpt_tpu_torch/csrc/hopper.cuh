// Hopper (sm_90a) building blocks shared by the flash forward
// (flash.cu) and the fused backward routes (fused_attn.cu): 16-byte
// asynchronous copies into the 128-byte-swizzled tile layout that `wgmma`
// reads, the shared-memory matrix descriptors, and the warpgroup matrix
// products themselves (raw PTX, `wgmma.mma_async`, bf16 operands, f32 sums).
//
// The tile layout. A [rows, C] bf16 tile (C = 64 or 128) is stored as C / 64
// panels of [rows, 64]; a panel row is 128 bytes and its eight 16-byte
// chunks are XOR-swizzled with the row's low three bits (the
// Swizzle<3, 4, 3> pattern of CUTLASS's SW128 atoms: 8 rows x 128 bytes,
// 1024 bytes, 1024-byte aligned). The same tile serves as a K-major
// operand (the product's depth runs along C: Q K^T, dO V^T) and as an
// MN-major one (depth runs along the rows: P V, P^T dO, dS^T Q, dS K).
//
// Register fragments. The f32 accumulator of an m64nN product gives
// thread t of the warpgroup (warp w = t / 32, lane l) the rows 16 w + l / 4
// and 16 w + l / 4 + 8; for each 8-column block i it holds d[4 i + 0, 1]
// (first row, columns 8 i + 2 (l % 4) + {0, 1}) and d[4 i + 2, 3] (second
// row, same columns). Packed to bf16 pairs, columns [16 k, 16 k + 16) of it
// are exactly the A-operand registers of an m64nNk16 product whose depth
// slice is k (the "RS" form): no shuffle moves P or dS between the two.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace hopper {

constexpr int kPanelBytes = 64 * 128;  // one [64, 64] bf16 panel

// Byte offset of 16-byte chunk `j` (of C / 8) of row `r` in a tile of
// `rows`-row panels.
__device__ __forceinline__ uint32_t sw128(int r, int j, int rows) {
  return static_cast<uint32_t>((j >> 3) * rows * 128 + r * 128 +
                               (((j & 7) ^ (r & 7)) << 4));
}

// Byte offset of the bf16 pair at (row r, even column c) in such a tile.
__device__ __forceinline__ uint32_t sw128_pair(int r, int c, int rows) {
  return sw128(r, c >> 3, rows) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory's base rounded up to 1024 bytes (the swizzle
// atom's alignment); launchers ask for 1024 bytes more than they use.
__device__ __forceinline__ uint32_t aligned_smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// Writes made by threads (cp.async, st.shared) become visible to the
// tensor cores' reads (the async proxy); a barrier must follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `rows` rows of C bf16 (row stride `stride` elements, 16-byte aligned
// rows) into the swizzled tile at `dst`, threads `tid` of `nthreads`.
template <int C>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int rows,
                                                int tid, int nthreads) {
  constexpr int kChunks = C / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, j = i % kChunks;
    cp_async16(dst + sw128(r, j, rows), src + r * stride + j * 8);
  }
}

// Matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr`: `lbo` and `sbo` in bytes (bits 16-29 and 32-45, in 16-byte
// units), layout type 1 (SW128) in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Depth slice kk (16 columns) of a 64-row tile read K-major: the slice
// starts 32 kk bytes into its panel (the hardware applies the swizzle to
// the address it forms); 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}

// Depth slice kk (16 rows) of a 64-row tile read MN-major: the slice starts
// 16 rows (2048 bytes) in; panels (64 columns of N) are `kPanelBytes`
// apart (LBO), 8-row groups along the depth 1024 bytes (SBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B read from shared memory
// through their descriptors; kTransA / kTransB pick MN-major operands.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the
// accumulator layout of a 64 x 16 slice, bf16 pairs), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (the
// accumulator layout of a 64 x 16 slice, bf16 pairs), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

// D[64 x N] (+)= A B over one depth slice, N = 64 or 128 by the array's size.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  wgmma_rs_n64<kTransB>(d, a, db, accumulate);
}
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  wgmma_rs_n128<kTransB>(d, a, db, accumulate);
}

}  // namespace hopper
