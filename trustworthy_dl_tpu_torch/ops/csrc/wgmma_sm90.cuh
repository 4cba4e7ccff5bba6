// Inline-PTX helpers for Hopper's warpgroup products (sm_90a only):
// shared-memory matrix descriptors of 128-byte-swizzled tiles, the
// wgmma fence / commit / wait, and the m64nNk16 bf16 products with f32
// accumulation that the non-causal flash backward (flash_attention.cu)
// runs.  Header-only and inline, as mma_sm90.cuh.
//
// The tiles: a [rows, D] bf16 row-major tile is kept as D / 64 column
// blocks of [rows, 64] (128 bytes a row, rows back to back); within a
// block, row r's 16-byte chunk c sits at chunk c ^ (r % 8) (the 128-byte
// swizzle; every block starts on a 1024-byte boundary, so the hardware's
// swizzle, which XORs address bits 4-6 with bits 7-9, matches it).
//   * Read K-major (the product's K dimension along D): 8-row groups are
//     1024 bytes apart (SBO); a k16 step is 32 bytes on within a block.
//   * Read MN-major (the product's N dimension along D, K along rows):
//     8-row K groups 1024 bytes apart (SBO), 64-column N blocks one block
//     apart (LBO); a k16 step is 16 rows (2048 bytes) on.
// Accumulators: warp w of the warpgroup holds rows 16 w + lane / 4 and
// + 8, as mma.sync's C tiles: d[j][0..1] at (row, 8 j + 2 (lane % 4)
// + {0, 1}), d[j][2..3] at row + 8, so a C tile pair rounded to bf16 pairs
// is the A-fragment of a register-A product, as in mma_sm90.cuh.

#pragma once

#include <stdint.h>

namespace wgmma_sm90 {

constexpr uint32_t SW128_ROW = 128;         // bytes a swizzled row
constexpr uint32_t SW128_GROUP = 1024;      // bytes of 8 swizzled rows

// Descriptor of a 128-byte-swizzled tile at shared address `addr`.
// Offsets in bytes (multiples of 16).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: k16 step kk of a tile of D / 64 column blocks, each
// `block` bytes, from the tile's first row of interest at `addr`.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int kk,
                                                uint32_t block) {
  return desc_sw128(addr + (kk >> 2) * block + (kk & 3) * 32, 16,
                    SW128_GROUP);
}

// MN-major operand: k16 step kk (rows 16 kk on from `addr`), N blocks
// `block` bytes apart.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int kk,
                                                 uint32_t block) {
  return desc_sw128(addr + kk * 16 * SW128_ROW, block, SW128_GROUP);
}

// Orders this thread's register writes (A-fragments, accumulators) before
// the warpgroup's next products.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N of this warp's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the compiler's reads of an accumulator after the wait that
// completes it (the products write it behind the compiler's back).
template <int J>
__device__ __forceinline__ void fence_regs(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async's
// and plain stores) visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[32 / 8][4] (+)= A . B, m64n32k16, A and B K-major in shared
// memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void ss_n32(float (&d)[4][4], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 / 8][4] (+)= A . B, m64n64k16, A and B K-major in shared
// memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void ss_n64(float (&d)[8][4], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 / 8][4] (+)= A . B, m64n64k16: A from registers (a, the
// mma.sync m16n8k16 A-fragment of this warp's 16 of the 64 rows), B
// MN-major in shared memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void rs_n64(float (&d)[8][4],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d[128 / 8][4] (+)= A . B, m64n128k16: A from registers (a, the
// mma.sync m16n8k16 A-fragment of this warp's 16 of the 64 rows), B
// MN-major in shared memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void rs_n128(float (&d)[16][4],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

}  // namespace wgmma_sm90
