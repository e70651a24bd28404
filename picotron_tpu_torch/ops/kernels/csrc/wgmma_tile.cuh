// Warpgroup tensor-core building blocks (sm_90a): 64-row tiles in shared
// memory under the 128-byte swizzle, cp.async copies into them, wgmma
// matrix descriptors, and the bf16 wgmma.mma_async m64n64k16 product with
// fp32 accumulators, its B operand from shared memory and its A operand
// from shared memory or from registers; and m64n128k16 with both operands
// from shared memory, B MN-major.
//
// Tiles. A tile holds 64 rows of D bf16 as D / 64 blocks of [64 rows][64
// columns] (8 KB each, 1024-byte aligned). Row r of a block is 128 bytes;
// its 16-byte chunk c lives at chunk c ^ (r % 8): the 128-byte swizzle
// (byte address bits 4-6 XOR bits 7-9), which the hardware undoes when
// wgmma reads through a descriptor with layout type 1. One such tile is
// read as a K-major operand (contraction along the row: Q and K in
// S = Q K^T) or as an MN-major one (contraction down the rows: V in P V),
// so no tile is ever transposed.
//
// Registers. The accumulator of an m64nN product is laid out per warp w of
// the warpgroup as mma.sync's 16x8 C fragments side by side: with lane l,
// g = l / 4 and c = 2 (l % 4), d[n][0..1] are row 16 w + g, columns 8 n + c
// and + 1, d[n][2..3] row 16 w + g + 8. An A operand in registers is, per
// warp, mma.sync's 16x16 A fragment. So c_to_a turns two neighbouring
// accumulator tiles (16 columns), rounded to bf16, into the A operand of a
// product whose contraction runs over those 16 columns: the scores feed the
// next product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace picotron {
namespace wg {

constexpr int kRows = 64;              // rows of a tile: one m64 operand
constexpr int kBlockBytes = 64 * 128;  // one swizzled [64][64] bf16 block
constexpr int kThreads = 128;          // one warpgroup

template <int D>
constexpr int tile_bytes() {
  return (D / 64) * kBlockBytes;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (the swizzle's repeat).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const unsigned a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes global -> shared, zeros for src_bytes 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are in flight, then make this
// thread's landed copies visible to wgmma (the async proxy); a barrier
// must follow before another thread's wgmma reads them
template <int N>
__device__ __forceinline__ void cp_async_wait_for_wgmma() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + 64) of one head of a [.., S, heads, D] bf16 tensor into a
// swizzled tile; rows at or past S become zeros and are not read. ``src``
// points at row 0 of the head, ``stride`` is the elements between rows.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t stride, int r0, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* g =
        ok ? src + static_cast<size_t>(r0 + r) * stride + ch * 8 : src;
    cp_async16(dst + (ch >> 3) * kBlockBytes + r * 128 +
                   (((ch & 7) ^ (r & 7)) << 4),
               g, ok ? 16 : 0);
  }
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each in 16-byte units).
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

// A tile's 64 rows x the 16 columns [16 kk, 16 kk + 16), K-major: the
// contraction runs along the row. Eight-row groups are 1024 bytes apart;
// the leading offset is unused under this swizzle.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  return desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}

// A tile's rows [16 kk, 16 kk + 16) x the 64 columns of block nb,
// MN-major: the contraction runs down the rows (eight-row groups 1024
// bytes apart), the N side along them (64-column blocks 8 KB apart).
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk, int nb) {
  return desc(tile + nb * kBlockBytes + kk * 16 * 128, kBlockBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties an accumulator's registers to this point of the program, so the
// compiler neither reads them before a wgmma_wait nor writes them while a
// product that uses them is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// d (+)= A B, m64n64k16: A and B K-major from shared memory. accumulate 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n64k16: A from registers, B MN-major from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A B, m64n128k16: A K-major and B MN-major from shared memory (B
// a tile's 16 rows kk x two 64-column blocks, desc_mn).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// two fp32 -> one bf16x2 register (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand over columns [16 j, 16 j + 16) of an accumulator: its
// tiles 2 j and 2 j + 1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace wg
}  // namespace picotron
