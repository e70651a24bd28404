// Kernel G: int8-weight matmul with a per-output-channel scale epilogue,
// written by hand for Hopper (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/quant_matmul.py::_quant_matmul_kernel
// (:130), reached through quant_matmul_pallas (:153). Same function:
// out[M, N] = bf16((x[M, K] @ q[K, N]) * s[N]), x bf16, q int8 (|q| <= 127,
// the JAX layout), s fp32 per output channel. The products accumulate in
// fp32; the scale lands once on the fp32 sum, then the result rounds to
// bf16. Per-channel scales commute with the contraction, so the epilogue
// multiply IS the dequantization: no dequantized weight exists in device
// memory. Every int8 value is a bf16 value, so the weights reach the
// tensor cores exactly, converted in registers or in shared memory.
//
// The conversion, without the conversion units. A byte b = l - 128 s (l
// its low 7 bits, s its sign bit) is the difference of two bf16 values
// made by masks alone: 0x4300 | l = 128 + l and 0x4300 | s << 7 = 128 *
// 2^s. One lop3 per mask does two bytes of a word at once (bits 0-7 and
// 16-23), one packed bf16 subtraction gives both values exactly, and a
// shift brings bytes 1 and 3 down: per four weights 4 lop3, a shift and
// 2 sub.bf16x2, plus one prmt that gathers the bytes an mma register pairs
// (or puts a row's bytes in order), where an int-to-float and a
// float-to-bf16 conversion a weight would run at a fraction of the rate.
//
// Two kernels, picked per call by the wrapper's plan (a function of M, K
// and N alone):
//
// splitk (M <= 16: decode, the last-token head). What bounds it: bytes --
//   the weight, K * N bytes, is read once for 2 * M FLOPs a byte. The
//   weights are the 16-row operand of mma.sync m16n8k16 and the <= 8
//   tokens the n = 8 side (out^T = q^T x^T; M <= 16 takes two n8 tiles),
//   so no half of a tile is padding. A warp's step is a slab of 16 rows
//   of q by 128 columns: lane (g, t) loads 16 bytes of each of the rows
//   4t .. 4t + 3 at columns 16g .. 16g + 15, straight from device memory
//   into registers (a 128-byte segment per row and load), the next two
//   slabs' loads in flight while this one converts and multiplies. The
//   contraction order inside a slab is free as long as both operands
//   agree: kcols 2t, 2t + 1, 2t + 8, 2t + 9 of the m16n8k16 tile are the
//   rows 4t .. 4t + 3, so a lane's x fragment is 4 consecutive bf16 of one
//   token. A block is 8 warps on 128 columns, the warps taking slabs in
//   turn. What sets the pace on the card is how evenly the blocks share
//   the SMs, so the plan splits K over 1 to 8 blocks a column tile to give
//   the grid about two blocks an SM. The 8 warps' sums meet in shared
//   memory in a fixed order; the splits' through a workspace, added in
//   split order by the last block of the tile to finish (an int32 counter
//   the wrapper keeps at zero, as kernel C's merge does): no float atomics,
//   the same bits every call.
//
// wgmma (M > 16: prefill chunks). What bounds it: operations at M = 512,
//   once the tiles arrive fast enough. 128 x 128 output tiles, BK = 64,
//   two warpgroups of 64 rows each running wgmma m64n128k16 with fp32
//   accumulators, two blocks an SM. x tiles are the K-major A operand in
//   128-byte-swizzled blocks, q tiles land as stored (int8), three stages
//   deep, both brought by TMA (one thread, an mbarrier a stage: cp.async
//   copies of the same tiles, every thread issuing its share, could not
//   keep the tensor cores fed) where the shapes allow a tensor map (K % 8
//   == 0, N % 16 == 0), by cp.async otherwise. Every thread converts its share of a staged q tile into a
//   swizzled bf16 block, read MN-major by descriptor as B, while the
//   previous tile's products run on the tensor cores. Rows past M, columns
//   past N and contraction past K are zeros; stores past an edge are
//   skipped.
//
// Rows of x and q are copied 16 bytes at a time where the shapes and
// pointers allow it (K % 8 == 0, N % 16 == 0 on the model's shapes), element
// by element otherwise.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using picotron::wg::kBlockBytes;

// ---------------------------------------------------------------- convert

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// bf16x2 a - b, exact where the difference is a bf16 value
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bytes 0 and 2 of w (int8) -> one bf16x2 (byte 0 in the low half), and
// bytes 1 and 3 -> another, exactly: with l a byte's low 7 bits and s its
// sign bit, 0x4300 | l is the bf16 128 + l and 0x4300 | s << 7 the bf16
// 128 * 2^s, and their difference l - 128 s is the byte's value
__device__ __forceinline__ void i8x4_bf16x2(uint32_t w, uint32_t& p02,
                                            uint32_t& p13) {
  const uint32_t w8 = w >> 8;
  p02 = sub_bf16x2((w & 0x007F007Fu) | 0x43004300u,
                   (w & 0x00800080u) | 0x43004300u);
  p13 = sub_bf16x2((w8 & 0x007F007Fu) | 0x43004300u,
                   (w8 & 0x00800080u) | 0x43004300u);
}

// 8 int8 (lowest byte first) -> 8 bf16 (16 bytes), exactly: each word's
// bytes reordered 0, 2, 1, 3 first, so the pairs come out in order
__device__ __forceinline__ uint4 int8x8_bf16(uint2 v) {
  uint4 o;
  i8x4_bf16x2(prmt(v.x, 0, 0x3120u), o.x, o.y);
  i8x4_bf16x2(prmt(v.y, 0, 0x3120u), o.z, o.w);
  return o;
}

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------------------- splitk

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSplitBN = 128;  // columns of a block
constexpr int kMaxSplits = 8;  // blocks that split one column tile's K

// One lane's share of a slab: 16 bytes of each of its four rows, and its
// tokens' four bf16 of x (per n8 tile).
template <int MT>
struct Slab {
  uint4 q[4];
  uint2 x[MT];
};

template <int MT>
__device__ __forceinline__ void load_slab(Slab<MT>& sl,
                                          const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ q, int M,
                                          int N, int K, int slab, int n,
                                          int g, int t, bool vec_q,
                                          bool vec_x) {
  const int k = slab * 16 + 4 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k + i;
    if (vec_q) {
      sl.q[i] = kr < K && n < N
                    ? ld_stream(q + static_cast<size_t>(kr) * N + n)
                    : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (kr < K)
        for (int j = 0; j < 16; ++j)
          if (n + j < N)
            w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             q[static_cast<size_t>(kr) * N + n + j]))
                         << (8 * (j & 3));
      sl.q[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = g + 8 * mt;
    const __nv_bfloat16* xr = x + static_cast<size_t>(m) * K + k;
    if (m >= M) {
      sl.x[mt] = make_uint2(0, 0);
    } else if (vec_x) {
      sl.x[mt] = k < K ? __ldg(reinterpret_cast<const uint2*>(xr))
                       : make_uint2(0, 0);
    } else {
      uint16_t h[4];
      for (int j = 0; j < 4; ++j)
        h[j] = k + j < K ? __bfloat16_as_ushort(xr[j]) : uint16_t{0};
      sl.x[mt] = make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                            h[2] | (static_cast<uint32_t>(h[3]) << 16));
    }
  }
}

// the eight m16n8k16 products of a slab: tile j's rows g and g + 8 are
// columns 16g + 2j and 16g + 2j + 1, i.e. bytes 2j and 2j + 1 of each row
template <int MT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][8][4],
                                         const Slab<MT>& sl) {
  const uint32_t* r0 = &sl.q[0].x;
  const uint32_t* r1 = &sl.q[1].x;
  const uint32_t* r2 = &sl.q[2].x;
  const uint32_t* r3 = &sl.q[3].x;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    // tile h of this word: columns 4w + 2h and 4w + 2h + 1; rows 0 and 1
    // (kcols 2t, 2t + 1) gathered into one word, rows 2 and 3 into another
    uint32_t a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sel = h ? 0x7632u : 0x5410u;
      i8x4_bf16x2(prmt(r0[w], r1[w], sel), a[h][0], a[h][1]);
      i8x4_bf16x2(prmt(r2[w], r3[w], sel), a[h][2], a[h][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(acc[mt][2 * w + h], a[h], sl.x[mt].x, sl.x[mt].y);
  }
}

// ws: the splits' partial sums, [column tiles, splits, 32 * 32 * MT] fp32;
// counters: one int32 a column tile, zero before and after the launch.
template <int MT>
__global__ void __launch_bounds__(kSplitThreads)
    quant_matmul_splitk(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters,
                        int M, int N, int K, int vec_q, int vec_x) {
  constexpr int kRedWarp = 32 * (32 * MT + 4);  // floats a parked warp
  __shared__ __align__(16) float red[kSplitWarps / 2][kRedWarp];
  __shared__ __align__(16) float part[32 * 32 * MT];
  __shared__ int last;

  const int C = gridDim.y;  // splits of K
  const int c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kSplitBN;
  const int n = n0 + 16 * g;
  const int n_slabs = (K + 15) / 16;
  const int sl_begin = static_cast<int>(static_cast<long long>(n_slabs) * c / C);
  const int sl_end =
      static_cast<int>(static_cast<long long>(n_slabs) * (c + 1) / C);

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // the warp's slabs s, s + 8, s + 16, ... in order, two loads in flight
  // behind the one being multiplied (three register buffers in turn)
  constexpr int W = kSplitWarps;
  Slab<MT> b0, b1, b2;
  int sl = sl_begin + warp;
  if (sl < sl_end) load_slab<MT>(b0, x, q, M, N, K, sl, n, g, t, vec_q, vec_x);
  if (sl + W < sl_end)
    load_slab<MT>(b1, x, q, M, N, K, sl + W, n, g, t, vec_q, vec_x);
  for (; sl < sl_end; sl += 3 * W) {
    if (sl + 2 * W < sl_end)
      load_slab<MT>(b2, x, q, M, N, K, sl + 2 * W, n, g, t, vec_q, vec_x);
    mma_slab<MT>(acc, b0);
    if (sl + W >= sl_end) break;
    if (sl + 3 * W < sl_end)
      load_slab<MT>(b0, x, q, M, N, K, sl + 3 * W, n, g, t, vec_q, vec_x);
    mma_slab<MT>(acc, b1);
    if (sl + 2 * W >= sl_end) break;
    if (sl + 4 * W < sl_end)
      load_slab<MT>(b1, x, q, M, N, K, sl + 4 * W, n, g, t, vec_q, vec_x);
    mma_slab<MT>(acc, b2);
  }

  // the 8 warps' sums, each lane's accumulators side by side (a lane's
  // 32 * MT floats padded to a 16-byte multiple + 16 bytes, so that 16-byte
  // stores of a quarter warp hit 8 bank groups): warps 4-7 park theirs,
  // warps 0-3 add their own (w + (w + 4)), then the four in order
  constexpr int kAcc = 32 * MT;
  float* mine = &red[0][0] + (warp % (kSplitWarps / 2)) * kRedWarp +
                lane * (kAcc + 4);
  if (warp >= kSplitWarps / 2) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(mine + 32 * mt + 4 * j) =
            make_float4(acc[mt][j][0], acc[mt][j][1], acc[mt][j][2],
                        acc[mt][j][3]);
  }
  __syncthreads();
  if (warp < kSplitWarps / 2) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float4* p = reinterpret_cast<float4*>(mine + 32 * mt + 4 * j);
        const float4 o = *p;
        *p = make_float4(__fadd_rn(acc[mt][j][0], o.x),
                         __fadd_rn(acc[mt][j][1], o.y),
                         __fadd_rn(acc[mt][j][2], o.z),
                         __fadd_rn(acc[mt][j][3], o.w));
      }
  }
  __syncthreads();
  // part: the block's sum in the same layout (lane l, accumulator a)
  for (int i = threadIdx.x; i < 32 * kAcc; i += kSplitThreads) {
    const float* r = &red[0][0] + (i / kAcc) * (kAcc + 4) + i % kAcc;
    part[i] = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[kRedWarp]),
                                  r[2 * kRedWarp]),
                        r[3 * kRedWarp]);
  }

  // one split: the block's sum is the tile's. Else the block's partial
  // sum goes to ws; the last block of the tile to count itself (an int32
  // atomic, after the barrier and one thread's fence, as a grid-wide sync
  // does) adds the splits' partials in split order and resets the counter
  float* tile_ws = ws + static_cast<size_t>(blockIdx.x) * C * (32 * kAcc);
  if (C > 1) {
    for (int i = threadIdx.x; i < 32 * kAcc; i += kSplitThreads)
      tile_ws[static_cast<size_t>(c) * (32 * kAcc) + i] = part[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(&counters[blockIdx.x], 1) == C - 1;
      if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
  }
  for (int i = threadIdx.x; i < 32 * kAcc; i += kSplitThreads) {
    float sum = part[i];
    if (C > 1) {
      sum = 0.f;
      for (int r = 0; r < C; ++r)
        sum = __fadd_rn(sum, __ldcg(tile_ws + static_cast<size_t>(r) *
                                                  (32 * kAcc) + i));
    }
    // accumulator e of tile j of lane (g, t): D row g (+ 8 for e >= 2) is
    // column 16g + 2j (+ 1), D column 2t + e % 2 the token
    const int ln = i / kAcc, a = i % kAcc;
    const int jj = (a % 32) / 4, e = a % 4;
    const int m = 8 * (a / 32) + 2 * (ln & 3) + (e & 1);
    const int col = n0 + 16 * (ln >> 2) + 2 * jj + (e >> 1);
    if (m < M && col < N)
      out[static_cast<size_t>(m) * N + col] =
          __float2bfloat16_rn(__fmul_rn(sum, s[col]));
  }
  if (C > 1 && threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// ------------------------------------------------------------------ wgmma

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kBK * 2;     // two swizzled 64-row blocks
constexpr int kRawBytes = kBK * kBN;       // the int8 tile as stored
constexpr int kStageBytes = kXBytes + kRawBytes;
constexpr int kQBytes = (kBN / 64) * kBlockBytes;  // the bf16 q tile
constexpr int kBarBytes = kStages * 8;
constexpr int kWgSmem = kStages * kStageBytes + 2 * kQBytes + kBarBytes + 1024;
static_assert(kStageBytes % 1024 == 0 && kQBytes % 1024 == 0,
              "tiles stay 1024-byte aligned");

// Stage kt of x (rows m0.., columns kt * BK..) and of q (rows kt * BK..,
// columns n0..) into a ring slot, by cp.async (shapes and pointers that a
// tensor map does not take).
__device__ __forceinline__ void wg_load_stage(
    unsigned char* st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, int M, int N, int K, int m0, int n0, int kt,
    bool vec_x, bool vec_q) {
  const int k0 = kt * kBK;
  // x: 128 rows x 8 chunks of 8 bf16, row r in block r / 64
  for (int idx = threadIdx.x; idx < kBM * (kBK / 8); idx += kWgThreads) {
    const int r = idx / (kBK / 8), ch = idx % (kBK / 8);
    unsigned char* dst = st + (r >> 6) * kBlockBytes + (r & 63) * 128 +
                         ((ch ^ (r & 7)) << 4);
    const int gm = m0 + r, gk = k0 + 8 * ch;
    if (vec_x) {
      const bool ok = gm < M && gk < K;
      picotron::wg::cp_async16(
          dst, ok ? x + static_cast<size_t>(gm) * K + gk : x, ok ? 16 : 0);
    } else {
      uint16_t h[8];
      for (int j = 0; j < 8; ++j)
        h[j] = gm < M && gk + j < K
                   ? __bfloat16_as_ushort(x[static_cast<size_t>(gm) * K + gk + j])
                   : uint16_t{0};
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                     h[2] | (static_cast<uint32_t>(h[3]) << 16),
                     h[4] | (static_cast<uint32_t>(h[5]) << 16),
                     h[6] | (static_cast<uint32_t>(h[7]) << 16));
    }
  }
  // q: 64 rows of BN bytes, as stored
  int8_t* raw = reinterpret_cast<int8_t*>(st + kXBytes);
  for (int idx = threadIdx.x; idx < kBK * (kBN / 16); idx += kWgThreads) {
    const int r = idx / (kBN / 16), c16 = (idx % (kBN / 16)) * 16;
    int8_t* dst = raw + r * kBN + c16;
    const int gk = k0 + r, gn = n0 + c16;
    if (vec_q) {
      const bool ok = gk < K && gn < N;
      picotron::wg::cp_async16(
          dst, ok ? q + static_cast<size_t>(gk) * N + gn : q, ok ? 16 : 0);
    } else {
      for (int j = 0; j < 16; ++j)
        dst[j] = gk < K && gn + j < N ? q[static_cast<size_t>(gk) * N + gn + j]
                                      : static_cast<int8_t>(0);
    }
  }
}

// the staged int8 tile of a stage -> the swizzled bf16 tile qb: row k of
// block nb holds columns 64 nb .. 64 nb + 63
__device__ __forceinline__ void wg_convert(const unsigned char* st,
                                           unsigned char* qb) {
  const unsigned char* raw = st + kXBytes;
  constexpr int kUnits = kBK * kBN / 8;
#pragma unroll
  for (int i = 0; i < kUnits / kWgThreads; ++i) {
    const int u = threadIdx.x + i * kWgThreads;
    const int r = u / (kBN / 8), c8 = u % (kBN / 8);
    const uint4 v = int8x8_bf16(
        *reinterpret_cast<const uint2*>(raw + r * kBN + 8 * c8));
    *reinterpret_cast<uint4*>(qb + (c8 >> 3) * kBlockBytes + r * 128 +
                              (((c8 & 7) ^ (r & 7)) << 4)) = v;
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// a box of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// Stage kt by TMA: x's box (64 columns x 128 rows, 128-byte swizzle) and
// q's (128 columns x 64 rows, as stored); out-of-range elements land as
// zeros. One thread issues both.
__device__ __forceinline__ void wg_tma_stage(unsigned char* st, uint64_t* bar,
                                             const CUtensorMap* tx,
                                             const CUtensorMap* tq, int m0,
                                             int n0, int kt) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(kStageBytes)
      : "memory");
  tma_2d(st, tx, kt * kBK, m0, bar);
  tma_2d(st + kXBytes, tq, n0, kt * kBK, bar);
}

// kTma: the tiles come by TMA through tx and tq (K % 8 == 0, N % 16 == 0,
// 16-byte aligned x and q); else by cp.async from x and q.
template <bool kTma>
__global__ void __launch_bounds__(kWgThreads, 2)
    quant_matmul_wgmma(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tq,
                       const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ out, int M, int N, int K,
                       int vec_x, int vec_q) {
  namespace wg = picotron::wg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align1024(smem_raw);
  unsigned char* qbuf = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(qbuf + 2 * kQBytes);
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wgi = threadIdx.x >> 7;  // this thread's warpgroup
  const int nk = (K + kBK - 1) / kBK;

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < kStages; ++st)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_u32(&full[st]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int st = 0; st < kStages - 1 && st < nk; ++st)
        wg_tma_stage(smem + st * kStageBytes, &full[st], &tx, &tq, m0, n0, st);
    }
    __syncthreads();
    bar_wait(&full[0], 0);
  } else {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk)
        wg_load_stage(smem + st * kStageBytes, x, q, M, N, K, m0, n0, st,
                      vec_x, vec_q);
      wg::cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
  }
  wg_convert(smem, qbuf);
  fence_proxy_async();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const unsigned char* xt =
        smem + (kt % kStages) * kStageBytes + wgi * kBlockBytes;
    const unsigned char* qt = qbuf + (kt & 1) * kQBytes;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wg::wgmma_ss_n128(acc, wg::desc_k(xt, kk), wg::desc_mn(qt, kk, 0), 1);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // this warpgroup's products of tile kt - 1 are done
    wg::fence_regs(acc);
    __syncthreads();  // ... and the other's: tile kt - 1's buffers are free
    const int nxt = kt + kStages - 1;
    if constexpr (kTma) {
      if (threadIdx.x == 0 && nxt < nk) {
        fence_proxy_async();  // the slot's reads come before its refill
        wg_tma_stage(smem + (nxt % kStages) * kStageBytes,
                     &full[nxt % kStages], &tx, &tq, m0, n0, nxt);
      }
    } else {
      if (nxt < nk)
        wg_load_stage(smem + (nxt % kStages) * kStageBytes, x, q, M, N, K,
                      m0, n0, nxt, vec_x, vec_q);
      wg::cp_async_commit();
    }
    if (kt + 1 < nk) {
      if constexpr (kTma) {
        bar_wait(&full[(kt + 1) % kStages], ((kt + 1) / kStages) & 1);
      } else {
        cp_async_wait<kStages - 2>();  // tile kt + 1 has landed (here)
        __syncthreads();               // ... for every thread
      }
      wg_convert(smem + ((kt + 1) % kStages) * kStageBytes,
                 qbuf + ((kt + 1) & 1) * kQBytes);
      fence_proxy_async();  // the stores (and copies), to wgmma
      __syncthreads();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);

  // epilogue: the per-channel scale on the fp32 sum, then bf16
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = m0 + 64 * wgi + 16 * w + (lane >> 2);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= N) continue;
    const float s0 = __ldg(s + col);
    const float s1 = col + 1 < N ? __ldg(s + col + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      __nv_bfloat16* o = out + static_cast<size_t>(row) * N + col;
      const __nv_bfloat16 v0 = __float2bfloat16_rn(__fmul_rn(acc[j][2 * h], s0));
      const __nv_bfloat16 v1 =
          __float2bfloat16_rn(__fmul_rn(acc[j][2 * h + 1], s1));
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(v0, v1);
      } else {
        o[0] = v0;
        if (col + 1 < N) o[1] = v1;
      }
    }
  }
}

// -------------------------------------------------------------- launches

template <int MT>
int launch_splitk(const void* x, const void* q, const void* s, void* out,
                  void* ws, void* counters, int M, int N, int K, int splits,
                  cudaStream_t st) {
  const int vec_q = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const dim3 grid((N + kSplitBN - 1) / kSplitBN, splits);
  quant_matmul_splitk<MT><<<grid, kSplitThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, vec_q,
      vec_x);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's dynamic shared memory above 48 KB, granted once per device
// (not per launch).
template <typename Kernel>
cudaError_t smem_once(Kernel kernel, int bytes, bool (&granted)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) granted[dev] = true;
  return e;
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

int launch_wgmma(const void* x, const void* q, const void* s, void* out,
                 int M, int N, int K, cudaStream_t st) {
  const bool tma = K % 8 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  CUtensorMap tx{}, tq{};
  if (tma) {
    PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint32_t unit[2] = {1, 1};
    const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
    const cuuint64_t xs[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t xb[2] = {kBK, kBM};
    const cuuint64_t qd[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
    const cuuint64_t qs[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t qb[2] = {kBN, kBK};
    if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
               xd, xs, xb, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
        encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), qd,
               qs, qb, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool granted[2][64] = {};
  cudaError_t e = tma ? smem_once(quant_matmul_wgmma<true>, kWgSmem, granted[1])
                      : smem_once(quant_matmul_wgmma<false>, kWgSmem,
                                  granted[0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_q = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (tma)
    quant_matmul_wgmma<true><<<grid, kWgThreads, kWgSmem, st>>>(
        tx, tq, xp, qp, sp, op, M, N, K, vec_x, vec_q);
  else
    quant_matmul_wgmma<false><<<grid, kWgThreads, kWgSmem, st>>>(
        tx, tq, xp, qp, sp, op, M, N, K, vec_x, vec_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16; q: [K, N] int8; s: [N] fp32; out: [M, N] bf16; all
// contiguous on one device. variant (the wrapper's plan): 0 splitk (M <=
// 16; splits 1 to 8 blocks split K; with more than one, ws holds [ceil(N /
// 128), splits, 1024 * ceil(M / 8)] fp32 partials and counters
// ceil(N / 128) int32 zeros, left zero), 1 wgmma (ws and counters unused).
extern "C" int picotron_quant_matmul(const void* x, const void* q,
                                     const void* s, void* out, void* ws,
                                     void* counters, int M, int N, int K,
                                     int variant, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if (M > 16 || splits < 1 || splits > kMaxSplits)
        return static_cast<int>(cudaErrorInvalidValue);
      return M <= 8 ? launch_splitk<1>(x, q, s, out, ws, counters, M, N, K,
                                       splits, st)
                    : launch_splitk<2>(x, q, s, out, ws, counters, M, N, K,
                                       splits, st);
    case 1:
      return launch_wgmma(x, q, s, out, M, N, K, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
