// Kernel G: int8-weight matmul with a per-output-channel scale epilogue,
// written by hand for Hopper (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/quant_matmul.py::_quant_matmul_kernel
// (:130), reached through quant_matmul_pallas (:153). Same function:
// out[M, N] = (x[M, K] @ q[K, N]) * s[N], x bf16, q int8 (|q| <= 127), s
// fp32 per output channel. The products accumulate in fp32; the scale
// lands once on the fp32 accumulator in the epilogue, then the result
// rounds to bf16. Per-channel scales commute with the contraction, so the
// epilogue multiply IS the dequantization: no dequantized weight exists,
// in device memory or in shared memory. The int8 tile is copied to shared
// memory as stored and each pair of int8 values becomes a bf16 pair in
// registers right before the tensor-core product (lossless: every int8
// value is a bf16 value).
//
// What bounds it on this card: at decode (M = 8 slots) bytes -- the int8
// weight, K * N bytes, is read once per call for 2 * M FLOPs per byte,
// far below the H100's ~295 FLOP/byte balance point; at the prefill
// shapes (M = 512) operations. This first kernel reads the weight once
// per N tile with cp.async and a multi-stage shared-memory ring, and runs
// the products on mma.sync m16n8k16 (bf16 in, fp32 accumulate), not
// wgmma: TMA, wgmma and a split-K GEMV for M = 8 are later work.
//
// Design: one block per (BM-row, BN-column) output tile, 4 warps. Two
// shapes of block, picked by M on the host:
//   - wide (M > 16): 64 x 128 tiles, BK = 32, warps 2 x 2 over the tile,
//     each warp 32 x 64 (2 x 8 mma tiles);
//   - narrow (M <= 16, decode and the last-token head): 16 x 32 tiles,
//     BK = 128, the 4 warps split each K step four ways and their fp32
//     partial sums are added in a fixed order through shared memory, so
//     N = 4096 still spreads over 128 blocks.
// Nothing assumes a tile divides K, N or M (11008 = 43 x 256): loads past
// an edge fill zeros, stores past an edge are skipped. Rows of x and q
// are copied 16 bytes at a time when K % 8 == 0 and N % 16 == 0 (the
// model's shapes), element by element otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM_, int BN_, int BK_, int WM_, int WN_, int WK_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_, WK = WK_, STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * WK * 32;
  static constexpr int kWarpM = BM / WM;  // output rows per warp
  static constexpr int kWarpN = BN / WN;  // output columns per warp
  static constexpr int kWarpK = BK / WK;  // contraction per warp per stage
  static constexpr int kMT = kWarpM / 16;  // mma tiles along M
  static constexpr int kNT = kWarpN / 8;   // mma tiles along N
  static constexpr int kAStride = BK + 8;  // bf16 per shared row of x
  static constexpr int kBStride = BN + 16;  // bytes per shared row of q
  static constexpr int kABytes = BM * kAStride * 2;
  static constexpr int kBBytes = BK * kBStride;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRedBytes = WK > 1 ? WK * BM * BN * 4 : 0;
  static constexpr int kSmem = STAGES * kStageBytes + kRedBytes;
  static_assert(kWarpM % 16 == 0 && kWarpN % 8 == 0 && kWarpK % 16 == 0,
                "warp tiles are whole mma tiles");
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0 && BN % 16 == 0 &&
                    BK % 8 == 0,
                "16-byte copies");
};

using Wide = Cfg<64, 128, 32, 2, 2, 1, 3>;
using Narrow = Cfg<16, 32, 128, 1, 1, 4, 4>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two int8 weights (lower k first) -> one bf16x2 register, exactly
__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `kt` of x (rows m0.., columns kt * BK..) and of q (rows kt * BK..,
// columns n0..) into one ring slot.
template <class C>
__device__ __forceinline__ void load_stage(
    unsigned char* slot, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ q, int M, int N, int K, int m0, int n0,
    int kt, bool vec_a, bool vec_b) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(slot);
  int8_t* Bs = reinterpret_cast<int8_t*>(slot + C::kABytes);
  const int k0 = kt * C::BK;
  constexpr int kAChunks = C::BK / 8;  // 16-byte chunks per row of x
  for (int c = threadIdx.x; c < C::BM * kAChunks; c += C::kThreads) {
    const int r = c / kAChunks, kc = (c % kAChunks) * 8;
    const int gm = m0 + r, gk = k0 + kc;
    __nv_bfloat16* dst = As + r * C::kAStride + kc;
    if (vec_a) {  // K % 8 == 0: a chunk is wholly inside or outside
      const bool in = gm < M && gk < K;
      cp_async16(dst, in ? x + static_cast<size_t>(gm) * K + gk : x,
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = gm < M && gk + i < K
                     ? x[static_cast<size_t>(gm) * K + gk + i]
                     : __float2bfloat16(0.f);
    }
  }
  constexpr int kBChunks = C::BN / 16;  // 16-byte chunks per row of q
  for (int c = threadIdx.x; c < C::BK * kBChunks; c += C::kThreads) {
    const int r = c / kBChunks, nc = (c % kBChunks) * 16;
    const int gk = k0 + r, gn = n0 + nc;
    int8_t* dst = Bs + r * C::kBStride + nc;
    if (vec_b) {  // N % 16 == 0
      const bool in = gk < K && gn < N;
      cp_async16(dst, in ? q + static_cast<size_t>(gk) * N + gn : q,
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = gk < K && gn + i < N
                     ? q[static_cast<size_t>(gk) * N + gn + i]
                     : static_cast<int8_t>(0);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ s,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K,
                    int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * C::BN;
  const int m0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp / (C::WM * C::WN);
  const int wm = (warp % (C::WM * C::WN)) / C::WN;
  const int wn = warp % C::WN;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates

  float acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + C::BK - 1) / C::BK;
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nk)
      load_stage<C>(smem + st * C::kStageBytes, x, q, M, N, K, m0, n0, st,
                    vec_a, vec_b);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // stage kt has landed (this thread)
    __syncthreads();                 // ... for every thread; and stage
                                     // kt - 1's slot is free again
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk)
      load_stage<C>(smem + (nxt % C::STAGES) * C::kStageBytes, x, q, M, N,
                    K, m0, n0, nxt, vec_a, vec_b);
    cp_async_commit();

    const unsigned char* slot = smem + (kt % C::STAGES) * C::kStageBytes;
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(slot);
    const int8_t* Bs = reinterpret_cast<const int8_t*>(slot + C::kABytes);
#pragma unroll
    for (int kk = wk * C::kWarpK; kk < (wk + 1) * C::kWarpK; kk += 16) {
      uint32_t a[C::kMT][4];
#pragma unroll
      for (int i = 0; i < C::kMT; ++i) {
        const __nv_bfloat16* p =
            As + (wm * C::kWarpM + i * 16 + g) * C::kAStride + kk + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * C::kAStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(p + 8 * C::kAStride + 8);
      }
#pragma unroll
      for (int j = 0; j < C::kNT; ++j) {
        const int8_t* p =
            Bs + (kk + 2 * t) * C::kBStride + wn * C::kWarpN + j * 8 + g;
        const uint32_t b0 = pack_i8(p[0], p[C::kBStride]);
        const uint32_t b1 = pack_i8(p[8 * C::kBStride], p[9 * C::kBStride]);
#pragma unroll
        for (int i = 0; i < C::kMT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: the per-channel scale on the fp32 sum, then bf16
  if constexpr (C::WK == 1) {
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wm * C::kWarpM + i * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn * C::kWarpN + j * 8 + 2 * t + (e & 1);
          if (r < M && c < N)
            out[static_cast<size_t>(r) * N + c] =
                __float2bfloat16(acc[i][j][e] * s[c]);
        }
  } else {
    float* red = reinterpret_cast<float*>(smem + C::STAGES * C::kStageBytes);
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wm * C::kWarpM + i * 16 + g + (e >> 1) * 8;
          const int c = wn * C::kWarpN + j * 8 + 2 * t + (e & 1);
          red[(wk * C::BM + r) * C::BN + c] = acc[i][j][e];
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < C::BM * C::BN; idx += C::kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < C::WK; ++w) sum += red[w * C::BM * C::BN + idx];
      const int r = m0 + idx / C::BN, c = n0 + idx % C::BN;
      if (r < M && c < N)
        out[static_cast<size_t>(r) * N + c] = __float2bfloat16(sum * s[c]);
    }
  }
}

template <class C>
int launch(const void* x, const void* q, const void* s, void* out, int M,
           int N, int K, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      quant_matmul_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_a = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_b = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  quant_matmul_kernel<C><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), M, N,
      K, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16; q: [K, N] int8; s: [N] fp32; out: [M, N] bf16; all
// contiguous on one device.
extern "C" int picotron_quant_matmul(const void* x, const void* q,
                                     const void* s, void* out, int M, int N,
                                     int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= Narrow::BM) return launch<Narrow>(x, q, s, out, M, N, K, st);
  return launch<Wide>(x, q, s, out, M, N, K, st);
}
