// Kernel E: dQ of the causal flash attention, and delta, written by hand
// for Hopper (sm_90a), its products on the bf16 tensor cores.
//
// Replaces picotron_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (:223), reached through _bwd (:295). Same function: with P re-derived
// from the forward's log-sum-exp as p = exp(q.k * scale - lse) (0 above the
// diagonal), dP = dO . V and delta = rowsum(dO * O) (fp32),
//
//   dS = P * (dP - delta) * scale,  dQ = bf16(dS) @ K,
//
// bf16 . bf16 products summed in fp32, dS rounded to bf16 before the dQ
// product (the Pallas body's rounding point, :233-248), fp32 accumulators,
// bf16 output: only the order of the fp32 sums differs. Kernel F (dK, dV)
// is flash_attention_bwd_dkv.cu and reads the delta this kernel writes.
//
// What bounds it on this card: operations, the three products over the
// causal half, 6 * D * H * S (S + 1) / 2 per batch entry; at the training
// shape [4, 2048, 32, 64] that is 103 GFLOP, 0.10 ms at 989 TFLOP/s.
//
// Design: one warpgroup (4 warps, 128 threads) per (batch, query head, 64
// query rows); the block's queries are the M side of every product
// (wgmma_tile.cuh has the tile and register layouts).
//   - The Q and dO tiles are copied to shared memory once, under the
//     128-byte swizzle; K and V tiles of 64 keys stream through a 2-stage
//     cp.async ring, tile j + 1 in flight while tile j is computed.
//   - S = Q K^T and dP = dO V^T are wgmma m64n64k16 products (both
//     operands K-major in shared memory) into fp32 registers.
//   - dS = exp(S * scale - lse) * (dP - delta) * scale is formed in those
//     registers, rounded to bf16 and handed over (c_to_a) as the register A
//     operand of dQ += dS K, whose B operand is the same K tile read
//     MN-major: nothing is transposed and no score touches shared memory.
//   - dQ accumulates in fp32 registers from key tile 0 up to the diagonal
//     and is written once, in bf16.
//   - delta = rowsum(dO * O) is computed in fp32 once per row at the
//     block's start and written to a [B, H, S] buffer, which F then reads:
//     F must run after E on the same stream.
//   - Only the diagonal tile is masked (it is also the ragged last key
//     tile, whose keys past S every row < S masks). The grid runs the
//     heaviest query tiles (the last, which walk every key tile) first.
//
// Same contract as B and F: D in {64, 128}, any S >= 1 (rows and keys past
// S load as zeros and are neither read nor written), compact GQA (kv head =
// h / (H / Hkv)), any B.

#include "wgmma_tile.cuh"

namespace {

using namespace picotron::wg;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // byte offsets from the 1024-aligned base
  static constexpr int kTile = tile_bytes<D>();  // 64 rows of one tensor
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kK = 2 * kTile;                 // [kStages] tiles
  static constexpr int kV = kK + kStages * kTile;      // [kStages] tiles
  static constexpr int kLse = kV + kStages * kTile;    // [64] fp32
  static constexpr int kDelta = kLse + kRows * 4;      // [64] fp32
  static constexpr int kBytes = kDelta + kRows * 4 + 1024;
};

// the fp32 dot product of 8 bf16 pairs, added to acc in order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc += u.x * w.x;
    acc += u.y * w.y;
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int B, int S, int H, int Hkv,
                    float scale) {
  using L = Layout<D>;
  constexpr int kNB = D / 64;  // 64-column blocks of the head dim
  constexpr int kDK = D / 16;  // 16-deep steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm + L::kDelta);

  const int nq = (S + kRows - 1) / kRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / (B * H);
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Hkv);
  const int s0 = qt * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, c = 2 * (lane & 3);

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* kh = k + kv_off;
  const __nv_bfloat16* vh = v + kv_off;
  const size_t rows = (static_cast<size_t>(b) * H + h) * S;  // lse, delta

  const int n_tiles = qt + 1;  // key tiles up to the diagonal
  load_tile<D>(sm + L::kQ, q + q_off, q_stride, s0, S);
  load_tile<D>(sm + L::kDO, dout + q_off, q_stride, s0, S);
  load_tile<D>(sm + L::kK, kh, kv_stride, 0, S);
  load_tile<D>(sm + L::kV, vh, kv_stride, 0, S);
  cp_async_commit();

  // delta = rowsum(dO * O) in fp32, two threads a row, while the first
  // copies are in flight; rows past S get delta 0 and lse 0 (their dS is 0)
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    if (s0 + r < S) {
      const size_t at = q_off + static_cast<size_t>(s0 + r) * q_stride +
                        half * (D / 2);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) acc = dot8(dp[i], op[i], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      lse_s[r] = s0 + r < S ? lse[rows + s0 + r] : 0.f;
      if (s0 + r < S) delta[rows + s0 + r] = acc;
    }
  }
  __syncthreads();
  // rows gr and gr + 8 of the warp's 16: their lse (log2 units) and delta
  const int rl = warp * 16 + gr;
  const float l2_0 = lse_s[rl] * kLog2e, l2_1 = lse_s[rl + 8] * kLog2e;
  const float dl0 = delta_s[rl], dl1 = delta_s[rl + 8];
  const int row0 = s0 + rl;  // query position of rows gr, gr + 8
  const float sl2 = scale * kLog2e;

  float acc[kNB][8][4];  // dQ, 64-column block by block
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<D>(sm + L::kK + (st ^ 1) * L::kTile, kh, kv_stride,
                   (j + 1) * kRows, S);
      load_tile<D>(sm + L::kV + (st ^ 1) * L::kTile, vh, kv_stride,
                   (j + 1) * kRows, S);
      cp_async_commit();
      cp_async_wait_for_wgmma<1>();
    } else {
      cp_async_wait_for_wgmma<0>();
    }
    __syncthreads();
    const unsigned char* ks = sm + L::kK + st * L::kTile;
    const unsigned char* vs = sm + L::kV + st * L::kTile;

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      wgmma_ss(s, desc_k(sm + L::kQ, kk), desc_k(ks, kk), kk > 0);
      wgmma_ss(dp, desc_k(sm + L::kDO, kk), desc_k(vs, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(s * scale - lse), 0 where the key follows the query (only on
    // the diagonal tile); dS = P (dP - delta) scale
    const bool diag = j == qt;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kRows + n * 8 + c + e;
        float p0 = exp2f(s[n][e] * sl2 - l2_0);
        float p1 = exp2f(s[n][2 + e] * sl2 - l2_1);
        if (diag) {
          if (key > row0) p0 = 0.f;
          if (key > row0 + 8) p1 = 0.f;
        }
        dp[n][e] = p0 * (dp[n][e] - dl0) * scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - dl1) * scale;
      }
    }

    // dQ += bf16(dS) K: the registers are the A operand, the contraction
    // runs over the tile's 64 keys (K read MN-major)
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(acc[nb], da[kk], desc_mn(ks, kk, nb), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(acc[nb]);
    __syncthreads();  // this stage is free for tile j + 2
  }

  __nv_bfloat16* dqh = dq + q_off;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = nb * 64 + n * 8 + c;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(dqh + row0 * q_stride + col) =
            __floats2bfloat162_rn(acc[nb][n][0], acc[nb][n][1]);
      if (row0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(dqh + (row0 + 8) * q_stride +
                                           col) =
            __floats2bfloat162_rn(acc[nb][n][2], acc[nb][n][3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int B, int S, int H, int Hkv, float scale, cudaStream_t st) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((S + kRows - 1) / kRows) * B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(delta), B, S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E. q, o, dout, dq: [B, S, H, D]; k, v: [B, S, Hkv, D]; bf16, contiguous;
// lse, delta (written): [B, H, S] fp32; D in {64, 128}.
extern "C" int picotron_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int B, int S,
    int H, int Hkv, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, o, dout, lse, dq, delta, B, S, H, Hkv,
                           scale, st);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, lse, dq, delta, B, S, H, Hkv,
                            scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
