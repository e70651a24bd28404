// Kernel F: dK and dV of the causal flash attention, written by hand for
// Hopper (sm_90a), its products on the bf16 tensor cores.
//
// Replaces picotron_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel
// (:255), reached through _bwd (:295). Same function: with P re-derived
// from the forward's log-sum-exp, p = exp(q.k * scale - lse) (0 above the
// diagonal), dP = dO . V and delta = rowsum(dO * O) (fp32, written by
// kernel E, flash_attention_bwd.cu),
//
//   dS = P * (dP - delta) * scale,
//   dK = bf16(dS)^T @ Q,  dV = bf16(P)^T @ dO,
//
// summed over the g = H / Hkv query heads of each kv head, fp32
// accumulators, bf16 outputs. Those are the Pallas body's rounding points
// and the tensor cores' own: only the order of the fp32 sums differs.
//
// What bounds it on this card: operations, the four products over the
// causal half, 8 * D * H * S (S + 1) / 2 per batch entry; at the training
// shape [4, 2048, 32, 64] that is 137 GFLOP, 0.14 ms at 989 TFLOP/s.
//
// Design: one warpgroup (4 warps, 128 threads) per (batch, kv head, 64
// keys); the block's keys are the M side of every product (wgmma_tile.cuh
// has the tile and register layouts).
//   - It computes S^T = K Q^T and dP^T = V dO^T directly (wgmma m64n64k16,
//     both operands K-major in shared memory), so P^T and dS^T come out as
//     accumulator registers already laid out as the register A operand of
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q, whose B operands are the
//     same dO and Q tiles read MN-major: nothing is transposed.
//   - dK and dV accumulate in fp32 registers across every query tile of
//     every query head of the group, from the first tile that sees the
//     block's keys (Pallas j0 :264) to the last, and are written once: no
//     atomics.
//   - The K and V tiles are copied to shared memory once; Q and dO tiles
//     of 64 rows, with their lse and delta, stream through a 2-stage
//     cp.async ring, tile i + 1 in flight while tile i is computed.
//   - Only the diagonal tile and a ragged last tile are masked. The grid
//     runs the heaviest key tiles first (key tile 0 walks every query
//     tile).
//
// Same contract as B: D in {64, 128}, any S >= 1 (rows and keys past S load
// as zeros, are masked and are neither read nor written), compact GQA,
// any B.

#include "wgmma_tile.cuh"

namespace {

using namespace picotron::wg;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {  // byte offsets from the 1024-aligned base
  static constexpr int kTile = tile_bytes<D>();  // 64 rows of one tensor
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;                 // [kStages] tiles
  static constexpr int kDO = kQ + kStages * kTile;     // [kStages] tiles
  static constexpr int kLse = kDO + kStages * kTile;   // [kStages][64] fp32
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kBytes = kDelta + kStages * kRows * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int S, int H,
                     int Hkv, float scale) {
  using L = Layout<D>;
  constexpr int kNB = D / 64;  // 64-column blocks of the head dim
  constexpr int kDK = D / 16;  // 16-deep steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm + L::kDelta);

  const int kt = static_cast<int>(blockIdx.x) / (B * Hkv);
  const int bh = static_cast<int>(blockIdx.x) % (B * Hkv);
  const int kvh = bh % Hkv, b = bh / Hkv;
  const int g = H / Hkv;
  const int k0 = kt * kRows;
  const int nq = (S + kRows - 1) / kRows;
  const int per_head = nq - kt;  // query tiles from the diagonal on
  const int n_tiles = g * per_head;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, c = 2 * (lane & 3);

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;

  // tile i of the walk: query head kvh * g + i / per_head, query tile
  // kt + i % per_head
  auto issue = [&](int i, int st) {
    const int h = kvh * g + i / per_head;
    const int s0 = (kt + i % per_head) * kRows;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(h) * D;
    load_tile<D>(sm + L::kQ + st * L::kTile, q + q_off, q_stride, s0, S);
    load_tile<D>(sm + L::kDO + st * L::kTile, dout + q_off, q_stride, s0, S);
    const float* rows = (threadIdx.x < kRows ? lse : delta) +
                        (static_cast<size_t>(b) * H + h) * S;
    float* dst = (threadIdx.x < kRows ? lse_s : delta_s) + st * kRows;
    const int r = threadIdx.x % kRows;
    const bool ok = s0 + r < S;
    cp_async4(dst + r, ok ? rows + s0 + r : rows, ok ? 4 : 0);
  };

  load_tile<D>(sm + L::kK, k + kv_off, kv_stride, k0, S);
  load_tile<D>(sm + L::kV, v + kv_off, kv_stride, k0, S);
  issue(0, 0);
  cp_async_commit();

  float dka[kNB][8][4], dva[kNB][8][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nb][n][e] = dva[nb][n][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + gr;  // key position of rows gr, gr + 8

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) {
      issue(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait_for_wgmma<1>();
    } else {
      cp_async_wait_for_wgmma<0>();
    }
    __syncthreads();
    const int s0 = (kt + i % per_head) * kRows;
    const unsigned char* qs = sm + L::kQ + st * L::kTile;
    const unsigned char* dos = sm + L::kDO + st * L::kTile;
    const float* ls = lse_s + st * kRows;
    const float* dls = delta_s + st * kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      wgmma_ss(s, desc_k(sm + L::kK, kk), desc_k(qs, kk), kk > 0);
      wgmma_ss(dp, desc_k(sm + L::kV, kk), desc_k(dos, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(s * scale - lse), 0 where the query precedes the key or
    // lies past S; dS^T = P^T (dP^T - delta) scale
    const bool masked = s0 == k0 || s0 + kRows > S;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + c + e;
        const float l2 = ls[col] * kLog2e, dl = dls[col];
        float p0 = exp2f(s[n][e] * sl2 - l2);
        float p1 = exp2f(s[n][2 + e] * sl2 - l2);
        if (masked) {
          const int qpos = s0 + col;
          if (qpos < key0 || qpos >= S) p0 = 0.f;
          if (qpos < key0 + 8 || qpos >= S) p1 = 0.f;
        }
        s[n][e] = p0;
        s[n][2 + e] = p1;
        dp[n][e] = p0 * (dp[n][e] - dl) * scale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - dl) * scale;
      }
    }

    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q: the registers are the A
    // operands, the contraction runs over the tile's 64 queries
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      fence_regs(dva[nb]);
      fence_regs(dka[nb]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        wgmma_rs(dva[nb], pa[kk], desc_mn(dos, kk, nb), 1);
        wgmma_rs(dka[nb], da[kk], desc_mn(qs, kk, nb), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      fence_regs(dva[nb]);
      fence_regs(dka[nb]);
    }
    __syncthreads();  // this stage is free for tile i + 2
  }

  __nv_bfloat16* dkh = dk + kv_off;
  __nv_bfloat16* dvh = dv + kv_off;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = nb * 64 + n * 8 + c;
      if (key0 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + key0 * kv_stride + col) =
            __floats2bfloat162_rn(dka[nb][n][0], dka[nb][n][1]);
        *reinterpret_cast<__nv_bfloat162*>(dvh + key0 * kv_stride + col) =
            __floats2bfloat162_rn(dva[nb][n][0], dva[nb][n][1]);
      }
      if (key0 + 8 < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + (key0 + 8) * kv_stride +
                                           col) =
            __floats2bfloat162_rn(dka[nb][n][2], dka[nb][n][3]);
        *reinterpret_cast<__nv_bfloat162*>(dvh + (key0 + 8) * kv_stride +
                                           col) =
            __floats2bfloat162_rn(dva[nb][n][2], dva[nb][n][3]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int S, int H, int Hkv, float scale, cudaStream_t st) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((S + kRows - 1) / kRows) * B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, S,
      H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: [B, S, H, D]; k, v, dk, dv: [B, S, Hkv, D]; bf16, contiguous;
// lse and delta (E's output): [B, H, S] fp32; D in {64, 128}.
extern "C" int picotron_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int Hkv, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv,
                         scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
