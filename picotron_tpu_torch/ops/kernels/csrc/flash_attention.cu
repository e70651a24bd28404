// Kernel B: causal flash-attention forward, written by hand for Hopper
// (sm_90a), its products on the bf16 tensor cores.
//
// Replaces picotron_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:97),
// reached through _fwd (:138) from flash_attention (:431). Same function:
// causal attention of q [B, S, H, D] over k/v [B, S, Hkv, D] (bf16), each
// score a bf16 . bf16 product summed in fp32, an fp32 online softmax, p
// rounded to bf16 before the P @ V product (l sums the fp32 p), output in
// bf16. KV tiles wholly above the diagonal are never read (the TPU
// kernel's causal_kv_blocks bound). Those rounding points are the tensor
// cores' own, so only the order of the fp32 sums differs from the Pallas
// body.
//
// What bounds it on this card: operations, 4 * D * H * S (S + 1) / 2 per
// batch entry against (2 H + 2 Hkv) * S * D * 2 bytes; at the training
// shape [4, 2048, 32, 64] that is 69 GFLOP, 0.07 ms at 989 TFLOP/s.
//
// Design: one warpgroup (4 warps, 128 threads) per (batch, head, 64 query
// rows) (wgmma_tile.cuh has the tile and register layouts).
//   - Q is copied to shared memory once, under the 128-byte swizzle, and is
//     the A operand of every S product.
//   - K/V tiles of 64 keys stream through a 2-stage cp.async ring: tile
//     j + 1 is in flight while tile j is computed.
//   - S = Q K^T on wgmma m64n64k16 (both operands K-major in shared memory)
//     into fp32 registers; the row max and row sum reduce over the 4
//     threads of a quad with shuffles.
//   - p = exp2(s * scale * log2 e - m) stays in registers, is rounded to
//     bf16 and fed as the register A operand of O += P V, whose B operand is
//     the V tile read MN-major: no score touches shared memory and no tile
//     is transposed.
//   - O accumulates in fp32 registers, is divided by l and written in
//     bf16; with a non-null lse each row also writes m + log(l), the
//     residual the backward (E and F) re-derives P from. The serving path
//     passes null and pays nothing for it.
//   - Only the diagonal tile is masked. The grid runs the heaviest query
//     tiles (the last, which walk every key tile) first.
// TMA with a warp-specialised producer, and two consumer warpgroups that
// overlap one's softmax with the other's products, are the next steps.
//
// It takes what the serving and training paths hand it: D in {64, 128},
// any S >= 1 (the ragged last tile: rows and keys past S load as zeros and
// are neither read nor written), compact GQA K/V (kv head = h / (H / Hkv)),
// any B, rows H * D (Hkv * D) elements apart.

#include "wgmma_tile.cuh"

namespace {

using namespace picotron::wg;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {  // byte offsets from the 1024-aligned base
  static constexpr int kTile = tile_bytes<D>();  // 64 rows of Q, K or V
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = kV + kStages * kTile + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int S, int H, int Hkv, float scale) {
  using L = Layout<D>;
  constexpr int kNB = D / 64;   // 64-column blocks of the head dim
  constexpr int kDK = D / 16;   // 16-deep steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);

  const int nq = (S + kRows - 1) / kRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / (B * H);
  const int bh = static_cast<int>(blockIdx.x) % (B * H);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Hkv);
  const int s0 = qt * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = 2 * (lane & 3);

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qh = q + static_cast<size_t>(b) * S * q_stride +
                            static_cast<size_t>(h) * D;
  const __nv_bfloat16* kh = k + static_cast<size_t>(b) * S * kv_stride +
                            static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(b) * S * kv_stride +
                            static_cast<size_t>(kvh) * D;

  const int n_tiles = qt + 1;  // key tiles up to the diagonal
  load_tile<D>(sm + L::kQ, qh, q_stride, s0, S);
  load_tile<D>(sm + L::kK, kh, kv_stride, 0, S);
  load_tile<D>(sm + L::kV, vh, kv_stride, 0, S);
  cp_async_commit();

  float acc[kNB][8][4];  // O, 64-column block by block
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[nb][n][0] = acc[nb][n][1] = acc[nb][n][2] = acc[nb][n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's part of the running sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float sl2 = scale * kLog2e;
  const int row0 = s0 + warp * 16 + g;  // query position of rows g, g + 8

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

    // S = Q K^T: 64 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk)
      wgmma_ss(s, desc_k(sm + L::kQ, kk), desc_k(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax in log2 units; only the diagonal tile has masked keys
    const bool diag = j == qt;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kRows + n * 8 + c + e;
        float x0 = s[n][e] * sl2, x1 = s[n][2 + e] * sl2;
        if (diag) {
          if (key > row0) x0 = -CUDART_INF_F;
          if (key > row0 + 8) x1 = -CUDART_INF_F;
        }
        s[n][e] = x0;
        s[n][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every row sees at least key 0 of its first tile, so mx is finite
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[nb][n][0] *= alpha0;
        acc[nb][n][1] *= alpha0;
        acc[nb][n][2] *= alpha1;
        acc[nb][n][3] *= alpha1;
      }
      fence_regs(acc[nb]);
    }

    // O += bf16(P) V: the score registers are the A operand
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(acc[nb], pa[kk], desc_mn(vs, kk, nb), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(acc[nb]);
    __syncthreads();  // this stage is free for tile j + 2
  }

  // the row sums over the quad, then the output and the LSE
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* oh = o + static_cast<size_t>(b) * S * q_stride +
                      static_cast<size_t>(h) * D;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = nb * 64 + n * 8 + c;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(oh + row0 * q_stride + col) =
            __floats2bfloat162_rn(acc[nb][n][0] * inv0,
                                  acc[nb][n][1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(oh + (row0 + 8) * q_stride +
                                           col) =
            __floats2bfloat162_rn(acc[nb][n][2] * inv1,
                                  acc[nb][n][3] * inv1);
    }
  }
  if (lse != nullptr && c == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    if (row0 < S) lrow[row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < S) lrow[row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((S + kRows - 1) / kRows) * B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B, S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, S, Hkv, D]; bf16, contiguous; D in {64, 128}.
// lse: null, or [B, H, S] fp32.
extern "C" int picotron_flash_attention_fwd(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int S, int H, int Hkv,
                                            int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
