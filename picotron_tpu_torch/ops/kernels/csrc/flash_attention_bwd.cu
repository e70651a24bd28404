// Kernel E: dQ of the causal flash attention, and delta, written by hand
// for Hopper (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (:223), reached through _bwd (:295). Same function: with P re-derived
// from the forward's log-sum-exp as p = exp(q.k * scale - lse) (0 above the
// diagonal), dP = dO . V and delta = rowsum(dO * O) (fp32),
//
//   dS = P * (dP - delta) * scale,  dQ = bf16(dS) @ K,
//
// the rounding point of the Pallas body (dS to bf16 before the dQ
// product), fp32 accumulators, bf16 output. Kernel F (dK, dV) is
// flash_attention_bwd_dkv.cu and reads the delta this kernel writes.
//
// What bounds it on this card: at the training shape [4, 2048, 32, 64]
// the operations, 6 * D * H * S^2 / 2 (three products over the causal
// half) per batch entry, against bytes of about 6 * H * S * D * 2. This
// first version runs its products on the fp32 pipes, not the tensor cores
// (67 TFLOP/s of fp32 FMA, not 989 of bf16); the tensor cores are later
// work, as kernels B and F have them.
//
// Design: 64 query rows by 64 keys, 128 threads. In the score phase
// thread t owns key t % 64 and every other row (rows of parity t / 64),
// holding its key's K row (then its V row) in registers while the query
// and dO rows are read from shared memory as broadcasts. In the product
// phase thread (d = t % D, r0 = t / D) owns output column d of rows r0,
// r0 + 128 / D, ...; each accumulator lives in shared memory, owned by
// one thread, so there is no race and no atomic.
//
// One block per (batch, query head, 64-row query tile). It walks the KV
// tiles up to the diagonal (causal_kv_blocks :74) and writes dQ. It also
// computes delta for its rows and writes it to a [B, H, S] fp32 buffer,
// which F then reads: delta is part of E, and F must run after E on the
// same stream.
//
// Ragged S: the last query tile and the last key tile may be partial.
// Rows past S load as zeros, keys past S load as zeros and are masked, so
// nothing reads past the end (the Pallas kernel assumes blocks divide S,
// _pick_block :67).

#include "attention_tile.cuh"

namespace {

using picotron::kThreads;
using picotron::store8;
using picotron::unpack8;
using picotron::warp_sum;

constexpr int kR = 64;   // query rows per tile
constexpr int kT = 64;   // keys per tile
constexpr int kWarps = kThreads / 32;
constexpr int kRowPar = kThreads / kT;  // row parities in the score phase
static_assert(kThreads % kT == 0, "score phase: threads per key");
static_assert(kR == kT, "load_rows fills query and key tiles alike");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
struct SmemDq {
  float q[kR][D];     // query rows, fp32
  float dout[kR][D];  // dO rows, fp32
  float k[kT][D];     // the K tile, fp32
  float ds[kR][kT];   // p, then bf16(dS)
  float dq[kR][D];    // dQ accumulators
  float lse[kR];
  float delta[kR];
};

// Rows [s0, s0 + nr) of one head of a [B, S, heads, D] tensor into a
// [kR][D] fp32 tile (rows >= nr zero); head0 is the element offset of row
// 0's vector, row_stride the elements between rows.
template <int D>
__device__ __forceinline__ void load_rows(float (*dst)[D],
                                          const __nv_bfloat16* src,
                                          size_t head0, size_t row_stride,
                                          int nr) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kR * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const uint4 u = r < nr ? *reinterpret_cast<const uint4*>(
                                 src + head0 + r * row_stride + c * 8)
                           : make_uint4(0u, 0u, 0u, 0u);
    store8(&dst[r][c * 8], u);
  }
}

// One key's row of K or V (zeros past the end) into registers.
template <int D>
__device__ __forceinline__ void load_key(float* dst,
                                         const __nv_bfloat16* src,
                                         bool valid) {
  if (valid) {
    const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) unpack8(p[c], &dst[c * 8]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) dst[c] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_row(const float* row, const float* reg) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(&row[c]);
    acc += a.x * reg[c] + a.y * reg[c + 1] + a.z * reg[c + 2] +
           a.w * reg[c + 3];
  }
  return acc;
}

// E: dQ and delta.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int S, int H, int Hkv,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemDq<D>& sm = *reinterpret_cast<SmemDq<D>*>(smem_raw);
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nr = min(kR, S - s0);
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t q0 = (static_cast<size_t>(b) * S + s0) * q_stride +
                    static_cast<size_t>(h) * D;
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S + s0;

  load_rows<D>(sm.q, q, q0, q_stride, nr);
  load_rows<D>(sm.dout, dout, q0, q_stride, nr);
  for (int i = tid; i < kR * D; i += kThreads) (&sm.dq[0][0])[i] = 0.f;
  __syncthreads();
  // delta = rowsum(dO * O) in fp32, one warp per row
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < nr; r += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += sm.dout[r][d] * __bfloat162float(o[q0 + r * q_stride + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      sm.delta[r] = acc;
      sm.lse[r] = lse[row0 + r];
      delta[row0 + r] = acc;
    }
  }
  __syncthreads();

  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t kv0 = static_cast<size_t>(b) * S * kv_stride +
                     static_cast<size_t>(kvh) * D;
  const int kk = tid % kT;      // this thread's key in the tile
  const int rp = tid / kT;      // and its row parity
  const int d = tid % D;        // product phase: output column
  const int r0 = tid / D;       // first row
  constexpr int kStep = kThreads / D;
  const int n_tiles = (s0 + nr - 1) / kT + 1;  // tiles up to the diagonal
  float reg[D];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kT;
    const int key = t0 + kk;
    const bool key_ok = key < S;
    load_rows<D>(sm.k, k, kv0 + t0 * kv_stride, kv_stride, min(kT, S - t0));
    // p = exp(q.k * scale - lse), 0 where masked
    load_key<D>(reg, k + kv0 + key * kv_stride, key_ok);
    for (int r = rp; r < nr; r += kRowPar) {
      const float s = dot_row<D>(sm.q[r], reg) * scale;
      sm.ds[r][kk] =
          key_ok && key <= s0 + r ? expf(s - sm.lse[r]) : 0.f;
    }
    // dS = p * (dO.v - delta) * scale, rounded to bf16 for the dQ product
    load_key<D>(reg, v + kv0 + key * kv_stride, key_ok);
    for (int r = rp; r < nr; r += kRowPar) {
      const float dp = dot_row<D>(sm.dout[r], reg);
      sm.ds[r][kk] = round_bf16(sm.ds[r][kk] * (dp - sm.delta[r]) * scale);
    }
    __syncthreads();
    // dQ += bf16(dS) @ K
    for (int r = r0; r < nr; r += kStep) {
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < kT; ++t) acc += sm.ds[r][t] * sm.k[t][d];
      sm.dq[r][d] += acc;
    }
    __syncthreads();
  }
  for (int r = r0; r < nr; r += kStep)
    dq[q0 + r * q_stride + d] = __float2bfloat16(sm.dq[r][d]);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int B, int S, int H, int Hkv, float scale, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(SmemDq<D>));
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kR - 1) / kR, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(delta), S, H, Hkv, scale);
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
