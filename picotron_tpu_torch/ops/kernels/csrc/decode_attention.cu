// Kernel C: flash decode (KV-cache attention), written by hand for Hopper
// (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/decode_attention.py::_flash_decode_kernel
// (:162), reached through flash_decode_attention (:376): the contiguous
// variants, full precision (picotron_flash_decode) and int8 with per-row
// scales (picotron_flash_decode_int8, the quantized=True path); paged
// block tables and hot_bf16 mixed pages are not ported yet. Same
// function: S >= 1 fresh queries per slot, q [B, S, H, D], against the
// slot's cache block k/v [B, T, Hkv, D] (bf16, or int8 with fp32 scales
// k_scale/v_scale [B, T, Hkv], each row dequantized in registers as
// int8 -> fp32 x scale, as at :293-315); query row s sits at position
// lengths[b] - S + s and sees key t iff t <= that position and t < T;
// fp32 scores, softmax and P @ V; rows with no visible key (a free slot,
// lengths == 0) return zeros.
//
// What bounds it on this card: bytes. A decode step reads every live
// K/V row of every slot once, 2 * sum_b(len_b) * Hkv * D * 2 bytes, for
// 4 * D operations per key and query row: at S = 1 that is about one
// operation per byte, far below the H100's ~295 FLOP/byte balance point.
// The int8 cache halves those bytes (plus 4 bytes of scale per row and
// head): 2 * sum_b(len_b) * Hkv * (D + 4).
// The design therefore reads only the live rows: each block walks the KV
// tiles up to its own slot's length and the highest position its rows can
// see (the TPU kernel's length-aware, causal-clipped walk); nothing beyond
// ceil(visible / 128) tiles is touched, and a free slot reads nothing.
//
// Design (attention_tile.cuh): one block per (slot, kv head, 64 folded
// query rows). GQA folds the g = H / Hkv query heads that share a kv head
// into the rows of one block (row = s * g + head-in-group), so each K/V
// byte is read once per kv head, never repeated per query head. Decode
// (S = 1) has g rows per block; chunked prefill (B = 1, S = chunk) spreads
// its S * g rows over several blocks.

#include "attention_tile.cuh"

namespace {

using picotron::kRows;
using picotron::kThreads;
using picotron::Smem;

// The block's folded rows (slot b, kv head kvh, rows row0..): fills
// sm.off / sm.pos; returns the row count and sets max_pos.
template <int D>
__device__ __forceinline__ int fold_rows(Smem<D>& sm, int b, int kvh,
                                         int row0, int S, int H, int Hkv,
                                         int len, int& max_pos) {
  const int g = H / Hkv;
  const int nr = min(kRows, S * g - row0);
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    const int s = (row0 + r) / g;
    const int h = kvh * g + (row0 + r) % g;
    sm.off[r] = (static_cast<long long>(b) * S + s) * H * D +
                static_cast<long long>(h) * D;
    sm.pos[r] = len - S + s;
  }
  max_pos = len - S + (row0 + nr - 1) / g;
  __syncthreads();
  return nr;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                    int T, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  int max_pos;
  const int nr = fold_rows<D>(sm, b, kvh, blockIdx.x * kRows, S, H, Hkv,
                              lengths[b], max_pos);
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  picotron::attend_rows<D, false>(sm, nr, max_pos, q, k + head0, v + head0,
                                  o, stride, T, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ o, int S, int H,
                         int Hkv, int T, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  int max_pos;
  const int nr = fold_rows<D>(sm, b, kvh, blockIdx.x * kRows, S, H, Hkv,
                              lengths[b], max_pos);
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  const size_t shead0 = static_cast<size_t>(b) * T * Hkv + kvh;
  const picotron::Int8KV kv{k + head0, v + head0, k_scale + shead0,
                            v_scale + shead0, stride,
                            static_cast<size_t>(Hkv)};
  picotron::attend_rows_kv<D, false>(sm, nr, max_pos, q, kv, o, T, scale);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int B, int S, int H, int Hkv, int T, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(picotron::smem_bytes<D>());
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = S * (H / Hkv);
  const dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  flash_decode_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      static_cast<__nv_bfloat16*>(o), S, H, Hkv, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_int8(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const int* lengths,
                void* o, int B, int S, int H, int Hkv, int T, float scale,
                cudaStream_t stream) {
  const int smem = static_cast<int>(picotron::smem_bytes<D>());
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_int8_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = S * (H / Hkv);
  const dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  flash_decode_int8_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), lengths,
      static_cast<__nv_bfloat16*>(o), S, H, Hkv, T, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, T, Hkv, D]; bf16, contiguous;
// lengths: [B] int32 on the device; D in {64, 128}.
extern "C" int picotron_flash_decode(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, int B, int S, int H, int Hkv,
                                     int T, int D, float scale,
                                     void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, len, o, B, S, H, Hkv, T, scale, st);
    case 128:
      return launch<128>(q, k, v, len, o, B, S, H, Hkv, T, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: [B, S, H, D] bf16; k, v: [B, T, Hkv, D] int8; k_scale, v_scale:
// [B, T, Hkv] fp32; all contiguous; lengths: [B] int32 on the device;
// D in {64, 128}.
extern "C" int picotron_flash_decode_int8(const void* q, const void* k,
                                          const void* v, const void* k_scale,
                                          const void* v_scale,
                                          const void* lengths, void* o, int B,
                                          int S, int H, int Hkv, int T, int D,
                                          float scale, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_int8<64>(q, k, v, k_scale, v_scale, len, o, B, S, H, Hkv,
                             T, scale, st);
    case 128:
      return launch_int8<128>(q, k, v, k_scale, v_scale, len, o, B, S, H,
                              Hkv, T, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
