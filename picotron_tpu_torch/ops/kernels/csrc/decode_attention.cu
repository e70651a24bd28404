// Kernel C: flash decode (KV-cache attention), written by hand for Hopper
// (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/decode_attention.py::_flash_decode_kernel
// (:162), reached through flash_decode_attention (:376): the contiguous
// variants, full precision (picotron_flash_decode) and int8 with per-row
// scales (picotron_flash_decode_int8, the quantized=True path); the paged
// and hot_bf16 variants are in paged_decode.cu. Same function: S >= 1
// fresh queries per slot, q [B, S, H, D], against the slot's cache block
// k/v [B, T, Hkv, D] (bf16, or int8 with fp32 scales k_scale/v_scale
// [B, T, Hkv], each row dequantized as int8 -> fp32 x scale, as at
// :293-315); query row s sits at position lengths[b] - S + s and sees key t
// iff t <= that position and t < T; fp32 scores, softmax (p not rounded)
// and P @ V, the Pallas body's numerics (:344-372); rows with no visible
// key (a free slot, lengths == 0) return zeros.
//
// What bounds it on this card: bytes. A decode step reads every live
// K/V row of every slot once, 2 * sum_b(len_b) * Hkv * D * 2 bytes, for
// 4 * D operations per key and query row: at S = 1 that is about one
// operation per byte, far below the H100's ~295 FLOP/byte balance point.
// The int8 cache halves those bytes (plus 4 bytes of scale per row and
// head): 2 * sum_b(len_b) * Hkv * (D + 4).
//
// Design (attention_tile.cuh): the walk over the window is split across
// blocks, one per (split, row block, kv head, slot), so that a decode step
// of 8 slots fills the card (at T = 2048, 16 splits of one 128-key tile:
// 4,096 blocks for 32 kv heads) and each block reads only the live rows of
// its split, its copies in flight while it computes; a second launch
// merges the splits. GQA folds the g = H / Hkv query heads that share a kv
// head into the rows of one block (row = s * g + head-in-group), so each
// K/V byte is read once per kv head and split, never repeated per query
// head. The caller passes the plan (n_splits) and an fp32 workspace of
// n_splits * B * S * H * (D + 2) values.

#include "attention_tile.cuh"

namespace {

using picotron::Bf16KV;
using picotron::Int8KV;
using picotron::kChunkRows;
using picotron::kSmallRows;
using picotron::Partials;

// grid (row blocks x n_splits, Hkv, B): split fastest
template <int D, int kR>
__global__ void __launch_bounds__(picotron::block_threads(kR))
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths, Partials ws, int S,
                    int H, int Hkv, int T, int n_splits, int tiles_per_split,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = static_cast<int>(blockIdx.x) % n_splits;
  const int row0 = static_cast<int>(blockIdx.x) / n_splits * kR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  const Bf16KV kv{k + head0, v + head0, stride};
  picotron::attend_split<D, kR>(smem_raw, kv, q, b, kvh, row0, S, H, Hkv,
                                lengths[b], T, split, tiles_per_split, scale,
                                ws);
}

template <int D, int kR>
__global__ void __launch_bounds__(picotron::block_threads(kR))
flash_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ lengths, Partials ws, int S,
                         int H, int Hkv, int T, int n_splits,
                         int tiles_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = static_cast<int>(blockIdx.x) % n_splits;
  const int row0 = static_cast<int>(blockIdx.x) / n_splits * kR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  const size_t shead0 = static_cast<size_t>(b) * T * Hkv + kvh;
  const Int8KV kv{k + head0, v + head0, k_scale + shead0, v_scale + shead0,
                  stride, static_cast<size_t>(Hkv)};
  picotron::attend_split<D, kR>(smem_raw, kv, q, b, kvh, row0, S, H, Hkv,
                                lengths[b], T, split, tiles_per_split, scale,
                                ws);
}

template <int D, int kR>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, void* ws, int B, int S, int H, int Hkv, int T,
           int n_splits, int per, float scale, cudaStream_t stream) {
  const int smem = picotron::smem_bytes<D, kR, Bf16KV>(per);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<D, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_vec = B * S * H;
  const int row_blocks = (S * (H / Hkv) + kR - 1) / kR;
  const dim3 grid(row_blocks * n_splits, Hkv, B);
  flash_decode_kernel<D, kR>
      <<<grid, picotron::block_threads(kR), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      picotron::partials_of(ws, n_splits, n_vec, D), S, H, Hkv, T, n_splits,
      per, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return picotron::launch_merge<D>(ws, n_splits, n_vec, o, stream);
}

template <int D, int kR>
int launch_int8(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const int* lengths,
                void* o, void* ws, int B, int S, int H, int Hkv, int T,
                int n_splits, int per, float scale, cudaStream_t stream) {
  const int smem = picotron::smem_bytes<D, kR, Int8KV>(per);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_int8_kernel<D, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_vec = B * S * H;
  const int row_blocks = (S * (H / Hkv) + kR - 1) / kR;
  const dim3 grid(row_blocks * n_splits, Hkv, B);
  flash_decode_int8_kernel<D, kR>
      <<<grid, picotron::block_threads(kR), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), lengths,
      picotron::partials_of(ws, n_splits, n_vec, D), S, H, Hkv, T, n_splits,
      per, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return picotron::launch_merge<D>(ws, n_splits, n_vec, o, stream);
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, T, Hkv, D]; bf16, contiguous; lengths: [B]
// int32 on the device; ws: n_splits * B * S * H * (D + 2) fp32 values; D
// in {64, 128}; n_splits from decode_attention.split_plan.
extern "C" int picotron_flash_decode(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, void* ws, int B, int S, int H,
                                     int Hkv, int T, int D, int n_splits,
                                     float scale, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = picotron::tiles_per_split_of(T, n_splits);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = S * (H / Hkv) <= kSmallRows;
  switch (D) {
    case 64:
      return small ? launch<64, kSmallRows>(q, k, v, len, o, ws, B, S, H,
                                            Hkv, T, n_splits, per, scale, st)
                   : launch<64, kChunkRows>(q, k, v, len, o, ws, B, S, H,
                                            Hkv, T, n_splits, per, scale, st);
    case 128:
      return small ? launch<128, kSmallRows>(q, k, v, len, o, ws, B, S, H,
                                             Hkv, T, n_splits, per, scale, st)
                   : launch<128, kChunkRows>(q, k, v, len, o, ws, B, S, H,
                                             Hkv, T, n_splits, per, scale,
                                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: [B, S, H, D] bf16; k, v: [B, T, Hkv, D] int8; k_scale, v_scale:
// [B, T, Hkv] fp32; all contiguous; lengths: [B] int32 on the device; ws
// and n_splits as for picotron_flash_decode; D in {64, 128}.
extern "C" int picotron_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* o, void* ws, int B,
    int S, int H, int Hkv, int T, int D, int n_splits, float scale,
    void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = picotron::tiles_per_split_of(T, n_splits);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = S * (H / Hkv) <= kSmallRows;
  switch (D) {
    case 64:
      return small ? launch_int8<64, kSmallRows>(q, k, v, k_scale, v_scale,
                                                 len, o, ws, B, S, H, Hkv, T,
                                                 n_splits, per, scale, st)
                   : launch_int8<64, kChunkRows>(q, k, v, k_scale, v_scale,
                                                 len, o, ws, B, S, H, Hkv, T,
                                                 n_splits, per, scale, st);
    case 128:
      return small ? launch_int8<128, kSmallRows>(q, k, v, k_scale, v_scale,
                                                  len, o, ws, B, S, H, Hkv,
                                                  T, n_splits, per, scale, st)
                   : launch_int8<128, kChunkRows>(q, k, v, k_scale, v_scale,
                                                  len, o, ws, B, S, H, Hkv,
                                                  T, n_splits, per, scale,
                                                  st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
