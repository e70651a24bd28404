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
// its split, its copies in flight while it computes; the last block of a
// row block to finish merges its splits, so a call is one launch. GQA folds
// the g = H / Hkv query heads that share a kv head into the rows of one
// block (row = s * g + head-in-group), so each K/V byte is read once per kv
// head and split, never repeated per query head. Decode rows (S * g <= 16)
// run their products on the fp32 pipes; chunk rows (a prefill chunk over a
// cached prefix, about S * g operations for each K/V byte read, so at S =
// 512 near or past the balance point) run them on the bf16 tensor cores,
// one warpgroup per 64 rows, with p kept to fp32 precision as two bf16
// halves. The caller passes the plan (n_splits), an
// fp32 workspace of n_splits * B * S * H * (D + 2) values and the zeroed
// int32 counters, one per (slot, kv head, row block).

#include "attention_tile.cuh"

namespace {

using picotron::Bf16KV;
using picotron::Int8KV;
using picotron::kMmaRows;
using picotron::kSmallRows;
using picotron::kThreads;
using picotron::Partials;

// grid (row blocks x n_splits, Hkv, B): split fastest
template <int D, int kR>
__global__ void __launch_bounds__(kThreads,
                                  picotron::min_blocks<D, kR, Bf16KV>())
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ lengths, Partials ws,
                    int* __restrict__ counters, __nv_bfloat16* __restrict__ o,
                    int S, int H, int Hkv, int T, int n_splits,
                    int tiles_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  const Bf16KV kv{k + head0, v + head0, stride};
  picotron::attend<D, kR>(smem_raw, kv, q, b, kvh, S, H, Hkv, lengths[b], T,
                          n_splits, tiles_per_split, scale, ws, counters, o);
}

template <int D, int kR>
__global__ void __launch_bounds__(kThreads,
                                  picotron::min_blocks<D, kR, Int8KV>())
flash_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ lengths, Partials ws,
                         int* __restrict__ counters,
                         __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                         int T, int n_splits, int tiles_per_split,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * T * stride +
                       static_cast<size_t>(kvh) * D;
  const size_t shead0 = static_cast<size_t>(b) * T * Hkv + kvh;
  const Int8KV kv{k + head0, v + head0, k_scale + shead0, v_scale + shead0,
                  stride, static_cast<size_t>(Hkv)};
  picotron::attend<D, kR>(smem_raw, kv, q, b, kvh, S, H, Hkv, lengths[b], T,
                          n_splits, tiles_per_split, scale, ws, counters, o);
}

// The shapes and pointers every launch shares.
struct Call {
  const void* q;
  const int* lengths;
  void* o;
  void* ws;
  void* counters;
  int B, S, H, Hkv, T, n_splits, per;
  float scale;
  cudaStream_t stream;

  dim3 grid(int kR) const {
    return dim3(((S * (H / Hkv) + kR - 1) / kR) * n_splits, Hkv, B);
  }
  Partials partials(int D) const {
    return picotron::partials_of(ws, n_splits, B * S * H, D);
  }
};

template <int D, int kR>
int launch(const Call& c, const void* k, const void* v) {
  const int smem = picotron::smem_bytes<D, kR, Bf16KV>(c.per);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<D, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_kernel<D, kR><<<c.grid(kR), kThreads, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), c.lengths, c.partials(D),
      static_cast<int*>(c.counters), static_cast<__nv_bfloat16*>(c.o), c.S,
      c.H, c.Hkv, c.T, c.n_splits, c.per, c.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kR>
int launch_int8(const Call& c, const void* k, const void* v,
                const void* k_scale, const void* v_scale) {
  const int smem = picotron::smem_bytes<D, kR, Int8KV>(c.per);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_int8_kernel<D, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_int8_kernel<D, kR><<<c.grid(kR), kThreads, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), c.lengths, c.partials(D),
      static_cast<int*>(c.counters), static_cast<__nv_bfloat16*>(c.o), c.S,
      c.H, c.Hkv, c.T, c.n_splits, c.per, c.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, T, Hkv, D]; bf16, contiguous; lengths: [B]
// int32 on the device; ws: n_splits * B * S * H * (D + 2) fp32 values;
// counters: B * Hkv * ceil(S * (H / Hkv) / rows) int32, all zero (rows 16
// when S * (H / Hkv) <= 16, else 64), zero again on return; D in {64,
// 128}; n_splits from decode_attention.split_plan.
extern "C" int picotron_flash_decode(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, void* ws, void* counters, int B,
                                     int S, int H, int Hkv, int T, int D,
                                     int n_splits, float scale,
                                     void* stream) {
  const int per = picotron::tiles_per_split_of(T, n_splits);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, static_cast<const int*>(lengths), o, ws, counters, B, S,
               H, Hkv, T, n_splits, per, scale,
               static_cast<cudaStream_t>(stream)};
  const bool small = S * (H / Hkv) <= kSmallRows;
  switch (D) {
    case 64:
      return small ? launch<64, kSmallRows>(c, k, v)
                   : launch<64, kMmaRows>(c, k, v);
    case 128:
      return small ? launch<128, kSmallRows>(c, k, v)
                   : launch<128, kMmaRows>(c, k, v);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, o: [B, S, H, D] bf16; k, v: [B, T, Hkv, D] int8; k_scale, v_scale:
// [B, T, Hkv] fp32; all contiguous; lengths: [B] int32 on the device; ws,
// counters and n_splits as for picotron_flash_decode; D in {64, 128}.
extern "C" int picotron_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* o, void* ws,
    void* counters, int B, int S, int H, int Hkv, int T, int D, int n_splits,
    float scale, void* stream) {
  const int per = picotron::tiles_per_split_of(T, n_splits);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q, static_cast<const int*>(lengths), o, ws, counters, B, S,
               H, Hkv, T, n_splits, per, scale,
               static_cast<cudaStream_t>(stream)};
  const bool small = S * (H / Hkv) <= kSmallRows;
  switch (D) {
    case 64:
      return small ? launch_int8<64, kSmallRows>(c, k, v, k_scale, v_scale)
                   : launch_int8<64, kMmaRows>(c, k, v, k_scale, v_scale);
    case 128:
      return small ? launch_int8<128, kSmallRows>(c, k, v, k_scale, v_scale)
                   : launch_int8<128, kMmaRows>(c, k, v, k_scale, v_scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
