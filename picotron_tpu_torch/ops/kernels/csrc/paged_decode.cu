// Kernel C's paged variants: flash decode (KV-cache attention) over a page
// pool, written by hand for Hopper (sm_90a).
//
// Replaces the paged paths of
// picotron_tpu/ops/pallas/decode_attention.py::_flash_decode_kernel (:162),
// reached through flash_decode_attention (:376) with block_tables: the walk
// over a slot's block-table row (_srcs :207, the clamp to the table's width
// :328) in three variants, each its own exported function:
//
//   picotron_flash_decode_paged       bf16 pool          (paged=True)
//   picotron_flash_decode_paged_int8  int8 pool + fp32 per-row scales
//                                                        (quantized=True)
//   picotron_flash_decode_mixed       bf16 pool + int8 pool + scales, one
//                                     flag per page      (mixed=True, the
//                                     hot_bf16 policy, :221-284)
//
// Same function as the contiguous kernel C (decode_attention.cu): S >= 1
// fresh queries per slot, q [B, S, H, D], query row s at position
// lengths[b] - S + s seeing key t iff t <= that position; here key t of
// slot b is row t % page_len of pool page block_tables[b, t / page_len]
// (pools [P, page_len, Hkv, D], scales [P, page_len, Hkv]), and the walk
// stops at max_pages * page_len keys. Entries past a slot's pages are the
// NULL page 0, which the mask hides. The mixed variant reads page p from
// the int8 pool when page_quant[p] != 0 and from the bf16 pool otherwise;
// it looks the flag up through the table itself, so the caller passes
// page_quant [P] and no gathered [B, max_pages] flag array.
//
// What bounds it: bytes, as for contiguous C. A decode step reads every
// live K/V row once, 2 * sum_b(len_b) * Hkv * D * 2 bytes in bf16 and
// 2 * sum_b(len_b) * Hkv * (D + 4) in int8, for about one operation per
// byte. Pages add the table: the entries a split spans, once per (slot, kv
// head, row block, split), read into shared memory.
//
// Design: the split walk of contiguous C (attention_tile.cuh) with a paged
// tile source (Paged<Bf16KV>, Paged<Int8KV>, MixedKV): one block per
// (split, row block, kv head, slot), walking only the tiles of its split
// that hold a visible key, decode rows on the fp32 pipes and chunk rows on
// the bf16 tensor cores; at its start the block copies its split's page
// ids (and, for mixed pages, their flags) into shared memory, and every key
// copy goes through them; the last block of a row block merges its splits,
// so a call is one launch. The plan (n_splits) is the contiguous call's for
// the same window (max_pages * page_len keys), so on the same rows each
// variant is bit for bit its contiguous twin: the arithmetic is the same
// code.

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using picotron::Bf16KV;
using picotron::Int8KV;
using picotron::kMinPageLen;
using picotron::kMmaRows;
using picotron::kSmallRows;
using picotron::kThreads;
using picotron::MixedKV;
using picotron::PageMap;
using picotron::Paged;
using picotron::Partials;
using picotron::SplitHead;

// The pointers and sizes every variant shares; one per launch.
struct PagedArgs {
  const __nv_bfloat16* q;
  const int* block_tables;  // [B, max_pages]
  const int* lengths;       // [B]
  int* counters;            // [B, Hkv, row blocks], zero between launches
  __nv_bfloat16* o;
  int S, H, Hkv, max_pages, page_shift, n_splits, tiles_per_split;
  float scale;
};

// the variant, a template argument (an int, so that ptxas's report names
// it)
constexpr int kBf16 = 0;
constexpr int kInt8 = 1;
constexpr int kMixed = 2;

template <int V>
using SourceOf = std::conditional_t<
    V == kBf16, Paged<Bf16KV>,
    std::conditional_t<V == kInt8, Paged<Int8KV>, MixedKV>>;

// kv / kq: the bf16 and int8 pools (the one the variant reads); ks / vs:
// the scale pools; page_quant: the mixed variant's flags. Grid (row blocks
// x n_splits, Hkv, B): split fastest.
template <int D, int kR, int V>
__global__ void __launch_bounds__(kThreads,
                                  picotron::min_blocks<D, kR, SourceOf<V>>())
flash_decode_paged_kernel(PagedArgs a, Partials ws,
                          const void* __restrict__ k,
                          const void* __restrict__ v,
                          const int8_t* __restrict__ kq,
                          const int8_t* __restrict__ vq,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ page_quant) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& head = *reinterpret_cast<SplitHead*>(smem_raw);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t stride = static_cast<size_t>(a.Hkv) * D;
  const size_t hkv = static_cast<size_t>(a.Hkv);
  const PageMap map{a.block_tables + static_cast<size_t>(b) * a.max_pages,
                    head.pages, a.max_pages, a.page_shift, 0};
  const int n_keys = a.max_pages << a.page_shift;
  SourceOf<V> src;
  if constexpr (V == kInt8) {
    src = Paged<Int8KV>{
        Int8KV{kq + kvh * D, vq + kvh * D, ks + kvh, vs + kvh, stride, hkv},
        map};
  } else {
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    const Bf16KV hot{kb + kvh * D, vb + kvh * D, stride};
    if constexpr (V == kBf16) {
      src = Paged<Bf16KV>{hot, map};
    } else {
      src = MixedKV{hot,
                    Int8KV{kq + kvh * D, vq + kvh * D, ks + kvh, vs + kvh,
                           stride, hkv},
                    map, page_quant, head.quant};
    }
  }
  picotron::attend<D, kR>(smem_raw, src, a.q, b, kvh, a.S, a.H, a.Hkv,
                          a.lengths[b], n_keys, a.n_splits,
                          a.tiles_per_split, a.scale, ws, a.counters, a.o);
}

template <int D, int kR, int V>
int launch(const PagedArgs& a, int B, void* ws, const void* k,
           const void* v, const int8_t* kq, const int8_t* vq,
           const float* ks, const float* vs, const int* page_quant,
           cudaStream_t stream) {
  const int smem =
      picotron::smem_bytes<D, kR, SourceOf<V>>(a.tiles_per_split);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_paged_kernel<D, kR, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_vec = B * a.S * a.H;
  const int row_blocks = (a.S * (a.H / a.Hkv) + kR - 1) / kR;
  const dim3 grid(row_blocks * a.n_splits, a.Hkv, B);
  flash_decode_paged_kernel<D, kR, V><<<grid, kThreads, smem, stream>>>(
      a, picotron::partials_of(ws, a.n_splits, n_vec, D), k, v, kq, vq, ks,
      vs, page_quant);
  return static_cast<int>(cudaGetLastError());
}

// log2(page_len), or -1 unless page_len is a power of two >= kMinPageLen
int page_shift_of(int page_len) {
  if (page_len < kMinPageLen || (page_len & (page_len - 1)) != 0) return -1;
  int shift = 0;
  while ((1 << shift) < page_len) ++shift;
  return shift;
}

template <int V>
int dispatch(const void* q, const void* k, const void* v, const void* kq,
             const void* vq, const void* ks, const void* vs,
             const void* page_quant, const void* block_tables,
             const void* lengths, void* o, void* ws, void* counters, int B,
             int S, int H, int Hkv, int page_len, int max_pages, int D,
             int n_splits, float scale, void* stream) {
  const int shift = page_shift_of(page_len);
  if (shift < 0 || max_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = picotron::tiles_per_split_of(max_pages << shift, n_splits);
  if (per < 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q),
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(lengths),
                    static_cast<int*>(counters),
                    static_cast<__nv_bfloat16*>(o),
                    S, H, Hkv, max_pages, shift, n_splits, per, scale};
  const auto* kq8 = static_cast<const int8_t*>(kq);
  const auto* vq8 = static_cast<const int8_t*>(vq);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* pq = static_cast<const int*>(page_quant);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = S * (H / Hkv) <= kSmallRows;
  switch (D) {
    case 64:
      return small ? launch<64, kSmallRows, V>(a, B, ws, k, v, kq8, vq8, ksf,
                                               vsf, pq, st)
                   : launch<64, kMmaRows, V>(a, B, ws, k, v, kq8, vq8, ksf,
                                             vsf, pq, st);
    case 128:
      return small ? launch<128, kSmallRows, V>(a, B, ws, k, v, kq8, vq8,
                                                ksf, vsf, pq, st)
                   : launch<128, kMmaRows, V>(a, B, ws, k, v, kq8, vq8, ksf,
                                              vsf, pq, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every pointer is contiguous device memory. q, o: [B, S, H, D] bf16;
// k, v: the bf16 pool [P, page_len, Hkv, D]; block_tables: [B, max_pages]
// int32; lengths: [B] int32; ws: n_splits * B * S * H * (D + 2) fp32
// values; counters: zeroed int32, as for picotron_flash_decode; D in {64,
// 128}; page_len a power of two >= 8; n_splits from
// decode_attention.split_plan over max_pages * page_len keys.
extern "C" int picotron_flash_decode_paged(
    const void* q, const void* k, const void* v, const void* block_tables,
    const void* lengths, void* o, void* ws, void* counters, int B, int S,
    int H, int Hkv, int page_len, int max_pages, int D, int n_splits,
    float scale, void* stream) {
  return dispatch<kBf16>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                         nullptr, block_tables, lengths, o, ws, counters, B,
                         S, H, Hkv, page_len, max_pages, D, n_splits, scale,
                         stream);
}

// As picotron_flash_decode_paged, with k, v the int8 pool
// [P, page_len, Hkv, D] and k_scale, v_scale its fp32 scales
// [P, page_len, Hkv].
extern "C" int picotron_flash_decode_paged_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* lengths,
    void* o, void* ws, void* counters, int B, int S, int H, int Hkv,
    int page_len, int max_pages, int D, int n_splits, float scale,
    void* stream) {
  return dispatch<kInt8>(q, nullptr, nullptr, k, v, k_scale, v_scale,
                         nullptr, block_tables, lengths, o, ws, counters, B,
                         S, H, Hkv, page_len, max_pages, D, n_splits, scale,
                         stream);
}

// As picotron_flash_decode_paged, with both pools: k, v bf16 and k_quant,
// v_quant int8 [P, page_len, Hkv, D], k_scale, v_scale fp32
// [P, page_len, Hkv], and page_quant [P] int32 (nonzero: the page reads
// from the int8 pool).
extern "C" int picotron_flash_decode_mixed(
    const void* q, const void* k, const void* v, const void* k_quant,
    const void* v_quant, const void* k_scale, const void* v_scale,
    const void* page_quant, const void* block_tables, const void* lengths,
    void* o, void* ws, void* counters, int B, int S, int H, int Hkv,
    int page_len, int max_pages, int D, int n_splits, float scale,
    void* stream) {
  return dispatch<kMixed>(q, k, v, k_quant, v_quant, k_scale, v_scale,
                          page_quant, block_tables, lengths, o, ws, counters,
                          B, S, H, Hkv, page_len, max_pages, D, n_splits,
                          scale, stream);
}
