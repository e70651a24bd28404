// The block-level flash-attention loop of kernel C (flash decode,
// decode_attention.cu) and its paged variants (paged_decode.cu), its
// products on the fp32 pipes. Kernel B (prefill flash attention,
// flash_attention.cu) runs on the tensor cores through wgmma_tile.cuh, so
// no caller passes kRoundP = true or an lse (below).
//
// A block owns up to kRows query rows that all attend to the same K/V head
// (one batch entry, one kv head). The caller fills, for each row, the
// element offset of its query vector (the output vector sits at the same
// offset: q and o share the [B, S, H, D] layout) and its position: key t
// is visible to the row iff t <= pos and t < n_keys. The block then walks
// only the KV tiles that hold a visible key -- tiles above the highest
// position are never read -- with an online softmax in fp32:
//
//   1. load the tile: thread t keeps key t's row in registers, V goes to
//      shared memory as fp32;
//   2. scores: thread t computes every row's dot product with key t
//      (query rows are read from shared memory by all threads at once,
//      so each load is a broadcast); masked scores are -inf;
//   3. per row (one warp each): the tile max, the new running max m, the
//      rescale factor alpha = exp(m_old - m), p = exp(s - m) with masked
//      entries exactly 0, and l = l * alpha + sum(p);
//   4. P @ V: thread (d, r0) keeps the fp32 accumulators of column d for
//      rows r0, r0 + kRowStep, ...; it rescales them by alpha and adds the
//      tile's contribution.
//
// A row whose every key is masked keeps l == 0 and writes zeros. With
// kRoundP, p is rounded to bf16 before the P @ V product (the training
// flash kernel's p.astype(v.dtype)); l always sums the fp32 p. With a
// non-null lse, row r also writes its log-sum-exp m + log(l) (fp32) at
// lse[r]. C passes kRoundP = false and no lse.
//
// Where the keys and values come from is a template parameter, the tile
// source: Bf16KV reads bf16 rows (kernel C); Int8KV reads int8 rows
// and their fp32 per-row scales and dequantizes each row in registers,
// int8 -> fp32 x scale, before it enters the tile (C's int8 variant).
// Paged<Bf16KV>, Paged<Int8KV> and MixedKV read a slot's keys out of a page
// pool through its block-table row (C's paged variants, paged_decode.cu):
// key t lives in pool page table[t / page_len] at row t % page_len. A paged
// source copies the table entries a 128-key tile spans into shared memory
// once per tile (prepare_tile, then a barrier), so no thread reads the
// table per key. The walk, the masks and the softmax are the same code for
// every source: on the same rows a paged variant computes bit for bit
// what its contiguous twin computes.
//
// Nothing carries over between blocks, unlike the TPU grid that runs in
// order on one core: each block loops over its own KV tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace picotron {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 128;     // keys per KV tile
constexpr int kThreads = 128;  // one thread per key in the score phase
constexpr int kWarps = kThreads / 32;
constexpr int kMinPageLen = 8;  // the smallest KV page (a power of two)
static_assert(kThreads == kKeys, "the score phase maps one thread to a key");

template <int D>
struct Smem {
  float q[kRows][D];      // query rows, fp32
  float v[kKeys][D];      // the V tile, fp32
  float s[kRows][kKeys];  // scores, then probabilities
  float m[kRows];         // running max per row
  float l[kRows];         // running normalizer per row
  float alpha[kRows];     // this tile's rescale factor per row
  long long off[kRows];   // element offset of each row's q (and o) vector
  int pos[kRows];         // each row's position
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// unpack8 into 16-byte-aligned shared memory, as two 16-byte stores
__device__ __forceinline__ void store8(float* dst, const uint4& u) {
  float f[8];
  unpack8(u, f);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// int8 bytes of w (lowest first) -> fp32, times the row's scale
__device__ __forceinline__ void dequant4(uint32_t w, float sc, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i))) * sc;
}

// Tile sources. k and v point at key 0 of one head; consecutive keys are
// stride elements apart. key_row fills one key's D values, value_chunk 8
// values (chunk c) of one value row, both in fp32.
struct Bf16KV {
  static constexpr bool kPaged = false;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  size_t stride;

  template <int D>
  __device__ __forceinline__ void key_row(int key, float* kr) const {
    const uint4* kp =
        reinterpret_cast<const uint4*>(k + static_cast<size_t>(key) * stride);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) unpack8(kp[c], &kr[c * 8]);
  }
  __device__ __forceinline__ void value_chunk(int key, int c,
                                              float* f) const {
    unpack8(*reinterpret_cast<const uint4*>(
                v + static_cast<size_t>(key) * stride + c * 8),
            f);
  }
};

// int8 rows with one fp32 scale per (key, head): k_scale / v_scale point
// at key 0's scale of the head, consecutive keys scale_stride apart.
struct Int8KV {
  static constexpr bool kPaged = false;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  size_t stride;
  size_t scale_stride;

  template <int D>
  __device__ __forceinline__ void key_row(int key, float* kr) const {
    const float sc = k_scale[static_cast<size_t>(key) * scale_stride];
    const uint4* kp =
        reinterpret_cast<const uint4*>(k + static_cast<size_t>(key) * stride);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint4 u = kp[c];
      dequant4(u.x, sc, &kr[c * 16]);
      dequant4(u.y, sc, &kr[c * 16 + 4]);
      dequant4(u.z, sc, &kr[c * 16 + 8]);
      dequant4(u.w, sc, &kr[c * 16 + 12]);
    }
  }
  __device__ __forceinline__ void value_chunk(int key, int c,
                                              float* f) const {
    const float sc = v_scale[static_cast<size_t>(key) * scale_stride];
    const uint2 u = *reinterpret_cast<const uint2*>(
        v + static_cast<size_t>(key) * stride + c * 8);
    dequant4(u.x, sc, f);
    dequant4(u.y, sc, f + 4);
  }
};

// A slot's block-table row and the shared-memory copy of the entries the
// current tile spans: kKeys >> page_shift of them (one when a page holds a
// whole tile or more).
struct PageMap {
  const int* table;  // the slot's max_pages entries (device memory)
  int* tile_pages;   // shared, kKeys / kMinPageLen entries
  int max_pages;
  int page_shift;    // log2(page_len)

  __device__ __forceinline__ int tile_entries() const {
    return page_shift >= 7 ? 1 : (kKeys >> page_shift);
  }
  // the tile starting at key t0 (a multiple of kKeys); entries past the
  // table (a tile that overhangs the window) point at the NULL page
  __device__ __forceinline__ void prepare_tile(int t0) const {
    const int first = t0 >> page_shift;
    for (int i = threadIdx.x; i < tile_entries(); i += kThreads) {
      const int p = first + i;
      tile_pages[i] = p < max_pages ? table[p] : 0;
    }
  }
  // index into tile_pages of a key of the current tile
  __device__ __forceinline__ int entry(int key) const {
    return (key & (kKeys - 1)) >> page_shift;
  }
  // the pool row (page * page_len + offset) that holds a key of the tile
  __device__ __forceinline__ int pool_row(int key) const {
    return (tile_pages[entry(key)] << page_shift) |
           (key & ((1 << page_shift) - 1));
  }
};

// A contiguous source read through a page map: Rows addresses the pool as
// one run of page_len-row pages (stride and scale stride as in a
// contiguous cache), and each key is sent to its pool row.
template <class Rows>
struct Paged {
  static constexpr bool kPaged = true;
  Rows rows;
  PageMap map;

  __device__ __forceinline__ void prepare_tile(int t0) const {
    map.prepare_tile(t0);
  }
  template <int D>
  __device__ __forceinline__ void key_row(int key, float* kr) const {
    rows.template key_row<D>(map.pool_row(key), kr);
  }
  __device__ __forceinline__ void value_chunk(int key, int c,
                                              float* f) const {
    rows.value_chunk(map.pool_row(key), c, f);
  }
};

// hot_bf16 mixed pages: two pools side by side, one flag per page
// (page_quant[page] != 0: read the int8 pool with its scales, else the bf16
// pool). prepare_tile copies each tile page's flag beside its id. With
// page_len < 32 a warp's keys span several pages, so the two branches can
// diverge inside a warp.
struct MixedKV {
  static constexpr bool kPaged = true;
  Bf16KV hot;
  Int8KV cold;
  PageMap map;
  const int* page_quant;  // [num_pages]
  int* tile_quant;        // shared, beside map.tile_pages

  __device__ __forceinline__ void prepare_tile(int t0) const {
    const int first = t0 >> map.page_shift;
    for (int i = threadIdx.x; i < map.tile_entries(); i += kThreads) {
      const int p = first + i;
      const int page = p < map.max_pages ? map.table[p] : 0;
      map.tile_pages[i] = page;
      tile_quant[i] = page_quant[page];
    }
  }
  template <int D>
  __device__ __forceinline__ void key_row(int key, float* kr) const {
    const int row = map.pool_row(key);
    if (tile_quant[map.entry(key)] != 0) {
      cold.template key_row<D>(row, kr);
    } else {
      hot.template key_row<D>(row, kr);
    }
  }
  __device__ __forceinline__ void value_chunk(int key, int c,
                                              float* f) const {
    const int row = map.pool_row(key);
    if (tile_quant[map.entry(key)] != 0) {
      cold.value_chunk(row, c, f);
    } else {
      hot.value_chunk(row, c, f);
    }
  }
};

// The block's folded query rows for kernel C (slot b, kv head kvh, rows
// row0..): GQA folds the g = H / Hkv query heads of a kv head into rows
// (row = s * g + head-in-group). Fills sm.off / sm.pos; returns the row
// count and sets max_pos.
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

// Attend the block's nr rows (sm.off / sm.pos filled for r < nr by the
// caller, before a __syncthreads) against keys [0, n_keys) of one head,
// read through the tile source kv. max_pos is the highest position of any
// row (negative: no row sees any key).
template <int D, bool kRoundP, class KV>
__device__ void attend_rows_kv(Smem<D>& sm, int nr, int max_pos,
                               const __nv_bfloat16* __restrict__ q,
                               const KV& kv, __nv_bfloat16* __restrict__ o,
                               int n_keys, float scale,
                               float* __restrict__ lse = nullptr) {
  constexpr int kChunks = D / 8;             // 8-value chunks per row
  constexpr int kRowStep = kThreads / D;     // rows between accumulators
  constexpr int kAcc = kRows / kRowStep;     // accumulators per thread
  static_assert(kThreads % D == 0, "D must divide the block");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -CUDART_INF_F;

  for (int idx = tid; idx < nr * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    store8(&sm.q[r][c * 8],
           *reinterpret_cast<const uint4*>(q + sm.off[r] + c * 8));
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sm.m[r] = neg_inf;
    sm.l[r] = 0.f;
  }
  const int d = tid % D;
  const int r0 = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  const int last_key = min(max_pos, n_keys - 1);
  const int n_tiles = last_key >= 0 ? last_key / kKeys + 1 : 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kKeys;
    const int key = t0 + tid;
    if constexpr (KV::kPaged) {  // the tile's page ids, then every thread
      kv.prepare_tile(t0);       // reads them from shared memory
      __syncthreads();
    }

    // 1. the tile
    for (int idx = tid; idx < kKeys * kChunks; idx += kThreads) {
      const int t = idx / kChunks, c = idx % kChunks;
      float f[8];
      if (t0 + t < n_keys) {
        kv.value_chunk(t0 + t, c, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&sm.v[t][c * 8]);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    float kr[D];
    if (key < n_keys) {
      kv.template key_row<D>(key, kr);
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) kr[c] = 0.f;
    }

    // 2. scores
    for (int r = 0; r < nr; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.q[r][c]);
        dot += qv.x * kr[c] + qv.y * kr[c + 1] + qv.z * kr[c + 2] +
               qv.w * kr[c + 3];
      }
      const bool visible = key < n_keys && key <= sm.pos[r];
      sm.s[r][tid] = visible ? dot * scale : neg_inf;
    }
    __syncthreads();

    // 3. online softmax, one warp per row
    for (int r = warp; r < nr; r += kWarps) {
      float mx = neg_inf;
      for (int t = lane; t < kKeys; t += 32) mx = fmaxf(mx, sm.s[r][t]);
      mx = warp_max(mx);
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kKeys; t += 32) {
        const float sv = sm.s[r][t];
        const float p = sv == neg_inf ? 0.f : expf(sv - m_new);
        sum += p;
        sm.s[r][t] = kRoundP ? __bfloat162float(__float2bfloat16(p)) : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_new == neg_inf ? 1.f : expf(m_old - m_new);
        sm.alpha[r] = alpha;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * alpha + sum;
      }
    }
    __syncthreads();

    // 4. P @ V
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int r = r0 + j * kRowStep;
      if (r < nr) acc[j] *= sm.alpha[r];
    }
    for (int t = 0; t < kKeys; t += 4) {
      const float v0 = sm.v[t][d], v1 = sm.v[t + 1][d];
      const float v2 = sm.v[t + 2][d], v3 = sm.v[t + 3][d];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int r = r0 + j * kRowStep;
        if (r < nr) {
          const float4 p = *reinterpret_cast<const float4*>(&sm.s[r][t]);
          acc[j] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = r0 + j * kRowStep;
    if (r < nr) {
      const float l = sm.l[r];
      o[sm.off[r] + d] = __float2bfloat16(l > 0.f ? acc[j] / l : 0.f);
    }
  }
  if (lse != nullptr) {
    for (int r = tid; r < nr; r += kThreads)
      lse[r] = sm.l[r] > 0.f ? sm.m[r] + logf(sm.l[r]) : neg_inf;
  }
}

// The bf16 form kernels B and C call: keys and values of one head at k and
// v, consecutive keys kv_stride elements apart.
template <int D, bool kRoundP>
__device__ void attend_rows(Smem<D>& sm, int nr, int max_pos,
                            const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, size_t kv_stride,
                            int n_keys, float scale,
                            float* __restrict__ lse = nullptr) {
  attend_rows_kv<D, kRoundP>(sm, nr, max_pos, q, Bf16KV{k, v, kv_stride}, o,
                             n_keys, scale, lse);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>);
}

}  // namespace picotron
