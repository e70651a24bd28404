// The split walk of kernel C (flash decode, decode_attention.cu) and its
// paged variants (paged_decode.cu), and the merge of its splits; its
// products on the fp32 pipes.
//
// Split-K over the window ("flash-decoding"). The key range [0, n_keys) is
// cut into n_splits fixed ranges of tiles_per_split whole 128-key tiles.
// A block owns one (split, row block, kv head, slot): up to kR query rows
// that all attend to the same K/V head (one slot, one kv head; GQA folds
// the g = H / Hkv query heads of the kv head into rows, row = s * g +
// head-in-group). Query row s sits at position len - S + s and sees key t
// iff t <= that position and t < n_keys. The block walks only the tiles of
// its split that hold a key visible to its rows; a split with none (a free
// slot, or a range past the slot's length or the rows' highest position)
// writes an empty partial (m = -inf, l = 0) and returns at once. Inside
// its split a block runs the online softmax in fp32:
//
//   1. copy: the tile's K and V rows (and scales) as stored, bf16 or int8,
//      into a stage of a 2-stage cp.async ring (one stage when the split
//      holds one tile); tile i + 1 is in flight while tile i is computed;
//      only keys below the highest visible one are read, the rest of the
//      stage is zero-filled;
//   2. scores: each thread takes a few keys and a few query rows (a
//      decode block: one key, every row; a chunk block: 4 keys by 4 rows),
//      converts the keys' rows to fp32 8 columns at a time (int8 x its
//      row's scale) and dots them with the rows (fp32 in shared memory,
//      read as broadcasts); masked scores are -inf;
//   3. per row (one warp each): the tile max, the new running max m, the
//      rescale factor alpha = exp(m_old - m), p = exp(s - m) with masked
//      entries exactly 0 (fp32, not rounded), and l = l * alpha + sum(p);
//   4. P @ V: each thread keeps the fp32 accumulators of 4 columns of a few
//      rows; it rescales them by alpha and adds the tile's contribution,
//      each value converted at use.
//
// The block then writes its rows' fp32 partials (m, l and the unnormalised
// accumulator) to a workspace, and a second kernel (flash_decode_merge)
// merges the splits of each output row in split order: with m the largest
// m_i, o = sum_i acc_i exp(m_i - m) / sum_i l_i exp(m_i - m), or zeros
// where that sum is 0 (a row with no visible key). Both launches are one
// call of the C entry.
//
// The split plan (n_splits) is the caller's, a host function of the
// shapes alone (decode_attention.split_plan): it never reads the lengths,
// so the contiguous and the paged call over the same rows get the same
// plan. The row tile fits the rows: kR = 16 when S * g <= 16 (decode), 32
// otherwise (chunks), with shared memory sized for it.
//
// Where the keys and values come from is a template parameter, the tile
// source: Bf16KV reads bf16 rows (kernel C); Int8KV int8 rows and their
// fp32 per-row scales (C's int8 variant); Paged<Bf16KV>, Paged<Int8KV> and
// MixedKV read a slot's keys out of a page pool through its block-table row
// (C's paged variants, paged_decode.cu): key t lives in pool page
// table[t / page_len] at row t % page_len, and entries past the table are
// the NULL page 0, behind the mask. A paged source copies the table
// entries its split spans into shared memory once (begin, then a barrier),
// so no thread reads the table per key. MixedKV stages a page's rows in the
// form its flag names and converts each as that form. The walk, the masks,
// the conversions and the softmax are the same code for every source: on
// the same rows a paged variant computes bit for bit what its contiguous
// twin computes, and mixed pages with every flag 0 (1) what the paged
// (paged int8) variant computes.

#pragma once

#include "wgmma_tile.cuh"

namespace picotron {

constexpr int kKeys = 128;     // keys per KV tile
constexpr int kThreads = 128;  // a decode block, and a merge block
constexpr int kMinPageLen = 8;     // the smallest KV page (a power of two)
constexpr int kMaxSplitTiles = 8;  // the most tiles a split may hold
constexpr int kMaxSplitPages = kMaxSplitTiles * kKeys / kMinPageLen;
constexpr int kSmallRows = 16;  // the row tile when S * g <= 16
constexpr int kChunkRows = 32;  // the row tile of chunks

// A block's threads: one per key of a tile at decode, two for chunks. A
// chunk block's rows and stages take 99-173 KB of shared memory, so one or
// two blocks share an SM, and four warps each would leave it stalled on
// its shared-memory loads.
__host__ __device__ constexpr int block_threads(int rows) {
  return rows > kSmallRows ? 2 * kKeys : kKeys;
}
static_assert(kThreads == kKeys, "a decode block has a thread per key");

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of the ring: a tile's K rows, then its V rows, kRowBytes as
// stored, each padded by 16 bytes so that the 8 threads of a quarter warp
// reading 16 bytes from 8 consecutive rows hit 8 different bank groups;
// then (kScaled) the tile's fp32 K and V scales.
template <int kRowBytes_, bool kScaled>
struct Stage {
  static constexpr int kRowBytes = kRowBytes_;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kK = 0;
  static constexpr int kV = kKeys * kPitch;
  static constexpr int kKs = 2 * kKeys * kPitch;
  static constexpr int kVs = kKs + kKeys * 4;
  static constexpr int kBytes = kScaled ? kVs + kKeys * 4 : kKs;
};

// Tile sources. A source copies the 16-byte chunk ch of a key's K and V
// rows into slot t of a stage (copy_chunk; zeros and no read where !ok),
// and converts a staged key to fp32, 8 K columns at a time (key8) or 4 V
// columns (value4), in the form is_quant names for the key (always one
// form but for mixed pages). k and v point at key 0 of one head; consecutive keys
// (pool rows, for a paged source) are stride elements apart.
struct Bf16KV {
  static constexpr bool kScaled = false;
  static constexpr int kElemBytes = 2;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  size_t stride;

  __device__ __forceinline__ void begin(int, int) {}
  template <int D, class St>
  __device__ __forceinline__ void copy_row(unsigned char* st, int t, int row,
                                           int ch, bool ok) const {
    const size_t at = ok ? static_cast<size_t>(row) * stride + ch * 8 : 0;
    const int n = ok ? 16 : 0;
    wg::cp_async16(st + St::kK + t * St::kPitch + ch * 16, k + at, n);
    wg::cp_async16(st + St::kV + t * St::kPitch + ch * 16, v + at, n);
  }
  template <int D, class St>
  __device__ __forceinline__ void copy_chunk(unsigned char* st, int t,
                                             int key, int ch, bool ok) const {
    copy_row<D, St>(st, t, key, ch, ok);
  }
  __device__ __forceinline__ bool is_quant(int) const { return false; }
  template <class St>
  __device__ __forceinline__ void key8(const unsigned char* st, int t, bool,
                                       int c8, float* f) const {
    unpack8(*reinterpret_cast<const uint4*>(st + St::kK + t * St::kPitch +
                                            c8 * 16),
            f);
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool, int d, float* f) const {
    const uint2 u = *reinterpret_cast<const uint2*>(st + St::kV +
                                                    t * St::kPitch + d * 2);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

// int8 rows with one fp32 scale per (key, head): k_scale / v_scale point
// at key 0's scale of the head, consecutive keys scale_stride apart.
struct Int8KV {
  static constexpr bool kScaled = true;
  static constexpr int kElemBytes = 1;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  size_t stride;
  size_t scale_stride;

  __device__ __forceinline__ void begin(int, int) {}
  // the row's D bytes are chunks 0 .. D / 16 - 1 of a slot (which may be
  // wider: the mixed source stages int8 rows in bf16-sized slots)
  template <int D, class St>
  __device__ __forceinline__ void copy_row(unsigned char* st, int t, int row,
                                           int ch, bool ok) const {
    if (ch >= D / 16) return;
    const size_t at = ok ? static_cast<size_t>(row) * stride + ch * 16 : 0;
    const int n = ok ? 16 : 0;
    wg::cp_async16(st + St::kK + t * St::kPitch + ch * 16, k + at, n);
    wg::cp_async16(st + St::kV + t * St::kPitch + ch * 16, v + at, n);
  }
  template <class St>
  __device__ __forceinline__ void copy_row_scales(unsigned char* st, int t,
                                                  int row, bool ok) const {
    const size_t at = ok ? static_cast<size_t>(row) * scale_stride : 0;
    const int n = ok ? 4 : 0;
    wg::cp_async4(st + St::kKs + t * 4, k_scale + at, n);
    wg::cp_async4(st + St::kVs + t * 4, v_scale + at, n);
  }
  template <int D, class St>
  __device__ __forceinline__ void copy_chunk(unsigned char* st, int t,
                                             int key, int ch, bool ok) const {
    copy_row<D, St>(st, t, key, ch, ok);
  }
  template <class St>
  __device__ __forceinline__ void copy_scales(unsigned char* st, int t,
                                              int key, bool ok) const {
    copy_row_scales<St>(st, t, key, ok);
  }
  __device__ __forceinline__ bool is_quant(int) const { return true; }
  template <class St>
  __device__ __forceinline__ void key8(const unsigned char* st, int t, bool,
                                       int c8, float* f) const {
    const uint2 u = *reinterpret_cast<const uint2*>(st + St::kK +
                                                    t * St::kPitch + c8 * 8);
    const float sc = reinterpret_cast<const float*>(st + St::kKs)[t];
    dequant4(u.x, sc, f);
    dequant4(u.y, sc, f + 4);
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool, int d, float* f) const {
    dequant4(*reinterpret_cast<const uint32_t*>(st + St::kV +
                                                t * St::kPitch + d),
             reinterpret_cast<const float*>(st + St::kVs)[t], f);
  }
};

// A slot's block-table row and the shared-memory copy of the entries its
// split spans (begin): key t of the split is pool row pages[entry(t)] *
// page_len + t % page_len.
struct PageMap {
  const int* table;  // the slot's max_pages entries (device memory)
  int* pages;        // shared, kMaxSplitPages entries
  int max_pages;
  int page_shift;    // log2(page_len)
  int first;         // the table index of the split's first entry

  // the entries of keys [key0, key0 + n_tiles * kKeys); entries past the
  // table (a tile that overhangs the window) point at the NULL page 0
  __device__ __forceinline__ int begin(int key0, int n_tiles) {
    first = key0 >> page_shift;
    const int n = ((key0 + n_tiles * kKeys - 1) >> page_shift) - first + 1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = first + i;
      pages[i] = p < max_pages ? table[p] : 0;
    }
    return n;
  }
  __device__ __forceinline__ int entry(int key) const {
    return (key >> page_shift) - first;
  }
  __device__ __forceinline__ int pool_row(int key) const {
    return (pages[entry(key)] << page_shift) |
           (key & ((1 << page_shift) - 1));
  }
};

// A contiguous source read through a page map: Rows addresses the pool as
// one run of page_len-row pages (stride and scale stride as in a
// contiguous cache), and each key is sent to its pool row.
template <class Rows>
struct Paged {
  static constexpr bool kScaled = Rows::kScaled;
  static constexpr int kElemBytes = Rows::kElemBytes;
  Rows rows;
  PageMap map;

  __device__ __forceinline__ void begin(int key0, int n_tiles) {
    map.begin(key0, n_tiles);
  }
  template <int D, class St>
  __device__ __forceinline__ void copy_chunk(unsigned char* st, int t,
                                             int key, int ch, bool ok) const {
    rows.template copy_row<D, St>(st, t, ok ? map.pool_row(key) : 0, ch, ok);
  }
  template <class St>
  __device__ __forceinline__ void copy_scales(unsigned char* st, int t,
                                              int key, bool ok) const {
    rows.template copy_row_scales<St>(st, t, ok ? map.pool_row(key) : 0, ok);
  }
  __device__ __forceinline__ bool is_quant(int key) const {
    return rows.is_quant(key);
  }
  template <class St>
  __device__ __forceinline__ void key8(const unsigned char* st, int t,
                                       bool quant, int c8, float* f) const {
    rows.template key8<St>(st, t, quant, c8, f);
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool quant, int d, float* f) const {
    rows.template value4<St>(st, t, quant, d, f);
  }
};

// hot_bf16 mixed pages: two pools side by side, one flag per page
// (page_quant[page] != 0: the int8 pool with its scales, else the bf16
// pool). begin copies each split page's flag beside its id; a key is
// staged, in a bf16-sized slot, and converted in the form its flag names.
// With page_len < 32 a warp's keys span several pages, so the two branches
// can diverge inside a warp.
struct MixedKV {
  static constexpr bool kScaled = true;
  static constexpr int kElemBytes = 2;
  Bf16KV hot;
  Int8KV cold;
  PageMap map;
  const int* page_quant;  // [num_pages]
  int* quant;             // shared, beside map.pages

  __device__ __forceinline__ void begin(int key0, int n_tiles) {
    const int n = map.begin(key0, n_tiles);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = map.first + i;
      quant[i] = page_quant[p < map.max_pages ? map.table[p] : 0];
    }
  }
  __device__ __forceinline__ bool is_quant(int key) const {
    return quant[map.entry(key)] != 0;
  }
  template <int D, class St>
  __device__ __forceinline__ void copy_chunk(unsigned char* st, int t,
                                             int key, int ch, bool ok) const {
    const int row = ok ? map.pool_row(key) : 0;
    if (is_quant(key)) {
      cold.copy_row<D, St>(st, t, row, ch, ok);
    } else {
      hot.copy_row<D, St>(st, t, row, ch, ok);
    }
  }
  template <class St>
  __device__ __forceinline__ void copy_scales(unsigned char* st, int t,
                                              int key, bool ok) const {
    if (is_quant(key))
      cold.copy_row_scales<St>(st, t, ok ? map.pool_row(key) : 0, ok);
  }
  template <class St>
  __device__ __forceinline__ void key8(const unsigned char* st, int t,
                                       bool quant, int c8, float* f) const {
    if (quant) {
      cold.key8<St>(st, t, quant, c8, f);
    } else {
      hot.key8<St>(st, t, quant, c8, f);
    }
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool quant, int d, float* f) const {
    if (quant) {
      cold.value4<St>(st, t, quant, d, f);
    } else {
      hot.value4<St>(st, t, quant, d, f);
    }
  }
};

// Everything in shared memory but the stages, which follow it.
template <int D, int kR>
struct Smem {
  float q[kR][D];      // query rows, fp32
  // scores, then probabilities; rows 16 bytes longer than a tile, so
  // that 16-byte reads of two rows at one key hit different banks
  float s[kR][kKeys + 4];
  float m[kR];         // running max per row
  float l[kR];         // running normalizer per row
  float alpha[kR];     // this tile's rescale factor per row
  long long off[kR];   // element offset of each row's q (and o) vector
  int pos[kR];         // each row's position
  int pages[kMaxSplitPages];  // the split's page ids (paged sources)
  int quant[kMaxSplitPages];  // and their flags (mixed pages)
};

template <class KV, int D>
using StageOf = Stage<D * KV::kElemBytes, KV::kScaled>;

template <int D, int kR>
__host__ __device__ constexpr int smem_head_bytes() {
  return (static_cast<int>(sizeof(Smem<D, kR>)) + 127) / 128 * 128;
}

// dynamic shared memory of a split block: one stage when a split holds one
// tile, else two
template <int D, int kR, class KV>
constexpr int smem_bytes(int tiles_per_split) {
  return smem_head_bytes<D, kR>() +
         (tiles_per_split > 1 ? 2 : 1) * StageOf<KV, D>::kBytes;
}

// The workspace: acc [n_splits][n_vec][D], then m and l [n_splits][n_vec],
// fp32; n_vec = B * S * H output vectors, vector (b * S + s) * H + h.
struct Partials {
  float* acc;
  float* m;
  float* l;
  int n_vec;
};

__host__ __device__ inline Partials partials_of(void* ws, int n_splits,
                                                int n_vec, int D) {
  float* acc = static_cast<float*>(ws);
  float* m = acc + static_cast<size_t>(n_splits) * n_vec * D;
  return Partials{acc, m, m + static_cast<size_t>(n_splits) * n_vec, n_vec};
}

// The tile starting at key t0 into a stage: keys at or past n_valid are
// zero-filled and not read.
template <int D, int kNT, class St, class KV>
__device__ __forceinline__ void stage_tile(const KV& kv, unsigned char* st,
                                           int t0, int n_valid) {
  constexpr int kChunks = St::kRowBytes / 16;
  for (int idx = threadIdx.x; idx < kKeys * kChunks; idx += kNT) {
    const int t = idx / kChunks, ch = idx % kChunks;
    kv.template copy_chunk<D, St>(st, t, t0 + t, ch, t0 + t < n_valid);
  }
  if constexpr (KV::kScaled) {
    if (threadIdx.x < kKeys) {
      const int key = t0 + threadIdx.x;
      kv.template copy_scales<St>(st, threadIdx.x, key, key < n_valid);
    }
  }
}

// One block of the split walk (see the header): rows [row0, row0 + kR) of
// slot b's S * g folded rows of kv head kvh, against keys [0, n_keys) of
// the head read through kv, split `split` of tiles_per_split tiles; len is
// the slot's length. Writes the rows' partials to ws.
template <int D, int kR, class KV>
__device__ void attend_split(unsigned char* smem, KV kv,
                             const __nv_bfloat16* __restrict__ q, int b,
                             int kvh, int row0, int S, int H, int Hkv,
                             int len, int n_keys, int split,
                             int tiles_per_split, float scale, Partials ws) {
  using St = StageOf<KV, D>;
  constexpr int kNT = block_threads(kR);
  // scores: kKW warps share a group of kSR rows, lane l of key warp kw
  // takes keys 32 kw + l + 32 kKW j (j < kSK): each q value read is used
  // kSK times, each key value kSR times. A chunk block tiles 4 keys by 4
  // rows a thread; a decode block, whose rows are few (S * g <= 16, one at
  // g = 1), gives each warp a quarter of the keys and every row
  constexpr int kKW = kR > kSmallRows ? 1 : kNT / 32;
  constexpr int kSK = kKeys / (32 * kKW);
  constexpr int kSR = kR / (kNT / 32 / kKW);
  // P @ V: thread (cg, rg) takes columns [4 cg, 4 cg + 4) of rows rg,
  // rg + kRG, ... (kPR of them)
  constexpr int kCG = D / 4;
  constexpr int kRG = kNT / kCG;
  constexpr int kPR = kR / kRG;
  static_assert(kNT % kCG == 0 && kR % kRG == 0, "the P @ V tiling");
  Smem<D, kR>& sm = *reinterpret_cast<Smem<D, kR>*>(smem);
  unsigned char* stages = smem + smem_head_bytes<D, kR>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -CUDART_INF_F;
  const int g = H / Hkv;
  const int nr = min(kR, S * g - row0);
  // the block's last row sees the most keys: the causal clip, then the
  // window's
  const int max_pos = len - S + (row0 + nr - 1) / g;
  const int last_key = min(max_pos, n_keys - 1);
  const int tiles_seen = last_key >= 0 ? last_key / kKeys + 1 : 0;
  const int t_begin = split * tiles_per_split;
  const int n_tiles = min(t_begin + tiles_per_split, tiles_seen) - t_begin;
  const size_t base = static_cast<size_t>(split) * ws.n_vec;

  if (n_tiles <= 0) {  // no visible key: the empty partial
    for (int r = tid; r < nr; r += kNT) {
      const int s = (row0 + r) / g, h = kvh * g + (row0 + r) % g;
      const size_t i = base + (static_cast<size_t>(b) * S + s) * H + h;
      ws.m[i] = neg_inf;
      ws.l[i] = 0.f;
    }
    return;
  }

  for (int r = tid; r < nr; r += kNT) {
    const int s = (row0 + r) / g, h = kvh * g + (row0 + r) % g;
    sm.off[r] = ((static_cast<long long>(b) * S + s) * H + h) * D;
    sm.pos[r] = len - S + s;
    sm.m[r] = neg_inf;
    sm.l[r] = 0.f;
  }
  kv.begin(t_begin * kKeys, n_tiles);
  __syncthreads();

  const int n_valid = last_key + 1;  // keys past it are never read
  stage_tile<D, kNT, St>(kv, stages, t_begin * kKeys, n_valid);
  wg::cp_async_commit();
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < nr * kChunks; idx += kNT) {
    const int r = idx / kChunks, c = idx % kChunks;
    store8(&sm.q[r][c * 8],
           *reinterpret_cast<const uint4*>(q + sm.off[r] + c * 8));
  }
  const int cg = tid % kCG;
  const int rg = tid / kCG;
  float acc[kPR][4];
#pragma unroll
  for (int i = 0; i < kPR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = (t_begin + i) * kKeys;
    const unsigned char* st = stages + (i & 1) * St::kBytes;
    if (i + 1 < n_tiles) {
      stage_tile<D, kNT, St>(kv, stages + ((i + 1) & 1) * St::kBytes,
                             t0 + kKeys, n_valid);
      wg::cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t_live = min(kKeys, n_valid - t0);  // staged keys

    // 2. scores
    if (warp / kKW * kSR < nr) {
      const int r_lo = warp / kKW * kSR;
      const int k_lo = warp % kKW * 32 + lane;  // this lane's first key
      float dot[kSK][kSR];
      bool quant[kSK];
#pragma unroll
      for (int j = 0; j < kSK; ++j) {
        quant[j] = kv.is_quant(t0 + k_lo + 32 * kKW * j);
#pragma unroll
        for (int i = 0; i < kSR; ++i) dot[j][i] = 0.f;
      }
#pragma unroll 1
      for (int c8 = 0; c8 < D / 8; ++c8) {
        float kf[kSK][8];
#pragma unroll
        for (int j = 0; j < kSK; ++j)
          kv.template key8<St>(st, k_lo + 32 * kKW * j, quant[j], c8,
                               kf[j]);
#pragma unroll
        for (int i = 0; i < kSR; ++i) {
          if (r_lo + i >= nr) break;  // the same for the whole warp
          const float4 a =
              *reinterpret_cast<const float4*>(&sm.q[r_lo + i][c8 * 8]);
          const float4 e =
              *reinterpret_cast<const float4*>(&sm.q[r_lo + i][c8 * 8 + 4]);
#pragma unroll
          for (int j = 0; j < kSK; ++j)
            dot[j][i] += a.x * kf[j][0] + a.y * kf[j][1] + a.z * kf[j][2] +
                         a.w * kf[j][3] + e.x * kf[j][4] + e.y * kf[j][5] +
                         e.z * kf[j][6] + e.w * kf[j][7];
        }
      }
#pragma unroll
      for (int i = 0; i < kSR; ++i) {
        const int r = r_lo + i;
        if (r < nr) {
#pragma unroll
          for (int j = 0; j < kSK; ++j) {
            const int t = k_lo + 32 * kKW * j, key = t0 + t;
            const bool visible =
                t < t_live && key < n_keys && key <= sm.pos[r];
            sm.s[r][t] = visible ? dot[j][i] * scale : neg_inf;
          }
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per row
    for (int r = warp; r < nr; r += kNT / 32) {
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
        sm.s[r][t] = p;
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

    // 4. P @ V over the staged keys (p is exactly 0 past them)
#pragma unroll
    for (int i = 0; i < kPR; ++i) {
      const int r = rg + i * kRG;
      if (r < nr) {
        const float alpha = sm.alpha[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
      }
    }
    if (rg < nr) {
      for (int t = 0; t < t_live; t += 4) {
        // a page holds at least 8 keys, so the group's 4 share one form
        const bool quant = kv.is_quant(t0 + t);
        float v[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kv.template value4<St>(st, t + e, quant, cg * 4, v[e]);
#pragma unroll
        for (int i = 0; i < kPR; ++i) {
          const int r = rg + i * kRG;
          if (r < nr) {
            const float4 p = *reinterpret_cast<const float4*>(&sm.s[r][t]);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][c] += p.x * v[0][c] + p.y * v[1][c] + p.z * v[2][c] +
                           p.w * v[3][c];
          }
        }
      }
    }
    __syncthreads();  // this stage is free for tile i + 2, s for tile i + 1
  }

  // the partials: acc unnormalised, m and l
#pragma unroll
  for (int i = 0; i < kPR; ++i) {
    const int r = rg + i * kRG;
    if (r < nr)
      *reinterpret_cast<float4*>(
          &ws.acc[(base + static_cast<size_t>(sm.off[r] / D)) * D +
                  cg * 4]) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                         acc[i][3]);
  }
  for (int r = tid; r < nr; r += kNT) {
    const size_t i = base + static_cast<size_t>(sm.off[r] / D);
    ws.m[i] = sm.m[r];
    ws.l[i] = sm.l[r];
  }
}

// The merge kernel and its launch are internal to each translation unit
// that includes this header.
namespace {

// The merge: output vector vec's splits in split order, rescaled to the
// largest m, o = acc / l, or zeros where l == 0 (no visible key).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ ws, int n_splits, int n_vec,
                   __nv_bfloat16* __restrict__ o) {
  constexpr int kVecs = kThreads / D;  // vectors per block
  const int vec = static_cast<int>(blockIdx.x) * kVecs + threadIdx.x / D;
  const int d = threadIdx.x % D;
  if (vec >= n_vec) return;
  const Partials p = partials_of(const_cast<float*>(ws), n_splits, n_vec, D);
  const float neg_inf = -CUDART_INF_F;
  float m = neg_inf;
  for (int i = 0; i < n_splits; ++i)
    m = fmaxf(m, p.m[static_cast<size_t>(i) * n_vec + vec]);
  float l = 0.f, acc = 0.f;
  if (m != neg_inf) {
    for (int i = 0; i < n_splits; ++i) {
      const size_t at = static_cast<size_t>(i) * n_vec + vec;
      const float mi = p.m[at];
      if (mi == neg_inf) continue;  // an empty partial
      const float w = expf(mi - m);
      l += p.l[at] * w;
      acc += p.acc[at * D + d] * w;
    }
  }
  o[static_cast<size_t>(vec) * D + d] =
      __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

// The merge launch that follows every split launch.
template <int D>
int launch_merge(void* ws, int n_splits, int n_vec, void* o,
                 cudaStream_t stream) {
  constexpr int kVecs = kThreads / D;
  flash_decode_merge<D><<<(n_vec + kVecs - 1) / kVecs, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), n_splits, n_vec,
      static_cast<__nv_bfloat16*>(o));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A call's tiles per split from its n_splits over a window of n_keys keys,
// or -1 if the plan does not fit the kernels (no split, or more than
// kMaxSplitTiles tiles in one).
inline int tiles_per_split_of(int n_keys, int n_splits) {
  const int tiles = (n_keys + kKeys - 1) / kKeys;
  if (n_splits < 1 || tiles < 1) return -1;
  const int per = (tiles + n_splits - 1) / n_splits;
  return per <= kMaxSplitTiles ? per : -1;
}

}  // namespace picotron
