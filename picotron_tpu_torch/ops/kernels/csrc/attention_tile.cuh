// The split walks of kernel C (flash decode, decode_attention.cu) and its
// paged variants (paged_decode.cu), and the merge of their splits, folded
// into the walk: one launch a call.
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
// returns at once. The splits that hold one are the row block's first
// n_live, which every block computes from the same highest position. Only
// keys below the highest visible one are read; the rest of a stage is
// zero-filled. Inside its split a block runs the online softmax in fp32,
// in one of two walks:
//
// Decode rows (S * g <= 16, kR = kSmallRows): products on the fp32 pipes.
//   1. copy: the tile's K and V rows (and scales) as stored, bf16 or int8,
//      into a stage of a 2-stage cp.async ring (one stage when the split
//      holds one tile); tile i + 1 is in flight while tile i is computed;
//   2. scores: each thread takes one key and every row, converts the key's
//      row to fp32 8 columns at a time (int8 x its row's scale) and dots it
//      with the rows (fp32 in shared memory, read as broadcasts); masked
//      scores are -inf;
//   3. per row (one warp each): the tile max, the new running max m, the
//      rescale factor alpha = exp(m_old - m), p = exp(s - m) with masked
//      entries exactly 0 (fp32, not rounded), and l = l * alpha + sum(p);
//   4. P @ V: each thread keeps the fp32 accumulators of 4 columns of a few
//      rows; it rescales them by alpha and adds the tile's contribution,
//      each value converted at use.
//
// Chunk rows (S * g > 16, kR = kMmaRows = 64): one warpgroup per 64 rows,
// its products on the bf16 tensor cores (wgmma_tile.cuh), in 64-key steps
// (the wgmma N) over a 2-stage cp.async ring:
//   1. copy: bf16 rows straight into 128-byte-swizzled K and V tiles; int8
//      rows as stored into a staging area, then (after the copy lands) a
//      register pass writes them into the same tiles as bf16, which holds
//      every int8 value exactly; the fp32 scales beside them;
//   2. S = Q K^T on wgmma m64n64k16 (Q, copied once, and K both K-major):
//      bf16 products summed in fp32; each key's K scale then multiplies
//      its score column (int8 keys), then the softmax scale;
//   3. the online softmax in registers, in log2 units (x = score x log2 e,
//      p = 2^(x - m); m goes to the partials in natural units), the row's
//      max and sum over the 4 threads of a quad; p stays fp32 and l sums
//      it; a step whose keys every row of the block sees skips the mask;
//   4. O += P V with p unrounded: the key's V scale multiplies p in fp32
//      (int8 keys), which is then split into two bf16 halves, hi = bf16(p)
//      and lo = bf16(p - hi), both register A operands of wgmma against
//      the same V tile read MN-major, into one fp32 accumulator.
// A key of a bf16 page of mixed pages gets scales of exactly 1.0, so one
// code path carries both forms.
//
// The merge. Each block of a live split writes its rows' fp32 partials (m,
// l and the unnormalised accumulator) to a workspace, makes them visible
// (a barrier, then a fence) and counts itself on its (row block, kv head,
// slot)'s counter. The block that brings the counter to n_live merges that
// row block's splits in split order, whichever block it is, so the result
// is deterministic: with m the largest m_i, o = sum_i acc_i exp(m_i - m) /
// sum_i l_i exp(m_i - m), or zeros where that sum is 0 (a row that sees no
// key); it writes o in bf16 and resets the counter to 0 for the next
// launch. A row block with one live split skips all of it: that split's
// block writes o itself with the same arithmetic (its weight is exactly
// 1). Where no split is live (a free slot, or rows that all sit at
// positions below 0), split 0's block writes the zeros. An empty split
// neither writes a partial nor counts: at decode most splits of a batch
// are empty, and a fence and an atomic each would cost them more than
// their walk. The counters are the caller's int32 buffer, all zero between
// launches; calls that share it run one at a time (one stream).
//
// The split plan (n_splits) is the caller's, a host function of the
// shapes alone (decode_attention.split_plan): it never reads the lengths,
// so the contiguous and the paged call over the same rows get the same
// plan.
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
// the conversions and the softmax are the same code for every source, and
// every product by a scale is an explicitly rounded multiply, never fused:
// on the same rows a paged variant computes bit for bit what its
// contiguous twin computes, and mixed pages with every flag 0 (1) what the
// paged (paged int8) variant computes.

#pragma once

#include "wgmma_tile.cuh"

namespace picotron {

constexpr int kKeys = 128;     // keys per tile of the split plan
constexpr int kThreads = 128;  // every block: a decode block, a warpgroup
constexpr int kMinPageLen = 8;     // the smallest KV page (a power of two)
constexpr int kMaxSplitTiles = 8;  // the most tiles a split may hold
constexpr int kMaxSplitPages = kMaxSplitTiles * kKeys / kMinPageLen;
constexpr int kSmallRows = 16;  // the row tile when S * g <= 16
constexpr int kMmaRows = 64;    // the row tile of chunks: the wgmma M
constexpr int kSubKeys = 64;    // keys per step of a chunk's walk: the N
static_assert(kThreads == kKeys, "a decode block has a thread per key");
static_assert(kThreads == wg::kThreads, "a chunk block is one warpgroup");

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

// 8 int8 values (lowest byte first) -> 8 bf16, exactly
__device__ __forceinline__ uint4 int8x8_to_bf16(uint2 w) {
  uint4 out;
  uint32_t* o = &out.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? w.x : w.y;
    const int sh = (i & 1) * 16;
    o[i] = wg::pack_bf16(static_cast<float>(static_cast<int8_t>(word >> sh)),
                         static_cast<float>(
                             static_cast<int8_t>(word >> (sh + 8))));
  }
  return out;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of the decode walk's ring: a tile's K rows, then its V rows,
// kRowBytes as stored, each padded by 16 bytes so that the 8 threads of a
// quarter warp reading 16 bytes from 8 consecutive rows hit 8 different
// bank groups; then (kScaled) the tile's fp32 K and V scales. A bf16 row
// and an int8 row of key t start at the same slot (k_at, qk_at).
template <int kRowBytes_, bool kScaled>
struct Stage {
  static constexpr int kRowBytes = kRowBytes_;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kK = 0;
  static constexpr int kV = kKeys * kPitch;
  static constexpr int kKs = 2 * kKeys * kPitch;
  static constexpr int kVs = kKs + kKeys * 4;
  static constexpr int kBytes = kScaled ? kVs + kKeys * 4 : kKs;
  // the byte offset of 16-byte chunk ch of key t's bf16 (int8) K / V row
  __device__ static int k_at(int t, int ch) { return kK + t * kPitch + ch * 16; }
  __device__ static int v_at(int t, int ch) { return kV + t * kPitch + ch * 16; }
  __device__ static int qk_at(int t, int ch) { return k_at(t, ch); }
  __device__ static int qv_at(int t, int ch) { return v_at(t, ch); }
};

// One stage of a chunk's ring, 64 keys: the bf16 K and V tiles under the
// 128-byte swizzle (wgmma_tile.cuh), then (kScaled) the int8 rows as
// stored, padded as in Stage, and the fp32 K and V scales.
template <int D, bool kScaled>
struct MmaStage {
  static constexpr int kTile = wg::tile_bytes<D>();
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kPitch = D + 16;
  static constexpr int kQK = 2 * kTile;
  static constexpr int kQV = kQK + kSubKeys * kPitch;
  static constexpr int kKs = kQV + kSubKeys * kPitch;
  static constexpr int kVs = kKs + kSubKeys * 4;
  // a multiple of 1024, so that every stage's tiles stay aligned
  static constexpr int kBytes =
      kScaled ? (kVs + kSubKeys * 4 + 1023) / 1024 * 1024 : 2 * kTile;
  __device__ static int swizzled(int t, int ch) {
    return (ch >> 3) * wg::kBlockBytes + t * 128 + (((ch & 7) ^ (t & 7)) << 4);
  }
  __device__ static int k_at(int t, int ch) { return kK + swizzled(t, ch); }
  __device__ static int v_at(int t, int ch) { return kV + swizzled(t, ch); }
  __device__ static int qk_at(int t, int ch) { return kQK + t * kPitch + ch * 16; }
  __device__ static int qv_at(int t, int ch) { return kQV + t * kPitch + ch * 16; }
};

// Tile sources. A source copies the 16-byte chunk ch of a key's K and V
// rows into slot t of a stage (copy_chunk; zeros and no read where !ok),
// at the stage layout's offsets (St::k_at for bf16 rows, St::qk_at for
// int8 rows), and its scales (copy_scales); the decode walk converts a
// staged key to fp32, 8 K columns at a time (key8) or 4 V columns
// (value4), in the form is_quant names for the key (always one form but
// for mixed pages). k and v point at key 0 of one head; consecutive keys
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
    wg::cp_async16(st + St::k_at(t, ch), k + at, n);
    wg::cp_async16(st + St::v_at(t, ch), v + at, n);
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
    unpack8(*reinterpret_cast<const uint4*>(st + St::k_at(t, c8)), f);
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool, int d, float* f) const {
    const uint2 u = *reinterpret_cast<const uint2*>(st + St::v_at(t, 0) +
                                                    d * 2);
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
  // the row's D bytes are chunks 0 .. D / 16 - 1 (a mixed source's chunk
  // loop runs to the bf16 row's D / 8)
  template <int D, class St>
  __device__ __forceinline__ void copy_row(unsigned char* st, int t, int row,
                                           int ch, bool ok) const {
    if (ch >= D / 16) return;
    const size_t at = ok ? static_cast<size_t>(row) * stride + ch * 16 : 0;
    const int n = ok ? 16 : 0;
    wg::cp_async16(st + St::qk_at(t, ch), k + at, n);
    wg::cp_async16(st + St::qv_at(t, ch), v + at, n);
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
    const uint2 u = *reinterpret_cast<const uint2*>(st + St::qk_at(t, 0) +
                                                    c8 * 8);
    const float sc = reinterpret_cast<const float*>(st + St::kKs)[t];
    dequant4(u.x, sc, f);
    dequant4(u.y, sc, f + 4);
  }
  template <class St>
  __device__ __forceinline__ void value4(const unsigned char* st, int t,
                                         bool, int d, float* f) const {
    dequant4(*reinterpret_cast<const uint32_t*>(st + St::qv_at(t, 0) + d),
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
// staged in the form its flag names (a bf16 row where a bf16 row goes, an
// int8 row where an int8 row goes) and converted as that form; a bf16
// key's scales are 1.0. With page_len < 32 a warp's keys span several
// pages, so the two branches can diverge inside a warp.
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
    if (is_quant(key)) {
      cold.copy_row_scales<St>(st, t, ok ? map.pool_row(key) : 0, ok);
    } else {
      reinterpret_cast<float*>(st + St::kKs)[t] = 1.f;
      reinterpret_cast<float*>(st + St::kVs)[t] = 1.f;
    }
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

// The head of a block's dynamic shared memory, ahead of its walk's own:
// the split's page ids and flags (paged sources), and the merge's flag.
struct SplitHead {
  int pages[kMaxSplitPages];
  int quant[kMaxSplitPages];
  int last;  // this block brought its row block's counter to n_live
};
constexpr int kHeadBytes = (static_cast<int>(sizeof(SplitHead)) + 127) /
                           128 * 128;

// The decode walk's shared memory, ahead of its stages.
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
};

template <class KV, int D>
using StageOf = Stage<D * KV::kElemBytes, KV::kScaled>;

template <int D, int kR>
__host__ __device__ constexpr int smem_walk_bytes() {
  return (static_cast<int>(sizeof(Smem<D, kR>)) + 127) / 128 * 128;
}

// Dynamic shared memory of a split block: the head, then a decode walk's
// rows and one stage when a split holds one tile, else two; or a chunk
// walk's Q tile and two stages, 1024-aligned.
template <int D, int kR, class KV>
constexpr int smem_bytes(int tiles_per_split) {
  if constexpr (kR == kMmaRows) {
    return kHeadBytes + 1024 + wg::tile_bytes<D>() +
           2 * MmaStage<D, KV::kScaled>::kBytes;
  } else {
    return kHeadBytes + smem_walk_bytes<D, kR>() +
           (tiles_per_split > 1 ? 2 : 1) * StageOf<KV, D>::kBytes;
  }
}

// The blocks of a walk an SM can hold at once by their shared memory (a
// decode split of one tile): the second argument of the kernels'
// __launch_bounds__, so that registers never hold an SM to fewer blocks
// than its shared memory allows. A chunk walk takes at most 4 (128
// registers a thread: its accumulators need them), a decode walk at most 8.
template <int D, int kR, class KV>
constexpr int min_blocks() {
  // an H100 SM's shared memory, and what the system keeps of it per block
  constexpr int kSmemPerSm = 233472, kReservedPerBlock = 1024;
  constexpr int n =
      kSmemPerSm / (smem_bytes<D, kR, KV>(1) + kReservedPerBlock);
  constexpr int most = kR == kMmaRows ? 4 : 8;
  return n < 1 ? 1 : (n > most ? most : n);
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

// A block's rows: folded rows [row0, row0 + nr) of slot b's S * g rows of
// kv head kvh (row = s * g + head-in-group), the slot's length len.
struct RowBlock {
  int b, kvh, row0, nr, S, H, g, len;

  // row r's output vector (b * S + s) * H + h
  __device__ __forceinline__ size_t vec(int r) const {
    const int row = row0 + r;
    return (static_cast<size_t>(b) * S + row / g) * H + kvh * g + row % g;
  }
  __device__ __forceinline__ int pos(int r) const {
    return len - S + (row0 + r) / g;
  }
};

// The keys [k0, k0 + kN) into a stage: keys at or past n_valid are
// zero-filled and not read.
template <int D, int kN, class St, class KV>
__device__ __forceinline__ void stage_keys(const KV& kv, unsigned char* st,
                                           int k0, int n_valid) {
  constexpr int kChunks = D * KV::kElemBytes / 16;
  for (int idx = threadIdx.x; idx < kN * kChunks; idx += kThreads) {
    const int t = idx / kChunks, ch = idx % kChunks;
    kv.template copy_chunk<D, St>(st, t, k0 + t, ch, k0 + t < n_valid);
  }
  if constexpr (KV::kScaled) {
    if (threadIdx.x < kN) {
      const int key = k0 + threadIdx.x;
      kv.template copy_scales<St>(st, threadIdx.x, key, key < n_valid);
    }
  }
}

// Output columns of one row: acc / l in bf16, or zeros where l == 0 (the
// row sees no key), the merge's arithmetic for a row block with one live
// split (whose weight is exactly 1).
__device__ __forceinline__ float out_of(float a, float l) {
  return l > 0.f ? __fdiv_rn(a, l) : 0.f;
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* dst, float a0,
                                           float a1, float l) {
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      __floats2bfloat162_rn(out_of(a0, l), out_of(a1, l));
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* dst, float a0,
                                           float a1, float a2, float a3,
                                           float l) {
  store_out2(dst, a0, a1, l);
  store_out2(dst + 2, a2, a3, l);
}

// Rows no split of which sees a key (a free slot, rows at positions below
// 0): their output is zeros.
template <int D>
__device__ __forceinline__ void write_zeros(const RowBlock& rows,
                                            __nv_bfloat16* __restrict__ o) {
  constexpr int kC = D / 8;  // 16-byte chunks of a row
  for (int idx = threadIdx.x; idx < rows.nr * kC; idx += kThreads) {
    const int r = idx / kC, c = idx % kC;
    *reinterpret_cast<uint4*>(o + rows.vec(r) * D + c * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// The keys of a block's split and the tiles it walks, from its rows'
// highest position (the causal clip), the window and the split; and how
// many of the row block's splits hold a visible key (splits [0, n_live):
// split s holds one iff its first tile does).
struct SplitRange {
  int n_valid;   // keys past the last visible one are never read
  int k_begin;   // the split's first key
  int n_tiles;   // tiles walked; <= 0: no visible key in the split
  int n_live;    // the row block's splits that hold a visible key

  __device__ __forceinline__ SplitRange(const RowBlock& rows, int n_keys,
                                        int split, int n_splits,
                                        int tiles_per_split) {
    const int last_key = min(rows.pos(rows.nr - 1), n_keys - 1);
    const int tiles_seen = last_key >= 0 ? last_key / kKeys + 1 : 0;
    const int t_begin = split * tiles_per_split;
    n_valid = last_key + 1;
    k_begin = t_begin * kKeys;
    n_tiles = min(t_begin + tiles_per_split, tiles_seen) - t_begin;
    n_live = min(n_splits,
                 (tiles_seen + tiles_per_split - 1) / tiles_per_split);
  }
};

// The decode walk (see the header): rows of one block against keys
// [0, n_keys) of the head read through kv, split `split` of
// tiles_per_split tiles. Writes the rows' partials to ws.
template <int D, int kR, class KV>
__device__ void walk_decode(unsigned char* smem, KV kv,
                            const __nv_bfloat16* __restrict__ q,
                            const RowBlock& rows, const SplitRange& range,
                            int n_keys, int split, float scale, Partials ws,
                            __nv_bfloat16* __restrict__ o) {
  using St = StageOf<KV, D>;
  // scores: the four warps share every row, lane l of warp w takes key
  // 32 w + l: each key value is used for every row
  constexpr int kKW = kThreads / 32;
  // P @ V: thread (cg, rg) takes columns [4 cg, 4 cg + 4) of rows rg,
  // rg + kRG, ... (kPR of them)
  constexpr int kCG = D / 4;
  constexpr int kRG = kThreads / kCG;
  constexpr int kPR = kR / kRG;
  static_assert(kThreads % kCG == 0 && kR % kRG == 0, "the P @ V tiling");
  static_assert(kKeys == 32 * kKW, "a key a thread");
  Smem<D, kR>& sm = *reinterpret_cast<Smem<D, kR>*>(smem);
  unsigned char* stages = smem + smem_walk_bytes<D, kR>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -CUDART_INF_F;
  const int nr = rows.nr;
  const int n_tiles = range.n_tiles;
  const size_t base = static_cast<size_t>(split) * ws.n_vec;

  for (int r = tid; r < nr; r += kThreads) {
    sm.off[r] = static_cast<long long>(rows.vec(r)) * D;
    sm.pos[r] = rows.pos(r);
    sm.m[r] = neg_inf;
    sm.l[r] = 0.f;
  }
  kv.begin(range.k_begin, n_tiles);
  __syncthreads();

  const int n_valid = range.n_valid;
  stage_keys<D, kKeys, St>(kv, stages, range.k_begin, n_valid);
  wg::cp_async_commit();
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < nr * kChunks; idx += kThreads) {
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
    const int t0 = range.k_begin + i * kKeys;
    const unsigned char* st = stages + (i & 1) * St::kBytes;
    if (i + 1 < n_tiles) {
      stage_keys<D, kKeys, St>(kv, stages + ((i + 1) & 1) * St::kBytes,
                               t0 + kKeys, n_valid);
      wg::cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t_live = min(kKeys, n_valid - t0);  // staged keys

    // 2. scores: this lane's key against every row
    {
      const int t = warp * 32 + lane, key = t0 + t;
      const bool quant = kv.is_quant(key);
      float dot[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dot[r] = 0.f;
#pragma unroll 1
      for (int c8 = 0; c8 < D / 8; ++c8) {
        float kf[8];
        kv.template key8<St>(st, t, quant, c8, kf);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= nr) break;  // the same for the whole block
          const float4 a = *reinterpret_cast<const float4*>(&sm.q[r][c8 * 8]);
          const float4 e =
              *reinterpret_cast<const float4*>(&sm.q[r][c8 * 8 + 4]);
          dot[r] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                    e.x * kf[4] + e.y * kf[5] + e.z * kf[6] + e.w * kf[7];
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < nr) {
          const bool visible = t < t_live && key < n_keys && key <= sm.pos[r];
          sm.s[r][t] = visible ? dot[r] * scale : neg_inf;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per row
    for (int r = warp; r < nr; r += kThreads / 32) {
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

  // the output itself when the split is the row block's only live one,
  // else the partials: acc unnormalised, m and l
  if (range.n_live == 1) {
#pragma unroll
    for (int i = 0; i < kPR; ++i) {
      const int r = rg + i * kRG;
      if (r < nr)
        store_out4(o + sm.off[r] + cg * 4, acc[i][0], acc[i][1], acc[i][2],
                   acc[i][3], sm.l[r]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPR; ++i) {
    const int r = rg + i * kRG;
    if (r < nr)
      *reinterpret_cast<float4*>(
          &ws.acc[(base + static_cast<size_t>(sm.off[r] / D)) * D +
                  cg * 4]) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                         acc[i][3]);
  }
  for (int r = tid; r < nr; r += kThreads) {
    const size_t i = base + static_cast<size_t>(sm.off[r] / D);
    ws.m[i] = sm.m[r];
    ws.l[i] = sm.l[r];
  }
}

// Rows [0, nr) of a chunk block into a swizzled Q tile (rows past nr are
// zeros and read nothing).
template <int D>
__device__ __forceinline__ void load_q_tile(unsigned char* dst,
                                            const __nv_bfloat16* __restrict__ q,
                                            const RowBlock& rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kMmaRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = r < rows.nr;
    const __nv_bfloat16* src = ok ? q + rows.vec(r) * D + ch * 8 : q;
    wg::cp_async16(dst + (ch >> 3) * wg::kBlockBytes + r * 128 +
                       (((ch & 7) ^ (r & 7)) << 4),
                   src, ok ? 16 : 0);
  }
}

// The int8 rows of a staged step into its bf16 tiles (exact); a mixed
// source's bf16 rows are there already.
template <int D, class St, class KV>
__device__ __forceinline__ void convert_keys(const KV& kv, unsigned char* st,
                                             int k0) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  for (int idx = threadIdx.x; idx < kSubKeys * kChunks; idx += kThreads) {
    const int t = idx / kChunks, ch = idx % kChunks;
    if (!kv.is_quant(k0 + t)) continue;
    *reinterpret_cast<uint4*>(st + St::k_at(t, ch)) = int8x8_to_bf16(
        *reinterpret_cast<const uint2*>(st + St::qk_at(t, 0) + ch * 8));
    *reinterpret_cast<uint4*>(st + St::v_at(t, ch)) = int8x8_to_bf16(
        *reinterpret_cast<const uint2*>(st + St::qv_at(t, 0) + ch * 8));
  }
}

// x0, x1 -> hi = bf16(x), lo = bf16(x - hi), packed (x0 in the low half):
// hi + lo is x to about 2^-17 of its size
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Step 3 of the chunk walk on one thread's scores (rows r0 and r1, keys
// k0 + 8 n + c + e): each key's K scale (kScaled) and the softmax scale in
// log2 units, each an explicitly rounded multiply; with kMasked, keys at
// or past n_valid or past a row's position are -inf; then the online
// softmax: m and l updated, p = 2^(x - m) in place of the scores (masked
// entries exactly 0), and the accumulators' rescale factors.
template <bool kMasked, bool kScaled>
__device__ __forceinline__ void softmax_step(
    float (&s)[8][4], const float* ks, float scale_log2, int k0, int c,
    int n_valid, int pos0, int pos1, float& m0, float& m1, float& l0,
    float& l1, float& alpha0, float& alpha1) {
  const float neg_inf = -CUDART_INF_F;
  float mx0 = neg_inf, mx1 = neg_inf;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = n * 8 + c + e, key = k0 + t;
      float x0 = s[n][e], x1 = s[n][2 + e];
      if constexpr (kScaled) {
        x0 = __fmul_rn(x0, ks[t]);
        x1 = __fmul_rn(x1, ks[t]);
      }
      x0 = __fmul_rn(x0, scale_log2);
      x1 = __fmul_rn(x1, scale_log2);
      if constexpr (kMasked) {
        const bool live = key < n_valid;
        x0 = live && key <= pos0 ? x0 : neg_inf;
        x1 = live && key <= pos1 ? x1 : neg_inf;
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
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // unmasked, every score is finite and so is the new max
  alpha0 = kMasked && mn0 == neg_inf ? 1.f : exp2f(m0 - mn0);
  alpha1 = kMasked && mn1 == neg_inf ? 1.f : exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p0 = exp2f(s[n][e] - m0), p1 = exp2f(s[n][2 + e] - m1);
      if constexpr (kMasked) {
        p0 = s[n][e] == neg_inf ? 0.f : p0;
        p1 = s[n][2 + e] == neg_inf ? 0.f : p1;
      }
      sum0 += p0;
      sum1 += p1;
      s[n][e] = p0;
      s[n][2 + e] = p1;
    }
  }
  l0 = __fmaf_rn(l0, alpha0, sum0);
  l1 = __fmaf_rn(l1, alpha1, sum1);
}

// The chunk walk (see the header): 64 rows of one block, one warpgroup,
// against keys [0, n_keys) of the head read through kv, split `split` of
// tiles_per_split tiles, in 64-key steps. Thread (warp w, lane l) holds
// rows 16 w + l / 4 and + 8 of every accumulator (wgmma_tile.cuh). Writes
// the rows' partials to ws.
template <int D, class KV>
__device__ void walk_chunk(unsigned char* smem, KV kv,
                           const __nv_bfloat16* __restrict__ q,
                           const RowBlock& rows, const SplitRange& range,
                           int split, float scale, Partials ws,
                           __nv_bfloat16* __restrict__ o) {
  using St = MmaStage<D, KV::kScaled>;
  constexpr int kNB = D / 64;  // 64-column blocks of the head dim
  constexpr int kDK = D / 16;  // 16-deep steps over the head dim
  const float neg_inf = -CUDART_INF_F;
  unsigned char* qs = wg::align1024(smem);
  unsigned char* stages = qs + St::kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = 2 * (lane & 3);
  const size_t base = static_cast<size_t>(split) * ws.n_vec;
  kv.begin(range.k_begin, range.n_tiles);
  __syncthreads();
  const int n_valid = range.n_valid;
  const int n_steps =
      (min(range.k_begin + range.n_tiles * kKeys, n_valid) - range.k_begin +
       kSubKeys - 1) / kSubKeys;
  load_q_tile<D>(qs, q, rows);
  stage_keys<D, kSubKeys, St>(kv, stages, range.k_begin, n_valid);
  wg::cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int pos0 = r0 < rows.nr ? rows.pos(r0) : -1;
  const int pos1 = r1 < rows.nr ? rows.pos(r1) : -1;
  const int pos_min = rows.pos(0);  // the block's lowest row position
  const float scale_log2 = __fmul_rn(scale, kLog2e);
  float acc[kNB][8][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[nb][n][0] = acc[nb][n][1] = acc[nb][n][2] = acc[nb][n][3] = 0.f;
  // rows r0 and r1: running max (log2 units), and this thread's part of
  // the sum
  float m0 = neg_inf, m1 = neg_inf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int k0 = range.k_begin + i * kSubKeys;
    unsigned char* st = stages + (i & 1) * St::kBytes;
    if (i + 1 < n_steps) {
      stage_keys<D, kSubKeys, St>(kv, stages + ((i + 1) & 1) * St::kBytes,
                                  k0 + kSubKeys, n_valid);
      wg::cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (KV::kScaled) {
      __syncthreads();  // every thread's int8 rows have landed
      convert_keys<D, St>(kv, st, k0);
    }
    // the copies and the converted rows, visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* ks = reinterpret_cast<const float*>(st + St::kKs);
    const float* vs = reinterpret_cast<const float*>(st + St::kVs);

    // 2. S = Q K^T: 64 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk)
      wg::wgmma_ss(s, wg::desc_k(qs, kk), wg::desc_k(st + St::kK, kk),
                   kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(s);

    // 3. scales, mask, online softmax (p in s, fp32); a step whose keys
    // every row sees needs no mask
    float alpha0, alpha1;
    if (k0 + kSubKeys <= n_valid && k0 + kSubKeys - 1 <= pos_min) {
      softmax_step<false, KV::kScaled>(s, ks, scale_log2, k0, c, n_valid,
                                       pos0, pos1, m0, m1, l0, l1, alpha0,
                                       alpha1);
    } else {
      softmax_step<true, KV::kScaled>(s, ks, scale_log2, k0, c, n_valid,
                                      pos0, pos1, m0, m1, l0, l1, alpha0,
                                      alpha1);
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[nb][n][0] *= alpha0;
        acc[nb][n][1] *= alpha0;
        acc[nb][n][2] *= alpha1;
        acc[nb][n][3] *= alpha1;
      }
      wg::fence_regs(acc[nb]);
    }

    // 4. O += (p vs) V, p vs as bf16 hi + lo, register A operands
    if constexpr (KV::kScaled) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = vs[n * 8 + c + e];
          s[n][e] = __fmul_rn(s[n][e], v);
          s[n][2 + e] = __fmul_rn(s[n][2 + e], v);
        }
    }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
    }
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const uint64_t dv = wg::desc_mn(st + St::kV, kk, nb);
        wg::wgmma_rs(acc[nb], hi[kk], dv, 1);
        wg::wgmma_rs(acc[nb], lo[kk], dv, 1);
      }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) wg::fence_regs(acc[nb]);
    __syncthreads();  // this stage is free for step i + 2
  }

  // the partials: the row sums over the quad, acc unnormalised, m and l
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows.nr) continue;
    if (range.n_live == 1) {  // the output itself, as in the decode walk
      __nv_bfloat16* dst = o + rows.vec(r) * D;
      const float l = half ? l1 : l0;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store_out2(dst + nb * 64 + n * 8 + c, acc[nb][n][2 * half],
                     acc[nb][n][2 * half + 1], l);
      continue;
    }
    const size_t at = base + rows.vec(r);
    float* dst = ws.acc + at * D;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(dst + nb * 64 + n * 8 + c) =
            make_float2(acc[nb][n][2 * half], acc[nb][n][2 * half + 1]);
    if ((lane & 3) == 0) {  // m in natural units, as the merge takes it
      ws.m[at] = __fmul_rn(half ? m1 : m0, kLn2);
      ws.l[at] = half ? l1 : l0;
    }
  }
}

// The merge, folded into the walk: a block of a split that holds a visible
// key counts itself once its partials are visible (the barrier, then one
// thread's fence, as a grid-wide sync does); the one that brings the
// counter to n_live merges the row block's splits [0, n_live) in split
// order (rescaled to the largest m, o = acc / l, or zeros where l == 0: a
// row no split of which sees a key), writes o and resets the counter. The
// partials are read past L1, which no other block's writes reach.
template <int D>
__device__ void merge_if_last(SplitHead& head, const RowBlock& rows,
                              Partials ws, int n_live, int* counter,
                              __nv_bfloat16* __restrict__ o) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    head.last = atomicAdd(counter, 1) == n_live - 1;
    if (head.last) __threadfence();
  }
  __syncthreads();
  if (!head.last) return;
  const float neg_inf = -CUDART_INF_F;
  constexpr int kC = D / 4;  // 4 columns a thread
  for (int idx = threadIdx.x; idx < rows.nr * kC; idx += kThreads) {
    const int r = idx / kC, c4 = idx % kC;
    const size_t vec = rows.vec(r);
    // the loops are unrolled and every live split wrote every row's
    // partials, so that a thread's loads of several splits are in flight
    // at once; a split in which the row sees no key weighs 0
    float m = neg_inf;
#pragma unroll 4
    for (int i = 0; i < n_live; ++i)
      m = fmaxf(m, __ldcg(ws.m + static_cast<size_t>(i) * ws.n_vec + vec));
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_live; ++i) {
      const size_t at = static_cast<size_t>(i) * ws.n_vec + vec;
      const float mi = __ldcg(ws.m + at);
      const float li = __ldcg(ws.l + at);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(ws.acc + at * D) + c4);
      const float w = mi != neg_inf ? expf(mi - m) : 0.f;
      l = __fmaf_rn(li, w, l);
      a.x = __fmaf_rn(x.x, w, a.x);
      a.y = __fmaf_rn(x.y, w, a.y);
      a.z = __fmaf_rn(x.z, w, a.z);
      a.w = __fmaf_rn(x.w, w, a.w);
    }
    store_out4(o + vec * D + c4 * 4, a.x, a.y, a.z, a.w, l);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// One block of a C launch, grid (row blocks x n_splits, Hkv, B), split
// fastest: its walk (decode rows on the fp32 pipes when kR is kSmallRows,
// chunk rows on wgmma when kR is kMmaRows), then the merge if it is the
// last of its row block. counters: one int32 per (slot, kv head, row
// block), zero between launches.
template <int D, int kR, class KV>
__device__ __forceinline__ void attend(
    unsigned char* smem, KV kv, const __nv_bfloat16* __restrict__ q, int b,
    int kvh, int S, int H, int Hkv, int len, int n_keys, int n_splits,
    int tiles_per_split, float scale, Partials ws, int* counters,
    __nv_bfloat16* __restrict__ o) {
  static_assert(kR == kSmallRows || kR == kMmaRows, "a row tile of C");
  const int split = static_cast<int>(blockIdx.x) % n_splits;
  const int blk = static_cast<int>(blockIdx.x) / n_splits;
  const int g = H / Hkv;
  const RowBlock rows{b, kvh, blk * kR, min(kR, S * g - blk * kR), S, H, g,
                      len};
  const SplitRange range(rows, n_keys, split, n_splits, tiles_per_split);
  if (range.n_tiles <= 0) {  // this split holds no visible key
    if (range.n_live == 0 && split == 0) write_zeros<D>(rows, o);
    return;
  }
  if constexpr (kR == kMmaRows) {
    walk_chunk<D>(smem + kHeadBytes, kv, q, rows, range, split, scale, ws,
                  o);
  } else {
    walk_decode<D, kR>(smem + kHeadBytes, kv, q, rows, range, n_keys, split,
                       scale, ws, o);
  }
  if (range.n_live == 1) return;  // the walk wrote the output
  const int row_blocks = (S * g + kR - 1) / kR;
  merge_if_last<D>(*reinterpret_cast<SplitHead*>(smem), rows, ws,
                   range.n_live,
                   counters + (static_cast<size_t>(b) * Hkv + kvh) *
                                  row_blocks + blk,
                   o);
}

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
