// Kernel H: the segmented multi-LoRA residual, written by hand for Hopper
// (sm_90a), in one launch that can add the residual into the base output.
//
// Replaces picotron_tpu/ops/pallas/lora_matmul.py::_lora_kernel (:78),
// reached through lora_matmul_pallas (:92, pallas_call :110). Same function:
// r[b] = (x[b] @ a[ids[b]]) @ b[ids[b]] for x [B, S, K] (bf16 or fp32), a
// stacked pack of adapters a [T, K, R] and b [T, R, N] in fp32, ids [B]
// int32. Both contractions accumulate in fp32. Slot 0 is the null adapter,
// and so is any id outside [0, T) (the engine refuses such ids before a
// launch; the kernel never reads the pack through one). Two modes, one
// kernel:
//
//   residual: out [B, S, N] fp32 = r; a null row's entries are 0.0;
//   fused:    base [B, S, N] (x's dtype) += r in place, rounded as
//             PyTorch rounds base + r.to(base.dtype): for bf16,
//             bf16(float(base) + float(bf16(r))), bit for bit; a null row
//             is left as it is (adding an exact zero changes at most the
//             sign of a zero).
//
// What bounds it on this card: neither bytes nor operations but latency.
// A call reads x, each distinct adapter's a and b ((K + N) * R * 4 bytes)
// and the base, for 2 * B * S * (K + N) * R operations (2 MFLOP at decode,
// 67 at a 512-row chunk, where the card's floor is a couple of us), so
// every launch and every trip through device memory counts: a shrink and
// an expand launch with a global scratch between them, and a cast and an
// add at the model's seam, would be four kernels and four allocations a
// call where this is one kernel and none.
//
// Design: one thread-block cluster of C blocks (C <= 8, the plan's) per
// (batch row, tile of TS rows). Rank c of the cluster
//   1. loads its slice of b[id] (one column per thread) and, fused at
//      decode, the base entry it will update, before anything else, so
//      those reads overlap the shrink;
//   2. shrinks over its slice of K: a thread owns 4 ranks of 1 row (at
//      decode, x read straight from memory) or of 4 rows (x staged as
//      stored in shared memory, 32 KB a step) for one contraction lane,
//      sums its lane's products in order with the adapter's 4 columns
//      loaded 16 bytes at a time, and the lanes' sums are added in a
//      fixed order through shared memory into the block's [TS, RMAX]
//      partial t_c;
//   3. after a cluster barrier, adds t_0 .. t_{C-1} in rank order through
//      distributed shared memory, so every block holds the same full t
//      (no float atomics: the result does not depend on scheduling);
//   4. expands its slice of N (a column of b[id] in registers a thread,
//      fmaf over r in order) and writes out, or updates base in place.
// A second cluster barrier (arrived at after step 3, waited for before the
// block exits) keeps every block's t_c alive until the others have read
// it. Nothing is allocated per call: the fused mode writes only base.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // portable cluster size

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// base + r, rounded as PyTorch rounds base + r.to(base.dtype)
__device__ __forceinline__ float fused(float base, float r) {
  return __fadd_rn(base, r);
}
__device__ __forceinline__ __nv_bfloat16 fused(__nv_bfloat16 base, float r) {
  return __float2bfloat16_rn(__fadd_rn(
      __bfloat162float(base), __bfloat162float(__float2bfloat16_rn(r))));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four adapter columns of row k (a [K, R] slice): one 16-byte load where
// R % 4 == 0, else one at a time; ranks at or past R are zeros.
__device__ __forceinline__ float4 load_a4(const float* __restrict__ ab, int k,
                                          int r0, int R, bool vec) {
  const float* p = ab + static_cast<size_t>(k) * R + r0;
  if (vec) return r0 < R ? __ldg(reinterpret_cast<const float4*>(p))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(r0 < R ? __ldg(p) : 0.f, r0 + 1 < R ? __ldg(p + 1) : 0.f,
                     r0 + 2 < R ? __ldg(p + 2) : 0.f,
                     r0 + 3 < R ? __ldg(p + 3) : 0.f);
}

// T: x's element type (and base's, fused). TS: rows of a tile (1 at
// decode). RMAX: the rank tile (>= the pack's rank R). out: fp32 [B, S, N]
// (residual) or the base [B, S, N] of type T (fused).
//
// The shrink's threads: each owns RT rows x 4 ranks of the tile (RT = 4
// for TS = 16, 1 at decode) in registers, for the contraction lane
// tid / P (P threads cover the tile), and sums its lane's k in order.
template <typename T, bool kFused, int TS, int RMAX>
__global__ void __launch_bounds__(kThreads)
    lora_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bm, const int* __restrict__ ids,
                void* __restrict__ out, int S, int K, int N, int R,
                int n_adapters) {
  constexpr int RT = TS == 1 ? 1 : 4;    // rows a thread
  constexpr int GR = RMAX / 4;           // rank groups of 4
  constexpr int P = (TS / RT) * GR;      // threads a lane
  constexpr int KL = kThreads / P;       // contraction lanes
  constexpr int kVec = 16 / sizeof(T);   // x elements in 16 bytes
  // x columns staged a step (TS > 1): 32 KB of x as stored, each row
  // padded by 16 bytes
  constexpr int kChunk = 32768 / (TS * sizeof(T));
  constexpr int kPitch = kChunk + kVec;
  constexpr int kXsBytes = TS == 1 ? 0 : TS * kPitch * sizeof(T);
  constexpr int kRedBytes = KL * TS * RMAX * 4;
  // the staged x and, after the shrink, the lanes' sums share one buffer
  __shared__ __align__(16)
      unsigned char stage[kXsBytes > kRedBytes ? kXsBytes : kRedBytes];
  __shared__ float part[TS][RMAX];  // this block's t_c, read by the cluster
  __shared__ __align__(16) float tf[TS][RMAX];  // the full t
  T* xs = reinterpret_cast<T*>(stage);
  float* red = reinterpret_cast<float*>(stage);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS;
  const int rows = min(TS, S - s0);
  const int nc = (N + C - 1) / C;  // this rank's columns [n_lo, n_hi)
  const int n_lo = min(N, c * nc), n_hi = min(N, n_lo + nc);
  const int id = ids[b];
  const size_t row0 = static_cast<size_t>(b) * S + s0;  // out's first row

  if (id <= 0 || id >= n_adapters) {  // every block of the cluster returns
    if constexpr (!kFused) {
      float* o = static_cast<float*>(out) + row0 * N;
      for (int n = n_lo + threadIdx.x; n < n_hi; n += kThreads)
        for (int s = 0; s < rows; ++s) o[static_cast<size_t>(s) * N + n] = 0.f;
    }
    return;
  }

  // 1. this thread's first column of b[id] and, fused at decode, of the
  // base
  const float* bb = bm + static_cast<size_t>(id) * R * N;
  const int n_first = n_lo + threadIdx.x;
  float bc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    bc[r] = (r < R && n_first < n_hi) ? bb[static_cast<size_t>(r) * N + n_first]
                                      : 0.f;
  T* base = static_cast<T*>(out) + row0 * N;
  T pre = T(0.f);
  if constexpr (kFused && TS == 1) {
    if (n_first < n_hi) pre = base[n_first];
  }

  // 2. the shrink over this rank's slice of K
  const int kc = ((K + C - 1) / C + 7) / 8 * 8;
  const int k_begin = min(K, c * kc), k_end = min(K, k_begin + kc);
  const int p = threadIdx.x % P, lane = threadIdx.x / P;
  const int sg = p / GR, r0 = 4 * (p % GR);
  const bool vec_a = R % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const T* xb = x + row0 * K;
  const float* ab = a + static_cast<size_t>(id) * K * R;
  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if constexpr (TS == 1) {
    // one row: x straight from memory (the P threads of a lane share it)
#pragma unroll 4
    for (int k = k_begin + lane; k < k_end; k += KL) {
      const float xv = to_float(xb[k]);
      const float4 av = load_a4(ab, k, r0, R, vec_a);
      acc[0][0] = fmaf(xv, av.x, acc[0][0]);
      acc[0][1] = fmaf(xv, av.y, acc[0][1]);
      acc[0][2] = fmaf(xv, av.z, acc[0][2]);
      acc[0][3] = fmaf(xv, av.w, acc[0][3]);
    }
  } else {
    // k_begin is a multiple of 8: rows of x copy 16 bytes at a time where
    // K and the pointer allow it
    const bool vec_x = K % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
    for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
      const int kw = min(kChunk, k_end - k0);
      if (k0 != k_begin) __syncthreads();  // the last step's reads are done
      // the step's kw columns of every row (rows past the tile: zeros)
      if (vec_x) {
        const int row_vecs = kw / kVec;  // kw is a multiple of kVec here
        for (int i = threadIdx.x; i < TS * row_vecs; i += kThreads) {
          const int s = i / row_vecs, k = (i % row_vecs) * kVec;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (s < rows)
            v = *reinterpret_cast<const uint4*>(
                xb + static_cast<size_t>(s) * K + k0 + k);
          *reinterpret_cast<uint4*>(xs + s * kPitch + k) = v;
        }
      } else {
        for (int i = threadIdx.x; i < TS * kw; i += kThreads) {
          const int s = i / kw, k = i % kw;
          xs[s * kPitch + k] =
              s < rows ? xb[static_cast<size_t>(s) * K + k0 + k] : T(0.f);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int k = lane; k < kw; k += KL) {
        const float4 av = load_a4(ab, k0 + k, r0, R, vec_a);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float xv = to_float(xs[(RT * sg + i) * kPitch + k]);
          acc[i][0] = fmaf(xv, av.x, acc[i][0]);
          acc[i][1] = fmaf(xv, av.y, acc[i][1]);
          acc[i][2] = fmaf(xv, av.z, acc[i][2]);
          acc[i][3] = fmaf(xv, av.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // every read of xs is done: red takes its place
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(lane * TS + RT * sg + i) * RMAX + r0 + j] = acc[i][j];
  __syncthreads();
  for (int i = threadIdx.x; i < TS * RMAX; i += kThreads) {
    float sum = 0.f;
    for (int l = 0; l < KL; ++l) sum += red[l * TS * RMAX + i];
    part[i / RMAX][i % RMAX] = sum;
  }

  // 3. t = t_0 + ... + t_{C-1}, in rank order, from every block's part
  cluster.sync();
  for (int i = threadIdx.x; i < TS * RMAX; i += kThreads) {
    const int s = i / RMAX, rr = i % RMAX;
    float sum = 0.f;
    for (int q = 0; q < C; ++q)
      sum += cluster.map_shared_rank(&part[0][0], q)[s * RMAX + rr];
    tf[s][rr] = sum;
  }
  cluster_arrive();  // this block has read every other block's part
  __syncthreads();

  // 4. the expand over this rank's columns (r in order), and the epilogue;
  // a fused tile's base rows load four at a time ahead of their sums
  for (int n = n_first; n < n_hi; n += kThreads) {
    if (n != n_first) {
#pragma unroll
      for (int rr = 0; rr < RMAX; ++rr)
        bc[rr] = rr < R ? bb[static_cast<size_t>(rr) * N + n] : 0.f;
    }
#pragma unroll 1
    for (int s4 = 0; s4 < rows; s4 += RT) {
      T pv[RT];
      if constexpr (kFused) {
        if constexpr (TS == 1) {
          pv[0] = n == n_first ? pre : base[n];
        } else {
#pragma unroll
          for (int i = 0; i < RT; ++i)
            pv[i] = s4 + i < rows ? base[static_cast<size_t>(s4 + i) * N + n]
                                  : T(0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int s = s4 + i;
        if (s < rows) {
          float v = 0.f;
#pragma unroll
          for (int r4 = 0; r4 < RMAX; r4 += 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(&tf[s][r4]);
            v = fmaf(t4.x, bc[r4], v);
            v = fmaf(t4.y, bc[r4 + 1], v);
            v = fmaf(t4.z, bc[r4 + 2], v);
            v = fmaf(t4.w, bc[r4 + 3], v);
          }
          const size_t at = static_cast<size_t>(s) * N + n;
          if constexpr (kFused) {
            base[at] = fused(pv[i], v);
          } else {
            static_cast<float*>(out)[row0 * N + at] = v;
          }
        }
      }
    }
  }
  cluster_wait();  // no block's part is read any more: safe to exit
}

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const int* ids;
  void* out;
  int B, S, K, N, R, n_adapters, rows, cluster;
};

template <typename T, bool kFused, int TS, int RMAX>
int launch(const Args& p, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, (p.S + TS - 1) / TS, p.B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, lora_kernel<T, kFused, TS, RMAX>, static_cast<const T*>(p.x),
      p.a, p.b, p.ids, p.out, p.S, p.K, p.N, p.R, p.n_adapters);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFused, int TS>
int launch_rank(const Args& p, cudaStream_t st) {
  if (p.R <= 16) return launch<T, kFused, TS, 16>(p, st);
  if (p.R <= 32) return launch<T, kFused, TS, 32>(p, st);
  if (p.R <= 64) return launch<T, kFused, TS, 64>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kFused>
int launch_rows(const Args& p, cudaStream_t st) {
  if (p.rows == 1) return launch_rank<T, kFused, 1>(p, st);
  if (p.rows == 16) return launch_rank<T, kFused, 16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [B, S, K] bf16 (x_bf16 != 0) or fp32; a: [T, K, R] fp32; b: [T, R, N]
// fp32; ids: [B] int32; out: [B, S, N] fp32 (fused == 0) or the base [B, S,
// N] of x's dtype, updated in place (fused != 0); all contiguous on one
// device; B, S, K, N > 0, 1 <= R <= 64; rows (the plan's row tile) 1 or
// 16; cluster (the plan's blocks a cluster) 1 to 8.
extern "C" int picotron_lora_matmul(const void* x, const void* a,
                                    const void* b, const void* ids, void* out,
                                    int B, int S, int K, int N, int R,
                                    int n_adapters, int rows, int cluster,
                                    int fused, int x_bf16, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const int*>(ids), out, B, S, K, N, R, n_adapters,
               rows, cluster};
  if (x_bf16)
    return fused ? launch_rows<__nv_bfloat16, true>(p, st)
                 : launch_rows<__nv_bfloat16, false>(p, st);
  return fused ? launch_rows<float, true>(p, st)
               : launch_rows<float, false>(p, st);
}
