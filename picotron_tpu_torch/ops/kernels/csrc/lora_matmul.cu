// Kernel H: the segmented multi-LoRA residual, written by hand for Hopper
// (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/lora_matmul.py::_lora_kernel (:78),
// reached through lora_matmul_pallas (:92, pallas_call :110). Same function:
// out[b] = (x[b] @ a[ids[b]]) @ b[ids[b]] for x [B, S, K] (bf16 or fp32), a
// stacked pack of adapters a [T, K, R] and b [T, R, N] in fp32, ids [B]
// int32, out [B, S, N] fp32. Both contractions accumulate in fp32. Slot 0
// is the null adapter: its rows come out exactly 0.0, and so do rows whose
// id lies outside [0, T) (the engine refuses such ids before a launch; the
// kernel never reads the pack through one).
//
// Like the Pallas kernel, which steers each grid instance's A/B blocks with
// a scalar-prefetched id, every block here reads its row's id from device
// memory and indexes the pack in place: no gathered copy of an adapter is
// ever made. Two launches per call (Punica's shrink and expand):
//
//   shrink: one block per (S tile of TS rows, K split of k_split columns,
//           batch row b) streams x[b]'s tile and a[ids[b]] over its K
//           split and writes that split's partial t = x @ a, [KS, B, S, R]
//           fp32 (KS = ceil(K / k_split)), into a scratch the wrapper
//           allocates. Thread i owns rank column r = i % RMAX and
//           contraction lane i / RMAX: it sums its lane's products for
//           each row of the tile; the lanes' sums are then added in a fixed
//           order through shared memory (no atomics: the result does not
//           depend on scheduling). x is staged 128 columns at a time, so a
//           512 x 8192 chunk never sits whole in shared memory. Splitting
//           K puts K / k_split blocks on every decode row instead of one.
//   expand: one block per (N tile of 256 columns, S tile of 16 rows, batch
//           row b) first adds the KS partials of its rows of t in split
//           order (t is complete over K only here, after the shrink
//           launch has ended), then each thread keeps its column of
//           b[ids[b]] (R values) in registers and writes out[b, s, n] =
//           sum_r t[b, s, r] * b[id, r, n] for the tile's rows.
//
// What bounds it on this card: bytes. A call reads x once, each distinct
// adapter's a and b (at R = 16, (K + N) * 64 bytes), and writes the fp32
// output, for 2 * B * S * (K + N) * R operations: at most about 32 FLOPs
// per byte at S = 512 and 2 at decode. This first kernel runs its
// products as fp32 FMAs (R = 16 is too narrow to fill a tensor-core tile
// along the rank), reads an adapter once per row that uses it (rows that
// share one hit L2) and pays for R's zero columns when a tenant's rank is
// below the pack's. Tensor cores, TMA and fusing the residual into the base
// product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkK = 128;  // columns of x staged per shrink step
constexpr int kExpandRows = 16;  // rows of one expand block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int TS, int RMAX>
__global__ void __launch_bounds__(kThreads)
    lora_shrink_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const int* __restrict__ ids, float* __restrict__ t,
                       int B, int S, int K, int R, int n_adapters,
                       int k_split) {
  constexpr int KL = kThreads / RMAX;  // contraction lanes
  __shared__ float xs[TS][kChunkK];
  __shared__ float red[KL][TS][RMAX];
  const int b = blockIdx.z;
  const int id = ids[b];
  // a null (or refused) row: the expand writes its zeros and never reads
  // its rows of t
  if (id <= 0 || id >= n_adapters) return;
  const int s0 = blockIdx.x * TS;
  const int rows = min(TS, S - s0);
  const int k_begin = blockIdx.y * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int r = threadIdx.x % RMAX;
  const int lane = threadIdx.x / RMAX;
  const T* xb = x + (static_cast<size_t>(b) * S + s0) * K;
  const float* ab = a + static_cast<size_t>(id) * K * R;
  float acc[TS];
#pragma unroll
  for (int s = 0; s < TS; ++s) acc[s] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kChunkK) {
    const int kc = min(kChunkK, k_end - k0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < TS * kChunkK; i += kThreads) {
      const int s = i / kChunkK, k = i % kChunkK;
      xs[s][k] = (s < rows && k < kc)
                     ? to_float(xb[static_cast<size_t>(s) * K + k0 + k])
                     : 0.f;
    }
    __syncthreads();
    if (r < R) {
      for (int k = lane; k < kc; k += KL) {
        const float av = ab[static_cast<size_t>(k0 + k) * R + r];
#pragma unroll
        for (int s = 0; s < TS; ++s) acc[s] = fmaf(xs[s][k], av, acc[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < TS; ++s) red[lane][s][r] = acc[s];
  __syncthreads();
  for (int i = threadIdx.x; i < TS * RMAX; i += kThreads) {
    const int s = i / RMAX, rr = i % RMAX;
    if (s < rows && rr < R) {
      float sum = 0.f;
      for (int l = 0; l < KL; ++l) sum += red[l][s][rr];
      t[((static_cast<size_t>(blockIdx.y) * B + b) * S + s0 + s) * R + rr] =
          sum;
    }
  }
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
    lora_expand_kernel(const float* __restrict__ t,
                       const float* __restrict__ bm,
                       const int* __restrict__ ids, float* __restrict__ out,
                       int B, int S, int N, int R, int n_adapters,
                       int n_splits) {
  __shared__ float ts[kExpandRows][RMAX];
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * kExpandRows;
  const int rows = min(kExpandRows, S - s0);
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int id = ids[b];
  float* ob = out + (static_cast<size_t>(b) * S + s0) * N;
  if (id <= 0 || id >= n_adapters) {  // the whole block takes this branch
    if (n < N)
      for (int s = 0; s < rows; ++s) ob[static_cast<size_t>(s) * N + n] = 0.f;
    return;
  }
  for (int i = threadIdx.x; i < kExpandRows * RMAX; i += kThreads) {
    const int s = i / RMAX, r = i % RMAX;
    float sum = 0.f;
    if (s < rows && r < R)
      for (int k = 0; k < n_splits; ++k)
        sum += t[((static_cast<size_t>(k) * B + b) * S + s0 + s) * R + r];
    ts[s][r] = sum;
  }
  __syncthreads();
  if (n >= N) return;
  const float* bb = bm + static_cast<size_t>(id) * R * N;
  float bc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    bc[r] = r < R ? bb[static_cast<size_t>(r) * N + n] : 0.f;
  for (int s = 0; s < rows; ++s) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc = fmaf(ts[s][r], bc[r], acc);
    ob[static_cast<size_t>(s) * N + n] = acc;
  }
}

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const int* ids;
  float* t;
  float* out;
  int B, S, K, N, R, n_adapters, k_split;
};

template <typename T, int RMAX>
int launch(const Args& p, cudaStream_t st) {
  const T* xp = static_cast<const T*>(p.x);
  const int n_splits = (p.K + p.k_split - 1) / p.k_split;
  if (p.S == 1) {
    lora_shrink_kernel<T, 1, RMAX><<<dim3(1, n_splits, p.B), kThreads, 0,
                                     st>>>(xp, p.a, p.ids, p.t, p.B, p.S,
                                           p.K, p.R, p.n_adapters,
                                           p.k_split);
  } else {
    lora_shrink_kernel<T, 16, RMAX><<<dim3((p.S + 15) / 16, n_splits, p.B),
                                      kThreads, 0, st>>>(
        xp, p.a, p.ids, p.t, p.B, p.S, p.K, p.R, p.n_adapters, p.k_split);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lora_expand_kernel<RMAX><<<dim3((p.N + kThreads - 1) / kThreads,
                                  (p.S + kExpandRows - 1) / kExpandRows, p.B),
                             kThreads, 0, st>>>(p.t, p.b, p.ids, p.out, p.B,
                                                p.S, p.N, p.R, p.n_adapters,
                                                n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rank(const Args& p, cudaStream_t st) {
  if (p.R <= 16) return launch<T, 16>(p, st);
  if (p.R <= 32) return launch<T, 32>(p, st);
  if (p.R <= 64) return launch<T, 64>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [B, S, K] bf16 (x_bf16 != 0) or fp32; a: [T, K, R] fp32; b: [T, R, N]
// fp32; ids: [B] int32; t: scratch of [ceil(K / k_split), B, S, R] fp32;
// out: [B, S, N] fp32; all contiguous on one device; B, S, K, N > 0,
// 1 <= R <= 64, k_split > 0 a multiple of 128.
extern "C" int picotron_lora_matmul(const void* x, const void* a,
                                    const void* b, const void* ids, void* t,
                                    void* out, int B, int S, int K, int N,
                                    int R, int n_adapters, int k_split,
                                    int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{x, static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const int*>(ids), static_cast<float*>(t),
               static_cast<float*>(out), B, S, K, N, R, n_adapters, k_split};
  if (x_bf16) return launch_rank<__nv_bfloat16>(p, st);
  return launch_rank<float>(p, st);
}
