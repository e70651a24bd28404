// Kernel A: RMSNorm forward, and kernel D: its backward, written by hand
// for Hopper (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/rmsnorm.py::_fwd_kernel (:34), reached
// through _run_fwd (:58) and rms_norm_pallas (:109). Same numerics as the
// plain version (ops/rmsnorm.py): per row, the fp32 mean of x*x, then
// x * rsqrt(var + eps) rounded to bf16, then that times the weight rounded
// to bf16 again (the multiply in the input dtype).
//
// What bounds it on this card: bytes. Each row is read, reduced and
// written once, a few operations per byte (far below the ~295 FLOP/byte
// at which an H100 stops being memory bound), so the least time is
// (2 * rows * H + H) * 2 bytes / 3.35 TB/s. The design does the one
// thing that matters for that: one block of 256 threads per row, every
// access a 16-byte vector of 8 bf16 values with neighbouring threads on
// neighbouring addresses, the sum of squares kept in registers and one
// warp-shuffle reduction. The second pass re-reads the row, which at
// H = 2048 (4 KB) is still in L1/L2, so device memory sees each byte once.
// The TPU kernel's row blocks sized for VMEM have no counterpart: a row
// is tiny next to a block's registers.
//
// Kernel D replaces picotron_tpu/ops/pallas/rmsnorm.py::_bwd_kernel (:41),
// reached through _bwd_rule (:82). Per row, in fp32 (the formula of
// :46-55): r = rsqrt(mean(x^2) + eps), xhat = x * r, dxhat = dy * w,
//   dx = r * (dxhat - xhat * mean(dxhat * xhat)),
// and dw = sum over rows of dy * xhat, cast to w's dtype (:103). The TPU
// kernel sums dw into one output block across grid steps, which is
// race-free only because a TPU grid runs in order. Here blocks run in
// parallel, so each block of rows writes its own fp32 partial dw
// row, and a second kernel sums the partial rows column by column, in a
// fixed order: deterministic, and no float atomics.
//
// What bounds D: bytes, as for A. It reads x and dy and writes dx (2 bytes
// each per element), a few operations per byte. The partial rows add
// (blocks * H * 4 bytes) written and read once (at 8192 rows and
// H = 2048, 2 MB next to 100 MB). One block of 256 threads walks its rows
// one at a time with 16-byte accesses: a first pass sums x^2 and
// dxhat * x together (mean(dxhat * xhat) = r * mean(dxhat * x)), a second
// writes dx and adds dy * xhat into the block's dw columns, which sit in
// shared memory, each column owned by one thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values per 16-byte access

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int h, float eps) {
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * h);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + row * h);
  const int nvec = h / kVec;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 u = xr[i];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  __shared__ float red[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(red[0] / static_cast<float>(h) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 u = xr[i];
    const uint4 wu = wr[i];
    uint4 o;
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&u);
    const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&wu);
    __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float n = __bfloat162float(
          __float2bfloat16(__bfloat162float(xe[j]) * r));
      oe[j] = __float2bfloat16(n * __bfloat162float(we[j]));
    }
    yr[i] = o;
  }
}

// Sum a pair over the block; every thread gets both sums.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
  }
  __syncthreads();  // red is reused by the next row
  return t;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ dw_partial, int rows,
                   int rows_per_block, int h, float eps) {
  extern __shared__ __align__(16) float dw_acc[];  // [h]
  __shared__ float2 red[kThreads / 32];
  const int nvec = h / kVec;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  for (int i = threadIdx.x; i < h; i += kThreads) dw_acc[i] = 0.f;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row0 + rows_per_block);
  for (int row = row0; row < row_end; ++row) {
    const size_t base = static_cast<size_t>(row) * h;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + base);
    uint4* dxr = reinterpret_cast<uint4*>(dx + base);
    float ss = 0.f, sdx = 0.f;  // sum x^2, sum dxhat * x
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 xu = xr[i], du = dyr[i], wu = wr[i];
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xu);
      const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&du);
      const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&wu);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xv = __bfloat162float(xe[j]);
        ss += xv * xv;
        sdx += __bfloat162float(de[j]) * __bfloat162float(we[j]) * xv;
      }
    }
    const float2 sums = block_sum2(ss, sdx, red);
    const float r = 1.0f / sqrtf(sums.x / static_cast<float>(h) + eps);
    const float c = r * sums.y / static_cast<float>(h);  // mean(dxhat*xhat)
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 xu = xr[i], du = dyr[i], wu = wr[i];
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xu);
      const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&du);
      const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&wu);
      uint4 o;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = __bfloat162float(xe[j]) * r;
        const float dyv = __bfloat162float(de[j]);
        const float dxhat = dyv * __bfloat162float(we[j]);
        oe[j] = __float2bfloat16(r * (dxhat - xhat * c));
        dw_acc[i * kVec + j] += dyv * xhat;
      }
      dxr[i] = o;
    }
  }
  __syncthreads();
  float* out = dw_partial + static_cast<size_t>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) out[i] = dw_acc[i];
}

// dw[col] = bf16(sum over the partial rows), in row order.
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw_kernel(const float* __restrict__ dw_partial,
                      __nv_bfloat16* __restrict__ dw, int n_partial,
                      int h) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= h) return;
  float acc = 0.f;
  for (int p = 0; p < n_partial; ++p)
    acc += dw_partial[static_cast<size_t>(p) * h + col];
  dw[col] = __float2bfloat16(acc);
}

}  // namespace

// x, y: [rows, h] bf16, w: [h] bf16, h % 8 == 0, 16-byte aligned.
extern "C" int picotron_rmsnorm_fwd(const void* x, const void* w, void* y,
                                    int rows, int h, float eps,
                                    void* stream) {
  rmsnorm_fwd_kernel<<<rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      h, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [rows, h] bf16; w, dw: [h] bf16; dw_partial: scratch of
// [max_blocks, h] fp32 (rows > 0, max_blocks > 0); h % 8 == 0, 16-byte
// aligned. The first kernel runs ceil(rows / ceil(rows / max_blocks))
// blocks, at most max_blocks.
extern "C" int picotron_rmsnorm_bwd(const void* x, const void* w,
                                    const void* dy, void* dx, void* dw,
                                    void* dw_partial, int rows, int h,
                                    int max_blocks, float eps,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = (rows + max_blocks - 1) / max_blocks;
  const int n_partial = (rows + rows_per_block - 1) / rows_per_block;
  const int smem = h * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_kernel<<<n_partial, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dw_partial), rows,
      rows_per_block, h, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_dw_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(dw_partial), static_cast<__nv_bfloat16*>(dw),
      n_partial, h);
  return static_cast<int>(cudaGetLastError());
}

// Readable text for the error codes the launch functions return.
extern "C" const char* picotron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
