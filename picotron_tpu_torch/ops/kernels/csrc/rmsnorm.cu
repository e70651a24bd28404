// Kernel A: RMSNorm forward, written by hand for Hopper (sm_90a).
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

// Readable text for the error codes the launch functions return.
extern "C" const char* picotron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
