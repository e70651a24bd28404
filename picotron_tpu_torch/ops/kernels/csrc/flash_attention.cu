// Kernel B: causal flash-attention forward, written by hand for Hopper
// (sm_90a).
//
// Replaces picotron_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:97),
// reached through _fwd (:138) from flash_attention (:431). Same function:
// causal attention of q [B, S, H, D] over k/v [B, S, Hkv, D] (bf16), fp32
// scores and online softmax, p rounded to bf16 before the P @ V product,
// output in bf16. KV tiles wholly above the diagonal are never read (the
// TPU kernel's causal_kv_blocks bound).
//
// What bounds it on this card: at the prefill buckets of the serving path
// (S <= 512, D = 64) the operations, 4 * D * H * S^2 / 2 per batch entry,
// against bytes of (2 H + 2 Hkv) * S * D * 2; both bounds are microseconds
// (the table in PERF.md has them per shape). This first kernel runs its
// products on the fp32 pipes, not on the tensor cores, so its ceiling is
// the H100's 67 TFLOP/s of fp32 FMA, not 989 TFLOP/s of bf16 tensor-core
// work: wgmma, TMA and warp specialisation are later work.
//
// Design (attention_tile.cuh): one block per (batch, head, 64-row query
// tile); 128 threads. GQA is handled in the kernel (kv head = h / g), so
// K/V are never repeated in memory. Prefill buckets are any power of two
// >= 16 and the ragged last tile is masked here, so nothing assumes the
// TPU kernel's divisibility (_pick_block :67).
//
// For training, the caller may pass an lse buffer [B, H, S] fp32: each row
// then also writes m + log(l), which the backward kernels
// (flash_attention_bwd.cu) use to re-derive P. The serving path passes
// null and pays nothing for it.

#include "attention_tile.cuh"

namespace {

using picotron::kRows;
using picotron::kThreads;
using picotron::Smem;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int Hkv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  const int s0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int nr = min(kRows, S - s0);
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    sm.off[r] = (static_cast<long long>(b) * S + s0 + r) * H * D +
                static_cast<long long>(h) * D;
    sm.pos[r] = s0 + r;
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = static_cast<size_t>(b) * S * stride +
                       static_cast<size_t>(kvh) * D;
  float* lse_rows =
      lse == nullptr
          ? nullptr
          : lse + (static_cast<size_t>(b) * H + h) * S + s0;
  picotron::attend_rows<D, true>(sm, nr, s0 + nr - 1, q, k + head0,
                                 v + head0, o, stride, S, scale, lse_rows);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(picotron::smem_bytes<D>());
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B, S, H, D]; k, v: [B, S, Hkv, D]; bf16, contiguous; D in {64, 128}.
// lse: null, or [B, H, S] fp32.
extern "C" int picotron_flash_attention_fwd(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int S, int H, int Hkv,
                                            int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, H, Hkv, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
