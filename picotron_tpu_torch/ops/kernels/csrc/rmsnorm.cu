// Kernel A: RMSNorm forward, and kernel D: its backward, written by hand
// for Hopper (sm_90a).
//
// A replaces picotron_tpu/ops/pallas/rmsnorm.py::_fwd_kernel (:34), reached
// through _run_fwd (:58) and rms_norm_pallas (:109). Same numerics as the
// plain version (ops/rmsnorm.py): per row, the fp32 mean of x*x, then
// x * rsqrt(var + eps) rounded to bf16, then that times the weight rounded
// to bf16 again (the multiply in the input dtype).
//
// What bounds A: bytes. A row is read, reduced and written once, a few
// operations per byte (far below the ~295 FLOP/byte at which an H100
// stops being memory bound), so the least time is (2 * rows * H + H) * 2
// bytes / 3.35 TB/s. At decode (8 rows) that is a few nanoseconds, and
// the time is one device-memory round trip, the launch and the lanes'
// serial arithmetic. The design (the plan, rmsnorm.plan_fwd): a group of
// warps per row, a few groups to a block, no block barrier. Each lane
// loads its 16-byte vectors of x and of the weight once, into registers
// (at most 8 each); the sum of squares is a warp-shuffle reduction, the
// group's warps' sums meet behind a named barrier of the group's own, and
// y is written from the registers: no second read of x. Decode and
// prefill chunks (up to 512 rows) take four warps a row, so a lane does
// 16 columns at H 2048 and not 64; training takes two, on a grid of at
// most 1024 blocks whose groups walk several rows each, the weight loaded
// once and each next row's x loaded before the current row's sum. Rows
// wider than 8 warps' vectors (H > 16384) take a loop, one warp a row,
// that reads x twice, the second time from the cache.
//
// D replaces picotron_tpu/ops/pallas/rmsnorm.py::_bwd_kernel (:41),
// reached through _bwd_rule (:82). Per row, in fp32 (the formula of
// :46-55): r = rsqrt(mean(x^2) + eps), xhat = x * r, dxhat = dy * w,
//   dx = r * (dxhat - xhat * mean(dxhat * xhat)),
// and dw = sum over rows of dy * xhat, cast to w's dtype (:103).
//
// What bounds D: bytes, as for A. It reads x and dy and writes dx (2 bytes
// each per element), a few operations per byte: (3 * rows * H + 2 * H) * 2
// bytes. To stream at the card's rate every SM needs tens of KB of loads
// in flight. The design (the plan, rmsnorm.plan_bwd):
// - One launch, a persistent grid of one 8-warp block per SM. A group of
//   1 to 8 warps takes a row (one warp up to H 2048, two at H 4096): each
//   lane owns up to 8 fixed 16-byte column vectors of it. A group walks
//   the rows group, group + groups, ... in order.
// - Each warp streams its rows' x and dy into a ring of shared memory with
//   cp.async, two rows ahead of the one it computes, so 16 KB a warp are
//   in flight without holding registers; a row is read from device memory
//   once and stays on chip from the statistics to dx. sum(x^2) and
//   sum(dxhat * x) are warp-shuffle reductions (and, for a group of
//   several warps, a sum of their per-warp pairs in warp order behind a
//   named barrier of that group alone).
// - dw accumulates in registers: each lane adds dy * xhat for its columns
//   over every row its group walks. At the end the groups put their
//   columns side by side in shared memory (a layout in which a warp's 32
//   lanes hit 32 banks), and after one block barrier the block adds each
//   column over its groups in group order and writes one fp32 partial
//   row. Then a grid-wide barrier, and each block sums its own slice of
//   the H columns over the partial rows: in segments of consecutive
//   blocks, each in block order, then the segments in order.
//
// Why a cooperative launch: the column sums need every block's partial
// row, so the grid waits at one barrier, which is only safe when every
// block is resident at once. cudaLaunchCooperativeKernel guarantees that
// or refuses the launch (the wrapper raises the error), where a second
// launch would cost a kernel boundary and a host call.
//
// Why the sums are deterministic: every sum has an order fixed by the plan
// (a function of rows, H and the SM count): a lane's rows in walk order,
// the groups of a block in group order, the partial rows in block order
// within a segment and the segments in order; a warp reduction's butterfly
// gives every lane the same bits. No float atomics, so dx and dw have the
// same bits from call to call.
//
// Rows wider than 8 warps' vectors (H > 16384) take a loop variant: the
// whole block on one row at a time, two passes over it (the second from
// the cache), dw accumulated by each thread for its own columns in the
// block's partial row, then the same barrier and column sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 8;           // bf16 values per 16-byte access
constexpr int kFwdThreads = 256;  // A's blocks: at most 8 warps
constexpr int kBwdThreads = 256;  // D's blocks: at most 8 warps
constexpr int kBwdStages = 3;  // D: rows a warp's ring holds (two ahead)
constexpr int kSegLoads = 16;  // partial rows a thread loads at once
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block can use

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float f[kVec]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 t = __bfloat1622float2(e[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// y = bf16(bf16(x * r) * w), 8 values
__device__ __forceinline__ uint4 norm8(const uint4& xu, const uint4& wu,
                                       float r) {
  float xf[kVec], wf[kVec];
  unpack8(xu, xf);
  unpack8(wu, wf);
  uint4 o;
  __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float n = __bfloat162float(__float2bfloat16(xf[j] * r));
    oe[j] = __float2bfloat16(n * wf[j]);
  }
  return o;
}

// ---------------------------------------------------------------- kernel A

// The sum of squares of a row held by a group of G warps: each warp's by
// shuffles, then (G > 1) the warps' in warp order, through `red` behind a
// named barrier of the group's own.
template <int VPL>
__device__ __forceinline__ float group_sumsq(const uint4 (&xv)[VPL], int G,
                                             int lg, float* red) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float f[kVec];
    unpack8(xv[i], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ss += f[j] * f[j];
  }
  ss = warp_sum(ss);
  if (G > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    named_barrier(1 + lg, 32 * G);
    ss = red[lg * G];
    for (int k = 1; k < G; ++k) ss += red[lg * G + k];
  }
  return ss;
}

template <int VPL>
__device__ __forceinline__ void store_row(uint4* yr, const uint4 (&xv)[VPL],
                                          const uint4 (&wv)[VPL], float ss,
                                          int h, float eps, int vbase,
                                          int nvec) {
  const float r = 1.0f / sqrtf(ss / static_cast<float>(h) + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = vbase + 32 * i;
    if (v < nvec) yr[v] = norm8(xv[i], wv[i], r);
  }
}

// A group of warps_per_row warps per row; warp gw of the group holds the
// row's vectors (gw * VPL + i) * 32 + lane, i < VPL, of x and of the
// weight. Group k of the grid's `groups` walks rows k, k + groups, ...:
// a group with one row (decode, a prefill chunk) loads it, and the weight
// while it sums, and is done; a group with more loads the weight once and
// each next row before it reduces the current one (the sums of consecutive
// rows alternate between the two halves of `red`, so one barrier a row).
template <int VPL>
__global__ void __launch_bounds__(kFwdThreads)
rmsnorm_fwd_rows(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, int rows, int h,
                 int warps_per_row, float eps) {
  __shared__ float red[2][kFwdThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = warps_per_row;
  const int gpb = (blockDim.x >> 5) / G;
  const int lg = warp / G;
  const int groups = gridDim.x * gpb;
  int row = blockIdx.x * gpb + lg;
  if (row >= rows) return;  // the whole group
  const int nvec = h / kVec;
  const int vbase = (warp % G) * VPL * 32 + lane;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xv[VPL], wv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = vbase + 32 * i;
    xv[i] = v < nvec ? x4[static_cast<size_t>(row) * nvec + v] : zero;
  }
  // the weight after the row's loads; for a group with one row, after its
  // sum (at a 512-row prefill chunk that ran faster on an H100 than loading
  // it beside the row)
  auto load_w = [&] {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = vbase + 32 * i;
      wv[i] = v < nvec ? __ldg(w4 + v) : zero;
    }
  };
  if (row + groups >= rows) {  // the group's only row
    const float ss = group_sumsq(xv, G, lg, red[0]);
    load_w();
    store_row(y4 + static_cast<size_t>(row) * nvec, xv, wv, ss, h, eps,
              vbase, nvec);
    return;
  }
  load_w();
  for (int parity = 0; row < rows; row += groups, parity ^= 1) {
    const int next = row + groups;
    uint4 xn[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = vbase + 32 * i;
      xn[i] = next < rows && v < nvec
                  ? __ldg(x4 + static_cast<size_t>(next) * nvec + v)
                  : zero;
    }
    const float ss = group_sumsq(xv, G, lg, red[parity]);
    store_row(y4 + static_cast<size_t>(row) * nvec, xv, wv, ss, h, eps,
              vbase, nvec);
#pragma unroll
    for (int i = 0; i < VPL; ++i) xv[i] = xn[i];
  }
}

// One warp per row of any width: a pass for the sum of squares, a second
// (x again, now from the cache) for y.
__global__ void __launch_bounds__(kFwdThreads)
rmsnorm_fwd_loop(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, int rows, int h, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = h / kVec;
  const size_t base = static_cast<size_t>(row) * nvec;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + base;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  float ss = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[kVec];
    unpack8(xr[v], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ss += f[j] * f[j];
  }
  ss = warp_sum(ss);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(h) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y) + base;
  for (int v = lane; v < nvec; v += 32) yr[v] = norm8(xr[v], __ldg(wr + v), r);
}

// ---------------------------------------------------------------- kernel D

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a lane's dw value of vector v, element j sits in its group's
// shared column buffer (kChunkSlots floats for each 32 vectors): rows of
// 36 words for each j, so a warp's 32 lanes (32 consecutive v at one j)
// hit 32 banks when they write, and 32 threads reading 32 consecutive
// columns (4 v by 8 j: banks 4j + v) hit 32 banks too.
constexpr int kSlotRow = 36;
constexpr int kChunkSlots = kVec * kSlotRow;
__device__ __forceinline__ int dw_slot(int v, int j) {
  return (v >> 5) * kChunkSlots + j * kSlotRow + (v & 31);
}

// After the grid barrier: block b sums columns [b * slice_cols, ...) of
// dw over the grid's partial rows, in segments of segment_blocks
// consecutive blocks (each in block order), then the segments in order.
__device__ void sum_partials(const float* partial, __nv_bfloat16* dw, int h,
                             int slice_cols, int segment_blocks,
                             float4* sbuf) {
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * slice_cols;
  const int c1 = min(h, c0 + slice_cols);
  if (c0 >= c1) return;  // uniform over the block
  const int n4 = (c1 - c0) >> 2;
  const int nseg = (nb + segment_blocks - 1) / segment_blocks;
  const int per = blockDim.x / nseg;  // column quads a pass
  const int seg = threadIdx.x / per, ul = threadIdx.x % per;
  const size_t stride = static_cast<size_t>(h >> 2);  // float4s a row
  const float4* p = reinterpret_cast<const float4*>(partial + c0);
  for (int u0 = 0; u0 < n4; u0 += per) {
    const int u = u0 + ul;
    if (seg < nseg && u < n4) {
      const int b0 = seg * segment_blocks;
      const int b1 = min(nb, b0 + segment_blocks);
      float4 a = __ldcg(p + b0 * stride + u);
      for (int bc = b0 + 1; bc < b1; bc += kSegLoads) {  // loads in flight
        float4 t[kSegLoads];
#pragma unroll
        for (int k = 0; k < kSegLoads; ++k)
          if (bc + k < b1) t[k] = __ldcg(p + (bc + k) * stride + u);
#pragma unroll
        for (int k = 0; k < kSegLoads; ++k) {
          if (bc + k < b1) {
            a.x += t[k].x;
            a.y += t[k].y;
            a.z += t[k].z;
            a.w += t[k].w;
          }
        }
      }
      sbuf[seg * per + ul] = a;
    }
    __syncthreads();
    if (threadIdx.x < per && u0 + threadIdx.x < n4) {
      float4 t = sbuf[threadIdx.x];
      for (int s = 1; s < nseg; ++s) {
        const float4 q = sbuf[s * per + threadIdx.x];
        t.x += q.x;
        t.y += q.y;
        t.z += q.z;
        t.w += q.w;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(t.x, t.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(t.z, t.w);
      uint2 o;
      o.x = *reinterpret_cast<uint32_t*>(&lo);
      o.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dw + c0 + 4 * (u0 + threadIdx.x)) = o;
    }
    __syncthreads();
  }
}

// The main variant. A group of warps_per_row warps takes a row; warp gw of
// the group owns vectors (gw * VPL + i) * 32 + lane, i < VPL. Shared
// memory: each warp's ring of kBwdStages slots of [x | dy][VPL][32] vectors,
// reused after the walk for the block's dw columns and the column sums.
template <int VPL>
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_rows(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ dy,
                 __nv_bfloat16* __restrict__ dx, float* partial,
                 __nv_bfloat16* dw, int rows, int h, int warps_per_row,
                 int slice_cols, int segment_blocks, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float2 red[2][kBwdThreads / 32];
  uint4* smem = reinterpret_cast<uint4*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = warps_per_row;
  const int gpb = (blockDim.x >> 5) / G;  // groups a block
  const int lg = warp / G, gw = warp % G;
  const int groups = gridDim.x * gpb;
  const int group = blockIdx.x * gpb + lg;
  const int nvec = h / kVec;
  const float hf = static_cast<float>(h);
  const int vbase = gw * VPL * 32 + lane;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* dy4 = reinterpret_cast<const uint4*>(dy);
  uint4* dx4 = reinterpret_cast<uint4*>(dx);

  uint4 wv[VPL];
  float acc[VPL][kVec];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = vbase + 32 * i;
    wv[i] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[i][j] = 0.f;
  }

  constexpr int kSlot = 2 * VPL * 32;  // vectors of one ring slot
  uint4* ring = smem + warp * kBwdStages * kSlot;
  auto fetch = [&](int r, int slot) {
    if (r < rows) {
      const size_t base = static_cast<size_t>(r) * nvec;
      uint4* s = ring + slot * kSlot;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = vbase + 32 * i;
        if (v < nvec) {
          cp_async16(s + i * 32 + lane, x4 + base + v);
          cp_async16(s + (VPL + i) * 32 + lane, dy4 + base + v);
        }
      }
    }
    cp_async_commit();  // an empty group past the last row keeps the count
  };
  for (int s = 0; s < kBwdStages - 1; ++s) fetch(group + s * groups, s);

  int slot = 0, parity = 0;
  for (int r = group; r < rows; r += groups) {
    fetch(r + (kBwdStages - 1) * groups,
          (slot + kBwdStages - 1) % kBwdStages);
    cp_async_wait<kBwdStages - 1>();  // this row's copies (each lane its own)
    const uint4* s = ring + slot * kSlot;
    float ss = 0.f, sd = 0.f;  // sum x^2, sum dxhat * x
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (vbase + 32 * i < nvec) {
        float xf[kVec], df[kVec], wf[kVec];
        unpack8(s[i * 32 + lane], xf);
        unpack8(s[(VPL + i) * 32 + lane], df);
        unpack8(wv[i], wf);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          ss += xf[j] * xf[j];
          sd += df[j] * wf[j] * xf[j];
        }
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if (G > 1) {  // the group's warps, in warp order
      if (lane == 0) red[parity][warp] = make_float2(ss, sd);
      named_barrier(1 + lg, 32 * G);
      float2 t = red[parity][lg * G];
      for (int k = 1; k < G; ++k) {
        t.x += red[parity][lg * G + k].x;
        t.y += red[parity][lg * G + k].y;
      }
      ss = t.x;
      sd = t.y;
      parity ^= 1;  // the next row writes the other half: one barrier a row
    }
    const float rr = 1.0f / sqrtf(ss / hf + eps);
    const float c = rr * sd / hf;  // mean(dxhat * xhat)
    const size_t base = static_cast<size_t>(r) * nvec;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = vbase + 32 * i;
      if (v < nvec) {
        float xf[kVec], df[kVec], wf[kVec];
        unpack8(s[i * 32 + lane], xf);
        unpack8(s[(VPL + i) * 32 + lane], df);
        unpack8(wv[i], wf);
        uint4 o;
        __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xhat = xf[j] * rr;
          const float dxhat = df[j] * wf[j];
          oe[j] = __float2bfloat16(rr * (dxhat - xhat * c));
          acc[i][j] += df[j] * xhat;
        }
        dx4[base + v] = o;
      }
    }
    slot = (slot + 1) % kBwdStages;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is off its ring

  // the block's partial row: its groups' columns side by side in shared
  // memory (group lg's at lg * cols), then each column over the groups in
  // group order
  float* buf = reinterpret_cast<float*>(smem_raw);
  const int cols = ((nvec + 31) >> 5) * kChunkSlots;  // a group's slots
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = vbase + 32 * i;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        buf[lg * cols + dw_slot(v, j)] = acc[i][j];
    }
  }
  __syncthreads();
  float* prow = partial + static_cast<size_t>(blockIdx.x) * h;
  for (int col = threadIdx.x; col < h; col += blockDim.x) {
    const int p = dw_slot(col >> 3, col & 7);
    float a = buf[p];
    for (int g = 1; g < gpb; ++g) a += buf[g * cols + p];
    prow[col] = a;  // coalesced
  }
  cg::this_grid().sync();
  sum_partials(partial, dw, h, slice_cols, segment_blocks,
               reinterpret_cast<float4*>(smem_raw));
}

// Sum a pair over the block in warp order; every thread gets both sums.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) {
    t.x += red[i].x;
    t.y += red[i].y;
  }
  __syncthreads();  // red is reused by the next row
  return t;
}

// The loop variant, any H: the block on one row at a time (rows b, b +
// blocks, ...); thread t owns vectors t, t + threads, ... and adds their
// dw into the block's partial row in place.
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_loop(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ dy,
                 __nv_bfloat16* __restrict__ dx, float* partial,
                 __nv_bfloat16* dw, int rows, int h, int slice_cols,
                 int segment_blocks, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float2 red[kBwdThreads / 32];
  const int nvec = h / kVec;
  const float hf = static_cast<float>(h);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* dy4 = reinterpret_cast<const uint4*>(dy);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  uint4* dx4 = reinterpret_cast<uint4*>(dx);
  float4* prow = reinterpret_cast<float4*>(
      partial + static_cast<size_t>(blockIdx.x) * h);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    prow[2 * v] = prow[2 * v + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = static_cast<size_t>(r) * nvec;
    float ss = 0.f, sd = 0.f;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      float xf[kVec], df[kVec], wf[kVec];
      unpack8(x4[base + v], xf);
      unpack8(dy4[base + v], df);
      unpack8(__ldg(w4 + v), wf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ss += xf[j] * xf[j];
        sd += df[j] * wf[j] * xf[j];
      }
    }
    const float2 sums = block_sum2(ss, sd, red);
    const float rr = 1.0f / sqrtf(sums.x / hf + eps);
    const float c = rr * sums.y / hf;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      float xf[kVec], df[kVec], wf[kVec];
      unpack8(x4[base + v], xf);
      unpack8(dy4[base + v], df);
      unpack8(__ldg(w4 + v), wf);
      float4 a0 = prow[2 * v], a1 = prow[2 * v + 1];
      float* a = reinterpret_cast<float*>(&a0);
      float* b = reinterpret_cast<float*>(&a1);
      uint4 o;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xhat = xf[j] * rr;
        const float dxhat = df[j] * wf[j];
        oe[j] = __float2bfloat16(rr * (dxhat - xhat * c));
        (j < 4 ? a[j] : b[j - 4]) += df[j] * xhat;
      }
      prow[2 * v] = a0;
      prow[2 * v + 1] = a1;
      dx4[base + v] = o;
    }
  }
  cg::this_grid().sync();
  sum_partials(partial, dw, h, slice_cols, segment_blocks,
               reinterpret_cast<float4*>(smem_raw));
}

// Raise a kernel's dynamic shared memory limit to `bytes` once per device
// (cudaFuncSetAttribute is a host call; it is made again only for a larger
// size). `slot` names the kernel: D's main variant at 1, 2, 4, 8 vectors.
std::atomic<int> g_smem_set[kMaxDevices][4];

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int slot, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& set = g_smem_set[dev][slot];
  if (set.load() >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) set.store(bytes);
  return e;
}

template <int VPL>
cudaError_t launch_bwd_rows(const __nv_bfloat16* x, const __nv_bfloat16* w,
                            const __nv_bfloat16* dy, __nv_bfloat16* dx,
                            float* partial, __nv_bfloat16* dw, int rows,
                            int h, int blocks, int warps, int warps_per_row,
                            int slice_cols, int segment_blocks, float eps,
                            int slot, cudaStream_t st) {
  const int ring = warps * kBwdStages * 2 * VPL * 32 * 16;
  const int cols = (warps / warps_per_row) * ((h / kVec + 31) / 32) *
                   kChunkSlots * 4;  // the groups' dw columns
  const int sums = warps * 32 * 16;                     // sum_partials
  const int smem = max(ring, max(cols, sums));
  if (smem > kMaxSmem - 1024) return cudaErrorInvalidValue;  // + static
  auto kernel = rmsnorm_bwd_rows<VPL>;
  cudaError_t e = allow_smem(kernel, slot, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&x, &w, &dy, &dx, &partial, &dw, &rows, &h,
                  &warps_per_row, &slice_cols, &segment_blocks, &eps};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(warps * 32), args,
                                     smem, st);
}

}  // namespace

// x, y: [rows, h] bf16, w: [h] bf16, h % 8 == 0, 16-byte aligned. The plan
// (rmsnorm.plan_fwd): `blocks` blocks of `warps` warps; vec_per_lane 1, 2,
// 4 or 8 takes the main variant, groups of warps_per_row warps a row
// (32 * 8 * vec_per_lane * warps_per_row >= h) walking the rows with the
// grid's stride, 0 the loop variant (one warp a row, blocks * warps >=
// rows).
extern "C" int picotron_rmsnorm_fwd(const void* x, const void* w, void* y,
                                    int rows, int h, int blocks, int warps,
                                    int warps_per_row, int vec_per_lane,
                                    float eps, void* stream) {
  const int per_row = vec_per_lane ? warps_per_row : 1;
  if (rows <= 0 || h <= 0 || h % kVec || warps < 1 ||
      warps * 32 > kFwdThreads || blocks < 1 || per_row < 1 ||
      warps % per_row ||
      (!vec_per_lane && static_cast<long long>(blocks) * warps < rows) ||
      (vec_per_lane && 32 * kVec * vec_per_lane * per_row < h))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  const dim3 grid(blocks), block(warps * 32);
  switch (vec_per_lane) {
    case 0:
      rmsnorm_fwd_loop<<<grid, block, 0, st>>>(xp, wp, yp, rows, h, eps);
      break;
#define PICOTRON_FWD_ROWS(V)                                                \
  case V:                                                                   \
    rmsnorm_fwd_rows<V><<<grid, block, 0, st>>>(xp, wp, yp, rows, h,        \
                                                per_row, eps);              \
    break;
    PICOTRON_FWD_ROWS(1)
    PICOTRON_FWD_ROWS(2)
    PICOTRON_FWD_ROWS(4)
    PICOTRON_FWD_ROWS(8)
#undef PICOTRON_FWD_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [rows, h] bf16; w, dw: [h] bf16; partial: fp32 scratch of
// [blocks, h]; h % 8 == 0, 16-byte aligned. The plan (rmsnorm.plan_bwd):
// `blocks` co-resident blocks of `warps` warps, launched cooperatively;
// vec_per_lane 1, 2, 4 or 8 takes the main variant with groups of
// warps_per_row warps (32 * 8 * vec_per_lane * warps_per_row >= h), 0
// the loop variant; block b sums
// dw's columns [b * slice_cols, (b + 1) * slice_cols) over the partial
// rows in segments of segment_blocks blocks.
extern "C" int picotron_rmsnorm_bwd(const void* x, const void* w,
                                    const void* dy, void* dx, void* dw,
                                    void* partial, int rows, int h,
                                    int blocks, int warps, int warps_per_row,
                                    int vec_per_lane, int slice_cols,
                                    int segment_blocks,
                                    float eps, void* stream) {
  const int threads = warps * 32;
  if (rows <= 0 || h <= 0 || h % kVec || blocks < 1 || warps < 1 ||
      threads > kBwdThreads || slice_cols < 4 || slice_cols % 4 ||
      static_cast<long long>(blocks) * slice_cols < h ||
      segment_blocks < 1 ||
      (blocks + segment_blocks - 1) / segment_blocks > threads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_per_lane &&
      (warps_per_row < 1 || warps % warps_per_row ||
       32 * kVec * vec_per_lane * warps_per_row < h))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* dyp = static_cast<const __nv_bfloat16*>(dy);
  __nv_bfloat16* dxp = static_cast<__nv_bfloat16*>(dx);
  __nv_bfloat16* dwp = static_cast<__nv_bfloat16*>(dw);
  float* pp = static_cast<float*>(partial);
  cudaError_t e;
  switch (vec_per_lane) {
    case 0: {
      const int smem = threads * 16;
      void* args[] = {&xp, &wp, &dyp, &dxp, &pp, &dwp, &rows, &h,
                      &slice_cols, &segment_blocks, &eps};
      e = cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(rmsnorm_bwd_loop), dim3(blocks),
          dim3(threads), args, smem, st);
      break;
    }
#define PICOTRON_BWD_ROWS(V, SLOT)                                          \
  case V:                                                                   \
    e = launch_bwd_rows<V>(xp, wp, dyp, dxp, pp, dwp, rows, h, blocks,      \
                           warps, warps_per_row, slice_cols,                \
                           segment_blocks, eps, SLOT, st);                  \
    break;
    PICOTRON_BWD_ROWS(1, 0)
    PICOTRON_BWD_ROWS(2, 1)
    PICOTRON_BWD_ROWS(4, 2)
    PICOTRON_BWD_ROWS(8, 3)
#undef PICOTRON_BWD_ROWS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Readable text for the error codes the launch functions return.
extern "C" const char* picotron_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
