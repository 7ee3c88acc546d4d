// Month-masked bucket-sums variants of the kernel micro-benchmark, written
// for Hopper (sm_90a).
//
// Replace the TPU kernels of tools/kernel_microbench.py:
//   microbench_monthmask    <- _kernel_mm (launched by sums_monthmask)
//   microbench_monthmask_g  <- _kernel_mg (launched by sums_monthmask_g)
//
// For every agent and every net-load scale s they compute, per month, the
// total of relu(load - s * gen), the sell-rate-weighted sum, and P - 1
// masked period sums; the last period is the month total minus the others
// (the float32 cancellation of that subtraction is part of the function).
// No one-hot matrix, no product. Lanes are the plain 8760-hour order with
// 13 month offsets (lanes.cuh); the kernels read bucket ids and take
// id % P as the period while staging.
//
// Bound on an H100: as the month kernel (bucket_sums.cu), float32 ALU
// work, ~6 operations per (agent, scale, hour), far above the bytes of the
// four streams read once.
//
// What the design isolates against the month kernel: that one sums every
// period directly with ten predicated adds per hour, whatever P is; these
// walk the staged month once for the total and the sell sum and once more
// per masked period, in a run-time loop over P - 1 periods, so an hour
// costs about 4 P instructions and every accumulator is a scalar
// register. A month of one agent is staged in shared memory as one float4
// per hour (load, gen, sell, period), read by a warp as a broadcast.
//
//   * monthmask: one agent per block, one thread per scale (256 threads;
//     more scales take more blocks of the same agent).
//   * monthmask_g: g_block agents per block. The block stages a month of
//     all its agents at once (g_block x 744 x 16 bytes of dynamic shared
//     memory, above 48 KB from g_block = 5 on) and its 256 threads walk
//     the g_block x R (agent, scale) pairs, several pairs a thread; the
//     running sell sums of the pairs live in shared memory beside the
//     hours. What it decides on this card is how many agents share a
//     block's staging and barriers, and how few blocks cover the card.

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMaxSegLanes;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kThreads = 256;
// shared memory one block may ask for on sm_90
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float4 stage(const float* __restrict__ load,
                                        const float* __restrict__ gen,
                                        const float* __restrict__ sell,
                                        const int* __restrict__ bucket,
                                        size_t g, int n_periods) {
  return make_float4(load[g], gen[g], sell[g],
                     __int_as_float(bucket[g] % n_periods));
}

// One (agent, scale) pair over one staged month: writes the month's
// n_periods bucket sums to out_month and returns the sell-weighted sum.
__device__ __forceinline__ float month_pass(const float4* __restrict__ hour,
                                            int len, float s, int n_periods,
                                            float* __restrict__ out_month) {
  float tot = 0.f;
  float sell = 0.f;
#pragma unroll 4
  for (int h = 0; h < len; ++h) {
    const float4 v = hour[h];
    const float pos = fmaxf(v.x - s * v.y, 0.f);
    tot += pos;
    sell += pos * v.z;
  }
  float rem = tot;
  for (int p = 0; p + 1 < n_periods; ++p) {
    float s_pm = 0.f;
#pragma unroll 4
    for (int h = 0; h < len; ++h) {
      const float4 v = hour[h];
      const float pos = fmaxf(v.x - s * v.y, 0.f);
      s_pm += (__float_as_int(v.w) == p) ? pos : 0.f;
    }
    out_month[p] = s_pm;
    rem -= s_pm;
  }
  out_month[n_periods - 1] = rem;
  return sell;
}

__global__ void __launch_bounds__(kThreads)
    monthmask_kernel(const float* __restrict__ load,
                     const float* __restrict__ gen,
                     const float* __restrict__ sell,
                     const int* __restrict__ bucket,
                     const float* __restrict__ scales,
                     float* __restrict__ out_imp, float* __restrict__ out_sell,
                     int r, int n_lanes, int n_periods, int r_blocks,
                     MonthOffsets offs) {
  __shared__ float4 hour[kMaxSegLanes];

  const int agent = blockIdx.x / r_blocks;
  const int ri = (blockIdx.x % r_blocks) * kThreads + threadIdx.x;
  const bool live = ri < r;
  const size_t row = static_cast<size_t>(agent) * n_lanes;
  const size_t out_row = static_cast<size_t>(agent) * r + ri;
  const int nb = kMonths * n_periods;
  const float s = live ? scales[out_row] : 0.f;

  float sell_sum = 0.f;
  for (int m = 0; m < kMonths; ++m) {
    const int h0 = offs.o[m];
    const int len = offs.o[m + 1] - h0;
    __syncthreads();  // every thread is done with the previous month
    for (int h = threadIdx.x; h < len; h += kThreads)
      hour[h] = stage(load, gen, sell, bucket, row + h0 + h, n_periods);
    __syncthreads();
    if (live)
      sell_sum += month_pass(hour, len, s, n_periods,
                             out_imp + out_row * nb + m * n_periods);
  }
  if (live) out_sell[out_row] = sell_sum;
}

__global__ void __launch_bounds__(kThreads)
    monthmask_g_kernel(const float* __restrict__ load,
                       const float* __restrict__ gen,
                       const float* __restrict__ sell,
                       const int* __restrict__ bucket,
                       const float* __restrict__ scales,
                       float* __restrict__ out_imp,
                       float* __restrict__ out_sell, int r, int n_lanes,
                       int n_periods, int g_block, int seg,
                       MonthOffsets offs) {
  // [g_block][seg] staged hours, then [g_block * r] running sell sums
  extern __shared__ float4 staged[];
  float* sell_sum = reinterpret_cast<float*>(staged + g_block * seg);

  const int agent0 = blockIdx.x * g_block;
  const int pairs = g_block * r;
  const size_t pair0 = static_cast<size_t>(agent0) * r;
  const int nb = kMonths * n_periods;

  for (int i = threadIdx.x; i < pairs; i += kThreads) sell_sum[i] = 0.f;
  for (int m = 0; m < kMonths; ++m) {
    const int h0 = offs.o[m];
    const int len = offs.o[m + 1] - h0;
    __syncthreads();  // every thread is done with the previous month
    for (int i = threadIdx.x; i < g_block * len; i += kThreads) {
      const int g = i / len;
      const int h = i % len;
      staged[g * seg + h] =
          stage(load, gen, sell, bucket,
                static_cast<size_t>(agent0 + g) * n_lanes + h0 + h, n_periods);
    }
    __syncthreads();
    // pair i = (agent i / r of the block, scale i % r); a thread keeps the
    // same pairs every month, so sell_sum[i] has one writer
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const size_t out_row = pair0 + i;
      sell_sum[i] += month_pass(staged + (i / r) * seg, len, scales[out_row],
                                n_periods,
                                out_imp + out_row * nb + m * n_periods);
    }
  }
  for (int i = threadIdx.x; i < pairs; i += kThreads)
    out_sell[pair0 + i] = sell_sum[i];
}

bool shapes_ok(int n, int r, int n_periods) {
  return n > 0 && r > 0 && n_periods >= 1 && n_periods <= kMaxPeriods;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or offsets the kernel does not take.
// `offsets` is a host array of 13 lane offsets; the lanes are their last.
extern "C" int microbench_monthmask(const float* load, const float* gen,
                                    const float* sell, const int* bucket,
                                    const float* scales, const int* offsets,
                                    float* out_imp, float* out_sell, int n,
                                    int r, int n_periods, void* stream) {
  MonthOffsets offs;
  if (!shapes_ok(n, r, n_periods) || offsets == nullptr ||
      !lanes::read_offsets(offsets, offsets[kMonths], 1, &offs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r_blocks = (r + kThreads - 1) / kThreads;
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  monthmask_kernel<<<static_cast<unsigned>(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      load, gen, sell, bucket, scales, out_imp, out_sell, r, offs.o[kMonths],
      n_periods, r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int microbench_monthmask_g(const float* load, const float* gen,
                                      const float* sell, const int* bucket,
                                      const float* scales, const int* offsets,
                                      float* out_imp, float* out_sell, int n,
                                      int r, int n_periods, int g_block,
                                      void* stream) {
  MonthOffsets offs;
  if (!shapes_ok(n, r, n_periods) || g_block < 1 || n % g_block != 0 ||
      offsets == nullptr ||
      !lanes::read_offsets(offsets, offsets[kMonths], 1, &offs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = lanes::max_segment(offs);
  const long long smem =
      static_cast<long long>(g_block) * (seg * sizeof(float4) + r * sizeof(float));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        monthmask_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  monthmask_g_kernel<<<static_cast<unsigned>(n / g_block), kThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      load, gen, sell, bucket, scales, out_imp, out_sell, r, offs.o[kMonths],
      n_periods, g_block, seg, offs);
  return static_cast<int>(cudaGetLastError());
}
