// Bucket-sums kernels of the sizing search, written for Hopper (sm_90a).
//
// Replace the TPU kernels of dgen_tpu/ops/billpallas.py:
//   bucket_sums_month       <- _kernel_month (billpallas.py:343)
//   bucket_sums_month_pair  <- _kernel_month_pair (billpallas.py:427)
//
// For every agent n and every net-load scale s = scales[n, r] they reduce
// net = load - s * gen over the agent's lanes into per-(month, TOU
// period) sums of relu(net) (and of net when signed), month-major with
// n_periods <= 10 periods per month, plus the sell-rate-weighted sums.
// The pair kernel prices two tariff structures (sell rate, period map)
// over one shared relu(net). Lanes follow lanes.cuh: the plain 8760-hour
// order or a daylight-compacted layout, months given by 13 lane offsets;
// the period lanes carry bucket % n_periods.
//
// Bound on an H100: per (agent, scale, hour) the work is a fused
// multiply-add for net, a max for relu, a multiply-add for the sell sum
// and one add into the period's sum (a second set of those for signed
// sums or the pair's second tariff). At the main path's shapes
// (8192 agents x 300 scales x 8760 hours) that is ~1.3e11 float32
// operations against ~1.2 GB of streams read once, so the kernel is
// bound by FP32 ALU throughput, not by memory.
//
// What the design does about it: the lane streams of one agent are read
// from device memory once per block and staged month by month into
// shared memory as one float4 per lane (load, gen, sell, period), so
// every thread reads an hour with a single broadcast 16-byte load and
// spends the rest of its instructions on arithmetic. One thread owns one
// scale and keeps its accumulators in registers; the period index
// selects its accumulator through predicated adds unrolled over the
// compile-time kMaxPeriods = 10, so no accumulator array spills to local
// memory. A block is kThreads = 128 threads (scales); a warp whose scales
// all lie past R helps stage the hours and skips the arithmetic. A month
// is a contiguous slice of lanes in both layouts, so no month-padded
// repack is needed. Each period is summed directly (no last
// period by subtraction from the month total), and the sell sums are
// taken per month and then added, which keeps float32 rounding small.

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMaxSegLanes;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kThreads = 128;

template <bool SIGNED>
__global__ void month_kernel(const float* __restrict__ load,
                             const float* __restrict__ gen,
                             const float* __restrict__ sell,
                             const int* __restrict__ period,
                             const float* __restrict__ scales,
                             float* __restrict__ out_imp,
                             float* __restrict__ out_sell_imp,
                             float* __restrict__ out_sgn,
                             float* __restrict__ out_sell_sgn,
                             int r, int n_lanes, int n_periods, int r_blocks,
                             MonthOffsets offs) {
  __shared__ float4 hour[kMaxSegLanes];  // load, gen, sell, period bits

  const int agent = blockIdx.x / r_blocks;
  const int ri = (blockIdx.x % r_blocks) * kThreads + threadIdx.x;
  const bool live = ri < r;
  const bool warp_live = ri - static_cast<int>(threadIdx.x % 32) < r;
  const size_t row = static_cast<size_t>(agent) * n_lanes;
  const size_t out_row = static_cast<size_t>(agent) * r + ri;
  const int nb = kMonths * n_periods;
  const float s = live ? scales[out_row] : 0.f;

  float sell_imp = 0.f;
  float sell_sgn = 0.f;
  for (int m = 0; m < kMonths; ++m) {
    const int h0 = offs.o[m];
    const int len = offs.o[m + 1] - h0;
    __syncthreads();  // every thread is done with the previous month
    for (int h = threadIdx.x; h < len; h += kThreads) {
      const size_t g = row + h0 + h;
      hour[h] = make_float4(load[g], gen[g], sell[g],
                            __int_as_float(period[g]));
    }
    __syncthreads();
    if (!warp_live) continue;  // no scale of this warp lies below R

    float acc_i[kMaxPeriods];
    float acc_s[kMaxPeriods];
#pragma unroll
    for (int q = 0; q < kMaxPeriods; ++q) {
      acc_i[q] = 0.f;
      acc_s[q] = 0.f;
    }
    float mi = 0.f;
    float ms = 0.f;
#pragma unroll 4
    for (int h = 0; h < len; ++h) {
      const float4 v = hour[h];
      const int p = __float_as_int(v.w);
      const float net = v.x - s * v.y;
      const float pos = fmaxf(net, 0.f);
      mi += pos * v.z;
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q) acc_i[q] += (p == q) ? pos : 0.f;
      if (SIGNED) {
        ms += net * v.z;
#pragma unroll
        for (int q = 0; q < kMaxPeriods; ++q) acc_s[q] += (p == q) ? net : 0.f;
      }
    }
    sell_imp += mi;
    sell_sgn += ms;
    if (live) {
      float* oi = out_imp + out_row * nb + m * n_periods;
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q)
        if (q < n_periods) oi[q] = acc_i[q];
      if (SIGNED) {
        float* os = out_sgn + out_row * nb + m * n_periods;
#pragma unroll
        for (int q = 0; q < kMaxPeriods; ++q)
          if (q < n_periods) os[q] = acc_s[q];
      }
    }
  }
  if (live) {
    out_sell_imp[out_row] = sell_imp;
    if (SIGNED) out_sell_sgn[out_row] = sell_sgn;
  }
}

__global__ void month_pair_kernel(const float* __restrict__ load,
                                  const float* __restrict__ gen,
                                  const float* __restrict__ sell_a,
                                  const int* __restrict__ period_a,
                                  const float* __restrict__ sell_b,
                                  const int* __restrict__ period_b,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out_a,
                                  float* __restrict__ out_sell_a,
                                  float* __restrict__ out_b,
                                  float* __restrict__ out_sell_b,
                                  int r, int n_lanes, int n_periods,
                                  int r_blocks, MonthOffsets offs) {
  __shared__ float4 hour[kMaxSegLanes];   // load, gen, sell_a, sell_b
  __shared__ int2 period[kMaxSegLanes];   // period_a, period_b

  const int agent = blockIdx.x / r_blocks;
  const int ri = (blockIdx.x % r_blocks) * kThreads + threadIdx.x;
  const bool live = ri < r;
  const bool warp_live = ri - static_cast<int>(threadIdx.x % 32) < r;
  const size_t row = static_cast<size_t>(agent) * n_lanes;
  const size_t out_row = static_cast<size_t>(agent) * r + ri;
  const int nb = kMonths * n_periods;
  const float s = live ? scales[out_row] : 0.f;

  float sell_sum_a = 0.f;
  float sell_sum_b = 0.f;
  for (int m = 0; m < kMonths; ++m) {
    const int h0 = offs.o[m];
    const int len = offs.o[m + 1] - h0;
    __syncthreads();
    for (int h = threadIdx.x; h < len; h += kThreads) {
      const size_t g = row + h0 + h;
      hour[h] = make_float4(load[g], gen[g], sell_a[g], sell_b[g]);
      period[h] = make_int2(period_a[g], period_b[g]);
    }
    __syncthreads();
    if (!warp_live) continue;  // no scale of this warp lies below R

    float acc_a[kMaxPeriods];
    float acc_b[kMaxPeriods];
#pragma unroll
    for (int q = 0; q < kMaxPeriods; ++q) {
      acc_a[q] = 0.f;
      acc_b[q] = 0.f;
    }
    float ma = 0.f;
    float mb = 0.f;
#pragma unroll 4
    for (int h = 0; h < len; ++h) {
      const float4 v = hour[h];
      const int2 p = period[h];
      const float pos = fmaxf(v.x - s * v.y, 0.f);  // shared by both tariffs
      ma += pos * v.z;
      mb += pos * v.w;
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q) {
        acc_a[q] += (p.x == q) ? pos : 0.f;
        acc_b[q] += (p.y == q) ? pos : 0.f;
      }
    }
    sell_sum_a += ma;
    sell_sum_b += mb;
    if (live) {
      float* oa = out_a + out_row * nb + m * n_periods;
      float* ob = out_b + out_row * nb + m * n_periods;
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q) {
        if (q < n_periods) {
          oa[q] = acc_a[q];
          ob[q] = acc_b[q];
        }
      }
    }
  }
  if (live) {
    out_sell_a[out_row] = sell_sum_a;
    out_sell_b[out_row] = sell_sum_b;
  }
}

// Grid (N x ceil(R / kThreads)) blocks and the month offsets; false for
// shapes or offsets the kernels do not take.
bool grid_for(int n, int r, int n_lanes, int n_periods, const int* offsets,
              MonthOffsets* offs, int* r_blocks, unsigned* blocks) {
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > kMaxPeriods ||
      !lanes::read_offsets(offsets, n_lanes, 1, offs))
    return false;
  *r_blocks = (r + kThreads - 1) / kThreads;
  const long long total = static_cast<long long>(n) * *r_blocks;
  if (total > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(total);
  return true;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or offsets the kernel does not take.
// `offsets` is a host array of 13 lane offsets.
extern "C" int bucket_sums_month(const float* load, const float* gen,
                                 const float* sell, const int* period,
                                 const float* scales, const int* offsets,
                                 float* out_imp, float* out_sell_imp,
                                 float* out_sgn, float* out_sell_sgn, int n,
                                 int r, int n_lanes, int n_periods,
                                 int with_signed, void* stream) {
  MonthOffsets offs;
  int r_blocks;
  unsigned blocks;
  if (!grid_for(n, r, n_lanes, n_periods, offsets, &offs, &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_signed) {
    month_kernel<true><<<blocks, kThreads, 0, st>>>(
        load, gen, sell, period, scales, out_imp, out_sell_imp, out_sgn,
        out_sell_sgn, r, n_lanes, n_periods, r_blocks, offs);
  } else {
    month_kernel<false><<<blocks, kThreads, 0, st>>>(
        load, gen, sell, period, scales, out_imp, out_sell_imp, out_sgn,
        out_sell_sgn, r, n_lanes, n_periods, r_blocks, offs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bucket_sums_month_pair(const float* load, const float* gen,
                                      const float* sell_a, const int* period_a,
                                      const float* sell_b, const int* period_b,
                                      const float* scales, const int* offsets,
                                      float* out_a, float* out_sell_a,
                                      float* out_b, float* out_sell_b, int n,
                                      int r, int n_lanes, int n_periods,
                                      void* stream) {
  MonthOffsets offs;
  int r_blocks;
  unsigned blocks;
  if (!grid_for(n, r, n_lanes, n_periods, offsets, &offs, &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  month_pair_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      load, gen, sell_a, period_a, sell_b, period_b, scales, out_a,
      out_sell_a, out_b, out_sell_b, r, n_lanes, n_periods, r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}
