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
// in order p = 0..P-2 (the float32 cancellation of that subtraction is
// part of the function). No one-hot matrix, no product. Lanes are the
// plain 8760-hour order with 13 month offsets (lanes.cuh); the kernels
// read bucket ids and take id % P as the period.
//
// Bound on an H100: as the month kernel (bucket_sums.cu), float32 ALU
// work, ~6 operations per (agent, scale, hour), far above the bytes of the
// four streams read once.
//
// monthmask (one agent per block, one thread per scale, 256 threads; more
// scales take more blocks of the same agent) walks a month staged in
// shared memory as one float4 per hour (load, gen, sell, period) once for
// the total and the sell sum and once more per masked period, in a
// run-time loop over P - 1 periods: about 4 P instructions an hour, every
// sum one scalar register, the staging synchronous. Its relu is fmaxf,
// which drops NaN.
//
// monthmask_g puts g_block agents in a block, which share its staging and
// barriers, and walks each staged hour once:
//   * one walk a month: pos = relu(load - s * gen) is formed once per
//     (scale, hour) and feeds the month total, the sell-weighted sum and
//     the P - 1 masked sums, each taken as pos * mask (a multiply-add
//     with the hour's 0/1 mask, so a NaN or infinite pos reaches every
//     masked sum as it does in the plain version); P is a template
//     argument (1..10), so the P + 1 running sums of a scale are
//     registers, and so are the sell sums carried across the months;
//   * several scales a thread: the block's threads map evenly onto (agent
//     of the block, tile of SPT consecutive scales); one shared-memory
//     read of a staged hour, a broadcast within the warp, feeds SPT
//     independent chains of each sum. SPT is 1, 2, 4 or 8 (at most 4 from
//     P = 6 on, so that SPT x (P + 1) sums stay within 48 registers), the
//     widest of those that need the fewest rounds of 256 threads; the
//     tiles of a group that do not fit one block take more blocks, each
//     staging only the agents its tiles belong to (the tool's g_block 8
//     at 250 scales: SPT 8, one block of 8 x 32 tiles; g_block 4: SPT 4,
//     4 x 63 tiles);
//   * staging in chunks of 192 hours (none crossing a month's end; 2%
//     faster than 96 at g_block 8, PERF.md), double buffered with 4-byte
//     cp.async (async_copy.cuh) into one 16-byte record an hour: chunk c +
//     1 of the block's agents lands while chunk c is walked, one block
//     barrier a chunk. Each thread turns the bucket ids it copied into
//     periods (P = 2: into period 0's mask) once they land, so no thread
//     divides while it walks. A stage takes 192 x 16 bytes an agent (48 KB
//     both stages at g_block 8), whatever the month lengths, so g_block is
//     bounded by shared memory only past 37 agents;
//   * the relu is staging::relu_keep_nan (max.NaN), as the engine
//     kernels'.
// What it decides against monthmask: how much one walk an hour, wide
// tiles and shared asynchronous staging buy over the per-period walks;
// against the month kernel: the masked sums against that kernel's
// period-sorted staging.

#include <cuda_runtime.h>

#include <algorithm>

#include "async_copy.cuh"
#include "lanes.cuh"
#include "month_chunks.cuh"
#include "staging.cuh"

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

constexpr int kChunk = 192;  // hours of an agent a stage holds
constexpr int kStages = 2;
constexpr int kMaxSpt = 8;
constexpr int kWideP = 5;  // most periods at kMaxSpt scales a thread

// g_block agents, tiles scale tiles each; the block's threads take items
// item0 .. item0 + 255 of the group's g_block x tiles (agent, tile) items
template <int P, int SPT>
__global__ void __launch_bounds__(kThreads)
    monthmask_g_kernel(const float* __restrict__ load,
                       const float* __restrict__ gen,
                       const float* __restrict__ sell,
                       const int* __restrict__ bucket,
                       const float* __restrict__ scales,
                       float* __restrict__ out_imp,
                       float* __restrict__ out_sell, int r, int n_lanes,
                       int g_block, int tiles, int blocks_per_group, int span,
                       MonthOffsets offs) {
  constexpr int kMasks = P > 1 ? P - 1 : 1;
  constexpr int kNb = kMonths * P;
  // [kStages][span][kChunk] hours (load, gen, sell, bucket id); once
  // landed the id is the hour's period (P > 2) or period 0's mask (P = 2)
  extern __shared__ float4 staged[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int item0 = (blockIdx.x % blocks_per_group) * kThreads;
  const int item_end = min(g_block * tiles, item0 + kThreads);
  const int g0 = item0 / tiles;  // the block's first agent in its group
  const int n_staged = (item_end - 1) / tiles - g0 + 1;
  const size_t agent0 =
      static_cast<size_t>(blockIdx.x / blocks_per_group) * g_block + g0;
  const int item = item0 + threadIdx.x;
  const bool live = item < item_end;
  const int ga = live ? item / tiles - g0 : 0;  // the thread's staged agent
  const int sc0 = live ? (item % tiles) * SPT : 0;
  const size_t row0 = (agent0 + ga) * r + sc0;  // its first (agent, scale)

  float neg_s[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k)
    neg_s[k] = live && sc0 + k < r ? -scales[row0 + k] : 0.f;

  // hours [h0, h0 + len) of the staged agents into stage `buf`: warp w
  // copies agents w, w + 8, ..., its lanes the hours; `periods` turns the
  // ids of the same hours into periods after this thread's copies landed
  auto copy_chunk = [&](int buf, int h0, int len) {
    float4* dst = staged + buf * span * kChunk;
    for (int a = warp; a < n_staged; a += kThreads / 32) {
      const size_t src = (agent0 + a) * n_lanes + h0;
      for (int h = lane; h < len; h += 32) {
        float* d = reinterpret_cast<float*>(dst + a * kChunk + h);
        async_copy::copy<4>(d, load + src + h);
        async_copy::copy<4>(d + 1, gen + src + h);
        async_copy::copy<4>(d + 2, sell + src + h);
        async_copy::copy<4>(d + 3, bucket + src + h);
      }
    }
    async_copy::commit();
  };
  auto periods = [&](int buf, int len) {
    if constexpr (P > 1) {
      float4* dst = staged + buf * span * kChunk;
      for (int a = warp; a < n_staged; a += kThreads / 32)
        for (int h = lane; h < len; h += 32) {
          float4& v = dst[a * kChunk + h];
          const int per = __float_as_int(v.w) % P;
          v.w = P == 2 ? (per == 0 ? 1.f : 0.f) : __int_as_float(per);
        }
    }
  };

  month_chunks::Cursor<kChunk> ahead(offs);  // the next chunk to stage
  for (int s = 0; s + 1 < kStages; ++s) {
    if (ahead.done()) {
      async_copy::commit();
    } else {
      copy_chunk(s, ahead.lane0(offs), ahead.len(offs));
      ahead.next(offs);
    }
  }

  float year_sell[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) year_sell[k] = 0.f;
  int buf = 0;
  for (int mo = 0; mo < kMonths; ++mo) {
    const int month_len = offs.o[mo + 1] - offs.o[mo];
    float tot[SPT], msell[SPT], acc[kMasks][SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      tot[k] = msell[k] = 0.f;
#pragma unroll
      for (int p = 0; p < kMasks; ++p) acc[p][k] = 0.f;
    }
    for (int c0 = 0; c0 < month_len; c0 += kChunk) {
      const int len = min(kChunk, month_len - c0);
      async_copy::wait<kStages - 2>();
      periods(buf, len);
      // the chunk is visible, and every thread is done with the stage
      // refilled now (the one walked last)
      __syncthreads();
      if (ahead.done()) {
        async_copy::commit();
      } else {
        copy_chunk((buf + kStages - 1) % kStages, ahead.lane0(offs),
                   ahead.len(offs));
        ahead.next(offs);
      }
      if (live) {
        const float4* hour = staged + (buf * span + ga) * kChunk;
#pragma unroll 2
        for (int h = 0; h < len; ++h) {
          const float4 v = hour[h];
          float mask[kMasks];
#pragma unroll
          for (int p = 0; p < kMasks; ++p)
            mask[p] = P == 2 ? v.w : (__float_as_int(v.w) == p ? 1.f : 0.f);
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            const float pos = staging::relu_keep_nan(fmaf(neg_s[k], v.y, v.x));
            tot[k] += pos;
            msell[k] = fmaf(pos, v.z, msell[k]);
#pragma unroll
            for (int p = 0; p + 1 < P; ++p)
              acc[p][k] = fmaf(pos, mask[p], acc[p][k]);
          }
        }
      }
      buf = (buf + 1) % kStages;
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        if (sc0 + k >= r) continue;
        float* out = out_imp + (row0 + k) * kNb + mo * P;
        float rem = tot[k];
#pragma unroll
        for (int p = 0; p + 1 < P; ++p) {
          out[p] = acc[p][k];
          rem -= acc[p][k];
        }
        out[P - 1] = rem;
        year_sell[k] += msell[k];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      if (sc0 + k < r) out_sell[row0 + k] = year_sell[k];
  }
}

bool shapes_ok(int n, int r, int n_periods) {
  return n > 0 && r > 0 && n_periods >= 1 && n_periods <= kMaxPeriods;
}

// The widest scale tile (1, 2, 4 or 8; 4 at most past kWideP periods) of
// those that need the fewest rounds of kThreads threads x scales a thread.
int pick_spt(int g_block, int r, int n_periods) {
  const int widest = n_periods <= kWideP ? kMaxSpt : kMaxSpt / 2;
  int best = 1;
  long long best_cost = -1;
  for (int spt = 1; spt <= widest; spt *= 2) {
    const long long items = static_cast<long long>(g_block) * ((r + spt - 1) / spt);
    const long long cost = (items + kThreads - 1) / kThreads * spt;
    if (best_cost < 0 || cost <= best_cost) {
      best = spt;
      best_cost = cost;
    }
  }
  return best;
}

struct GroupLaunch {
  const float *load, *gen, *sell;
  const int* bucket;
  const float* scales;
  float *out_imp, *out_sell;
  int n, r, g_block;
  MonthOffsets offs;
  cudaStream_t stream;
};

template <int P, int SPT>
int launch_group(const GroupLaunch& a) {
  const int tiles = (a.r + SPT - 1) / SPT;
  const long long items = static_cast<long long>(a.g_block) * tiles;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_per_group = static_cast<int>((items + kThreads - 1) / kThreads);
  // most agents the 256 consecutive items of one block can touch
  const int span = std::min(a.g_block, (kThreads + tiles - 2) / tiles + 1);
  const long long smem =
      static_cast<long long>(kStages) * span * kChunk * sizeof(float4);
  const long long total =
      static_cast<long long>(a.n / a.g_block) * blocks_per_group;
  if (smem > kMaxSmemBytes || total > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = &monthmask_g_kernel<P, SPT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(total), kThreads, static_cast<size_t>(smem),
           a.stream>>>(a.load, a.gen, a.sell, a.bucket, a.scales, a.out_imp,
                       a.out_sell, a.r, a.offs.o[kMonths], a.g_block, tiles,
                       blocks_per_group, span, a.offs);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_group_spt(const GroupLaunch& a, int spt) {
  switch (spt) {
    case 1:
      return launch_group<P, 1>(a);
    case 2:
      return launch_group<P, 2>(a);
    case 4:
      return launch_group<P, 4>(a);
    default:
      if constexpr (P <= kWideP) return launch_group<P, kMaxSpt>(a);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_group_periods(const GroupLaunch& a, int n_periods) {
  const int spt = pick_spt(a.g_block, a.r, n_periods);
  switch (n_periods) {
    case 1: return launch_group_spt<1>(a, spt);
    case 2: return launch_group_spt<2>(a, spt);
    case 3: return launch_group_spt<3>(a, spt);
    case 4: return launch_group_spt<4>(a, spt);
    case 5: return launch_group_spt<5>(a, spt);
    case 6: return launch_group_spt<6>(a, spt);
    case 7: return launch_group_spt<7>(a, spt);
    case 8: return launch_group_spt<8>(a, spt);
    case 9: return launch_group_spt<9>(a, spt);
    case 10: return launch_group_spt<10>(a, spt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  GroupLaunch a{load, gen, sell, bucket, scales, out_imp, out_sell, n, r,
                g_block, {}, static_cast<cudaStream_t>(stream)};
  if (!shapes_ok(n, r, n_periods) || g_block < 1 || n % g_block != 0 ||
      offsets == nullptr ||
      !lanes::read_offsets(offsets, offsets[kMonths], 1, &a.offs))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_group_periods(a, n_periods);
}
