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
// operations against ~1.2 GB of streams read once, so the kernels are
// bound by FP32 ALU throughput, not by memory.
//
// The month kernel: period-partitioned staging. A block stages one
// agent's month into shared memory as one float4 per lane (load, gen,
// sell) GROUPED BY TOU PERIOD, with a stable counting sort on the period
// lane (stage_by_period), and keeps the P + 1 run offsets beside it.
// Each thread owns SPT consecutive scales (default_spt: 1 at R <= 32, else
// 2) and walks the runs q = 0 .. P - 1: over run q it keeps one import sum
// (and one signed sum) per scale in registers and stores it as bucket
// m * P + q. Per staged hour that is one broadcast 16-byte shared-memory
// load feeding SPT x (fma, max, add, fma) — no accumulator array, no
// predicate per period, so the work follows the hours, not P x hours.
// Each run is summed in lane order, so a period's sum is the same float32
// sum, in the same order, as adding the period's lanes one by one; only
// the sell sums (per month, then added) take the lanes in period order.
// A block is as many warps as its scales need (at least 4, at most 8),
// so at R <= 512 one block stages each agent's month once; a warp whose
// scales all lie past R helps stage the hours and skips the arithmetic.
// The staging reads device memory in two sweeps with every thread's
// loads in flight together (periods, then the three streams), so a
// month costs two memory latencies, not one per chunk of lanes. A month
// is a contiguous slice of lanes in both layouts, so no month-padded
// repack is needed.
//
// The pair kernel: the lane streams of one agent are staged month by
// month as one float4 per lane; one thread owns one scale and selects
// each period's accumulator through predicated adds unrolled over the
// compile-time kMaxPeriods = 10, so no accumulator array spills to local
// memory. A block is kThreads = 128 threads (scales). Each period is
// summed directly (no last period by subtraction from the month total),
// and the sell sums are taken per month and then added, which keeps
// float32 rounding small.
//
// Stream types (lanes.cuh): load, gen and sell are read as float32,
// bfloat16 or int8 codes, upcast when read; the sums are taken in float
// and stored as SumsOut (bfloat16 for bf16 banks). Each type is a
// template argument, so a float32 launch runs the same instructions as
// before the narrow forms existed; the staged float4 is float either way.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "lanes.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMaxSegLanes;
using lanes::kMonths;
using lanes::MonthOffsets;
using lanes::store;
using lanes::to_f32;

constexpr int kThreads = 128;          // pair kernel: one scale a thread
constexpr int kMonthMaxThreads = 256;  // month kernel: most threads a block
constexpr int kMonthMinThreads = 128;  // ... and fewest (to stage a month)

// Stages one agent's month of `len` lanes from `row` into `hour`, grouped
// by TOU period with a stable counting sort: the lanes of period q, in
// lane order, in hour[run[q] .. run[q + 1]), and lanes whose period lies
// outside [0, n_periods) last, in run n_periods (they count in the sell
// sums only). Device memory is read in two sweeps in which every thread
// has its loads in flight at once: the period lanes into `cls` (as
// classes) first, the load, gen and sell lanes straight into their slots
// last. Between them each warp ranks a contiguous share of the month in
// chunks of 32 lanes from shared memory: pass 1 counts its lanes per
// class with one ballot per class, the block turns the (warp, class)
// counts into each warp's first slot per class, and pass 2 gives every
// lane its slot plus its rank among the chunk's lanes of its class.
template <typename TL, typename TG, typename TS>
__device__ __forceinline__ void stage_by_period(
    const TL* __restrict__ load, const TG* __restrict__ gen,
    const TS* __restrict__ sell, const int* __restrict__ period, size_t row,
    int len, int n_periods, float4* hour, int* cls, int* slot,
    int (*warp_count)[kMaxPeriods + 1], int (*warp_base)[kMaxPeriods + 1],
    int* run) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  const int n_classes = n_periods + 1;
  const unsigned below = (1u << lane) - 1u;

#pragma unroll 4
  for (int h = threadIdx.x; h < len; h += blockDim.x) {
    const int p = period[row + h];
    cls[h] = (p >= 0 && p < n_periods) ? p : n_periods;
  }
  __syncthreads();

  const int span = (len + blockDim.x - 1) / blockDim.x * 32;
  const int hb = min(len, warp * span);
  const int he = min(len, hb + span);
  int count = 0;  // lane q: lanes of class q in this warp's share
  for (int c = hb; c < he; c += 32) {
    const int p = c + lane < he ? cls[c + lane] : -1;
    for (int q = 0; q < n_classes; ++q) {
      const unsigned in_q = __ballot_sync(0xffffffffu, p == q);
      if (lane == q) count += __popc(in_q);
    }
  }
  if (lane < n_classes) warp_count[warp][lane] = count;
  __syncthreads();
  if (threadIdx.x < n_warps * n_classes) {
    const int w = threadIdx.x / n_classes;
    const int q = threadIdx.x % n_classes;
    int base = 0;  // every lane of an earlier class, then of q in earlier warps
    for (int w2 = 0; w2 < n_warps; ++w2) {
      for (int q2 = 0; q2 < q; ++q2) base += warp_count[w2][q2];
      if (w2 < w) base += warp_count[w2][q];
    }
    warp_base[w][q] = base;
    if (w == 0) run[q] = base;
    if (w == 0 && q == n_periods) run[n_classes] = len;
  }
  __syncthreads();
  int next = lane < n_classes ? warp_base[warp][lane] : 0;
  for (int c = hb; c < he; c += 32) {
    const int h = c + lane;
    const int p = h < he ? cls[h] : -1;
    int at = 0;
    for (int q = 0; q < n_classes; ++q) {
      const unsigned in_q = __ballot_sync(0xffffffffu, p == q);
      const int first = __shfl_sync(0xffffffffu, next, q);
      if (p == q) at = first + __popc(in_q & below);
      if (lane == q) next += __popc(in_q);
    }
    if (h < he) slot[h] = at;
  }
  __syncthreads();

#pragma unroll 4
  for (int h = threadIdx.x; h < len; h += blockDim.x) {
    const size_t g = row + h;
    hour[slot[h]] = make_float4(to_f32(load[g]), to_f32(gen[g]),
                                to_f32(sell[g]), 0.f);
  }
}

template <bool SIGNED, int SPT, typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(kMonthMaxThreads)
    month_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
                 const TS* __restrict__ sell, const int* __restrict__ period,
                 const float* __restrict__ scales, TO* __restrict__ out_imp,
                 TO* __restrict__ out_sell_imp, TO* __restrict__ out_sgn,
                 TO* __restrict__ out_sell_sgn, int r, int n_lanes,
                 int n_periods, int r_blocks, MonthOffsets offs) {
  __shared__ float4 hour[kMaxSegLanes];  // load, gen, sell; by period
  __shared__ int cls[kMaxSegLanes];      // each lane's period class
  __shared__ int slot[kMaxSegLanes];     // each lane's place in hour
  __shared__ int warp_count[kMonthMaxThreads / 32][kMaxPeriods + 1];
  __shared__ int warp_base[kMonthMaxThreads / 32][kMaxPeriods + 1];
  __shared__ int run[kMaxPeriods + 2];

  const int agent = blockIdx.x / r_blocks;
  // this thread's scales: SPT consecutive ones from r0
  const int r0 = ((blockIdx.x % r_blocks) * blockDim.x + threadIdx.x) * SPT;
  const bool warp_live = r0 - static_cast<int>(threadIdx.x % 32) * SPT < r;
  const size_t row = static_cast<size_t>(agent) * n_lanes;
  const size_t out_row = static_cast<size_t>(agent) * r + r0;
  const int nb = kMonths * n_periods;
  float s[SPT];
  float sell_imp[SPT];
  float sell_sgn[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    s[j] = r0 + j < r ? scales[out_row + j] : 0.f;
    sell_imp[j] = 0.f;
    sell_sgn[j] = 0.f;
  }

  for (int m = 0; m < kMonths; ++m) {
    const int h0 = offs.o[m];
    __syncthreads();  // every thread is done with the previous month
    stage_by_period(load, gen, sell, period, row + h0, offs.o[m + 1] - h0,
                    n_periods, hour, cls, slot, warp_count, warp_base, run);
    __syncthreads();
    if (!warp_live) continue;  // no scale of this warp lies below R

    float mi[SPT];  // the month's sell-weighted sums
    float ms[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      mi[j] = 0.f;
      ms[j] = 0.f;
    }
    for (int q = 0; q <= n_periods; ++q) {
      float ai[SPT];  // period q's sums
      float as[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        ai[j] = 0.f;
        as[j] = 0.f;
      }
      const int end = run[q + 1];
#pragma unroll 4
      for (int h = run[q]; h < end; ++h) {
        const float4 v = hour[h];
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const float net = fmaf(-s[j], v.y, v.x);
          const float pos = fmaxf(net, 0.f);
          ai[j] += pos;
          mi[j] = fmaf(pos, v.z, mi[j]);
          if (SIGNED) {
            as[j] += net;
            ms[j] = fmaf(net, v.z, ms[j]);
          }
        }
      }
      if (q == n_periods) break;  // out-of-range periods: sell sums only
      const size_t b = static_cast<size_t>(m) * n_periods + q;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        if (r0 + j >= r) break;
        store(out_imp + (out_row + j) * nb + b, ai[j]);
        if (SIGNED) store(out_sgn + (out_row + j) * nb + b, as[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      sell_imp[j] += mi[j];
      sell_sgn[j] += ms[j];
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (r0 + j >= r) break;
    store(out_sell_imp + out_row + j, sell_imp[j]);
    if (SIGNED) store(out_sell_sgn + out_row + j, sell_sgn[j]);
  }
}

template <typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void month_pair_kernel(const TL* __restrict__ load,
                                  const TG* __restrict__ gen,
                                  const TS* __restrict__ sell_a,
                                  const int* __restrict__ period_a,
                                  const TS* __restrict__ sell_b,
                                  const int* __restrict__ period_b,
                                  const float* __restrict__ scales,
                                  TO* __restrict__ out_a,
                                  TO* __restrict__ out_sell_a,
                                  TO* __restrict__ out_b,
                                  TO* __restrict__ out_sell_b,
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
      hour[h] = make_float4(to_f32(load[g]), to_f32(gen[g]), to_f32(sell_a[g]),
                            to_f32(sell_b[g]));
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
      TO* oa = out_a + out_row * nb + m * n_periods;
      TO* ob = out_b + out_row * nb + m * n_periods;
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q) {
        if (q < n_periods) {
          store(oa + q, acc_a[q]);
          store(ob + q, acc_b[q]);
        }
      }
    }
  }
  if (live) {
    store(out_sell_a + out_row, sell_sum_a);
    store(out_sell_b + out_row, sell_sum_b);
  }
}

// Grid (N x ceil(R / per_block)) blocks and the month offsets; false
// for shapes or offsets the kernels do not take.
bool grid_for(int n, int r, int n_lanes, int n_periods, const int* offsets,
              int per_block, MonthOffsets* offs, int* r_blocks,
              unsigned* blocks) {
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > kMaxPeriods ||
      !lanes::read_offsets(offsets, n_lanes, 1, offs))
    return false;
  *r_blocks = (r + per_block - 1) / per_block;
  const long long total = static_cast<long long>(n) * *r_blocks;
  if (total > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(total);
  return true;
}

// The month kernel's scales a thread: 1 while R's scales fit one warp
// (2 a thread would idle more than half its lanes), else 2, which feeds
// each staged hour to twice the arithmetic.
int default_spt(int r) { return r <= 32 ? 1 : 2; }

// Threads of a month-kernel block at spt scales a thread: whole warps
// for R's scales, at least kMonthMinThreads (the warps past R help stage
// each month) and at most kMonthMaxThreads.
int month_threads(int r, int spt) {
  const int warps = ((r + spt - 1) / spt + 31) / 32;
  return 32 * std::max(kMonthMinThreads / 32,
                       std::min(warps, kMonthMaxThreads / 32));
}

template <bool SIGNED, int SPT, typename TL, typename TG, typename TS>
int launch_month(const void* load, const void* gen, const void* sell,
                 const int* period, const float* scales, const int* offsets,
                 void* out_imp, void* out_sell_imp, void* out_sgn,
                 void* out_sell_sgn, int n, int r, int n_lanes, int n_periods,
                 cudaStream_t st) {
  using TO = lanes::SumsOut<TL, TG, TS>;
  const int threads = month_threads(r, SPT);
  MonthOffsets offs;
  int r_blocks;
  unsigned blocks;
  if (!grid_for(n, r, n_lanes, n_periods, offsets, threads * SPT, &offs,
                &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  month_kernel<SIGNED, SPT, TL, TG, TS><<<blocks, threads, 0, st>>>(
      static_cast<const TL*>(load), static_cast<const TG*>(gen),
      static_cast<const TS*>(sell), period, scales, static_cast<TO*>(out_imp),
      static_cast<TO*>(out_sell_imp), static_cast<TO*>(out_sgn),
      static_cast<TO*>(out_sell_sgn), r, n_lanes, n_periods, r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes, offsets or a stream dtype combination
// the kernels do not take (lanes.cuh: with_stream_types; dtype codes
// 0 = float32, 1 = bfloat16, 2 = int8). `offsets` is a host array of 13
// lane offsets; outputs are of the SumsOut type of the stream types.
// bucket_sums_month_spt takes the month kernel's scales per thread: 1 or
// 2, or 4 on float32 streams; 0 picks default_spt(r), as
// bucket_sums_month does.
extern "C" int bucket_sums_month_spt(const void* load, const void* gen,
                                     const void* sell, const int* period,
                                     const float* scales, const int* offsets,
                                     void* out_imp, void* out_sell_imp,
                                     void* out_sgn, void* out_sell_sgn, int n,
                                     int r, int n_lanes, int n_periods,
                                     int with_signed, int dt_load, int dt_gen,
                                     int dt_sell, int spt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  auto launch = [&](auto signed_tag, auto l, auto g, auto s) {
    constexpr bool kSigned = decltype(signed_tag)::value;
    using TL = typename decltype(l)::type;
    using TG = typename decltype(g)::type;
    using TS = typename decltype(s)::type;
    auto at = [&](auto spt_tag) {
      constexpr int kSpt = decltype(spt_tag)::value;
      rc = launch_month<kSigned, kSpt, TL, TG, TS>(
          load, gen, sell, period, scales, offsets, out_imp, out_sell_imp,
          out_sgn, out_sell_sgn, n, r, n_lanes, n_periods, st);
    };
    if (spt == 0) spt = default_spt(r);
    if (spt == 1) at(std::integral_constant<int, 1>());
    if (spt == 2) at(std::integral_constant<int, 2>());
    if constexpr (std::is_same<TL, float>::value &&
                  std::is_same<TG, float>::value &&
                  std::is_same<TS, float>::value) {
      if (spt == 4) at(std::integral_constant<int, 4>());
    }
  };
  const bool known =
      with_signed
          ? lanes::with_stream_types<true>(
                dt_load, dt_gen, dt_sell,
                [&](auto l, auto g, auto s) {
                  launch(std::true_type(), l, g, s);
                })
          : lanes::with_stream_types<false>(
                dt_load, dt_gen, dt_sell, [&](auto l, auto g, auto s) {
                  launch(std::false_type(), l, g, s);
                });
  return known ? rc : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bucket_sums_month(const void* load, const void* gen,
                                 const void* sell, const int* period,
                                 const float* scales, const int* offsets,
                                 void* out_imp, void* out_sell_imp,
                                 void* out_sgn, void* out_sell_sgn, int n,
                                 int r, int n_lanes, int n_periods,
                                 int with_signed, int dt_load, int dt_gen,
                                 int dt_sell, void* stream) {
  return bucket_sums_month_spt(load, gen, sell, period, scales, offsets,
                               out_imp, out_sell_imp, out_sgn, out_sell_sgn, n,
                               r, n_lanes, n_periods, with_signed, dt_load,
                               dt_gen, dt_sell, 0, stream);
}

extern "C" int bucket_sums_month_pair(const void* load, const void* gen,
                                      const void* sell_a, const int* period_a,
                                      const void* sell_b, const int* period_b,
                                      const float* scales, const int* offsets,
                                      void* out_a, void* out_sell_a,
                                      void* out_b, void* out_sell_b, int n,
                                      int r, int n_lanes, int n_periods,
                                      int dt_load, int dt_gen, int dt_sell,
                                      void* stream) {
  MonthOffsets offs;
  int r_blocks;
  unsigned blocks;
  if (!grid_for(n, r, n_lanes, n_periods, offsets, kThreads, &offs,
                &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = lanes::with_stream_types<false>(
      dt_load, dt_gen, dt_sell, [&](auto l, auto g, auto s) {
        using TL = typename decltype(l)::type;
        using TG = typename decltype(g)::type;
        using TS = typename decltype(s)::type;
        using TO = lanes::SumsOut<TL, TG, TS>;
        month_pair_kernel<TL, TG, TS><<<blocks, kThreads, 0, st>>>(
            static_cast<const TL*>(load), static_cast<const TG*>(gen),
            static_cast<const TS*>(sell_a), period_a,
            static_cast<const TS*>(sell_b), period_b, scales,
            static_cast<TO*>(out_a), static_cast<TO*>(out_sell_a),
            static_cast<TO*>(out_b), static_cast<TO*>(out_sell_b), r, n_lanes,
            n_periods, r_blocks, offs);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
