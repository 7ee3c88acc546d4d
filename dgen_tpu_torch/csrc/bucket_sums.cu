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
// The month kernel: period-partitioned staging (staging.cuh). A block
// stages one agent's month into shared memory as one float4 per lane
// (load, gen, sell) GROUPED BY TOU PERIOD, with a stable counting sort on
// the period lane (stage_by_period), and keeps the P + 1 run offsets
// beside it. Each thread owns SPT consecutive scales (default_spt: 1 at
// R <= 32, else 2) and walks the runs (sum_runs): over run q it keeps one
// import sum (and one signed sum) per scale in registers and stores it as
// bucket m * P + q. Per staged hour that is one broadcast 16-byte
// shared-memory load feeding SPT x (fma, max, add, fma) — no accumulator
// array, no predicate per period, so the work follows the hours, not
// P x hours. Each run is summed in lane order, so a period's sum is the
// same float32 sum, in the same order, as adding the period's lanes one
// by one; only the sell sums (per month, then added) take the lanes in
// period order. A block is as many warps as its scales need (at least 4,
// at most 8), so at R <= 512 one block stages each agent's month once; a
// warp whose scales all lie past R helps stage the hours and skips the
// arithmetic. The staging reads device memory in two sweeps with every
// thread's loads in flight together (periods, then the three streams),
// so a month costs two memory latencies, not one per chunk of lanes. A
// month is a contiguous slice of lanes in both layouts, so no
// month-padded repack is needed.
//
// The pair kernel: two partitions of one staged month. Both period rows
// are read in one sweep and ranked one after the other by the month
// kernel's routine (rank_by_class); one more sweep reads load, gen and
// the two sell rows and fills two arrays, one sorted by period_a (with
// sell_a), one by period_b (with sell_b): 2 x 16 bytes a lane, 24.6 KB
// at the longest month, in shared memory sized to it (with 16-bit slots,
// so 8 blocks fit an SM at full-hour months). On a compacted layout,
// lanes whose load and gen are both zero (its pad lanes) are ranked last
// and not staged, as in the stream kernel. Each thread then walks A's runs and B's
// runs over its SPT scales. That recomputes the fma and max for the
// second tariff (~8 issue slots per (scale, hour), against ~24 for
// predicated adds over 2 x 10 periods), and in return each output is,
// bit for bit, what one month-kernel launch gives on (load, gen, sell_a,
// period_a), resp. (load, gen, sell_b, period_b). What the fused pair
// saves over two month launches is the second staging of load and gen,
// and the walk over the pad lanes.
// Blocks and scales a thread as the month kernel's.
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
#include "staging.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMaxSegLanes;
using lanes::kMonths;
using lanes::MonthOffsets;
using lanes::store;
using lanes::to_f32;
using staging::kMaxThreads;

template <bool SIGNED, int SPT, typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(kMaxThreads)
    month_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
                 const TS* __restrict__ sell, const int* __restrict__ period,
                 const float* __restrict__ scales, TO* __restrict__ out_imp,
                 TO* __restrict__ out_sell_imp, TO* __restrict__ out_sgn,
                 TO* __restrict__ out_sell_sgn, int r, int n_lanes,
                 int n_periods, int r_blocks, MonthOffsets offs) {
  __shared__ float4 hour[kMaxSegLanes];  // load, gen, sell; by period
  __shared__ int cls[kMaxSegLanes];      // each lane's period class
  __shared__ int slot[kMaxSegLanes];     // each lane's place in hour
  __shared__ int warp_count[kMaxThreads / 32][kMaxPeriods + 1];
  __shared__ int warp_base[kMaxThreads / 32][kMaxPeriods + 1];
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
    const size_t h0 = row + offs.o[m];
    __syncthreads();  // every thread is done with the previous month
    staging::stage_by_period<false>(
        offs.o[m + 1] - offs.o[m], n_periods + 1,
        [&](int h) { return staging::period_class(period[h0 + h], n_periods); },
        [&](int h) {
          const size_t g = h0 + h;
          return make_float4(to_f32(load[g]), to_f32(gen[g]), to_f32(sell[g]),
                             0.f);
        },
        hour, cls, slot, warp_count, warp_base, run);
    if (!warp_live) continue;  // no scale of this warp lies below R
    staging::sum_runs<SIGNED, SPT>(hour, run, n_periods, m, s, r0, r, out_row,
                                   nb, out_imp, out_sgn, sell_imp, sell_sgn);
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (r0 + j >= r) break;
    store(out_sell_imp + out_row + j, sell_imp[j]);
    if (SIGNED) store(out_sell_sgn + out_row + j, sell_sgn[j]);
  }
}

// Byte offsets of the pair kernel's dynamic shared memory at seg_cap lanes
// in the longest month: the two sorted months (a float4 a lane each) at
// 0, the two 16-bit class/slot rows, the (warp, class) counts and bases,
// the two run-offset rows; `bytes` in all.
struct PairLayout {
  int slots, counts, bytes;
};

inline __host__ __device__ PairLayout pair_layout(int seg_cap, int n_warps) {
  PairLayout p;
  p.slots = 2 * 16 * seg_cap;
  p.counts = p.slots + (2 * 2 * seg_cap + 15) / 16 * 16;
  p.bytes = p.counts + 4 * (2 * n_warps * staging::kMaxClasses +
                            2 * (staging::kMaxClasses + 1));
  return p;
}

// Two partitions of one staged month: the lanes sorted by period_a (with
// sell_a) into hour_a and by period_b (with sell_b) into hour_b, each
// ranked by the month kernel's routine. The first sweep reads both
// period rows and load and gen (for the zero class below); the second
// reads load, gen and the sell rows again, from cache, and fills both
// arrays. On a compacted layout, lanes whose load and gen are both zero
// (its pad lanes) form one more class, ranked last in both partitions
// and not staged: they add nothing (bucket_sums_stream.cu says why, bit
// for bit). The walk over each partition is the month kernel's, so output A
// is bit for bit one month-kernel launch on (load, gen, sell_a,
// period_a), and B likewise on (load, gen, sell_b, period_b). Shared
// memory (pair_layout) is sized to the longest month, with 16-bit
// classes and slots: 27,368 bytes at 744 lanes and 5 warps, so 8 blocks
// fit an SM.
template <int SPT, bool DROP, typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(kMaxThreads)
    month_pair_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
                      const TS* __restrict__ sell_a,
                      const int* __restrict__ period_a,
                      const TS* __restrict__ sell_b,
                      const int* __restrict__ period_b,
                      const float* __restrict__ scales, TO* __restrict__ out_a,
                      TO* __restrict__ out_sell_a, TO* __restrict__ out_b,
                      TO* __restrict__ out_sell_b, int r, int n_lanes,
                      int n_periods, int r_blocks, int seg_cap,
                      MonthOffsets offs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x / 32;
  const PairLayout lay = pair_layout(seg_cap, n_warps);
  float4* hour_a = reinterpret_cast<float4*>(smem);  // load, gen, sell_a
  float4* hour_b = hour_a + seg_cap;                 // load, gen, sell_b
  short* slot_a = reinterpret_cast<short*>(smem + lay.slots);  // class, slot
  short* slot_b = slot_a + seg_cap;
  auto warp_count =
      reinterpret_cast<int(*)[staging::kMaxClasses]>(smem + lay.counts);
  auto warp_base = warp_count + n_warps;
  int* run_a = reinterpret_cast<int*>(warp_base + n_warps);
  int* run_b = run_a + staging::kMaxClasses + 1;

  const int agent = blockIdx.x / r_blocks;
  const int r0 = ((blockIdx.x % r_blocks) * blockDim.x + threadIdx.x) * SPT;
  const bool warp_live = r0 - static_cast<int>(threadIdx.x % 32) * SPT < r;
  const size_t row = static_cast<size_t>(agent) * n_lanes;
  const size_t out_row = static_cast<size_t>(agent) * r + r0;
  const int nb = kMonths * n_periods;
  const int n_classes = n_periods + (DROP ? 2 : 1);
  const int zero_class = n_periods + 1;  // load and gen both zero: dropped
  float s[SPT];
  float sell_sum_a[SPT];
  float sell_sum_b[SPT];
  float no_signed[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    s[j] = r0 + j < r ? scales[out_row + j] : 0.f;
    sell_sum_a[j] = 0.f;
    sell_sum_b[j] = 0.f;
    no_signed[j] = 0.f;
  }

  for (int m = 0; m < kMonths; ++m) {
    const size_t h0 = row + offs.o[m];
    const int len = offs.o[m + 1] - offs.o[m];
    __syncthreads();  // every thread is done with the previous month
#pragma unroll 4
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      const size_t g = h0 + h;
      const bool zero =
          DROP && to_f32(load[g]) == 0.f && to_f32(gen[g]) == 0.f;
      slot_a[h] = static_cast<short>(
          zero ? zero_class : staging::period_class(period_a[g], n_periods));
      slot_b[h] = static_cast<short>(
          zero ? zero_class : staging::period_class(period_b[g], n_periods));
    }
    __syncthreads();
    staging::rank_by_class(
        slot_a, len, n_classes, warp_count, warp_base, run_a,
        [&](int h, int at) { slot_a[h] = static_cast<short>(at); });
    staging::rank_by_class(
        slot_b, len, n_classes, warp_count, warp_base, run_b,
        [&](int h, int at) { slot_b[h] = static_cast<short>(at); });
    const int kept = DROP ? run_a[zero_class] : len;  // zero in A and B
#pragma unroll 4
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      const int at = slot_a[h];
      if (at >= kept) continue;
      const size_t g = h0 + h;
      const float l = to_f32(load[g]);
      const float ge = to_f32(gen[g]);
      hour_a[at] = make_float4(l, ge, to_f32(sell_a[g]), 0.f);
      hour_b[slot_b[h]] = make_float4(l, ge, to_f32(sell_b[g]), 0.f);
    }
    __syncthreads();
    if (!warp_live) continue;  // no scale of this warp lies below R
    staging::sum_runs<false, SPT, TO>(hour_a, run_a, n_periods, m, s, r0, r,
                                      out_row, nb, out_a, nullptr, sell_sum_a,
                                      no_signed);
    staging::sum_runs<false, SPT, TO>(hour_b, run_b, n_periods, m, s, r0, r,
                                      out_row, nb, out_b, nullptr, sell_sum_b,
                                      no_signed);
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (r0 + j >= r) break;
    store(out_sell_a + out_row + j, sell_sum_a[j]);
    store(out_sell_b + out_row + j, sell_sum_b[j]);
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

template <bool SIGNED, int SPT, typename TL, typename TG, typename TS>
int launch_month(const void* load, const void* gen, const void* sell,
                 const int* period, const float* scales, const int* offsets,
                 void* out_imp, void* out_sell_imp, void* out_sgn,
                 void* out_sell_sgn, int n, int r, int n_lanes, int n_periods,
                 cudaStream_t st) {
  using TO = lanes::SumsOut<TL, TG, TS>;
  const int threads = staging::agent_threads(r, SPT);
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
    if (spt == 0) spt = staging::default_spt(r);
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
  const int spt = staging::default_spt(r);
  const int threads = staging::agent_threads(r, spt);
  MonthOffsets offs;
  int r_blocks;
  unsigned blocks;
  if (!grid_for(n, r, n_lanes, n_periods, offsets, threads * spt, &offs,
                &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg_cap = lanes::max_segment(offs);
  const int smem = pair_layout(seg_cap, threads / 32).bytes;  // < 48 KB
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = lanes::with_stream_types<false>(
      dt_load, dt_gen, dt_sell, [&](auto l, auto g, auto s) {
        using TL = typename decltype(l)::type;
        using TG = typename decltype(g)::type;
        using TS = typename decltype(s)::type;
        using TO = lanes::SumsOut<TL, TG, TS>;
        auto launch = [&](auto spt_tag, auto drop_tag) {
          constexpr int kSpt = decltype(spt_tag)::value;
          constexpr bool kDrop = decltype(drop_tag)::value;
          month_pair_kernel<kSpt, kDrop, TL, TG, TS>
              <<<blocks, threads, smem, st>>>(
              static_cast<const TL*>(load), static_cast<const TG*>(gen),
              static_cast<const TS*>(sell_a), period_a,
              static_cast<const TS*>(sell_b), period_b, scales,
              static_cast<TO*>(out_a), static_cast<TO*>(out_sell_a),
              static_cast<TO*>(out_b), static_cast<TO*>(out_sell_b), r,
              n_lanes, n_periods, r_blocks, seg_cap, offs);
        };
        auto with_drop = [&](auto spt_tag) {
          if (staging::drops_zero_lanes(n_lanes)) launch(spt_tag, std::true_type());
          else launch(spt_tag, std::false_type());
        };
        if (spt == 1) with_drop(std::integral_constant<int, 1>());
        else with_drop(std::integral_constant<int, 2>());
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
