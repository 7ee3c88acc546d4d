// Segment-streaming bucket-sums kernel, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel_stream (dgen_tpu/ops/billpallas.py:840,
// launched by _sums_pallas_stream :942): the month kernel's function
// (bucket_sums.cu) over an (agent block x month segment) schedule. For
// every agent n and scale s = scales[n, r] it reduces net = load - s * gen
// over the agent's lanes into per-(month, TOU period) sums of relu(net)
// (and of net when signed) plus the sell-rate-weighted sums. Lanes follow
// lanes.cuh: the uniform daylight-compacted lanes of the sizing search's
// refine rounds, or the full-hour 8760 lanes of the battery forward run.
//
// Bound on an H100: as for the month kernel, float32 ALU throughput. Per
// (agent, scale, lane) the work is an FMA for net, a max for relu, an FMA
// for the sell sum and an add into the period's sum (twice that signed).
// At the refine rounds' shapes (8192 agents x 300 scales x 6144 compacted
// lanes, 4380 of them an hour) that is ~6.5e10 operations against ~0.8 GB
// of lanes read once. The signed launch (R = 25) is bound by its bytes.
//
// What the TPU kernel keeps out of HBM is its schedule: the copy of month
// segment m + 1 overlaps the sums over segment m, and the accumulators
// carry across the month loop. The design keeps that overlap and takes
// its arithmetic from the month kernel's period-partitioned staging
// (staging.cuh):
//   * one block owns an agent, as the month kernel's does: as many warps
//     as its scales need (staging::agent_threads: at least 4, at most
//     8), 1 scale a thread at R <= 32, else 2, so one block covers
//     R <= 512 and stages each agent-month once; a warp whose scales
//     all lie past R helps stage and skips the arithmetic. At R <= 32
//     (the signed launch, R = 25) several agents a block, each on 1, 2
//     or 4 warps of its own, were no faster on an H100 (1.80-1.96 ms
//     against the month kernel's one-agent block, 1.78-1.92, at 8192 x
//     25 x 8760), so the kernel keeps the one shape;
//   * the block's shared memory holds one raw stage (the month's load,
//     gen, sell and period rows, each in its own type) and one sorted
//     month (a float4 per lane). Month m + 1's rows are copied into the
//     raw stage with cp.async as soon as month m has been sorted out of
//     it, so the copy is in flight while the sorted month m is summed;
//   * once a month has landed, a stable counting sort by period class
//     (stage_by_period) turns the raw rows into float4 (load, gen, sell,
//     0) runs, out-of-range periods last (sell sums only). The int32
//     period row is read once per agent-month, in shared memory, and
//     holds the lanes' classes and then their slots in place;
//   * on a compacted layout, lanes whose load and gen are both zero (the
//     zero-filled pad lanes: 1764 of the uniform layout's 6144) form one
//     more class, ranked last and not staged (full-hour lanes have no
//     pads and skip the class, staging.cuh). Such a lane adds +0 or -0
//     to every sum: with finite scales and sell rates, fmaf(-s, 0, 0) is
//     +0, relu gives +-0, and an accumulator that starts at +0 is never
//     -0, so adding it changes no bit. Dropping them leaves every output
//     bit for bit the same and saves their share of the walk;
//   * each thread walks runs q = 0 .. P over its scales with (fma, max,
//     add, fma) a lane (sum_runs, the month kernel's own walk), so the
//     stream kernel equals the month kernel bit for bit on the same
//     operands, for every stream type, P and R.
// Rows are copied four lanes at a time (16 bytes of float, 8 of bfloat16,
// 4 of int8 codes or periods), so every month offset is a multiple of 4
// lanes (calendar months are whole days, compacted segments whole 128-lane
// blocks), which the launcher checks. Shared memory a block at the
// longest full-hour month (744 lanes): 11,904 bytes of float32 raw rows
// (7,456 with int8 load and gen), 11,904 of sorted month, ~400 of counts,
// well below the 48 KB a launch takes without opting in.
//
// Stream types (lanes.cuh): load, gen and sell are float32, bfloat16 or
// int8 codes, template arguments of the kernel, upcast when sorted and
// summed in float; the sums are stored as SumsOut.

#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"
#include "lanes.cuh"
#include "staging.cuh"

namespace {

using lanes::kMonths;
using lanes::MonthOffsets;
using lanes::to_f32;
using staging::kMaxClasses;

// Queues the copy of four lanes of type T starting at lane `lane` of
// `src` to lane `lane` of the shared row `dst`.
template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src, int lane) {
  async_copy::copy<static_cast<int>(4 * sizeof(T))>(dst + lane, src + lane);
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of a block's shared memory: the raw load row at 0, then
// the gen, sell and period rows, the sorted month (float4 a lane), the
// (warp, class) counts and bases, the run offsets; `bytes` in all.
struct StageLayout {
  int gen, sell, period, hour, counts, bytes;
};

__host__ __device__ inline StageLayout stage_layout(int seg_cap, int b_load,
                                                    int b_gen, int b_sell,
                                                    int n_warps) {
  StageLayout g;
  g.gen = align16(seg_cap * b_load);
  g.sell = g.gen + align16(seg_cap * b_gen);
  g.period = g.sell + align16(seg_cap * b_sell);
  g.hour = g.period + align16(seg_cap * 4);
  g.counts = g.hour + seg_cap * 16;
  g.bytes =
      align16(g.counts + 4 * (2 * n_warps * kMaxClasses + kMaxClasses + 1));
  return g;
}

// One block an agent's SPT x blockDim.x scales (r_blocks blocks for its
// scales past 512). DROP: lanes whose load and gen are both zero are not
// staged (staging::drops_zero_lanes).
template <bool SIGNED, int SPT, bool DROP, typename TL, typename TG,
          typename TS, typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(staging::kMaxThreads)
    stream_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
                  const TS* __restrict__ sell,
                  const int* __restrict__ period,
                  const float* __restrict__ scales, TO* __restrict__ out_imp,
                  TO* __restrict__ out_sell_imp, TO* __restrict__ out_sgn,
                  TO* __restrict__ out_sell_sgn, int r, int n_lanes,
                  int n_periods, int r_blocks, int seg_cap,
                  MonthOffsets offs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x / 32;
  const StageLayout lay = stage_layout(seg_cap, sizeof(TL), sizeof(TG),
                                       sizeof(TS), n_warps);
  const int agent = blockIdx.x / r_blocks;
  // this thread's scales: SPT consecutive ones from r0
  const int r0 = ((blockIdx.x % r_blocks) * blockDim.x + threadIdx.x) * SPT;
  TL* raw_l = reinterpret_cast<TL*>(smem);
  TG* raw_g = reinterpret_cast<TG*>(smem + lay.gen);
  TS* raw_s = reinterpret_cast<TS*>(smem + lay.sell);
  int* raw_p = reinterpret_cast<int*>(smem + lay.period);  // then classes, slots
  float4* hour = reinterpret_cast<float4*>(smem + lay.hour);
  auto warp_count = reinterpret_cast<int(*)[kMaxClasses]>(smem + lay.counts);
  auto warp_base = warp_count + n_warps;
  int* run = reinterpret_cast<int*>(warp_base + n_warps);

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

  // Queues the copies of month m's four rows into the raw stage as one
  // cp.async group.
  auto issue = [&](int m) {
    const size_t g0 = row + offs.o[m];
    const int len = offs.o[m + 1] - offs.o[m];
    for (int c = 4 * threadIdx.x; c < len; c += 4 * blockDim.x) {
      copy4(raw_l, load + g0, c);
      copy4(raw_g, gen + g0, c);
      copy4(raw_s, sell + g0, c);
      copy4(raw_p, period + g0, c);
    }
    async_copy::commit();
  };

  const int zero_class = n_periods + 1;  // load and gen both zero: dropped
  issue(0);
  for (int m = 0; m < kMonths; ++m) {
    async_copy::wait<0>();  // this thread's copies of month m landed
    __syncthreads();  // ... and every thread's; none still sums month m - 1
    staging::stage_by_period<DROP>(
        offs.o[m + 1] - offs.o[m], n_periods + (DROP ? 2 : 1),
        [&](int h) {
          return DROP && to_f32(raw_l[h]) == 0.f && to_f32(raw_g[h]) == 0.f
                     ? zero_class
                     : staging::period_class(raw_p[h], n_periods);
        },
        [&](int h) {
          return make_float4(to_f32(raw_l[h]), to_f32(raw_g[h]),
                             to_f32(raw_s[h]), 0.f);
        },
        hour, raw_p, raw_p, warp_count, warp_base, run);
    if (m + 1 < kMonths) issue(m + 1);  // in flight under month m's sums
    if (!warp_live) continue;  // no scale of this warp lies below R
    staging::sum_runs<SIGNED, SPT>(hour, run, n_periods, m, s, r0, r, out_row,
                                   nb, out_imp, out_sgn, sell_imp, sell_sgn);
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (r0 + j >= r) break;
    lanes::store(out_sell_imp + out_row + j, sell_imp[j]);
    if (SIGNED) lanes::store(out_sell_sgn + out_row + j, sell_sgn[j]);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes, offsets, pointers or a stream dtype
// combination the kernel does not take (every offset a multiple of 4
// lanes, n_lanes too, each stream aligned to four of its elements; dtype
// codes as in lanes.cuh). `offsets` is a host array of 13 lane offsets.
extern "C" int bucket_sums_stream(const void* load, const void* gen,
                                  const void* sell, const int* period,
                                  const float* scales, const int* offsets,
                                  void* out_imp, void* out_sell_imp,
                                  void* out_sgn, void* out_sell_sgn, int n,
                                  int r, int n_lanes, int n_periods,
                                  int with_signed, int dt_load, int dt_gen,
                                  int dt_sell, void* stream) {
  MonthOffsets offs;
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > lanes::kMaxPeriods ||
      !lanes::read_offsets(offsets, n_lanes, 4, &offs) ||
      !aligned(load, 4 * lanes::dtype_bytes(dt_load)) ||
      !aligned(gen, 4 * lanes::dtype_bytes(dt_gen)) ||
      !aligned(sell, 4 * lanes::dtype_bytes(dt_sell)) || !aligned(period, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int spt = staging::default_spt(r);
  const int threads = staging::agent_threads(r, spt);
  const int r_blocks = (r + threads * spt - 1) / (threads * spt);
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int seg_cap = lanes::max_segment(offs);
  const int smem = stage_layout(seg_cap, lanes::dtype_bytes(dt_load),
                                lanes::dtype_bytes(dt_gen),
                                lanes::dtype_bytes(dt_sell), threads / 32)
                       .bytes;  // < 48 KB
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(total);
  auto launch = [&](auto signed_tag, auto l, auto g, auto s) {
    constexpr bool kSigned = decltype(signed_tag)::value;
    using TL = typename decltype(l)::type;
    using TG = typename decltype(g)::type;
    using TS = typename decltype(s)::type;
    using TO = lanes::SumsOut<TL, TG, TS>;
    auto at = [&](auto spt_tag, auto drop_tag) {
      constexpr int kSpt = decltype(spt_tag)::value;
      constexpr bool kDrop = decltype(drop_tag)::value;
      stream_kernel<kSigned, kSpt, kDrop, TL, TG, TS>
          <<<blocks, threads, smem, st>>>(
          static_cast<const TL*>(load), static_cast<const TG*>(gen),
          static_cast<const TS*>(sell), period, scales,
          static_cast<TO*>(out_imp), static_cast<TO*>(out_sell_imp),
          static_cast<TO*>(out_sgn), static_cast<TO*>(out_sell_sgn), r,
          n_lanes, n_periods, r_blocks, seg_cap, offs);
    };
    auto with_drop = [&](auto spt_tag) {
      if (staging::drops_zero_lanes(n_lanes)) at(spt_tag, std::true_type());
      else at(spt_tag, std::false_type());
    };
    if (spt == 1) with_drop(std::integral_constant<int, 1>());
    else with_drop(std::integral_constant<int, 2>());
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
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
