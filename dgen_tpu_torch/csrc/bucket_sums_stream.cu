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
// lanes) that is ~9e10 operations against ~0.8 GB of lanes read once.
//
// What the design does about it. The TPU kernel shares a block among
// several agents and overlaps the copy of month segment m + 1 with the
// sums over segment m, keeping the accumulators across the month loop.
// Here:
//   * one thread owns one (agent, scale) pair and keeps its period
//     accumulators in registers (predicated adds unrolled over the
//     compile-time kMaxPeriods, as in the month kernel); a month's sums
//     are written once, when the month is done, and the sell sum carries
//     across months in a register;
//   * a 128-thread block holds block_n agents x r_tile scales, r_tile =
//     min(R, 128): at R = 25 five agents share a block (125 live
//     threads), where the month kernel runs one busy warp of four;
//   * each month segment of the block's agents (load, gen, sell, period
//     rows) is staged into shared memory with 16-byte cp.async.cg copies
//     in a two-stage ring: segment m + 1 is in flight while segment m is
//     summed (commit_group / wait_group 1, then a barrier). Rows are
//     16-byte aligned because every month offset is a multiple of 4 lanes
//     (calendar months are whole days; compacted segments whole 128-lane
//     blocks), which the launcher checks;
//   * threads read four lanes at a time as one float4 (int4 for periods)
//     from each row: one 16-byte shared load per lane, broadcast across
//     the threads of one agent.
// Shared memory per block: 2 stages x block_n agents x 4 rows x the
// longest segment x 4 bytes (81,920 bytes at 5 agents and 512 lanes;
// 119,040 at 5 agents and 744 full-hour lanes), dynamic, so the launcher
// raises the block's limit above 48 KB.

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kRows = 4;          // load, gen, sell, period
constexpr int kMaxBlockAgents = 8;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <bool SIGNED>
__device__ __forceinline__ void add_lane(float l, float g, float sl, int p,
                                         float s, float (&acc_i)[kMaxPeriods],
                                         float (&acc_s)[kMaxPeriods],
                                         float& mi, float& ms) {
  const float net = l - s * g;
  const float pos = fmaxf(net, 0.f);
  mi += pos * sl;
#pragma unroll
  for (int q = 0; q < kMaxPeriods; ++q) acc_i[q] += (p == q) ? pos : 0.f;
  if (SIGNED) {
    ms += net * sl;
#pragma unroll
    for (int q = 0; q < kMaxPeriods; ++q) acc_s[q] += (p == q) ? net : 0.f;
  }
}

template <bool SIGNED>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ load, const float* __restrict__ gen,
                  const float* __restrict__ sell,
                  const int* __restrict__ period,
                  const float* __restrict__ scales, float* __restrict__ out_imp,
                  float* __restrict__ out_sell_imp, float* __restrict__ out_sgn,
                  float* __restrict__ out_sell_sgn, int n, int r, int n_lanes,
                  int n_periods, int r_tile, int block_n, int r_blocks,
                  int seg_cap, MonthOffsets offs) {
  extern __shared__ __align__(16) float smem[];

  const int agent0 = (blockIdx.x / r_blocks) * block_n;
  const int n_here = min(block_n, n - agent0);
  const int a = threadIdx.x / r_tile;   // agent within the block
  const int ri = (blockIdx.x % r_blocks) * r_tile + threadIdx.x % r_tile;
  const bool live = a < n_here && ri < r;
  const size_t out_row = static_cast<size_t>(agent0 + a) * r + ri;
  const int nb = kMonths * n_periods;
  const int stage_floats = block_n * kRows * seg_cap;
  const float s = live ? scales[out_row] : 0.f;

  // Queue the copies of month m's segment of every agent of the block
  // into ring stage `stage` as one cp.async group.
  auto issue = [&](int m, int stage) {
    const int h0 = offs.o[m];
    const int chunks = (offs.o[m + 1] - h0) / 4;
    float* base = smem + stage * stage_floats;
    for (int i = threadIdx.x; i < n_here * kRows * chunks; i += kThreads) {
      const int c = i % chunks;
      const int row = i / chunks;  // agent * kRows + stream
      const size_t g =
          static_cast<size_t>(agent0 + row / kRows) * n_lanes + h0 + 4 * c;
      const int k = row % kRows;
      const void* src = k == 0   ? static_cast<const void*>(load + g)
                        : k == 1 ? static_cast<const void*>(gen + g)
                        : k == 2 ? static_cast<const void*>(sell + g)
                                 : static_cast<const void*>(period + g);
      cp_async16(base + row * seg_cap + 4 * c, src);
    }
    cp_async_commit();
  };

  float sell_imp = 0.f;
  float sell_sgn = 0.f;
  issue(0, 0);
  for (int m = 0; m < kMonths; ++m) {
    if (m + 1 < kMonths) {
      issue(m + 1, (m + 1) % kStages);  // that stage was freed below
      cp_async_wait<1>();               // this thread's month-m copies landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's month-m copies are visible

    if (live) {
      const int len = offs.o[m + 1] - offs.o[m];
      const float* rows = smem + (m % kStages) * stage_floats +
                          a * kRows * seg_cap;
      const float4* lv = reinterpret_cast<const float4*>(rows);
      const float4* gv = reinterpret_cast<const float4*>(rows + seg_cap);
      const float4* sv = reinterpret_cast<const float4*>(rows + 2 * seg_cap);
      const int4* pv = reinterpret_cast<const int4*>(rows + 3 * seg_cap);

      float acc_i[kMaxPeriods];
      float acc_s[kMaxPeriods];
#pragma unroll
      for (int q = 0; q < kMaxPeriods; ++q) {
        acc_i[q] = 0.f;
        acc_s[q] = 0.f;
      }
      float mi = 0.f;
      float ms = 0.f;
#pragma unroll 2
      for (int c = 0; c < len / 4; ++c) {
        const float4 l = lv[c];
        const float4 g = gv[c];
        const float4 sl = sv[c];
        const int4 p = pv[c];
        add_lane<SIGNED>(l.x, g.x, sl.x, p.x, s, acc_i, acc_s, mi, ms);
        add_lane<SIGNED>(l.y, g.y, sl.y, p.y, s, acc_i, acc_s, mi, ms);
        add_lane<SIGNED>(l.z, g.z, sl.z, p.z, s, acc_i, acc_s, mi, ms);
        add_lane<SIGNED>(l.w, g.w, sl.w, p.w, s, acc_i, acc_s, mi, ms);
      }
      sell_imp += mi;
      sell_sgn += ms;
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
    __syncthreads();  // stage m % kStages is free for month m + 2
  }
  if (live) {
    out_sell_imp[out_row] = sell_imp;
    if (SIGNED) out_sell_sgn[out_row] = sell_sgn;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes, offsets or pointers the kernel does not
// take (every offset a multiple of 4 lanes, n_lanes too, 16-byte aligned
// streams). `offsets` is a host array of 13 lane offsets.
extern "C" int bucket_sums_stream(const float* load, const float* gen,
                                  const float* sell, const int* period,
                                  const float* scales, const int* offsets,
                                  float* out_imp, float* out_sell_imp,
                                  float* out_sgn, float* out_sell_sgn, int n,
                                  int r, int n_lanes, int n_periods,
                                  int with_signed, void* stream) {
  MonthOffsets offs;
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > kMaxPeriods ||
      !lanes::read_offsets(offsets, n_lanes, 4, &offs) || !aligned16(load) ||
      !aligned16(gen) || !aligned16(sell) || !aligned16(period))
    return static_cast<int>(cudaErrorInvalidValue);
  const int r_tile = r < kThreads ? r : kThreads;
  const int seg_cap = lanes::max_segment(offs);
  const int agent_bytes = kStages * kRows * seg_cap * 4;
  int block_n = kThreads / r_tile;
  if (block_n > kMaxBlockAgents) block_n = kMaxBlockAgents;
  if (block_n * agent_bytes > kMaxSmemBytes)
    block_n = kMaxSmemBytes / agent_bytes;
  const int r_blocks = (r + r_tile - 1) / r_tile;
  const long long total =
      static_cast<long long>((n + block_n - 1) / block_n) * r_blocks;
  if (block_n < 1 || total > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = block_n * agent_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(total);
  if (with_signed) {
    cudaFuncSetAttribute(stream_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    stream_kernel<true><<<blocks, kThreads, smem, st>>>(
        load, gen, sell, period, scales, out_imp, out_sell_imp, out_sgn,
        out_sell_sgn, n, r, n_lanes, n_periods, r_tile, block_n, r_blocks,
        seg_cap, offs);
  } else {
    cudaFuncSetAttribute(stream_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    stream_kernel<false><<<blocks, kThreads, smem, st>>>(
        load, gen, sell, period, scales, out_imp, out_sell_imp, out_sgn,
        out_sell_sgn, n, r, n_lanes, n_periods, r_tile, block_n, r_blocks,
        seg_cap, offs);
  }
  return static_cast<int>(cudaGetLastError());
}
