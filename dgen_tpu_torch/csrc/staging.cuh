// Period-partitioned staging of one agent's month, shared by the month,
// pair and stream bucket-sums kernels (bucket_sums.cu,
// bucket_sums_stream.cu).
//
// What it solves. Every bucket-sums kernel adds relu(load - s * gen) of
// each hour into the sum of that hour's TOU period. Selecting the
// period's accumulator per hour costs one predicated add per period per
// hour (P x the work the hours need). Staging the month sorted by
// period instead turns the sums into one walk over P + 1 runs: per
// staged hour one broadcast 16-byte shared-memory load feeds a fused
// multiply-add, a max, an add and a multiply-add per scale, whatever P.
//
// The sort is a stable counting sort over the lanes' classes (periods
// 0 .. P - 1, then the out-of-range periods, counted in the sell sums
// only, then any class a caller drops). One block stages one agent's
// month. Each warp ranks a contiguous share of it in chunks of 32
// lanes: pass 1 counts its lanes per class with one ballot per class,
// the block turns the (warp, class) counts into each warp's first slot
// per class, and pass 2 gives every lane its slot plus its rank among
// the chunk's lanes of its class. So run q holds the lanes of class q
// in lane order, and a period's sum taken over its run is the same
// float32 sum, in the same order, as adding its lanes one by one.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "lanes.cuh"

namespace staging {

using lanes::kMaxPeriods;

// Most classes a sort takes: the periods, the out-of-range periods and
// one class a caller drops.
constexpr int kMaxClasses = kMaxPeriods + 2;

// Whether the kernels drop zero lanes (load and gen both zero) on a layout
// of n_lanes lanes: a daylight-compacted layout has fewer lanes than the
// year has hours and zero-fills each month past its hour count, the
// full-hour layout has no such pad lanes. Ranking one more class costs
// time where there is no lane to drop, so the full-hour launches skip it;
// the sums are the same bit for bit either way.
constexpr int kHours = 8760;
inline bool drops_zero_lanes(int n_lanes) { return n_lanes != kHours; }

// A period lane's class: the period, or n_periods when out of range.
__device__ __forceinline__ int period_class(int p, int n_periods) {
  return (p >= 0 && p < n_periods) ? p : n_periods;
}

// Ranks the `len` lanes whose classes (0 .. n_classes - 1) are in `cls`
// (int, or a narrower integer where shared memory is short): calls
// place(h, slot) for every lane h, slots grouped by class in lane order,
// and sets run[q] to class q's first slot for q < n_classes and
// run[n_classes] = len. warp_count and warp_base hold a row per warp of
// the block. place may overwrite cls[h] (each lane's class is read by
// its own thread before place is called for it). Ends with a barrier.
template <int W, typename ClsT, class Place>
__device__ __forceinline__ void rank_by_class(const ClsT* cls, int len,
                                              int n_classes,
                                              int (*warp_count)[W],
                                              int (*warp_base)[W], int* run,
                                              Place place) {
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int n_warps = blockDim.x / 32;
  const unsigned below = (1u << lane) - 1u;

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
  if (t < n_warps * n_classes) {
    const int w = t / n_classes;
    const int q = t % n_classes;
    int base = 0;  // every lane of an earlier class, then of q in earlier warps
    for (int w2 = 0; w2 < n_warps; ++w2) {
      for (int q2 = 0; q2 < q; ++q2) base += warp_count[w2][q2];
      if (w2 < w) base += warp_count[w2][q];
    }
    warp_base[w][q] = base;
    if (w == 0) run[q] = base;
    if (w == 0 && q == n_classes - 1) run[n_classes] = len;
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
    if (h < he) place(h, at);
  }
  __syncthreads();
}

// Stages one agent's month of `len` lanes into `hour`, grouped by class:
// cls[h] = classify(h) for every lane, then the ranking above, then
// hour[slot] = fetch(h) (one float4 per lane: load, gen, sell, 0). Run q
// is hour[run[q] .. run[q + 1]). With DROP_LAST the last class is ranked
// but not fetched: its lanes take no slot below run[n_classes - 1]. The
// classify and fetch sweeps have every thread's loads in flight at once,
// so a month read from device memory costs two memory latencies, not one
// per chunk of lanes. `slot` may be `cls` itself (the ranking overwrites
// each lane's class with its slot). Ends with a barrier.
template <bool DROP_LAST, int W, class Classify, class Fetch>
__device__ __forceinline__ void stage_by_period(
    int len, int n_classes, Classify classify, Fetch fetch,
    float4* hour, int* cls, int* slot, int (*warp_count)[W],
    int (*warp_base)[W], int* run) {
#pragma unroll 4
  for (int h = threadIdx.x; h < len; h += blockDim.x) cls[h] = classify(h);
  __syncthreads();
  rank_by_class(cls, len, n_classes, warp_count, warp_base, run,
                [&](int h, int at) { slot[h] = at; });
  const int kept = DROP_LAST ? run[n_classes - 1] : len;
#pragma unroll 4
  for (int h = threadIdx.x; h < len; h += blockDim.x) {
    const int at = slot[h];
    if (!DROP_LAST || at < kept) hour[at] = fetch(h);
  }
  __syncthreads();
}

// Sums one staged month m over its runs for this thread's SPT scales s
// (r0 the first; scales at or past R are computed and not stored): for
// each period q < P the sum of relu(net) over run q (and of net when
// SIGNED), stored as bucket m * P + q of the [.., R, nb] outputs at row
// out_row; the sell-weighted sums over runs 0 .. P (the out-of-range
// periods' run last) added to sell_imp / sell_sgn once the month is done.
// net = fmaf(-s, gen, load). Every kernel that prices a staged month
// calls this, so they sum each scale in the same order.
template <bool SIGNED, int SPT, typename TO>
__device__ __forceinline__ void sum_runs(
    const float4* hour, const int* run, int n_periods, int m,
    const float (&s)[SPT], int r0, int r, size_t out_row, int nb,
    TO* __restrict__ out_imp, TO* __restrict__ out_sgn,
    float (&sell_imp)[SPT], float (&sell_sgn)[SPT]) {
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
      lanes::store(out_imp + (out_row + j) * nb + b, ai[j]);
      if (SIGNED) lanes::store(out_sgn + (out_row + j) * nb + b, as[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    sell_imp[j] += mi[j];
    sell_sgn[j] += ms[j];
  }
}

// ---------------------------------------------------------------------------
// Block shapes (host)
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 256;  // most threads a block runs
constexpr int kMinThreads = 128;  // ... and fewest (to stage a month)

// Scales a thread: 1 while R's scales fit one warp (2 a thread would idle
// more than half its lanes), else 2, which feeds each staged hour to
// twice the arithmetic.
inline int default_spt(int r) { return r <= 32 ? 1 : 2; }

// Threads of a one-agent block at spt scales a thread: whole warps for
// R's scales, at least kMinThreads (the warps past R help stage each
// month) and at most kMaxThreads.
inline int agent_threads(int r, int spt) {
  const int warps = ((r + spt - 1) / spt + 31) / 32;
  return 32 * std::max(kMinThreads / 32, std::min(warps, kMaxThreads / 32));
}

}  // namespace staging
