// The rank-1-net prebuilt-mask variant of the kernel micro-benchmark,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/kernel_microbench.py:
//   microbench_mnet <- _kernel_mnet (launched by sums_mnet, hi and not)
//
// It computes the import bucket sums of one agent from its load and gen
// lanes and a PREBUILT mask matrix M [c_pad, hours] read from device
// memory (ops/microkernels.build_mask_cols: rows 0..P-2 the period
// one-hots, row P-1 ones, row P the sell rate, the rest zero). The net is
// itself a tensor-core product: it is rank-1, (1, -s) [scales x 2] times
// (load; gen) [2 x hours]. Per month and scale: pos = relu(net) over the
// month's hours, then the product pos [scales x hours] x M^T [hours x
// c_pad]. Column P-1 is the month total, the P-1 period sums come out as
// they are and the last period is the total minus the others (in that
// order, as the TPU kernel takes it); column P is the sell-weighted sum,
// carried across the months. Both products run in TF32, or with `hi` in
// 3xTF32, the Hopper counterpart of Precision.HIGHEST: x is split into
// big = tf32(x) and small = tf32(x - big), and a * b is summed as a_small
// * b_big + a_big * b_small + a_big * b_big (the small * small term, 2^-22
// of the product, is dropped).
//
// Bound on an H100: the function is the month kernel's (bucket_sums.cu),
// ~6 float32 operations per (agent, scale, hour) on the ALUs; here the
// multiply-add and the sums move to the tensor cores, so the kernel is
// held by the rate at which mma.sync issues products, and by what forms
// the relu operand between the two products, not by device memory: load,
// gen and M (10 or 18 floats an hour) are read once per agent.
//
// Design:
//   * one block per agent across its scales: up to 8 warps of two 16-scale
//     row tiles each, 256 scales (wider R takes more blocks of the agent);
//     so load, gen and M are read from device memory once per agent;
//   * staging in chunks of 96 hours (12 k-steps of 8; month lengths are
//     whole k-steps, chunks never cross a month's end), three stages with
//     4-byte cp.async (async_copy.cuh): chunks c + 1 and c + 2 land while
//     chunk c is walked, one block barrier a chunk. M lies in a stage as
//     c_pad rows of 104 floats, so a warp's 8-byte reads of its 8 columns
//     at 4 hour pairs hit 32 banks once;
//   * operands converted once, where they land: each thread rounds the
//     load, gen and M values it copied to TF32 (cvt.rna), with `hi` also
//     the small parts, so the warps' k-steps convert nothing they read.
//     hi stores, per hour, (load big, gen big, load small, gen small) and
//     gen big once more where gen is finite (0 where not), small parts 0
//     where the value is not finite, and M big and M small;
//   * the net: TF32 is one m16n8k4 per row tile and k-step, A = (1, -s, 0,
//     0), B = (load; gen; 0; 0) at the k-step's 8 hours. hi packs all three
//     terms into ONE m16n8k8: A = (1, -s big, 1, -s big | -s small, 0, 0,
//     0) times B = (load big, gen big, load small, gen small | finite gen
//     big, 0, 0, 0), so the tensor core sums load big + load small - s big
//     gen big - s big gen small - s small gen big (1 is exact in TF32). The
//     big x big terms carry IEEE's inf and NaN (an infinite gen gives -inf
//     and relu 0 for s > 0, NaN for s = 0, as load - s * gen does), and
//     the small terms see only finite operands, so they add no NaN of
//     their own;
//   * the accumulator is the next operand: thread (g, t) of the net's m16n8
//     accumulator holds rows g and g + 8 at hours 2t and 2t + 1, and the A
//     fragment of the masked product wants k = t and t + 4; the product
//     sums over k, so its k index t is taken as hour 2t and t + 4 as hour
//     2t + 1: relu (staging::relu_keep_nan, max.NaN) and the TF32 rounding
//     of the accumulator registers are the A fragment, and M's B fragment
//     is read at hours 2t and 2t + 1, one 8-byte shared load;
//   * two products in flight on separate accumulators per tile: TF32 sums
//     even and odd k-steps apart, hi the big x big term apart from the two
//     small ones; with two row tiles a warp, four independent chains;
//   * at a month's end each warp adds its two accumulator sets into a 32 x
//     (c_pad + 1) scratch tile in shared memory; lane l owns scale row l,
//     takes the last period by subtraction, stores the P bucket sums and
//     adds the sell column to its carried sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "lanes.cuh"
#include "month_chunks.cuh"
#include "staging.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kRowTile = 16;  // mma M
constexpr int kColTile = 8;   // mma N
constexpr int kK = 8;         // hours of a k-step
constexpr int kWarpTiles = 2;  // row tiles a warp holds
constexpr int kWarpRows = kWarpTiles * kRowTile;
constexpr int kMaxWarps = 8;
constexpr int kMaxColTiles = 2;  // c_pad <= 16
constexpr int kChunk = 96;       // hours a stage holds
constexpr int kStages = 3;
constexpr int kPitch = kChunk + 8;  // floats between two rows of M in a stage
constexpr int kMaxSmemBytes = 232448;
constexpr uint32_t kOne = 0x3f800000u;  // 1.0f

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// c += a [16 x 8] b [8 x 8]
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a [16 x 4] b [4 x 8]
__device__ __forceinline__ void mma_k4(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Floats of one stage: the net's operand (TF32: load, gen an hour; hi:
// load big, gen big, load small, gen small, then finite gen big), then M
// (hi: M big, then M small), c_pad rows of kPitch.
__host__ __device__ constexpr int net_floats(bool hi) { return kChunk * (hi ? 5 : 2); }
__host__ __device__ constexpr int stage_floats(bool hi, int cols) {
  return net_floats(hi) + cols * kPitch * (hi ? 2 : 1);
}

template <int NT, bool HI>
__global__ void __launch_bounds__(kMaxWarps * 32)
    mnet_kernel(const float* __restrict__ load, const float* __restrict__ gen,
                const float* __restrict__ m, const float* __restrict__ scales,
                float* __restrict__ out_imp, float* __restrict__ out_sell, int r,
                int hours, int n_periods, int r_blocks, MonthOffsets offs) {
  constexpr int kCols = NT * kColTile;  // c_pad
  constexpr int kNetW = HI ? 4 : 2;     // floats an hour of the net's B
  constexpr int kStageFloats = stage_floats(HI, kCols);
  extern __shared__ __align__(16) float smem[];

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;  // the fragment's row group
  const int tig = lane & 3;   // the thread's index in its group
  const int agent = blockIdx.x / r_blocks;
  const int r0 = ((blockIdx.x % r_blocks) * warps + warp) * kWarpRows;
  const bool warp_live = r0 < r;
  const int nb = kMonths * n_periods;
  const size_t srow = static_cast<size_t>(agent) * r;
  float* scratch = smem + kStages * kStageFloats + warp * kWarpRows * (kCols + 1);

  // A of the net per row tile (rows g and g + 8): TF32 a[0], a[1] of
  // m16n8k4, k = (1, -s, 0, 0); hi a[0..3] of m16n8k8, k = (1, -s big, 1,
  // -s big | -s small, 0, 0, 0)
  uint32_t a_net[kWarpTiles][4];
#pragma unroll
  for (int rt = 0; rt < kWarpTiles; ++rt) {
    float ns[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + rt * kRowTile + grp + 8 * h;
      ns[h] = row < r ? -scales[srow + row] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float big = tf32(ns[h]);
      if (HI) {
        a_net[rt][h] = tig & 1 ? __float_as_uint(big) : kOne;
        a_net[rt][2 + h] = tig == 0 ? __float_as_uint(tf32(ns[h] - big)) : 0u;
      } else {
        a_net[rt][h] = tig == 0 ? kOne : tig == 1 ? __float_as_uint(big) : 0u;
        a_net[rt][2 + h] = 0u;
      }
    }
  }

  // hours [h0, h0 + len) of the agent into stage `buf`: the net's load and
  // gen by all threads, M's rows by warps in turn; `convert` rounds the
  // same elements once this thread's copies landed
  const size_t lane_row = static_cast<size_t>(agent) * hours;
  const float* m_agent = m + static_cast<size_t>(agent) * kCols * hours;
  auto copy_chunk = [&](int buf, int h0, int len) {
    float* net = smem + buf * kStageFloats;
    float* mb = net + net_floats(HI);
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      async_copy::copy<4>(net + h * kNetW, load + lane_row + h0 + h);
      async_copy::copy<4>(net + h * kNetW + 1, gen + lane_row + h0 + h);
    }
    for (int c = warp; c < kCols; c += warps)
      for (int h = lane; h < len; h += 32)
        async_copy::copy<4>(mb + c * kPitch + h,
                            m_agent + static_cast<size_t>(c) * hours + h0 + h);
    async_copy::commit();
  };
  auto convert = [&](int buf, int len) {
    float* net = smem + buf * kStageFloats;
    float* mb = net + net_floats(HI);
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      float* v = net + h * kNetW;
      const float l = v[0], g = v[1];
      v[0] = tf32(l);
      v[1] = tf32(g);
      if (HI) {
        const bool g_fin = isfinite(g);
        v[2] = isfinite(l) ? tf32(l - v[0]) : 0.f;
        v[3] = g_fin ? tf32(g - v[1]) : 0.f;
        net[kChunk * 4 + h] = g_fin ? v[1] : 0.f;
      }
    }
    for (int c = warp; c < kCols; c += warps)
      for (int h = lane; h < len; h += 32) {
        float* x = mb + c * kPitch + h;
        const float big = tf32(*x);
        if (HI) x[kCols * kPitch] = tf32(*x - big);
        *x = big;
      }
  };

  // acc[q][rt][ct]: TF32 q = the k-step's parity; hi q = 0 the big x big
  // term, q = 1 the two small ones
  float acc[2][kWarpTiles][NT][4];
  auto clear = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int rt = 0; rt < kWarpTiles; ++rt)
#pragma unroll
        for (int ct = 0; ct < NT; ++ct)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][rt][ct][i] = 0.f;
  };
  // one k-step at hour k0 of stage `buf` into the accumulators of parity Q
  auto kstep = [&](int buf, int k0, auto parity) {
    constexpr int Q = decltype(parity)::value;
    const float* net_b = smem + buf * kStageFloats;
    const float* mb = net_b + net_floats(HI);
    // B of the net at hour k0 + g, k = t (and t + 4)
    uint32_t b0 = 0u, b1 = 0u;
    if (HI) {
      b0 = __float_as_uint(net_b[(k0 + grp) * kNetW + tig]);
      if (tig == 0) b1 = __float_as_uint(net_b[kChunk * 4 + k0 + grp]);
    } else if (tig < 2) {
      b0 = __float_as_uint(net_b[(k0 + grp) * kNetW + tig]);
    }
    // B of the masked product: column 8 ct + g at hours 2t and 2t + 1
    uint32_t mbig[NT][2], msmall[NT][2];
#pragma unroll
    for (int ct = 0; ct < NT; ++ct) {
      const int at = (ct * kColTile + grp) * kPitch + k0 + 2 * tig;
      const float2 v = *reinterpret_cast<const float2*>(mb + at);
      mbig[ct][0] = __float_as_uint(v.x);
      mbig[ct][1] = __float_as_uint(v.y);
      if (HI) {
        const float2 s = *reinterpret_cast<const float2*>(mb + kCols * kPitch + at);
        msmall[ct][0] = __float_as_uint(s.x);
        msmall[ct][1] = __float_as_uint(s.y);
      }
    }
#pragma unroll
    for (int rt = 0; rt < kWarpTiles; ++rt) {
      float net[4] = {0.f, 0.f, 0.f, 0.f};
      if (HI)
        mma_k8(net, a_net[rt], b0, b1);
      else
        mma_k4(net, a_net[rt][0], a_net[rt][1], b0);
      // A of the masked product: (g, t) hour 2t, (g + 8, t), (g, t + 4)
      // hour 2t + 1, (g + 8, t + 4)
      const float pos[4] = {staging::relu_keep_nan(net[0]),
                            staging::relu_keep_nan(net[2]),
                            staging::relu_keep_nan(net[1]),
                            staging::relu_keep_nan(net[3])};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float big = tf32(pos[i]);
        a_big[i] = __float_as_uint(big);
        if (HI) a_small[i] = __float_as_uint(tf32(pos[i] - big));
      }
#pragma unroll
      for (int ct = 0; ct < NT; ++ct) {
        if (HI) {
          mma_k8(acc[1][rt][ct], a_small, mbig[ct][0], mbig[ct][1]);
          mma_k8(acc[1][rt][ct], a_big, msmall[ct][0], msmall[ct][1]);
          mma_k8(acc[0][rt][ct], a_big, mbig[ct][0], mbig[ct][1]);
        } else {
          mma_k8(acc[Q][rt][ct], a_big, mbig[ct][0], mbig[ct][1]);
        }
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

  float sell_sum = 0.f;  // the sell sum of scale row r0 + lane
  int buf = 0;
  for (int mo = 0; mo < kMonths; ++mo) {
    const int month_len = offs.o[mo + 1] - offs.o[mo];
    clear();
    for (int c0 = 0; c0 < month_len; c0 += kChunk) {
      const int len = min(kChunk, month_len - c0);
      async_copy::wait<kStages - 2>();
      convert(buf, len);
      // the chunk is visible, and every warp is done with the stage
      // refilled now (the one walked before the last)
      __syncthreads();
      if (ahead.done()) {
        async_copy::commit();
      } else {
        copy_chunk((buf + kStages - 1) % kStages, ahead.lane0(offs),
                   ahead.len(offs));
        ahead.next(offs);
      }
      if (warp_live) {
        int k0 = 0;
        for (; k0 + 2 * kK <= len; k0 += 2 * kK) {
          kstep(buf, k0, std::integral_constant<int, 0>());
          kstep(buf, k0 + kK, std::integral_constant<int, 1>());
        }
        if (k0 < len) kstep(buf, k0, std::integral_constant<int, 0>());
      }
      buf = (buf + 1) % kStages;
    }
    if (!warp_live) continue;

    // the month's sums: (row g, column 2t + i % 2) and (g + 8, ...) of
    // each tile, both accumulator sets added
#pragma unroll
    for (int rt = 0; rt < kWarpTiles; ++rt)
#pragma unroll
      for (int ct = 0; ct < NT; ++ct) {
        float* at = scratch + (rt * kRowTile + grp) * (kCols + 1) + ct * kColTile +
                    2 * tig;
        at[0] = acc[0][rt][ct][0] + acc[1][rt][ct][0];
        at[1] = acc[0][rt][ct][1] + acc[1][rt][ct][1];
        at[8 * (kCols + 1)] = acc[0][rt][ct][2] + acc[1][rt][ct][2];
        at[8 * (kCols + 1) + 1] = acc[0][rt][ct][3] + acc[1][rt][ct][3];
      }
    __syncwarp();
    if (r0 + lane < r) {
      const float* sums = scratch + lane * (kCols + 1);
      float* out = out_imp + (srow + r0 + lane) * nb + mo * n_periods;
      float rem = sums[n_periods - 1];  // the month total
      for (int p = 0; p < n_periods - 1; ++p) {
        out[p] = sums[p];
        rem -= sums[p];
      }
      out[n_periods - 1] = rem;
      sell_sum += sums[n_periods];
    }
    __syncwarp();
  }
  if (warp_live && r0 + lane < r) out_sell[srow + r0 + lane] = sell_sum;
}

// Launches mnet_kernel over blocks of up to kMaxWarps x 32 scales of each
// agent; a CUDA error code, cudaErrorInvalidValue for shapes the kernel
// does not take.
template <bool HI>
int launch(const float* load, const float* gen, const float* m,
           const float* scales, const int* offsets, float* out_imp,
           float* out_sell, int n, int r, int n_periods, int c_pad,
           cudaStream_t stream) {
  MonthOffsets offs;
  // month lengths must be whole k-steps of 8 hours; c_pad a whole number
  // of 8-column tiles that holds the P - 1 one-hots, the ones and the sell
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > kMaxPeriods ||
      offsets == nullptr || c_pad % kColTile != 0 || c_pad < n_periods + 1 ||
      c_pad > kMaxColTiles * kColTile ||
      !lanes::read_offsets(offsets, offsets[kMonths], kK, &offs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = std::min(kMaxWarps, (r + kWarpRows - 1) / kWarpRows);
  const int rows = warps * kWarpRows;
  const int r_blocks = (r + rows - 1) / rows;
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) *
                   (kStages * stage_floats(HI, c_pad) + warps * kWarpRows * (c_pad + 1));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = &mnet_kernel<1, HI>;
  if (c_pad != kColTile) kernel = &mnet_kernel<2, HI>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(total), warps * 32, smem, stream>>>(
      load, gen, m, scales, out_imp, out_sell, r, offs.o[kMonths], n_periods,
      r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes the kernel does not take. `offsets` is
// a host array of 13 hour offsets whose last is the hours per agent; `m`
// is [n, c_pad, hours], c_pad 8 or 16.
extern "C" int microbench_mnet(const float* load, const float* gen,
                               const float* m, const float* scales,
                               const int* offsets, float* out_imp,
                               float* out_sell, int n, int r, int n_periods,
                               int c_pad, int hi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hi ? launch<true>(load, gen, m, scales, offsets, out_imp, out_sell, n,
                           r, n_periods, c_pad, st)
            : launch<false>(load, gen, m, scales, offsets, out_imp, out_sell, n,
                            r, n_periods, c_pad, st);
}
