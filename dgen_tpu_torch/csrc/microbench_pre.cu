// Prebuilt-mask tensor-core variants of the kernel micro-benchmark,
// written for Hopper (sm_90a).
//
// Replace the TPU kernels of tools/kernel_microbench.py:
//   microbench_monthdot_pre <- _kernel_mdp  (launched by sums_monthdot_pre)
//   microbench_mnet         <- _kernel_mnet (launched by sums_mnet, hi and not)
//
// Both compute the import bucket sums of one agent from its load and gen
// lanes and a PREBUILT mask matrix M [c_pad, hours] read from device
// memory (ops/microkernels.build_mask_cols: rows 0..P-2 the period
// one-hots, row P-1 ones, row P the sell rate, the rest zero). Per month
// and net-load scale s: pos = relu(load - s * gen) over the month's
// hours, then one narrow product pos [scales x hours] x M^T [hours x
// c_pad]. Column P-1 is the month total, the P-1 period sums come out
// as they are and the last period is the total minus the others (in
// that order, as the TPU kernel takes it); column P is the sell-weighted
// sum, carried across the months.
//
//   monthdot_pre: pos is formed in registers (one FMA and one max per
//     element) and the masked product runs on the tensor cores in TF32;
//   mnet:         net itself is a tensor-core product too: it is rank-1,
//     [scales x 4] (1, -s, 0, 0) times [4 x hours] (load; gen; 0; 0), an
//     m16n8k4 TF32 product; then the relu and the masked product;
//   mnet hi:      both products in 3xTF32, the Hopper counterpart of
//     Precision.HIGHEST: each operand x is split into big = tf32(x) and
//     small = tf32(x - big), and a * b is summed as a_small * b_big +
//     a_big * b_small + a_big * b_big (the small * small term, 2^-22 of
//     the product, is dropped), which keeps float32-level agreement.
//
// Bound on an H100: the function is the month kernel's (bucket_sums.cu),
// ~6 float32 operations per (agent, scale, hour) if done on the ALUs;
// here most of them move to the tensor cores (16 x 8 x 8 products per
// instruction), so what bounds the kernel is forming the relu operand
// (mnet: converting it) and feeding the products from shared memory, not
// device memory: load, gen and M are read once per block.
//
// Design:
//   * warp-level mma.sync.aligned.m16n8k8 (and m16n8k4 for the rank-1
//     net), TF32 inputs, float32 accumulators in registers. c_pad = 8 is
//     exactly the n = 8 of the PTX shape (nvcuda::wmma has no n = 8 for
//     TF32 and padding M to 16 columns would double the product); c_pad
//     = 16 (P up to 10) runs two column tiles;
//   * a block is one agent x (16 x warps) scales, one warp per 16-scale
//     row tile, at most 8 warps; each month's load, gen and c_pad M rows
//     are staged whole into shared memory (744 hours x 10 rows x 4 bytes
//     = 29,760 bytes at c_pad = 8), then every warp walks the month's
//     hours in k-steps of 8 (month lengths 672, 720 and 744 are whole
//     k-steps; the launcher refuses offsets off the 8-hour grid);
//   * the accumulator is not the next operand: in mnet the net tile of
//     the first product (a 16 x 8 accumulator: thread (g, t) holds rows
//     g and g + 8 at hours 2t and 2t + 1) is the A operand of the second
//     (thread (g, t) must hold k = t and t + 4). Neither shared memory nor
//     shuffles: the second product sums over its k axis, and the order of
//     the hours inside one k-step does not change that sum, so its k
//     index t maps to hour 2t and t + 4 to hour 2t + 1. The accumulator
//     registers then are the A fragment as they stand (after the relu),
//     and the B fragment of M is read at hours 2t and 2t + 1, one 8-byte
//     shared load. monthdot_pre forms pos in the same order, so both
//     share the second half of the k-step;
//   * at the end of a month each warp writes its accumulator tile to a
//     16 x c_pad scratch tile in shared memory; lanes 0..15 each own one
//     scale row, take the last period by subtraction, store the P
//     bucket sums and add the sell column to the row's carried sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kRowTile = 16;    // mma M
constexpr int kColTile = 8;     // mma N
constexpr int kK = 8;           // mma K of the masked product (TF32)
constexpr int kMaxWarps = 8;
constexpr int kMaxColTiles = 2;  // c_pad <= 16
constexpr int kMaxSmemBytes = 232448;

enum Mode { kMonthdotPre = 0, kMnet = 1, kMnetHi = 2 };

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x split as big + small, each a TF32 value (3xTF32)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a [16 x 8] b [8 x 8]
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

template <int MODE, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    mask_product_kernel(const float* __restrict__ load,
                        const float* __restrict__ gen,
                        const float* __restrict__ m,
                        const float* __restrict__ scales,
                        float* __restrict__ out_imp,
                        float* __restrict__ out_sell, int r, int hours,
                        int n_periods, int seg_cap, int r_blocks,
                        MonthOffsets offs) {
  constexpr int kCols = NT * kColTile;  // c_pad
  extern __shared__ __align__(16) float smem[];

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;  // the fragment's row group
  const int tig = lane & 3;   // the thread's index in its group
  const int agent = blockIdx.x / r_blocks;
  const int r0 = ((blockIdx.x % r_blocks) * warps + warp) * kRowTile;
  const bool warp_live = r0 < r;
  const int nb = kMonths * n_periods;

  // the month's load and gen, its c_pad M rows, one 16 x c_pad tile a warp
  float* s_load = smem;
  float* s_gen = s_load + seg_cap;
  float* s_m = s_gen + seg_cap;
  float* tile = s_m + kCols * seg_cap + warp * kRowTile * kCols;

  const size_t srow = static_cast<size_t>(agent) * r;
  const float s_lo = r0 + grp < r ? scales[srow + r0 + grp] : 0.f;
  const float s_hi = r0 + grp + 8 < r ? scales[srow + r0 + grp + 8] : 0.f;

  // A of the rank-1 product: row g holds (1, -s_g, 0, 0); thread t its
  // column t, for rows g and g + 8
  uint32_t coef_big[2] = {0u, 0u};
  uint32_t coef_small[2] = {0u, 0u};
  if (MODE != kMonthdotPre) {
    const float c_lo = tig == 0 ? 1.f : tig == 1 ? -s_lo : 0.f;
    const float c_hi = tig == 0 ? 1.f : tig == 1 ? -s_hi : 0.f;
    split(c_lo, coef_big[0], coef_small[0]);
    split(c_hi, coef_big[1], coef_small[1]);
  }

  const size_t row = static_cast<size_t>(agent) * hours;
  const float* m_agent = m + static_cast<size_t>(agent) * kCols * hours;
  float sell_sum = 0.f;  // lanes < 16: the sell sum of scale row r0 + lane

  for (int mo = 0; mo < kMonths; ++mo) {
    const int h0 = offs.o[mo];
    const int len = offs.o[mo + 1] - h0;
    __syncthreads();  // every warp is done with the previous month
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      s_load[h] = load[row + h0 + h];
      s_gen[h] = gen[row + h0 + h];
    }
    for (int i = threadIdx.x; i < kCols * len; i += blockDim.x) {
      const int c = i / len;
      const int h = i - c * len;
      s_m[c * seg_cap + h] = m_agent[static_cast<size_t>(c) * hours + h0 + h];
    }
    __syncthreads();
    if (!warp_live) continue;  // no scale of this warp lies below R

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

    for (int k0 = 0; k0 < len; k0 += kK) {
      // pos at (row g, hour 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
      // of this k-step: the accumulator layout of an m16n8 product
      float pos[4];
      if (MODE == kMonthdotPre) {
        const float2 l = *reinterpret_cast<const float2*>(s_load + k0 + 2 * tig);
        const float2 g = *reinterpret_cast<const float2*>(s_gen + k0 + 2 * tig);
        pos[0] = fmaxf(l.x - s_lo * g.x, 0.f);
        pos[1] = fmaxf(l.y - s_lo * g.y, 0.f);
        pos[2] = fmaxf(l.x - s_hi * g.x, 0.f);
        pos[3] = fmaxf(l.y - s_hi * g.y, 0.f);
      } else {
        // B of the rank-1 product, (k = t, n = g): load, gen, 0, 0 at
        // hour k0 + g
        const float bv = tig == 0   ? s_load[k0 + grp]
                         : tig == 1 ? s_gen[k0 + grp]
                                    : 0.f;
        float net[4] = {0.f, 0.f, 0.f, 0.f};
        if (MODE == kMnet) {
          mma_k4(net, coef_big[0], coef_big[1], tf32(bv));
        } else {
          uint32_t b_big, b_small;
          split(bv, b_big, b_small);
          mma_k4(net, coef_small[0], coef_small[1], b_big);
          mma_k4(net, coef_big[0], coef_big[1], b_small);
          mma_k4(net, coef_big[0], coef_big[1], b_big);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) pos[i] = fmaxf(net[i], 0.f);
      }
      // A of the masked product: k = t is hour 2t, k = t + 4 hour 2t + 1
      // (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4))
      uint32_t a_big[4], a_small[4];
      if (MODE == kMnetHi) {
        split(pos[0], a_big[0], a_small[0]);
        split(pos[2], a_big[1], a_small[1]);
        split(pos[1], a_big[2], a_small[2]);
        split(pos[3], a_big[3], a_small[3]);
      } else {
        a_big[0] = tf32(pos[0]);
        a_big[1] = tf32(pos[2]);
        a_big[2] = tf32(pos[1]);
        a_big[3] = tf32(pos[3]);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // B of the masked product, (k, n = g) = M[column t * 8 + g] at
        // the k-step's hours 2t and 2t + 1
        const float2 mv = *reinterpret_cast<const float2*>(
            s_m + (t * kColTile + grp) * seg_cap + k0 + 2 * tig);
        if (MODE == kMnetHi) {
          uint32_t b0_big, b0_small, b1_big, b1_small;
          split(mv.x, b0_big, b0_small);
          split(mv.y, b1_big, b1_small);
          mma_k8(acc[t], a_small[0], a_small[1], a_small[2], a_small[3], b0_big,
                 b1_big);
          mma_k8(acc[t], a_big[0], a_big[1], a_big[2], a_big[3], b0_small,
                 b1_small);
          mma_k8(acc[t], a_big[0], a_big[1], a_big[2], a_big[3], b0_big, b1_big);
        } else {
          mma_k8(acc[t], a_big[0], a_big[1], a_big[2], a_big[3], tf32(mv.x),
                 tf32(mv.y));
        }
      }
    }

    // the month's tile: (row g, column 2t + i % 2) and (g + 8, ...)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * kColTile + 2 * tig;
      tile[grp * kCols + c] = acc[t][0];
      tile[grp * kCols + c + 1] = acc[t][1];
      tile[(grp + 8) * kCols + c] = acc[t][2];
      tile[(grp + 8) * kCols + c + 1] = acc[t][3];
    }
    __syncwarp();
    if (lane < kRowTile && r0 + lane < r) {
      const float* sums = tile + lane * kCols;
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
  if (lane < kRowTile && r0 + lane < r) out_sell[srow + r0 + lane] = sell_sum;
}

// Launches MODE over (16 x warps)-scale blocks of each agent; a CUDA
// error code, cudaErrorInvalidValue for shapes the kernels do not take.
template <int MODE>
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
  int warps = (r + kRowTile - 1) / kRowTile;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int rows = warps * kRowTile;
  const int r_blocks = (r + rows - 1) / rows;
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int seg_cap = lanes::max_segment(offs);
  const int smem = static_cast<int>(sizeof(float)) *
                   ((2 + c_pad) * seg_cap + warps * kRowTile * c_pad);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = &mask_product_kernel<MODE, 1>;
  if (c_pad != kColTile) kernel = &mask_product_kernel<MODE, 2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(total), warps * 32, smem, stream>>>(
      load, gen, m, scales, out_imp, out_sell, r, offs.o[kMonths], n_periods,
      seg_cap, r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes the kernels do not take. `offsets` is
// a host array of 13 hour offsets whose last is the hours per agent; `m`
// is [n, c_pad, hours], c_pad 8 or 16.
extern "C" int microbench_monthdot_pre(const float* load, const float* gen,
                                       const float* m, const float* scales,
                                       const int* offsets, float* out_imp,
                                       float* out_sell, int n, int r,
                                       int n_periods, int c_pad, void* stream) {
  return launch<kMonthdotPre>(load, gen, m, scales, offsets, out_imp, out_sell,
                              n, r, n_periods, c_pad,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int microbench_mnet(const float* load, const float* gen,
                               const float* m, const float* scales,
                               const int* offsets, float* out_imp,
                               float* out_sell, int n, int r, int n_periods,
                               int c_pad, int hi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hi ? launch<kMnetHi>(load, gen, m, scales, offsets, out_imp, out_sell,
                              n, r, n_periods, c_pad, st)
            : launch<kMnet>(load, gen, m, scales, offsets, out_imp, out_sell, n,
                            r, n_periods, c_pad, st);
}
