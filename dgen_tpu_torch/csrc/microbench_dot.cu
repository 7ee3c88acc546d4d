// Tensor-core bucket-sums variants of the kernel micro-benchmark, written
// for Hopper (sm_90a).
//
// Replace the TPU kernels of tools/kernel_microbench.py:
//   microbench_variant   <- _kernel_v  (launched by sums_variant)
//   microbench_monthdot  <- _kernel_md (launched by sums_monthdot)
//
// Both compute the import bucket sums of the one-hot kernel
// (bucket_sums_dot.cu): for every agent and net-load scale s, relu(load -
// s * gen) [scales x hours] times a matrix M [hours x columns] whose
// columns are the (month, period) buckets and the hourly sell rate, on
// the tensor cores (nvcuda::wmma m16n16k8, TF32 inputs, float32 sums).
//
// Bound on an H100: ~6 float32 operations per (agent, scale, hour)
// outside the tensor cores against four streams read once: operations,
// not bytes. The TF32 products (495 TFLOP/s dense) are far from the
// limit; forming relu(net) and M in shared memory is what costs.
//
// variant_kernel exists to split that cost. It is the one-hot kernel over
// hour chunks with each stage a compile-time switch, so that a stage
// switched off leaves no instruction behind:
//   BUILD  onehot: M formed from the bucket ids, all `cols` (= b_pad)
//                  columns of it, the sell rate in column cols - 1;
//          const:  M = 0.01 everywhere, written once before the loop
//                  (never, without the product);
//          hbm:    M [agents x hours x cols] copied from device memory;
//   DOT    dot:    the products, `cols / 16` column tiles per k-step;
//          none:   no product: per chunk, sum_h pos[row, h] + sum_h
//                  M[h, 0] is added to the row's one sum, which lands in
//                  every output column;
//   NET    fma:    net = load - s * gen;   bcast: net = load.
// `cols` is a run-time width (a multiple of 16 up to 128), so the cost
// of zero columns (64 against 128) is measured, not compiled away; the
// hours per chunk are a run-time depth (a multiple of 8).
//
// monthdot_kernel is the month-blocked design: the year is walked month
// by month, and within a month M is built by position from the period
// lane alone (column = the hour's period, the sell rate in column P), so
// it is 16 columns wide (one tile) whatever P is, against 12 P + 1
// columns over all hours in the one-hot kernel. The month's accumulator
// tile is written to the month's P output columns when the month ends;
// the sell column is carried in a register across the 12 months. Month
// lengths (672, 720, 744 hours) are multiples of the k-step of 8; a month
// is staged in chunks of 48 hours with a shorter last chunk.
//
// A block is one agent x (16 x warps) scales, one warp per 16-scale row
// tile, at most 4 warps, as in the one-hot kernel.

#include <cuda_runtime.h>
#include <mma.h>

#include "lanes.cuh"

namespace {

using namespace nvcuda;
using lanes::kMaxPeriods;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kTile = 16;  // wmma M and N
constexpr int kK = 8;      // wmma K for TF32
constexpr int kMaxWarps = 4;
constexpr int kMaxCols = 128;
constexpr int kMaxColTiles = kMaxCols / kTile;
constexpr int kMonthChunk = 48;  // hours per staged chunk of monthdot
constexpr int kMaxSmemBytes = 232448;
constexpr float kConstM = 0.01f;

constexpr int kOnehot = 0, kConst = 1, kHbm = 2;  // BUILD
constexpr int kDot = 0, kNoDot = 1;               // DOT
constexpr int kFma = 0, kBcast = 1;               // NET

using FragA = wmma::fragment<wmma::matrix_a, kTile, kTile, kK,
                             wmma::precision::tf32, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, kTile, kTile, kK,
                             wmma::precision::tf32, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kTile, kTile, kK, float>;

template <typename Frag>
__device__ __forceinline__ void to_tf32(Frag& f) {
#pragma unroll
  for (int i = 0; i < f.num_elements; ++i)
    f.x[i] = wmma::__float_to_tf32(f.x[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <int BUILD, int DOT, int NET>
__global__ void __launch_bounds__(kMaxWarps * 32)
    variant_kernel(const float* __restrict__ load,
                   const float* __restrict__ gen,
                   const float* __restrict__ sell,
                   const int* __restrict__ bucket,
                   const float* __restrict__ scales,
                   const float* __restrict__ m_hbm, float* __restrict__ out_imp,
                   float* __restrict__ out_sell, int r, int hours, int nb,
                   int cols, int chunk, int r_blocks) {
  extern __shared__ __align__(128) float smem[];

  const int warps = blockDim.x / 32;
  const int rows = warps * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int agent = blockIdx.x / r_blocks;
  const int r0 = (blockIdx.x % r_blocks) * rows;
  const int col_tiles = cols / kTile;

  // [rows x chunk] relu(net), [chunk x cols] M, a 16 x 16 tile per warp,
  // then the chunk's staged hours and the block's scales
  float* a_pos = smem;
  float* m_tile = a_pos + rows * chunk;
  float* scratch = m_tile + chunk * cols;
  float* h_load = scratch + warps * kTile * kTile;
  float* h_gen = h_load + chunk;
  float* h_sell = h_gen + chunk;
  int* h_bucket = reinterpret_cast<int*>(h_sell + chunk);
  float* s_scale = h_sell + 2 * chunk;

  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int ri = r0 + i;
    s_scale[i] = ri < r ? scales[static_cast<size_t>(agent) * r + ri] : 0.f;
  }
  if (BUILD == kConst && DOT == kDot)
    for (int i = threadIdx.x; i < chunk * cols; i += blockDim.x)
      m_tile[i] = kConstM;

  FragC acc[DOT == kDot ? kMaxColTiles : 1];
  if constexpr (DOT == kDot) {
#pragma unroll
    for (int t = 0; t < kMaxColTiles; ++t) wmma::fill_fragment(acc[t], 0.f);
  }
  float row_sum = 0.f;  // DOT none: the sum of row warp * 16 + lane / 2

  const size_t row = static_cast<size_t>(agent) * hours;
  for (int h0 = 0; h0 < hours; h0 += chunk) {
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int h = threadIdx.x; h < chunk; h += blockDim.x) {
      h_load[h] = load[row + h0 + h];
      if (NET == kFma) h_gen[h] = gen[row + h0 + h];
      if (BUILD == kOnehot) {
        h_sell[h] = sell[row + h0 + h];
        h_bucket[h] = bucket[row + h0 + h];
      }
    }
    __syncthreads();
    if (BUILD == kOnehot) {
      for (int i = threadIdx.x; i < chunk * cols; i += blockDim.x) {
        const int h = i / cols;
        const int c = i % cols;
        m_tile[i] = c == cols - 1 ? h_sell[h] : (c == h_bucket[h] ? 1.f : 0.f);
      }
    } else if (BUILD == kHbm) {
      const float* src = m_hbm + (row + h0) * cols;
      for (int i = threadIdx.x; i < chunk * cols; i += blockDim.x)
        m_tile[i] = src[i];
    }
    for (int i = threadIdx.x; i < rows * chunk; i += blockDim.x) {
      const int h = i % chunk;
      const float net = NET == kFma ? h_load[h] - s_scale[i / chunk] * h_gen[h]
                                    : h_load[h];
      a_pos[i] = fmaxf(net, 0.f);
    }
    __syncthreads();

    const float* a_rows = a_pos + warp * kTile * chunk;
    if constexpr (DOT == kDot) {
      for (int k = 0; k < chunk; k += kK) {
        FragA fa;
        wmma::load_matrix_sync(fa, a_rows + k, chunk);
        to_tf32(fa);
#pragma unroll
        for (int t = 0; t < kMaxColTiles; ++t) {
          if (t >= col_tiles) break;
          FragB fb;
          wmma::load_matrix_sync(fb, m_tile + k * cols + t * kTile, cols);
          to_tf32(fb);
          wmma::mma_sync(acc[t], fa, fb, acc[t]);
        }
      }
    } else {
      // two lanes per row, half a chunk each
      const float* a_row = a_rows + (lane / 2) * chunk + (lane % 2) * (chunk / 2);
      float v = 0.f;
      for (int h = 0; h < chunk / 2; ++h) v += a_row[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      float m0;
      if (BUILD == kConst) {
        m0 = kConstM * static_cast<float>(chunk);
      } else {
        float part = 0.f;
        for (int h = lane; h < chunk; h += 32) part += m_tile[h * cols];
        m0 = warp_sum(part);
      }
      row_sum += v + m0;
    }
  }

  if constexpr (DOT == kDot) {
    float* tile = scratch + warp * kTile * kTile;
#pragma unroll
    for (int t = 0; t < kMaxColTiles; ++t) {
      if (t >= col_tiles) break;
      wmma::store_matrix_sync(tile, acc[t], kTile, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32) {
        const int ri = r0 + warp * kTile + e / kTile;
        const int c = t * kTile + e % kTile;
        if (ri >= r) continue;
        const size_t out_row = static_cast<size_t>(agent) * r + ri;
        if (c < nb) {
          out_imp[out_row * nb + c] = tile[e];
        } else if (c == cols - 1) {
          out_sell[out_row] = tile[e];
        }
      }
      __syncwarp();
    }
  } else {
    const int ri = r0 + warp * kTile + lane / 2;
    if (lane % 2 == 0 && ri < r) {
      const size_t out_row = static_cast<size_t>(agent) * r + ri;
      for (int c = 0; c < nb; ++c) out_imp[out_row * nb + c] = row_sum;
      out_sell[out_row] = row_sum;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    monthdot_kernel(const float* __restrict__ load,
                    const float* __restrict__ gen,
                    const float* __restrict__ sell,
                    const int* __restrict__ bucket,
                    const float* __restrict__ scales,
                    float* __restrict__ out_imp, float* __restrict__ out_sell,
                    int r, int n_lanes, int n_periods, int r_blocks,
                    MonthOffsets offs) {
  extern __shared__ __align__(128) float smem[];

  const int warps = blockDim.x / 32;
  const int rows = warps * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int agent = blockIdx.x / r_blocks;
  const int r0 = (blockIdx.x % r_blocks) * rows;
  const int nb = kMonths * n_periods;

  // [rows x 48] relu(net), [48 x 16] M, a 16 x 16 tile per warp, then the
  // chunk's staged hours and the block's scales
  float* a_pos = smem;
  float* m_tile = a_pos + rows * kMonthChunk;
  float* scratch = m_tile + kMonthChunk * kTile;
  float* h_load = scratch + warps * kTile * kTile;
  float* h_gen = h_load + kMonthChunk;
  float* h_sell = h_gen + kMonthChunk;
  int* h_period = reinterpret_cast<int*>(h_sell + kMonthChunk);
  float* s_scale = h_sell + 2 * kMonthChunk;

  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int ri = r0 + i;
    s_scale[i] = ri < r ? scales[static_cast<size_t>(agent) * r + ri] : 0.f;
  }

  const float* a_rows = a_pos + warp * kTile * kMonthChunk;
  float* tile = scratch + warp * kTile * kTile;
  const int my_row = r0 + warp * kTile + lane;  // lanes < 16 own a row's sell sum
  float sell_sum = 0.f;
  const size_t row = static_cast<size_t>(agent) * n_lanes;

  for (int m = 0; m < kMonths; ++m) {
    const int m0 = offs.o[m];
    const int len = offs.o[m + 1] - m0;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int c0 = 0; c0 < len; c0 += kMonthChunk) {
      const int clen = min(kMonthChunk, len - c0);  // a multiple of 8
      __syncthreads();  // the previous chunk's tiles are consumed
      for (int h = threadIdx.x; h < clen; h += blockDim.x) {
        const size_t g = row + m0 + c0 + h;
        h_load[h] = load[g];
        h_gen[h] = gen[g];
        h_sell[h] = sell[g];
        h_period[h] = bucket[g] % n_periods;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < clen * kTile; i += blockDim.x) {
        const int h = i / kTile;
        const int c = i % kTile;
        m_tile[i] = c == n_periods ? h_sell[h] : (c == h_period[h] ? 1.f : 0.f);
      }
      for (int i = threadIdx.x; i < rows * clen; i += blockDim.x) {
        const int h = i % clen;
        const int ri = i / clen;
        a_pos[ri * kMonthChunk + h] =
            fmaxf(h_load[h] - s_scale[ri] * h_gen[h], 0.f);
      }
      __syncthreads();
      for (int k = 0; k < clen; k += kK) {
        FragA fa;
        wmma::load_matrix_sync(fa, a_rows + k, kMonthChunk);
        to_tf32(fa);
        FragB fb;
        wmma::load_matrix_sync(fb, m_tile + k * kTile, kTile);
        to_tf32(fb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    // the month's tile: columns < P are its buckets, column P its sell sum
    wmma::store_matrix_sync(tile, acc, kTile, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < kTile * kTile; e += 32) {
      const int ri = r0 + warp * kTile + e / kTile;
      const int c = e % kTile;
      if (ri < r && c < n_periods)
        out_imp[(static_cast<size_t>(agent) * r + ri) * nb + m * n_periods + c] =
            tile[e];
    }
    if (lane < kTile) sell_sum += tile[lane * kTile + n_periods];
    __syncwarp();
  }
  if (lane < kTile && my_row < r)
    out_sell[static_cast<size_t>(agent) * r + my_row] = sell_sum;
}

using VariantFn = void (*)(const float*, const float*, const float*, const int*,
                           const float*, const float*, float*, float*, int, int,
                           int, int, int, int);

template <int BUILD>
VariantFn pick_variant(int dot, int net) {
  if (dot == kDot)
    return net == kFma ? variant_kernel<BUILD, kDot, kFma>
                       : variant_kernel<BUILD, kDot, kBcast>;
  return net == kFma ? variant_kernel<BUILD, kNoDot, kFma>
                     : variant_kernel<BUILD, kNoDot, kBcast>;
}

// Blocks of (16 x warps) scales per agent; false when the grid overflows.
bool row_grid(int n, int r, int* warps, int* r_blocks, unsigned* blocks) {
  *warps = (r + kTile - 1) / kTile;
  if (*warps > kMaxWarps) *warps = kMaxWarps;
  const int rows = *warps * kTile;
  *r_blocks = (r + rows - 1) / rows;
  const long long total = static_cast<long long>(n) * *r_blocks;
  if (total > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(total);
  return true;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes the kernel does not take. `offsets` is
// a host array of 13 hour offsets whose last is the hours per agent.
// Bucket ids must lie in [0, 12 * n_periods).
extern "C" int microbench_variant(const float* load, const float* gen,
                                  const float* sell, const int* bucket,
                                  const float* scales, const int* offsets,
                                  float* out_imp, float* out_sell, int n, int r,
                                  int n_periods, int b_pad, int h_chunk,
                                  int build, int dot, int net,
                                  const float* m_hbm, void* stream) {
  if (n <= 0 || r <= 0 || offsets == nullptr || n_periods < 1 ||
      n_periods > kMaxPeriods)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hours = offsets[kMonths];
  const int nb = kMonths * n_periods;
  if (b_pad % kTile != 0 || b_pad < nb + 1 || b_pad > kMaxCols || h_chunk < kK ||
      h_chunk % kK != 0 || hours <= 0 || hours % h_chunk != 0 ||
      build < kOnehot || build > kHbm || dot < kDot || dot > kNoDot ||
      net < kFma || net > kBcast || (build == kHbm) != (m_hbm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int warps, r_blocks;
  unsigned blocks;
  if (!row_grid(n, r, &warps, &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = warps * kTile;
  const long long smem =
      static_cast<long long>(sizeof(float)) *
      (static_cast<long long>(rows) * h_chunk +
       static_cast<long long>(h_chunk) * b_pad + warps * kTile * kTile +
       4LL * h_chunk + rows);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const VariantFn fn = build == kOnehot  ? pick_variant<kOnehot>(dot, net)
                       : build == kConst ? pick_variant<kConst>(dot, net)
                                         : pick_variant<kHbm>(dot, net);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<blocks, warps * 32, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(load, gen, sell, bucket, scales,
                                            m_hbm, out_imp, out_sell, r, hours,
                                            nb, b_pad, h_chunk, r_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int microbench_monthdot(const float* load, const float* gen,
                                   const float* sell, const int* bucket,
                                   const float* scales, const int* offsets,
                                   float* out_imp, float* out_sell, int n,
                                   int r, int n_periods, void* stream) {
  MonthOffsets offs;
  // month lengths must be whole k-steps of 8 hours
  if (n <= 0 || r <= 0 || n_periods < 1 || n_periods > kMaxPeriods ||
      offsets == nullptr ||
      !lanes::read_offsets(offsets, offsets[kMonths], kK, &offs))
    return static_cast<int>(cudaErrorInvalidValue);
  int warps, r_blocks;
  unsigned blocks;
  if (!row_grid(n, r, &warps, &r_blocks, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = warps * kTile;
  const int smem = static_cast<int>(sizeof(float)) *
                   (rows * kMonthChunk + kMonthChunk * kTile +
                    warps * kTile * kTile + 4 * kMonthChunk + rows);
  monthdot_kernel<<<blocks, warps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      load, gen, sell, bucket, scales, out_imp, out_sell, r, offs.o[kMonths],
      n_periods, r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}
