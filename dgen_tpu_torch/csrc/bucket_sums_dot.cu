// One-hot bucket-sums kernel on the tensor cores, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _kernel (dgen_tpu/ops/billpallas.py:296,
// launched by _sums_pallas_dot :1095): per agent and hour chunk it forms
// the one-hot bucket matrix M [hours x columns] (column = the hour's
// month-major bucket id, the hourly sell rate in the sell column) and
// contracts relu(net) [scales x hours] (and net, signed) with it. It
// computes the month kernel's function over the full-hour 8760 lanes,
// from bucket ids rather than period lanes; outputs are the month
// kernel's ([N, R, 12P] bucket sums and [N, R] sell sums).
//
// Bound on an H100: the same float32 work as the month kernel (the
// one-hot product is a way to reduce, not extra work), ALU-bound at the
// main path's shapes. The contraction itself runs on the tensor cores in
// TF32 (495 TFLOP/s dense), so it is not what limits the kernel: forming
// relu(net) and the one-hot tile in shared memory is.
//
// What the design does about it:
//   * only the 12 P + 1 live columns are formed, padded to a multiple of
//     16 (32 at P = 2) -- the TPU's 128-wide bucket axis is MXU tiling;
//   * a block is one agent x (16 x warps) scales, one warp per 16-scale
//     row tile, at most 4 warps; it walks the hours in chunks of 40 (5
//     k-steps of 8; 8760 = 219 x 40): the chunk's load, gen, sell and
//     bucket ids are staged once, then relu(net) [rows x 40] and M
//     [40 x columns] are built in shared memory by the whole block;
//   * each warp runs nvcuda::wmma m16n16k8 TF32 products of its row tile
//     against every 16-column tile of M, accumulating in float32
//     fragments that stay in registers for the whole year (at most 8
//     column tiles, 16 signed);
//   * TF32 keeps 10 mantissa bits of relu(net) and of the sell rate (the
//     one-hot ones are exact), so sums carry ~1e-4 relative rounding:
//     the kernel is held to the JAX package's dot-engine tolerance,
//     rtol 5e-3 and atol 2.0.
//
// Stream types (lanes.cuh): load, gen and sell are float32, bfloat16 or
// int8 codes, template arguments of the kernel, upcast when a chunk is
// staged; the products and sums are the float32 kernel's, and the sums
// are stored as SumsOut (bfloat16 for bf16 banks).

#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "lanes.cuh"

namespace {

using namespace nvcuda;

constexpr int kMonths = 12;
constexpr int kMaxPeriods = 10;
constexpr int kTile = 16;    // wmma M and N
constexpr int kK = 8;        // wmma K for TF32
constexpr int kChunk = 40;   // hours per staged chunk
constexpr int kMaxWarps = 4;
constexpr int kMaxColTiles = (kMonths * kMaxPeriods + 1 + kTile - 1) / kTile;

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

// Writes one warp's accumulated [16 x cols] tile row to the outputs:
// columns < nb to the bucket sums, column nb to the sell sums.
template <typename TO>
__device__ __forceinline__ void emit(FragC (&acc)[kMaxColTiles],
                                     int col_tiles, float* tile, int agent,
                                     int row0, int r, int nb, TO* out,
                                     TO* out_sell) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < kMaxColTiles; ++t) {
    if (t >= col_tiles) break;
    wmma::store_matrix_sync(tile, acc[t], kTile, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < kTile * kTile; e += 32) {
      const int ri = row0 + e / kTile;
      const int c = t * kTile + e % kTile;
      if (ri >= r) continue;
      const size_t row = static_cast<size_t>(agent) * r + ri;
      if (c < nb) {
        lanes::store(out + row * nb + c, tile[e]);
      } else if (c == nb) {
        lanes::store(out_sell + row, tile[e]);
      }
    }
    __syncwarp();
  }
}

template <bool SIGNED, typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dot_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
               const TS* __restrict__ sell, const int* __restrict__ bucket,
               const float* __restrict__ scales, TO* __restrict__ out_imp,
               TO* __restrict__ out_sell_imp, TO* __restrict__ out_sgn,
               TO* __restrict__ out_sell_sgn, int r, int hours,
               int n_periods, int cols, int r_blocks) {
  extern __shared__ __align__(128) float smem[];

  const int warps = blockDim.x / 32;
  const int rows = warps * kTile;
  const int warp = threadIdx.x / 32;
  const int agent = blockIdx.x / r_blocks;
  const int r0 = (blockIdx.x % r_blocks) * rows;
  const int nb = kMonths * n_periods;
  const int col_tiles = cols / kTile;

  // [rows x kChunk] relu(net) and net, [kChunk x cols] M, then the
  // chunk's staged hours and the block's scales
  float* a_imp = smem;
  float* a_sgn = a_imp + rows * kChunk;
  float* m_tile = a_sgn + (SIGNED ? rows * kChunk : 0);
  float* h_load = m_tile + kChunk * cols;
  float* h_gen = h_load + kChunk;
  float* h_sell = h_gen + kChunk;
  int* h_bucket = reinterpret_cast<int*>(h_sell + kChunk);
  float* s_scale = h_sell + 2 * kChunk;

  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int ri = r0 + i;
    s_scale[i] = ri < r ? scales[static_cast<size_t>(agent) * r + ri] : 0.f;
  }

  FragC acc_i[kMaxColTiles];
  FragC acc_s[kMaxColTiles];
#pragma unroll
  for (int t = 0; t < kMaxColTiles; ++t) {
    wmma::fill_fragment(acc_i[t], 0.f);
    if (SIGNED) wmma::fill_fragment(acc_s[t], 0.f);
  }

  const size_t row = static_cast<size_t>(agent) * hours;
  for (int h0 = 0; h0 < hours; h0 += kChunk) {
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int h = threadIdx.x; h < kChunk; h += blockDim.x) {
      h_load[h] = lanes::to_f32(load[row + h0 + h]);
      h_gen[h] = lanes::to_f32(gen[row + h0 + h]);
      h_sell[h] = lanes::to_f32(sell[row + h0 + h]);
      h_bucket[h] = bucket[row + h0 + h];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * cols; i += blockDim.x) {
      const int h = i / cols;
      const int c = i % cols;
      m_tile[i] = c == nb ? h_sell[h] : (c == h_bucket[h] ? 1.f : 0.f);
    }
    for (int i = threadIdx.x; i < rows * kChunk; i += blockDim.x) {
      const int h = i % kChunk;
      const float net = h_load[h] - s_scale[i / kChunk] * h_gen[h];
      a_imp[i] = fmaxf(net, 0.f);
      if (SIGNED) a_sgn[i] = net;
    }
    __syncthreads();

    const float* a_rows_i = a_imp + warp * kTile * kChunk;
    const float* a_rows_s = a_sgn + warp * kTile * kChunk;
#pragma unroll
    for (int k = 0; k < kChunk; k += kK) {
      FragA fa_i;
      wmma::load_matrix_sync(fa_i, a_rows_i + k, kChunk);
      to_tf32(fa_i);
      FragA fa_s;
      if (SIGNED) {
        wmma::load_matrix_sync(fa_s, a_rows_s + k, kChunk);
        to_tf32(fa_s);
      }
#pragma unroll
      for (int t = 0; t < kMaxColTiles; ++t) {
        if (t >= col_tiles) break;
        FragB fb;
        wmma::load_matrix_sync(fb, m_tile + k * cols + t * kTile, cols);
        to_tf32(fb);
        wmma::mma_sync(acc_i[t], fa_i, fb, acc_i[t]);
        if (SIGNED) wmma::mma_sync(acc_s[t], fa_s, fb, acc_s[t]);
      }
    }
  }

  __syncthreads();  // every warp is done with the A tiles it now reuses
  float* tile = a_imp + warp * kTile * kChunk;  // 640 floats >= 16 x 16
  emit(acc_i, col_tiles, tile, agent, r0 + warp * kTile, r, nb, out_imp,
       out_sell_imp);
  if (SIGNED)
    emit(acc_s, col_tiles, tile, agent, r0 + warp * kTile, r, nb, out_sgn,
         out_sell_sgn);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or a stream dtype combination the
// kernel does not take (hours a multiple of 40; dtype codes as in
// lanes.cuh). Bucket ids must lie in [0, 12 * n_periods).
extern "C" int bucket_sums_dot(const void* load, const void* gen,
                               const void* sell, const int* bucket,
                               const float* scales, void* out_imp,
                               void* out_sell_imp, void* out_sgn,
                               void* out_sell_sgn, int n, int r, int hours,
                               int n_periods, int with_signed, int dt_load,
                               int dt_gen, int dt_sell, void* stream) {
  if (n <= 0 || r <= 0 || hours <= 0 || hours % kChunk != 0 ||
      n_periods < 1 || n_periods > kMaxPeriods)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = (kMonths * n_periods + 1 + kTile - 1) / kTile * kTile;
  int warps = (r + kTile - 1) / kTile;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int rows = warps * kTile;
  const int r_blocks = (r + rows - 1) / rows;
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int a_tiles = with_signed ? 2 : 1;
  const int smem = static_cast<int>(sizeof(float)) *
                   (a_tiles * rows * kChunk + kChunk * cols + 4 * kChunk + rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(total);
  auto launch = [&](auto signed_tag, auto l, auto g, auto s) {
    constexpr bool kSigned = decltype(signed_tag)::value;
    using TL = typename decltype(l)::type;
    using TG = typename decltype(g)::type;
    using TS = typename decltype(s)::type;
    using TO = lanes::SumsOut<TL, TG, TS>;
    dot_kernel<kSigned, TL, TG, TS><<<blocks, warps * 32, smem, st>>>(
        static_cast<const TL*>(load), static_cast<const TG*>(gen),
        static_cast<const TS*>(sell), bucket, scales,
        static_cast<TO*>(out_imp), static_cast<TO*>(out_sell_imp),
        static_cast<TO*>(out_sgn), static_cast<TO*>(out_sell_sgn), r, hours,
        n_periods, cols, r_blocks);
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
