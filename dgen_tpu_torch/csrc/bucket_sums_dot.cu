// One-hot bucket-sums kernel on the tensor cores, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _kernel (dgen_tpu/ops/billpallas.py:296,
// launched by _sums_pallas_dot :1115): per agent it contracts relu(net)
// [scales x hours] (and net, signed) with the one-hot bucket matrix M
// [hours x columns] (column = the hour's month-major bucket id, the hourly
// sell rate in column 12 P). It computes the month kernel's function over
// the full-hour lanes, from bucket ids rather than period lanes; outputs
// are the month kernel's ([N, R, 12P] bucket sums and [N, R] sell sums).
//
// Bound on an H100: the dense product with the 12 P + 1 columns padded
// to a multiple of 8 (32 at P = 2) is N x R x H x cols multiply-adds, 2.8
// ms at 8,192 agents x 300 scales at the tensor cores' TF32 peak (495
// TFLOP/s dense, which only wgmma reaches; mma.sync issues well below
// it). But an hour falls in one bucket, so most of M's 8-column tiles are
// zero in any k-step of 8 hours, and the products of those tiles add
// nothing: the work the function needs is the products of the tiles the
// hours touch, plus forming relu(load - s * gen) per (scale, hour) on the
// CUDA cores.
//
// What the design does about it:
//   * M's columns go in tiles of 8: kGroup = 7 consecutive buckets and a
//     sell slot, which takes the sell rate of the hours whose bucket is in
//     the tile (the tiles' sell slots add up to the sell sums); a k-step
//     multiplies only the tiles its hours' buckets fall in, whatever the
//     bucket ids (a skipped tile's B is all zero): one tile for most
//     months at P = 2 (of 4), two or three at P = 10 (of 18); two k-steps
//     go per loop trip, so one's loads overlap the other's products;
//   * the operands are formed in registers, in the fragment layout of
//     mma.sync.m16n8k8 TF32 (raw PTX, so the layout is known): a thread
//     holds two scales of each 16-scale row tile and, per k-step, two
//     hours; its A elements are relu(load - s * gen) of those (a
//     multiply-add and an integer add-and-max that rounds to nearest TF32
//     and takes the positive part), formed once and used by every tile;
//     its B elements of a tile are 1 where the hour's key is the thread's
//     column and 0 elsewhere, the key being the hour's bucket, or for the
//     sell slot its bucket's tile and the value the sell rate; they are
//     formed once and used by every row tile of the warp; nothing of A or
//     M goes through shared memory;
//   * the hours of a k-step need not be consecutive in the product (it
//     sums over them), so a thread takes two adjacent hours and reads each
//     stream as one 2-element load;
//   * only the agent's streams are staged: load, gen, sell and bucket ids
//     of a chunk of kChunk hours (16 bytes an hour in float32), copied
//     with cp.async while the previous chunk is multiplied (two buffers);
//     once a chunk has landed, the block writes each hour's tile and each
//     k-step's mask of live tiles beside it (three block barriers a
//     chunk), so the k-loop divides and votes nothing;
//   * a warp holds RT row tiles, RT x NT float32 accumulators of 4
//     registers (twice that signed), and a block holds one agent's scales
//     (up to 8 warps; wider R takes several blocks);
//   * the accumulators go from registers to the outputs: a thread owns
//     two adjacent columns of two rows of each tile;
//   * TF32 keeps 10 mantissa bits of relu(net) and of the sell rate (the
//     one-hot ones are exact), so the import sums, whose terms are all of
//     one sign, carry ~1e-4 relative rounding. The signed sums' terms
//     cancel (net changes sign across the year, and a scale near the
//     crossing leaves a large agent a sum near 0 of large terms), so
//     there net and the sell rate go in as two TF32 parts each
//     (3xTF32: hi b + lo b + hi b_lo, three products where the imports
//     take one), ~2^-22 of each term. The kernel is held to the JAX
//     package's dot-engine tolerance, rtol 5e-3 and atol 2.0.
//
// Stream types (lanes.cuh): load, gen and sell are float32, bfloat16 or
// int8 codes, template arguments of the kernel, copied as they are and
// upcast when a thread reads them; the sums are the float32 kernel's and
// are stored as SumsOut (bfloat16 for bf16 banks).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "lanes.cuh"
#include "mma_tf32.cuh"

namespace {

using mma_tf32::kOne;
using mma_tf32::mma;
using mma_tf32::row_tiles;
using mma_tf32::tf32;
using mma_tf32::tf32_relu;
using mma_tf32::tf32_rest;

constexpr int kMonths = 12;
constexpr int kMaxPeriods = 10;
constexpr int kK = 8;          // hours of a k-step (mma K for TF32)
constexpr int kChunk = 584;    // hours a staged chunk (8760 = 15 x 584)
static_assert(2 * kChunk % 16 == 0, "staged arrays stay 16-byte aligned");
constexpr int kMaxWarps = 8;
// Buckets an 8-column tile holds; its eighth column is its sell slot.
constexpr int kGroup = 7;

// Column tiles a kernel is instantiated for: the tiles of 12 P buckets,
// kGroup a tile, rounded up to 2, 4, 8, 12 or 18.
inline int column_tiles(int n_periods) {
  const int nt = (kMonths * n_periods + kGroup - 1) / kGroup;
  return nt <= 2 ? 2 : nt <= 4 ? 4 : nt <= 8 ? 8 : nt <= 12 ? 12 : 18;
}

// Two adjacent elements (aligned to two), upcast.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const lanes::bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 x = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(x.x), static_cast<float>(x.y));
}

// Copies hours [h0, h0 + len) of one agent's row of a stream into dst:
// 16-byte pieces, 8-byte for int8 (rows of a multiple of 8 hours).
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* row, int h0, int len) {
  constexpr int kBytes = sizeof(T) == 1 ? 8 : 16;
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < len / kPer; i += blockDim.x)
    async_copy::copy<kBytes>(dst + i * kPer, row + h0 + i * kPer);
}

template <typename TO>
__device__ __forceinline__ void put(TO* out, int agent, int r, int nb,
                                    int row, int bucket, float v) {
  if (row < r && bucket < nb)
    lanes::store(out + (static_cast<size_t>(agent) * r + row) * nb + bucket, v);
}

template <typename TO>
__device__ __forceinline__ void put_sell(TO* out_sell, int agent, int r,
                                         int row, float v) {
  if (row < r) lanes::store(out_sell + static_cast<size_t>(agent) * r + row, v);
}

template <bool SIGNED, int NT, typename TL, typename TG, typename TS,
          typename TO = lanes::SumsOut<TL, TG, TS>>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dot_kernel(const TL* __restrict__ load, const TG* __restrict__ gen,
               const TS* __restrict__ sell, const int* __restrict__ bucket,
               const float* __restrict__ scales, TO* __restrict__ out_imp,
               TO* __restrict__ out_sell_imp, TO* __restrict__ out_sgn,
               TO* __restrict__ out_sell_sgn, int r, int hours,
               int n_periods, int r_blocks) {
  constexpr int RT = row_tiles(NT, SIGNED);
  // two buffers of each stream's chunk, at the stream's own type (every
  // array starts 16-byte aligned: 2 x kChunk bytes is a multiple of 16)
  __shared__ __align__(16) unsigned char
      staged[2 * kChunk * (sizeof(TL) + sizeof(TG) + sizeof(TS) + sizeof(int))];
  TL(*s_load)[kChunk] = reinterpret_cast<TL(*)[kChunk]>(staged);
  TG(*s_gen)[kChunk] = reinterpret_cast<TG(*)[kChunk]>(s_load + 2);
  TS(*s_sell)[kChunk] = reinterpret_cast<TS(*)[kChunk]>(s_gen + 2);
  int(*s_bucket)[kChunk] = reinterpret_cast<int(*)[kChunk]>(s_sell + 2);
  // the current chunk's tile of each hour's bucket, and per k-step the
  // tiles its hours fall in
  __shared__ __align__(16) int s_tile[kChunk];
  __shared__ unsigned s_live[kChunk / kK];

  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int q = lane % 4;
  const int warps = blockDim.x / 32;
  const int agent = blockIdx.x / r_blocks;
  const int nb = kMonths * n_periods;
  // first row of the warp's first tile, and its row tiles that hold rows
  const int row0 =
      ((blockIdx.x % r_blocks) * warps + threadIdx.x / 32) * RT * 16;
  const int rt_live = min(RT, max(0, (r - row0 + 15) / 16));
  // B element (hour, column j * 8 + grp) is the thread's value (1, or for
  // the sell slot the hour's sell rate) where the hour's key (its bucket,
  // or for the sell slot its bucket's tile) is key_step * j + key_off, and
  // 0 elsewhere
  const bool sell_slot = grp == kGroup;
  const int key_step = sell_slot ? 1 : kGroup;
  const int key_off = sell_slot ? 0 : grp;

  // the thread's scales: rows grp and grp + 8 of each row tile
  float s_lo[RT], s_hi[RT];
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int lo = row0 + t * 16 + grp;
    const float* s = scales + static_cast<size_t>(agent) * r;
    s_lo[t] = lo < r ? s[lo] : 0.f;
    s_hi[t] = lo + 8 < r ? s[lo + 8] : 0.f;
  }

  float acc[RT][NT][4];
  float acc_s[SIGNED ? RT : 1][SIGNED ? NT : 1][4];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[t][j][e] = 0.f;
        if constexpr (SIGNED) acc_s[t][j][e] = 0.f;
      }

  const size_t row = static_cast<size_t>(agent) * hours;
  const TL* l_row = load + row;
  const TG* g_row = gen + row;
  const TS* s_row = sell + row;
  const int* b_row = bucket + row;
  const int n_chunks = (hours + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int c) {
    const int h0 = c * kChunk;
    const int len = min(kChunk, hours - h0);
    const int b = c & 1;
    stage(s_load[b], l_row, h0, len);
    stage(s_gen[b], g_row, h0, len);
    stage(s_sell[b], s_row, h0, len);
    stage(s_bucket[b], b_row, h0, len);
  };
  stage_chunk(0);
  async_copy::commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage_chunk(c + 1);
    async_copy::commit();
    async_copy::wait<1>();  // chunk c has landed; chunk c + 1 is in flight
    __syncthreads();
    const int b = c & 1;
    const int len = min(kChunk, hours - c * kChunk);
    for (int i = threadIdx.x; i < len / kK; i += blockDim.x) {
      unsigned live = 0;
#pragma unroll
      for (int e = 0; e < kK; ++e) {
        const int tile = static_cast<unsigned>(s_bucket[b][i * kK + e]) / kGroup;
        s_tile[i * kK + e] = tile;
        live |= 1u << tile;
      }
      s_live[i] = live;
    }
    __syncthreads();
    const int* keys = sell_slot ? s_tile : s_bucket[b];
#pragma unroll 2
    for (int k0 = 0; k0 < len; k0 += kK) {
      // this thread's k indices q and q + 4 are hours h and h + 1
      const int h = k0 + 2 * q;
      const float2 l = load2(&s_load[b][h]);
      const float2 g = load2(&s_gen[b][h]);
      const float2 sv = load2(&s_sell[b][h]);
      const int2 key = *reinterpret_cast<const int2*>(&keys[h]);
      // the tiles any hour of the k-step falls in; every other tile's B
      // is all zero and its products add nothing
      const unsigned live = s_live[k0 / kK];
      const uint32_t val0 = sell_slot ? tf32(sv.x) : kOne;
      const uint32_t val1 = sell_slot ? tf32(sv.y) : kOne;
      // the sell rate's rest, for the signed products (0 off the sell slot)
      const uint32_t rest0 = sell_slot ? tf32_rest(sv.x, val0) : 0u;
      const uint32_t rest1 = sell_slot ? tf32_rest(sv.y, val1) : 0u;
      uint32_t a[RT][4];
      uint32_t as[SIGNED ? RT : 1][4], as_lo[SIGNED ? RT : 1][4];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const float n00 = fmaf(-s_lo[t], g.x, l.x);
        const float n10 = fmaf(-s_hi[t], g.x, l.x);
        const float n01 = fmaf(-s_lo[t], g.y, l.y);
        const float n11 = fmaf(-s_hi[t], g.y, l.y);
        a[t][0] = tf32_relu(n00);
        a[t][1] = tf32_relu(n10);
        a[t][2] = tf32_relu(n01);
        a[t][3] = tf32_relu(n11);
        if constexpr (SIGNED) {
          as[t][0] = tf32(n00);
          as[t][1] = tf32(n10);
          as[t][2] = tf32(n01);
          as[t][3] = tf32(n11);
          as_lo[t][0] = tf32_rest(n00, as[t][0]);
          as_lo[t][1] = tf32_rest(n10, as[t][1]);
          as_lo[t][2] = tf32_rest(n01, as[t][2]);
          as_lo[t][3] = tf32_rest(n11, as[t][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!(live >> j & 1u)) continue;  // warp-uniform
        const int kj = key_step * j + key_off;
        const uint32_t b0 = key.x == kj ? val0 : 0u;
        const uint32_t b1 = key.y == kj ? val1 : 0u;
        const uint32_t bl0 = key.x == kj ? rest0 : 0u;
        const uint32_t bl1 = key.y == kj ? rest1 : 0u;
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          if (t >= rt_live) break;  // warp-uniform: no rows left
          mma(acc[t][j], a[t], b0, b1);
          if constexpr (SIGNED) {
            mma(acc_s[t][j], as[t], b0, b1);
            mma(acc_s[t][j], as_lo[t], b0, b1);
            mma(acc_s[t][j], as[t], bl0, bl1);
          }
        }
      }
    }
    // buffer b, s_tile and s_live are read before chunk c + 2 is staged
    // into b and chunk c + 1's keys are written
    __syncthreads();
  }

  // thread (grp, q) holds columns 2q and 2q + 1 of each tile: buckets
  // j * kGroup + 2q (+ 1), and for q = 3 the tile's sell slot, added up
  // over the tiles
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int lo = row0 + t * 16 + grp;
    float sell_lo = 0.f, sell_hi = 0.f, sgn_lo = 0.f, sgn_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * kGroup + 2 * q;
      put(out_imp, agent, r, nb, lo, col, acc[t][j][0]);
      put(out_imp, agent, r, nb, lo + 8, col, acc[t][j][2]);
      if constexpr (SIGNED) {
        put(out_sgn, agent, r, nb, lo, col, acc_s[t][j][0]);
        put(out_sgn, agent, r, nb, lo + 8, col, acc_s[t][j][2]);
      }
      if (2 * q + 1 < kGroup) {
        put(out_imp, agent, r, nb, lo, col + 1, acc[t][j][1]);
        put(out_imp, agent, r, nb, lo + 8, col + 1, acc[t][j][3]);
        if constexpr (SIGNED) {
          put(out_sgn, agent, r, nb, lo, col + 1, acc_s[t][j][1]);
          put(out_sgn, agent, r, nb, lo + 8, col + 1, acc_s[t][j][3]);
        }
      } else {
        sell_lo += acc[t][j][1];
        sell_hi += acc[t][j][3];
        if constexpr (SIGNED) {
          sgn_lo += acc_s[t][j][1];
          sgn_hi += acc_s[t][j][3];
        }
      }
    }
    if (2 * q + 1 == kGroup) {
      put_sell(out_sell_imp, agent, r, lo, sell_lo);
      put_sell(out_sell_imp, agent, r, lo + 8, sell_hi);
      if constexpr (SIGNED) {
        put_sell(out_sell_sgn, agent, r, lo, sgn_lo);
        put_sell(out_sell_sgn, agent, r, lo + 8, sgn_hi);
      }
    }
  }
}

// Whether p is aligned to stage's copy size for dtype code dt (8 bytes
// for int8, else 16); bucket ids go as float32 do.
bool staged_aligned(const void* p, int dt) {
  return reinterpret_cast<uintptr_t>(p) % (dt == lanes::kI8 ? 8 : 16) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes, alignments or a stream dtype
// combination the kernel does not take (hours a multiple of 8; the
// float32 and bfloat16 streams and the bucket ids 16-byte aligned, the
// int8 streams 8-byte aligned, so that any row of an aligned array
// starts aligned; dtype codes as in lanes.cuh).
// Bucket ids must lie in [0, 12 * n_periods).
extern "C" int bucket_sums_dot(const void* load, const void* gen,
                               const void* sell, const int* bucket,
                               const float* scales, void* out_imp,
                               void* out_sell_imp, void* out_sgn,
                               void* out_sell_sgn, int n, int r, int hours,
                               int n_periods, int with_signed, int dt_load,
                               int dt_gen, int dt_sell, void* stream) {
  if (n <= 0 || r <= 0 || hours <= 0 || hours % kK != 0 || n_periods < 1 ||
      n_periods > kMaxPeriods || !staged_aligned(load, dt_load) ||
      !staged_aligned(gen, dt_gen) || !staged_aligned(sell, dt_sell) ||
      !staged_aligned(bucket, lanes::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt_max = column_tiles(n_periods);
  const int rt = row_tiles(nt_max, with_signed != 0);
  const int tiles = (r + 15) / 16;
  int warps = (tiles + rt - 1) / rt;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int r_blocks = (r + warps * rt * 16 - 1) / (warps * rt * 16);
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(total);
  auto launch = [&](auto signed_tag, auto nt_tag, auto l, auto g, auto s) {
    constexpr bool kSigned = decltype(signed_tag)::value;
    constexpr int kNT = decltype(nt_tag)::value;
    using TL = typename decltype(l)::type;
    using TG = typename decltype(g)::type;
    using TS = typename decltype(s)::type;
    using TO = lanes::SumsOut<TL, TG, TS>;
    dot_kernel<kSigned, kNT, TL, TG, TS><<<blocks, warps * 32, 0, st>>>(
        static_cast<const TL*>(load), static_cast<const TG*>(gen),
        static_cast<const TS*>(sell), bucket, scales,
        static_cast<TO*>(out_imp), static_cast<TO*>(out_sell_imp),
        static_cast<TO*>(out_sgn), static_cast<TO*>(out_sell_sgn), r, hours,
        n_periods, r_blocks);
  };
  auto with_nt = [&](auto signed_tag, auto l, auto g, auto s) {
    switch (nt_max) {
      case 2:
        launch(signed_tag, std::integral_constant<int, 2>(), l, g, s);
        break;
      case 4:
        launch(signed_tag, std::integral_constant<int, 4>(), l, g, s);
        break;
      case 8:
        launch(signed_tag, std::integral_constant<int, 8>(), l, g, s);
        break;
      case 12:
        launch(signed_tag, std::integral_constant<int, 12>(), l, g, s);
        break;
      default:
        launch(signed_tag, std::integral_constant<int, 18>(), l, g, s);
    }
  };
  const bool known =
      with_signed
          ? lanes::with_stream_types<true>(
                dt_load, dt_gen, dt_sell,
                [&](auto l, auto g, auto s) {
                  with_nt(std::true_type(), l, g, s);
                })
          : lanes::with_stream_types<false>(
                dt_load, dt_gen, dt_sell, [&](auto l, auto g, auto s) {
                  with_nt(std::false_type(), l, g, s);
                });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
