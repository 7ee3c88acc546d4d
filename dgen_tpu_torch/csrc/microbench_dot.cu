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
// the tensor cores in TF32 with float32 sums.
//
// variant_kernel is the one-hot product over hour chunks with each stage
// a compile-time switch, so that a stage switched off leaves no
// instruction behind:
//   BUILD  onehot: M formed from the bucket ids, all `cols` (= b_pad)
//                  columns of it, the sell rate in column cols - 1;
//          const:  M = 0.01 everywhere, written once before the loop
//                  (never, without the product);
//          hbm:    M [agents x hours x cols] copied from device memory;
//   DOT    dot:    the products, all `cols` columns;
//          none:   no product and no tensor-core instruction: sum_h
//                  pos[row, h] + sum_h M[h, 0] is the row's one sum,
//                  which lands in every output column;
//   NET    fma:    net = load - s * gen;   bcast: net = load.
// Its outputs need the TF32 product of 12 P + 1 columns, so its bound on
// an H100 is the larger of that product (2 x N x R x hours x (12 P + 1)
// operations at 495 TFLOP/s: 1.8 ms at 8,192 agents x 250 scales, P =
// 2), the ~6 float32 operations a (scale, hour) that form relu(net) (1.6
// ms) and the bytes of the four streams. Its contract multiplies every
// one of the `cols` columns all the same (the cost of zero columns, 64
// against 128, is what it measures): the dense product of 128 columns
// has a floor of 9.3 ms there, which only wgmma approaches (mma.sync
// issued about a quarter of the TF32 peak in the dot kernel), so the
// design is:
//   * wgmma.mma_async m64nNk8 TF32, A from registers and B (M) from
//     shared memory, float32 accumulators in registers; a warpgroup holds
//     64 scales, and a block one agent's scales (up to four warpgroups;
//     wider R takes more blocks), so each chunk of M is formed once per
//     agent and read by every warpgroup;
//   * the width N is cols, as one wgmma per k-step of 8 hours where cols
//     is 16, 32, 64 or 128, else as the binary parts of cols (112 = 64 +
//     32 + 16), each a product over its own columns of the same A;
//   * A = relu(net) is formed in registers in wgmma's fragment layout (a
//     warp's 16 rows as mma.sync.m16n8k8 holds them): a multiply-add and
//     the integer add-and-max that rounds to nearest TF32 and takes the
//     positive part, per (scale, hour); a thread's k indices q and q + 4
//     are the adjacent hours 2q and 2q + 1, read as one 2-element load;
//   * M lies in shared memory in the layout wgmma reads for a 32-bit B,
//     which must be K-major (there is no transposed TF32 form): per
//     k-step a slab of cols x 8 floats, core matrices of 8 columns x 4
//     hours (16 bytes a column), the two 4-hour halves 128 bytes apart
//     (leading byte offset) and the 8-column groups 256 bytes apart
//     (stride byte offset), no swizzle; the halves hold hours (0, 2, 4,
//     6) and (1, 3, 5, 7), the order of A's k indices above. The onehot
//     build writes it with no divide: one warpgroup forms a group of
//     128 / cols slabs, its thread owning one column of one slab and
//     writing each 4-hour half of it as one 16-byte store (1 where the
//     hour's bucket is the column, the sell rate in column cols - 1,
//     rounded to TF32); the hbm build copies each element of the chunk
//     straight from device memory into its place with 4-byte cp.async
//     (a TMA box cannot transpose 32-bit elements into the K-major
//     layout), and its values are truncated to TF32 by the tensor cores;
//   * stages: while the products of chunk c run, chunk c + 1 of M is
//     formed (group k at k-step k, by the warpgroups in turn, so that the
//     other warpgroups keep issuing products) or copied into the third
//     stage of M, and the streams of chunk c + 3 are copied with
//     cp.async into the fourth stage of the streams; a warpgroup keeps
//     two k-steps' products in flight (wgmma.fence before each, commit,
//     wait_group 1), across chunks too, with the A of even and odd
//     k-steps in registers of their own, and one block barrier a chunk
//     hands the stages on (M made visible to the tensor cores' async
//     proxy by fence.proxy.async);
//   * the accumulators go from registers straight to the outputs.
//
// monthdot_kernel is the month-blocked design: the year is walked month
// by month, and within a month M is built by position from the period
// lane alone (column = the hour's period bucket % P, the sell rate in
// column P), so it is P + 1 columns wide: one mma.sync n8 tile for P <=
// 7 and two for P <= 10, against 12 P + 1 columns over all hours in the
// one-hot product. Month lengths (672, 720, 744 hours) are multiples of
// the k-step of 8, so a k-step lies in one month and no key or vote is
// needed. Its bound is forming relu(net) (~6 float32 operations a
// (scale, hour), 1.6 ms at 8,192 x 250) on the CUDA cores, as the
// products of P + 1 columns are few. The design is the dot kernel's
// (bucket_sums_dot.cu): mma.sync.m16n8k8 TF32 through raw PTX
// (mma_tf32.cuh) with A and B formed in registers, one block per agent's
// scales (up to 8 warps of 4 row tiles at P <= 7, of 2 at P >= 8, where
// 4 spilled), the agent's streams staged once
// with cp.async double buffering and each staged bucket id turned into
// its period once for all warps (bucket % P by a float product, no
// divide); a month's accumulators are written to its P output columns
// when the month ends and cleared, while the sell column stays in its
// accumulator across the 12 months.
//
// Times, bounds and the A/Bs behind this design: PERF.md (section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "lanes.cuh"
#include "mma_tf32.cuh"

namespace {

using lanes::kMaxPeriods;
using lanes::kMonths;
using lanes::MonthOffsets;

constexpr int kK = 8;             // hours of a k-step (K of TF32 products)
constexpr int kColTile = 16;      // b_pad is a multiple of this
constexpr int kMaxCols = 128;
constexpr int kWgRows = 64;       // scales of a warpgroup (wgmma M)
constexpr int kMaxWarpgroups = 4;
constexpr int kStages = 4;        // staged chunks of the streams
constexpr int kMStages = 3;       // staged chunks of M
constexpr int kMaxSmemBytes = 232448;
constexpr float kConstM = 0.01f;

constexpr int kOnehot = 0, kConst = 1, kHbm = 2;  // BUILD
constexpr int kDot = 0, kNoDot = 1;               // DOT
constexpr int kFma = 0, kBcast = 1;               // NET

// ---------------------------------------------------------------------------
// wgmma: d [64 x N] += a [64 x 8] . b [8 x N], TF32, float32 accumulators.
// a: 4 registers a thread, warp w of the warpgroup holding rows 16 w .. 16 w
// + 15 as mma.sync.m16n8k8 does; b: a shared-memory descriptor; d: N / 2
// registers a thread, d[4 j + e] at rows (g, g, g + 8, g + 8) and columns
// 8 j + 2q + (0, 1, 0, 1) of the warp's 16 rows (g = lane / 4, q = lane %
// 4).
// ---------------------------------------------------------------------------

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma's B operand).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x with its bit pattern rounded to TF32 (mma_tf32::tf32), as a float.
__device__ __forceinline__ float tf32_value(float x) {
  return __uint_as_float(mma_tf32::tf32(x));
}

// Descriptor of a K-major B slab at `p` (see the file comment): start
// address, leading byte offset 128 (the second 4-hour half), stride byte
// offset 256 (the next 8 columns), all in 16-byte units; no swizzle.
__device__ __forceinline__ uint64_t slab_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}
// Offset of element (column n, k index kk) in a slab, in floats.
__device__ __forceinline__ int slab_at(int n, int kk) {
  return (n / 8) * 64 + (kk / 4) * 32 + (n % 8) * 4 + kk % 4;
}

// The accumulators of `cols` = 16 x NT columns: one array per binary part
// of NT (128, 64, 32 and 16 columns, in that order along the columns).
template <int NT>
struct Acc {
  float d128[NT & 8 ? 64 : 1];
  float d64[NT & 4 ? 32 : 1];
  float d32[NT & 2 ? 16 : 1];
  float d16[NT & 1 ? 8 : 1];

  // f(accumulators, width, first column) for each part
  template <typename F>
  __device__ __forceinline__ void each(F f) {
    using std::integral_constant;
    if constexpr ((NT & 8) != 0)
      f(d128, integral_constant<int, 128>(), integral_constant<int, 0>());
    if constexpr ((NT & 4) != 0)
      f(d64, integral_constant<int, 64>(),
        integral_constant<int, (NT & 8) * kColTile>());
    if constexpr ((NT & 2) != 0)
      f(d32, integral_constant<int, 32>(),
        integral_constant<int, (NT & 12) * kColTile>());
    if constexpr ((NT & 1) != 0)
      f(d16, integral_constant<int, 16>(),
        integral_constant<int, (NT & 14) * kColTile>());
  }
};

// Copies `count` floats (a multiple of 4, both ends 16-byte aligned).
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int count) {
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x)
    async_copy::copy<16>(dst + 4 * i, src + 4 * i);
}

// NT = cols / 16 for the products; 0 without them (cols then a run-time
// argument, as no accumulator depends on it).
template <int BUILD, int DOT, int NET, int NT>
__global__ void __launch_bounds__(kMaxWarpgroups * 128, 1)
    variant_kernel(const float* __restrict__ load,
                   const float* __restrict__ gen,
                   const float* __restrict__ sell,
                   const int* __restrict__ bucket,
                   const float* __restrict__ scales,
                   const float* __restrict__ m_hbm, float* __restrict__ out_imp,
                   float* __restrict__ out_sell, int r, int hours, int nb,
                   int cols_arg, int chunk, int r_blocks) {
  static_assert((DOT == kDot) == (NT > 0), "products need their width");
  constexpr bool kWithM = !(BUILD == kConst && DOT == kNoDot);
  extern __shared__ __align__(128) float smem[];
  const int cols = NT > 0 ? NT * kColTile : cols_arg;
  const int slabs = chunk / kK;
  const int m_chunk = chunk * cols;  // floats of one chunk of M
  // M: kMStages chunks of slabs (one for const), then the streams' stages
  float* s_m = smem;
  float* s_load = s_m + (BUILD == kConst ? (kWithM ? 1 : 0) : kMStages) * m_chunk;
  float* s_gen = s_load + kStages * chunk;
  float* s_sell = s_gen + kStages * chunk;
  int* s_bucket = reinterpret_cast<int*>(s_sell + kStages * chunk);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int agent = blockIdx.x / r_blocks;
  // rows g and g + 8 of the warp's 16 in its warpgroup's 64
  const int row_lo = (blockIdx.x % r_blocks) * (blockDim.x / 128) * kWgRows +
                     (tid / 32) * 16 + g;
  const int row_hi = row_lo + 8;
  const float* sc = scales + static_cast<size_t>(agent) * r;
  const float s_lo = row_lo < r ? sc[row_lo] : 0.f;
  const float s_hi = row_hi < r ? sc[row_hi] : 0.f;

  const size_t row = static_cast<size_t>(agent) * hours;
  const int n_chunks = hours / chunk;
  auto stage_streams = [&](int c) {
    if (c >= n_chunks) return;
    const int b = c % kStages;
    const size_t h0 = row + static_cast<size_t>(c) * chunk;
    stage_floats(s_load + b * chunk, load + h0, chunk);
    if constexpr (NET == kFma) stage_floats(s_gen + b * chunk, gen + h0, chunk);
    if constexpr (BUILD == kOnehot) {
      stage_floats(s_sell + b * chunk, sell + h0, chunk);
      stage_floats(reinterpret_cast<float*>(s_bucket) + b * chunk,
                   reinterpret_cast<const float*>(bucket) + h0, chunk);
    }
  };
  // hbm: chunk c of M, each element copied into its place in the slabs
  auto stage_m = [&](int c) {
    if (c >= n_chunks) return;
    float* dst = s_m + (c % kMStages) * m_chunk;
    const float* src = m_hbm + (row + static_cast<size_t>(c) * chunk) * cols;
    for (int i = tid; i < m_chunk; i += blockDim.x) {
      const int h = i / cols;
      const int n = i - h * cols;
      const int hk = h % kK;
      async_copy::copy<4>(dst + (h / kK) * cols * kK +
                              slab_at(n, (hk % 2) * 4 + hk / 2),
                          src + i);
    }
  };
  // onehot: M is formed a group of slabs at a time by one warpgroup. Its
  // thread t owns column n = t % cols of slab t / cols of the group (128 /
  // cols slabs a group) and writes both 4-hour halves of it, each as one
  // 16-byte store: 1 where the hour's bucket is the column, the sell rate
  // in column cols - 1 (rounded to TF32 for the products; 1 and 0 are
  // exact).
  const int wg = tid / 128;
  const int n_wg = blockDim.x / 128;
  const int group = 128 / cols;  // slabs a group
  const int n_groups = (slabs + group - 1) / group;
  const int own_n = tid % 128 % cols;
  const int own_slab = tid % 128 / cols;  // within the group
  const int own_at = slab_at(own_n, 0);
  auto form_group = [&](int c, int j) {
    const int slab = j * group + own_slab;
    if (own_slab >= group || slab >= slabs) return;
    const int h0 = (c % kStages) * chunk + slab * kK;
    float* dst = s_m + (c % kMStages) * m_chunk + slab * cols * kK + own_at;
    float4 v0, v1;  // hours (0, 2, 4, 6) and (1, 3, 5, 7) of the slab
    if (own_n == cols - 1) {
      const float4 x0 = *reinterpret_cast<const float4*>(s_sell + h0);
      const float4 x1 = *reinterpret_cast<const float4*>(s_sell + h0 + 4);
      v0 = make_float4(x0.x, x0.z, x1.x, x1.z);
      v1 = make_float4(x0.y, x0.w, x1.y, x1.w);
      if constexpr (DOT == kDot) {
        v0 = make_float4(tf32_value(v0.x), tf32_value(v0.y), tf32_value(v0.z),
                         tf32_value(v0.w));
        v1 = make_float4(tf32_value(v1.x), tf32_value(v1.y), tf32_value(v1.z),
                         tf32_value(v1.w));
      }
    } else {
      const int4 i0 = *reinterpret_cast<const int4*>(s_bucket + h0);
      const int4 i1 = *reinterpret_cast<const int4*>(s_bucket + h0 + 4);
      v0 = make_float4(i0.x == own_n, i0.z == own_n, i1.x == own_n, i1.z == own_n);
      v1 = make_float4(i0.y == own_n, i0.w == own_n, i1.y == own_n, i1.w == own_n);
    }
    *reinterpret_cast<float4*>(dst) = v0;
    *reinterpret_cast<float4*>(dst + 32) = v1;
  };

  // no initial value: a warpgroup's first products overwrite them
  // (scale-d 0), as a non-wgmma write would serialize the products
  Acc<NT> acc;
  float sum_lo = 0.f, sum_hi = 0.f;  // DOT none: rows g and g + 8

  if constexpr (BUILD == kConst && DOT == kDot) {
    for (int i = tid; i < m_chunk; i += blockDim.x)
      s_m[i] = tf32_value(kConstM);
  }
  // prologue: M of chunk 0 formed (or copied) and the streams of chunks 0
  // and 1 landed; chunk 2's in flight
  if (BUILD == kHbm) stage_m(0);
  stage_streams(0);
  stage_streams(1);
  async_copy::commit();
  stage_streams(2);
  async_copy::commit();
  async_copy::wait<1>();
  __syncthreads();
  if constexpr (BUILD == kOnehot) {
    for (int j = wg; j < n_groups; j += n_wg) form_group(0, j);
  }
  if constexpr (DOT == kDot) fence_async_shared();
  __syncthreads();

  // Chunk c: while its products run, chunk c + 1 of M is formed (group k
  // at k-step k, by warpgroups in turn, so that the others keep issuing
  // products) into the stage that held chunk c - 2, whose products every
  // warpgroup retired at its first wait in chunk c - 1; the streams of
  // chunk c + 3 are copied into the stage of chunk c - 1, and chunk c +
  // 2's have landed when the chunk ends. A warpgroup keeps two k-steps'
  // products in flight, across chunks too: even and odd k-steps of the
  // year form A in registers of their own, so that one k-step's products
  // read their A while the next k-step forms its own.
  uint32_t a_even[4], a_odd[4];
  for (int c = 0; c < n_chunks; ++c) {
    if (BUILD == kHbm) {
      stage_m(c + 1);
      async_copy::commit();
    }
    stage_streams(c + 3);
    async_copy::commit();
    const int b = c % kStages;
    const float* s_l = s_load + b * chunk + 2 * q;
    const float* s_g = s_gen + b * chunk + 2 * q;
    const float* m_c = s_m + (BUILD == kConst ? 0 : (c % kMStages) * m_chunk);
    // slab k starts k x cols x 8 floats on: cols x 2 16-byte units
    const uint64_t desc_c = DOT == kDot ? slab_desc(m_c) : 0;
    const bool form_next = BUILD == kOnehot && c + 1 < n_chunks;
    int form_at = (wg - c % n_wg + n_wg) % n_wg;  // this warpgroup's next group

    auto step = [&](int k, uint32_t(&a)[4]) {
      const float2 l = *reinterpret_cast<const float2*>(s_l + k * kK);
      float2 gv = make_float2(0.f, 0.f);
      if constexpr (NET == kFma) gv = *reinterpret_cast<const float2*>(s_g + k * kK);
      // net at (row g, hour 2q), (g + 8, 2q), (g, 2q + 1), (g + 8, 2q + 1)
      const float n00 = NET == kFma ? fmaf(-s_lo, gv.x, l.x) : l.x;
      const float n10 = NET == kFma ? fmaf(-s_hi, gv.x, l.x) : l.x;
      const float n01 = NET == kFma ? fmaf(-s_lo, gv.y, l.y) : l.y;
      const float n11 = NET == kFma ? fmaf(-s_hi, gv.y, l.y) : l.y;
      if constexpr (DOT == kDot) {
        a[0] = mma_tf32::tf32_relu(n00);
        a[1] = mma_tf32::tf32_relu(n10);
        a[2] = mma_tf32::tf32_relu(n01);
        a[3] = mma_tf32::tf32_relu(n11);
        const uint64_t desc = desc_c + static_cast<uint64_t>(k * cols * 2);
        const int scale_d = (c | k) != 0;
        wgmma_fence();
        acc.each([&](auto& d, auto w, auto c0) {
          // the part's first column: 8-column groups of 256 bytes
          Wgmma<decltype(w)::value>::mma(d, a, desc + decltype(c0)::value * 2,
                                         scale_d);
        });
        wgmma_commit();
      } else {
        // column 0 of M at the thread's hours: k indices q and q + 4
        const float m0 =
            BUILD == kConst ? 2.f * kConstM
                            : m_c[k * cols * kK + q] + m_c[k * cols * kK + 32 + q];
        sum_lo += fmaxf(n00, 0.f) + fmaxf(n01, 0.f) + m0;
        sum_hi += fmaxf(n10, 0.f) + fmaxf(n11, 0.f) + m0;
      }
      if (form_next && k == form_at && k < n_groups) {
        form_group(c + 1, k);
        form_at += n_wg;
      }
      if constexpr (DOT == kDot) wgmma_wait<1>();  // the previous k-step's
    };
    auto run = [&](auto odd) {
      uint32_t(&first)[4] = decltype(odd)::value ? a_odd : a_even;
      uint32_t(&second)[4] = decltype(odd)::value ? a_even : a_odd;
      int k = 0;
      for (; k + 1 < slabs; k += 2) {
        step(k, first);
        step(k + 1, second);
      }
      if (k < slabs) step(k, first);
    };
    if ((c * slabs) % 2 != 0)
      run(std::true_type());
    else
      run(std::false_type());
    // chunk c + 2's streams (and chunk c + 1's M) have landed; chunk c + 3's
    // may be in flight
    async_copy::wait<1>();
    if constexpr (DOT == kDot && BUILD != kConst) fence_async_shared();
    __syncthreads();
  }
  if constexpr (DOT == kDot) wgmma_wait<0>();

  const size_t out0 = static_cast<size_t>(agent) * r;
  if constexpr (DOT == kDot) {
    acc.each([&](auto& d, auto w, auto c0) {
      pin(d);
      constexpr int kW = decltype(w)::value;
      constexpr int kC0 = decltype(c0)::value;
#pragma unroll
      for (int j = 0; j < kW / 8; ++j) {
        const int col = kC0 + 8 * j + 2 * q;  // even; nb is even
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ri = half ? row_hi : row_lo;
          if (ri >= r) continue;
          const float v0 = d[4 * j + 2 * half];
          const float v1 = d[4 * j + 2 * half + 1];
          if (col < nb) {
            *reinterpret_cast<float2*>(out_imp + (out0 + ri) * nb + col) =
                make_float2(v0, v1);
          } else if (col + 1 == cols - 1) {
            out_sell[out0 + ri] = v1;
          }
        }
      }
    });
  } else {
    // the row's sum over its four threads
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, d);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, d);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ri = half ? row_hi : row_lo;
      const float v = half ? sum_hi : sum_lo;
      if (ri >= r) continue;
      for (int col = q; col < nb; col += 4) out_imp[(out0 + ri) * nb + col] = v;
      if (q == 0) out_sell[out0 + ri] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// monthdot
// ---------------------------------------------------------------------------

constexpr int kMdChunk = 584;  // hours a staged chunk (8760 = 15 x 584)
constexpr int kMdMaxWarps = 8;

// Row tiles a warp holds at NT column tiles: 4 at one tile; 2 at two,
// where 4 (row_tiles' choice) spilled 256 bytes at 127 registers.
__host__ __device__ constexpr int md_row_tiles(int nt) { return nt == 1 ? 4 : 2; }

template <int NT>
__global__ void __launch_bounds__(kMdMaxWarps * 32)
    monthdot_kernel(const float* __restrict__ load,
                    const float* __restrict__ gen,
                    const float* __restrict__ sell,
                    const int* __restrict__ bucket,
                    const float* __restrict__ scales,
                    float* __restrict__ out_imp, float* __restrict__ out_sell,
                    int r, int n_periods, int r_blocks, MonthOffsets offs) {
  constexpr int RT = md_row_tiles(NT);
  __shared__ __align__(16) float s_load[2][kMdChunk];
  __shared__ __align__(16) float s_gen[2][kMdChunk];
  __shared__ __align__(16) float s_sell[2][kMdChunk];
  __shared__ __align__(16) int s_bucket[2][kMdChunk];

  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int q = lane % 4;
  const int warps = blockDim.x / 32;
  const int agent = blockIdx.x / r_blocks;
  const int hours = offs.o[kMonths];
  const int nb = kMonths * n_periods;
  // first row of the warp's first tile, and its row tiles that hold rows
  const int row0 =
      ((blockIdx.x % r_blocks) * warps + threadIdx.x / 32) * RT * 16;
  const int rt_live = min(RT, max(0, (r - row0 + 15) / 16));
  // the hour's period, bucket % P, as bucket - P x floor((bucket + 0.5) /
  // P): exact for ids below 2^20
  const float inv_p = 1.f / static_cast<float>(n_periods);

  float s_lo[RT], s_hi[RT];
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int lo = row0 + t * 16 + grp;
    const float* s = scales + static_cast<size_t>(agent) * r;
    s_lo[t] = lo < r ? s[lo] : 0.f;
    s_hi[t] = lo + 8 < r ? s[lo + 8] : 0.f;
  }
  float acc[RT][NT][4];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // a month's bucket columns (2q, 2q + 1 of each tile) to the outputs,
  // then cleared; column P, the sell sum, stays
  auto flush = [&](int m) {
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      const int lo = row0 + t * 16 + grp;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1);
          const int ri = lo + (e >> 1) * 8;
          if (col >= n_periods) continue;
          if (ri < r)
            out_imp[(static_cast<size_t>(agent) * r + ri) * nb + m * n_periods +
                    col] = acc[t][j][e];
          acc[t][j][e] = 0.f;
        }
    }
  };

  const size_t row = static_cast<size_t>(agent) * hours;
  const int n_chunks = (hours + kMdChunk - 1) / kMdChunk;
  auto stage_chunk = [&](int c) {
    const int h0 = c * kMdChunk;
    const int len = min(kMdChunk, hours - h0);
    const int b = c & 1;
    stage_floats(s_load[b], load + row + h0, len);
    stage_floats(s_gen[b], gen + row + h0, len);
    stage_floats(s_sell[b], sell + row + h0, len);
    stage_floats(reinterpret_cast<float*>(s_bucket[b]),
                 reinterpret_cast<const float*>(bucket) + row + h0, len);
  };
  int month = 0;
  int month_end = offs.o[1];  // first hour of the next month
  stage_chunk(0);
  async_copy::commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage_chunk(c + 1);
    async_copy::commit();
    async_copy::wait<1>();  // chunk c has landed; chunk c + 1 is in flight
    __syncthreads();
    const int b = c & 1;
    const int h0 = c * kMdChunk;
    const int len = min(kMdChunk, hours - h0);
    // each hour's bucket id becomes its period, once for all warps
    for (int h = threadIdx.x; h < len; h += blockDim.x) {
      const int id = s_bucket[b][h];
      s_bucket[b][h] = id - n_periods * __float2int_rz((id + 0.5f) * inv_p);
    }
    __syncthreads();
#pragma unroll 2
    for (int k0 = 0; k0 < len; k0 += kK) {
      // months end on k-steps (offsets are multiples of 8)
      while (h0 + k0 == month_end && month < kMonths - 1) {
        flush(month++);
        month_end = offs.o[month + 1];
      }
      // this thread's k indices q and q + 4 are hours h and h + 1
      const int h = k0 + 2 * q;
      const float2 l = *reinterpret_cast<const float2*>(&s_load[b][h]);
      const float2 gv = *reinterpret_cast<const float2*>(&s_gen[b][h]);
      const float2 sv = *reinterpret_cast<const float2*>(&s_sell[b][h]);
      const int2 per = *reinterpret_cast<const int2*>(&s_bucket[b][h]);
      uint32_t a[RT][4];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        a[t][0] = mma_tf32::tf32_relu(fmaf(-s_lo[t], gv.x, l.x));
        a[t][1] = mma_tf32::tf32_relu(fmaf(-s_hi[t], gv.x, l.x));
        a[t][2] = mma_tf32::tf32_relu(fmaf(-s_lo[t], gv.y, l.y));
        a[t][3] = mma_tf32::tf32_relu(fmaf(-s_hi[t], gv.y, l.y));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B element (hour, column col): 1 where the hour's period is col,
        // the sell rate in column P, else 0
        const int col = 8 * j + grp;
        const bool sell_col = col == n_periods;
        const uint32_t b0 = sell_col ? mma_tf32::tf32(sv.x)
                                     : (per.x == col ? mma_tf32::kOne : 0u);
        const uint32_t b1 = sell_col ? mma_tf32::tf32(sv.y)
                                     : (per.y == col ? mma_tf32::kOne : 0u);
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          if (t >= rt_live) break;  // warp-uniform: no rows left
          mma_tf32::mma(acc[t][j], a[t], b0, b1);
        }
      }
    }
    // buffer b is read before chunk c + 2 is staged into it
    __syncthreads();
  }
  while (month < kMonths) flush(month++);

  // column P: thread q = P / 2 of tile P / 8 holds it, element P % 2
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int lo = row0 + t * 16 + grp;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = lo + (e >> 1) * 8;
        if (8 * j + 2 * q + (e & 1) == n_periods && ri < r)
          out_sell[static_cast<size_t>(agent) * r + ri] = acc[t][j][e];
      }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

using VariantFn = void (*)(const float*, const float*, const float*, const int*,
                           const float*, const float*, float*, float*, int, int,
                           int, int, int, int);

template <int BUILD, int NET>
VariantFn pick_width(int nt) {
  switch (nt) {
    case 1: return variant_kernel<BUILD, kDot, NET, 1>;
    case 2: return variant_kernel<BUILD, kDot, NET, 2>;
    case 3: return variant_kernel<BUILD, kDot, NET, 3>;
    case 4: return variant_kernel<BUILD, kDot, NET, 4>;
    case 5: return variant_kernel<BUILD, kDot, NET, 5>;
    case 6: return variant_kernel<BUILD, kDot, NET, 6>;
    case 7: return variant_kernel<BUILD, kDot, NET, 7>;
    default: return variant_kernel<BUILD, kDot, NET, 8>;
  }
}

template <int BUILD>
VariantFn pick_variant(int dot, int net, int nt) {
  if (dot == kDot)
    return net == kFma ? pick_width<BUILD, kFma>(nt) : pick_width<BUILD, kBcast>(nt);
  return net == kFma ? variant_kernel<BUILD, kNoDot, kFma, 0>
                     : variant_kernel<BUILD, kNoDot, kBcast, 0>;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or alignments the kernel does not take
// (the streams and bucket ids 16-byte aligned, as any row of an aligned
// array then is). `offsets` is a host array of 13 hour offsets whose last
// is the hours per agent. Bucket ids must lie in [0, 12 * n_periods).
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
  if (b_pad % kColTile != 0 || b_pad < nb + 1 || b_pad > kMaxCols ||
      h_chunk < kK || h_chunk % kK != 0 || hours <= 0 || hours % h_chunk != 0 ||
      build < kOnehot || build > kHbm || dot < kDot || dot > kNoDot ||
      net < kFma || net > kBcast || (build == kHbm) != (m_hbm != nullptr) ||
      !aligned16(load) || !aligned16(gen) || !aligned16(sell) ||
      !aligned16(bucket))
    return static_cast<int>(cudaErrorInvalidValue);
  // one warpgroup per 64 scales, at most four a block
  const int r_blocks = (r + kMaxWarpgroups * kWgRows - 1) / (kMaxWarpgroups * kWgRows);
  const int wgs = (r + r_blocks * kWgRows - 1) / (r_blocks * kWgRows);
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int m_stages = build == kConst ? (dot == kDot ? 1 : 0) : kMStages;
  const long long smem =
      static_cast<long long>(sizeof(float)) *
      (static_cast<long long>(m_stages) * h_chunk * b_pad + 4LL * kStages * h_chunk);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = b_pad / kColTile;
  const VariantFn fn = build == kOnehot  ? pick_variant<kOnehot>(dot, net, nt)
                       : build == kConst ? pick_variant<kConst>(dot, net, nt)
                                         : pick_variant<kHbm>(dot, net, nt);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<static_cast<unsigned>(total), wgs * 128, static_cast<size_t>(smem),
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
      !lanes::read_offsets(offsets, offsets[kMonths], kK, &offs) ||
      !aligned16(load) || !aligned16(gen) || !aligned16(sell) ||
      !aligned16(bucket))
    return static_cast<int>(cudaErrorInvalidValue);
  // one n8 tile holds columns 0..P for P <= 7, two for P <= 10
  const bool two = n_periods + 1 > 8;
  const int rt = md_row_tiles(two ? 2 : 1);
  const int tiles = (r + 15) / 16;
  int warps = (tiles + rt - 1) / rt;
  if (warps > kMdMaxWarps) warps = kMdMaxWarps;
  const int r_blocks = (r + warps * rt * 16 - 1) / (warps * rt * 16);
  const long long total = static_cast<long long>(n) * r_blocks;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto fn = two ? monthdot_kernel<2> : monthdot_kernel<1>;
  fn<<<static_cast<unsigned>(total), warps * 32, 0,
       static_cast<cudaStream_t>(stream)>>>(load, gen, sell, bucket, scales,
                                            out_imp, out_sell, r, n_periods,
                                            r_blocks, offs);
  return static_cast<int>(cudaGetLastError());
}
