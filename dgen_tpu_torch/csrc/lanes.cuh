// Lane layout and stream element types shared by the bucket-sums kernels.
//
// Every kernel reads [N, lanes] row-major streams whose month m occupies
// lanes [o[m], o[m + 1]): the plain 8760-hour order with the calendar
// month boundaries, or a daylight-compacted layout whose months are
// segments of whole 128-lane blocks (dgen_tpu_torch/ops/layout.py). The
// 13 offsets travel to the kernel by value as a kernel parameter.
//
// The load, gen and sell streams arrive as float32, as bfloat16 (bf16
// profile banks) or, for load and gen, as int8 codes (quantized banks,
// whose per-agent scales the caller folds into the candidate scales).
// Every element is upcast to float when it is read and every sum is
// taken in float; the sums are stored as bfloat16 where the bank
// precision says so (SumsOut, the rule of billkernels.sums_out_dtype)
// and as float everywhere else. with_stream_types names the
// combinations the kernels are instantiated for; the wrappers refuse
// the others before a launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lanes {

constexpr int kMonths = 12;
// Longest month segment: 744 hours in the full-hour layout, 6 x 128
// lanes in a compacted one.
constexpr int kMaxSegLanes = 768;
// Most TOU periods a tariff bank carries (12 x 10 buckets).
constexpr int kMaxPeriods = 10;

struct MonthOffsets {
  int o[kMonths + 1];
};

// Copies the 13 host offsets into `out`; false unless they tile
// [0, lanes) in nondecreasing months of at most kMaxSegLanes lanes, each
// offset a multiple of `quantum` lanes.
inline bool read_offsets(const int* host, int lanes, int quantum,
                         MonthOffsets* out) {
  if (host == nullptr || lanes <= 0 || host[0] != 0 || host[kMonths] != lanes)
    return false;
  for (int m = 0; m <= kMonths; ++m) {
    out->o[m] = host[m];
    if (host[m] % quantum != 0) return false;
    if (m > 0 && (host[m] < host[m - 1] ||
                  host[m] - host[m - 1] > kMaxSegLanes))
      return false;
  }
  return true;
}

inline int max_segment(const MonthOffsets& offs) {
  int longest = 0;
  for (int m = 0; m < kMonths; ++m) {
    const int len = offs.o[m + 1] - offs.o[m];
    if (len > longest) longest = len;
  }
  return longest;
}

// ---------------------------------------------------------------------------
// Stream element types
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Dtype codes of the C launchers' arguments (billkernels._DTYPE_CODES).
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive lanes starting at `p` (aligned to four elements),
// upcast: one 16-, 8- or 4-byte load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  v[0] = static_cast<float>(x.x);
  v[1] = static_cast<float>(x.y);
  v[2] = static_cast<float>(x.z);
  v[3] = static_cast<float>(x.w);
}

// The stored dtype of the sums: bfloat16 when load and gen are bfloat16,
// or when int8 codes ride beside a bfloat16 sell stream; float otherwise.
template <typename TL, typename TG, typename TS>
using SumsOut = typename std::conditional<
    (std::is_same<TL, bf16>::value && std::is_same<TG, bf16>::value) ||
        (std::is_same<TL, int8_t>::value && std::is_same<TS, bf16>::value),
    bf16, float>::type;

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<TL>(), Tag<TG>(), Tag<TS>()) for a (load, gen, sell) dtype
// combination the kernels are instantiated for and returns true; false
// for any other. Import sums take (f32, f32, f32), (bf16, bf16, bf16),
// (i8, i8, f32) and (i8, i8, bf16); signed sums (the battery forward
// run, whose gen is the float32 dispatch output) take (f32, f32, f32),
// (bf16, bf16, bf16), (bf16, f32, bf16) and (f32, f32, bf16).
template <bool SIGNED, typename F>
bool with_stream_types(int dl, int dg, int ds, F&& f) {
  if (dl == kF32 && dg == kF32 && ds == kF32) {
    f(Tag<float>(), Tag<float>(), Tag<float>());
    return true;
  }
  if (dl == kBF16 && dg == kBF16 && ds == kBF16) {
    f(Tag<bf16>(), Tag<bf16>(), Tag<bf16>());
    return true;
  }
  if constexpr (SIGNED) {
    if (dl == kBF16 && dg == kF32 && ds == kBF16) {
      f(Tag<bf16>(), Tag<float>(), Tag<bf16>());
      return true;
    }
    if (dl == kF32 && dg == kF32 && ds == kBF16) {
      f(Tag<float>(), Tag<float>(), Tag<bf16>());
      return true;
    }
  } else {
    if (dl == kI8 && dg == kI8 && ds == kF32) {
      f(Tag<int8_t>(), Tag<int8_t>(), Tag<float>());
      return true;
    }
    if (dl == kI8 && dg == kI8 && ds == kBF16) {
      f(Tag<int8_t>(), Tag<int8_t>(), Tag<bf16>());
      return true;
    }
  }
  return false;
}

inline int dtype_bytes(int code) {
  return code == kF32 ? 4 : code == kBF16 ? 2 : 1;
}

}  // namespace lanes
