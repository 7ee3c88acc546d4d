// Lane layout shared by the bucket-sums kernels.
//
// Every kernel reads [N, lanes] row-major streams whose month m occupies
// lanes [o[m], o[m + 1]): the plain 8760-hour order with the calendar
// month boundaries, or a daylight-compacted layout whose months are
// segments of whole 128-lane blocks (dgen_tpu_torch/ops/layout.py). The
// 13 offsets travel to the kernel by value as a kernel parameter.

#pragma once

#include <cuda_runtime.h>

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

}  // namespace lanes
