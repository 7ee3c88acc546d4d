// The months of a lane layout cut into chunks for a staging pipeline,
// shared by the micro-benchmark's grouped month-mask kernel
// (microbench_mask.cu) and rank-1-net mask-product kernel
// (microbench_mnet.cu).
//
// A kernel walks the year month by month and each month chunk by chunk;
// its staging runs ahead of the walk over the same sequence of chunks
// (month 0's first, ..., month 11's last), so that a chunk lands while an
// earlier one is walked. A chunk holds at most CHUNK lanes and never
// crosses a month's end; an empty month has no chunk.

#pragma once

#include "lanes.cuh"

namespace month_chunks {

template <int CHUNK>
struct Cursor {
  int month = 0;  // the chunk's month; kMonths once the year is done
  int start = 0;  // its first lane, counted from the month's first

  __device__ explicit Cursor(const lanes::MonthOffsets& offs) { skip_empty(offs); }

  __device__ bool done() const { return month >= lanes::kMonths; }
  // first lane of the chunk in the layout
  __device__ int lane0(const lanes::MonthOffsets& offs) const {
    return offs.o[month] + start;
  }
  __device__ int len(const lanes::MonthOffsets& offs) const {
    const int rest = offs.o[month + 1] - offs.o[month] - start;
    return rest < CHUNK ? rest : CHUNK;
  }
  __device__ void next(const lanes::MonthOffsets& offs) {
    start += CHUNK;
    if (start >= offs.o[month + 1] - offs.o[month]) {
      ++month;
      start = 0;
      skip_empty(offs);
    }
  }

 private:
  __device__ void skip_empty(const lanes::MonthOffsets& offs) {
    while (month < lanes::kMonths && offs.o[month + 1] == offs.o[month]) ++month;
  }
};

}  // namespace month_chunks
