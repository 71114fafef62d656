// A thread's k smallest values for k > 32, for the kernels whose k does not
// fit in registers (the general K1 kernel, csrc/knn_grid.cu; K4's large-k
// near walk, csrc/exact_knn.cu).
//
// The 32 smallest stay sorted in registers (reg), as the k <= 32 kernels
// keep theirs; the m = k - 32 next live unsorted in a strided buffer in
// shared (or global) memory, entry t at p[t * stride], with their largest
// (thr, at slot `at`) in registers. A value below thr enters the registers'
// min/max network, and what leaves the network (the largest of reg and the
// value, +inf while reg is not full) takes the buffer's next free slot or
// the slot of its largest, whose successor a rescan of the m entries finds.
// Every lane runs the same instructions whatever its values (the network,
// one store, the rescan): no lane's sort or shift holds its warp. Every
// buffer value is at least every register value, so reg then the sorted
// buffer are the k smallest in ascending order; values below +inf only
// (the caller's d2 < thr drops nan and +inf). The kernels interleave their
// lanes' buffers so that a warp's accesses to the same t fall in 32 banks.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace sd_kselect {

constexpr int kReg = 32;  // the values kept in registers

// v into the sorted reg; returns the largest of reg and v, which leaves
__device__ __forceinline__ float push(float (&reg)[kReg], float v) {
#pragma unroll
  for (int j = 0; j < kReg; ++j) {
    const float lo = fminf(reg[j], v);
    v = fmaxf(reg[j], v);
    reg[j] = lo;
  }
  return v;
}

// the largest of p[0 .. m) and its slot
__device__ __forceinline__ void rescan(const float* p, int stride, int m, float& thr, int& at) {
  float mx = p[0];
  int ai = 0;
#pragma unroll 4
  for (int t = 1; t < m; ++t) {
    const float x = p[t * stride];
    if (x > mx) {
      mx = x;
      ai = t;
    }
  }
  thr = mx;
  at = ai;
}

// offer v < thr: n counts the buffer's values (the registers fill first),
// thr is +inf until the buffer holds m
__device__ __forceinline__ void add(float (&reg)[kReg], float* p, int stride, int m, int& n,
                                    float& thr, int& at, float v) {
  const float up = push(reg, v);
  if (!(up < CUDART_INF_F)) return;  // reg was not full
  const int slot = n < m ? n++ : at;
  p[slot * stride] = up;
  if (n == m) rescan(p, stride, m, thr, at);
}

// after the last offer: the buffer's n values ascending (insertion sort)
__device__ __forceinline__ void sort(float* p, int stride, int n) {
  for (int i = 1; i < n; ++i) {
    const float v = p[i * stride];
    int j = i;
    float prev;
    while (j > 0 && (prev = p[(j - 1) * stride]) > v) {
      p[j * stride] = prev;
      --j;
    }
    p[j * stride] = v;
  }
}

}  // namespace sd_kselect
