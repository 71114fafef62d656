// Exact k-nearest-neighbour mean distance over a masked point cloud.
//
// Replaces semantic_depth_tpu/ops/pallas_exact_knn.py:_exact_knn_kernel,
// called by knn_mean_distances_exact_pallas.
//
// For each valid row q of frame b of a (B, C, 3) cloud: the mean Euclidean
// distance to its min(K, n) nearest valid points of the same frame, q itself
// included at distance 0 and coincident points counted once each; +inf on
// an invalid row. d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32, the Gram
// identity the TPU kernel evaluates on its matrix unit.
//
// Design: grid (ceil(C/128), B), one thread per query, so one launch covers
// the frame batch. Candidate tiles of 512 go through shared memory as one
// float4 each (x, y, z, |c|^2); an invalid or out-of-range candidate is
// staged as (0, 0, 0, +inf), so its d2 is +inf or nan and is never taken.
// Every thread of a warp reads the same candidate word (a broadcast). The K
// smallest squared distances stay sorted in registers: a candidate with
// d2 >= buf[K-1] (or nan) is rejected by one compare, anything else
// bubble-inserts by K unrolled compare-exchanges. That keeps exactly the
// multiset of the K smallest, duplicates included, as the TPU kernel's
// one-at-a-time tie masking does. The finite entries' square roots are
// summed in ascending order and divided by their count (at least 1).
//
// Products and sums use __fmul_rn/__fadd_rn/__fsub_rn in the plain version's
// order (the order csrc/radius.cu uses), so no FMA contraction changes a
// rounding, and __fsqrt_rn/__fdiv_rn round as IEEE: the result is bit-equal
// to the plain version's.
//
// Skips: a block whose 128 queries are all invalid writes +inf and leaves;
// a candidate tile with no valid row is not scanned. Compacted clouds keep
// their valid rows in front, so the work follows the valid count n (n^2
// pairs per frame), not the capacity.
//
// Bound on this card: operations. About 10 float32 operations per pair
// against 17 bytes per point; the shared tile turns every candidate read
// into one on-chip broadcast load, and the early reject keeps the K-deep
// insertion off the common path once the buffer holds near neighbours.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;  // threads per block, one query each
constexpr int kTile = 512;     // candidates per shared-memory tile

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <int K>
__global__ void __launch_bounds__(kQueries) exact_knn_kernel(
    const float* __restrict__ xyz_all, const uint8_t* __restrict__ valid_all,
    float* __restrict__ out_all, int C) {
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const size_t frame = static_cast<size_t>(b) * C;
  const float* xyz = xyz_all + frame * 3;
  const uint8_t* valid = valid_all + frame;
  float* out = out_all + frame;

  const int qi = blockIdx.x * kQueries + threadIdx.x;
  const bool active = qi < C && valid[qi] != 0;
  if (!__syncthreads_or(active)) {  // same answer for the whole block
    if (qi < C) out[qi] = INFINITY;
    return;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = xyz[3 * static_cast<size_t>(qi) + 0];
    qy = xyz[3 * static_cast<size_t>(qi) + 1];
    qz = xyz[3 * static_cast<size_t>(qi) + 2];
  }
  const float sqq = sq3(qx, qy, qz);

  float buf[K];
#pragma unroll
  for (int j = 0; j < K; ++j) buf[j] = INFINITY;

  for (int t0 = 0; t0 < C; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    int any = 0;
    for (int i = threadIdx.x; i < kTile; i += kQueries) {
      const int ci = t0 + i;
      float4 c = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (ci < C && valid[ci] != 0) {
        c.x = xyz[3 * static_cast<size_t>(ci) + 0];
        c.y = xyz[3 * static_cast<size_t>(ci) + 1];
        c.z = xyz[3 * static_cast<size_t>(ci) + 2];
        c.w = sq3(c.x, c.y, c.z);
        any = 1;
      }
      tile[i] = c;
    }
    if (!__syncthreads_or(any) || !active) continue;  // the first is block-uniform
    const int n = min(kTile, C - t0);
    for (int t = 0; t < n; ++t) {
      const float4 c = tile[t];
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)), __fmul_rn(qz, c.z));
      float d2 = __fsub_rn(__fadd_rn(sqq, c.w), __fmul_rn(2.f, cross));
      d2 = d2 < 0.f ? 0.f : d2;  // nan stays nan, like torch.clamp_min
      if (!(d2 < buf[K - 1])) continue;  // +inf and nan are never taken
      float cand = d2;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float lo = fminf(buf[j], cand);
        cand = fmaxf(buf[j], cand);
        buf[j] = lo;
      }
    }
  }

  if (qi >= C) return;
  float result = INFINITY;
  if (active) {
    float acc = 0.f, cnt = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (buf[j] < INFINITY) {  // ascending: the finite min(K, n) lead
        acc = __fadd_rn(acc, __fsqrt_rn(buf[j]));
        cnt += 1.f;
      }
    }
    result = __fdiv_rn(acc, fmaxf(cnt, 1.f));
  }
  out[qi] = result;
}

template <int K>
void launch(const void* xyz, const void* valid, void* out, int B, int C, cudaStream_t stream) {
  const dim3 grid((C + kQueries - 1) / kQueries, B);
  exact_knn_kernel<K><<<grid, kQueries, 0, stream>>>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), C);
}

}  // namespace

// k in [1, 32]: the register buffer's depth is a template parameter.
extern "C" int sd_exact_knn(const void* xyz, const void* valid, void* out, int B, int C, int k,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define SD_CASE(K) \
  case K:          \
    launch<K>(xyz, valid, out, B, C, s); \
    break;
    SD_CASE(1) SD_CASE(2) SD_CASE(3) SD_CASE(4) SD_CASE(5) SD_CASE(6) SD_CASE(7) SD_CASE(8)
    SD_CASE(9) SD_CASE(10) SD_CASE(11) SD_CASE(12) SD_CASE(13) SD_CASE(14) SD_CASE(15)
    SD_CASE(16) SD_CASE(17) SD_CASE(18) SD_CASE(19) SD_CASE(20) SD_CASE(21) SD_CASE(22)
    SD_CASE(23) SD_CASE(24) SD_CASE(25) SD_CASE(26) SD_CASE(27) SD_CASE(28) SD_CASE(29)
    SD_CASE(30) SD_CASE(31) SD_CASE(32)
#undef SD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
