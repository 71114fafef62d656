// Weighted radius neighbour counts over a compacted cloud.
//
// Replaces semantic_depth_tpu/ops/pallas_exact_knn.py:_radius_kernel, called
// by radius_counts_pallas (the wrapper's preparation, :162-202, included).
//
// For each valid query q of frame b: sum of w[c] over the valid candidates c
// of the same frame with d2 < r2 (strict), d2 = max(|q|^2 + |c|^2 - 2 q.c, 0)
// in float32; 0 on invalid rows.
//
// Bound on this card: operations, about 10 float32 operations a (valid
// query, valid candidate) pair within the widened radius in z, against 20
// bytes a point read once and 4 written.
//
// Design: two launches and nothing else on the torch side.
// 1. radius_prep_kernel, one block a frame: the largest |p|^2 over valid
//    rows, then each 32-candidate subtile's valid-z range widened by
//    sqrt(r^2 + 4e-6 max|p|^2), the radius plus the Gram identity's float32
//    error bound, so a skipped subtile provably holds no neighbour (lows,
//    then highs; an empty subtile gets (+inf, -inf) and is never scanned).
//    nan coordinates are left out of the ranges: a nan pair never counts.
//    It also zeroes the frame's tickets (below).
// 2. radius_kernel, grid (C / (128 kQ), B, S), 4 warps, each thread kQ = 2
//    consecutive queries, S = min(16, C / 128) splits (of 1, 2 and 4 queries
//    a thread and 1 to 32 splits, the fastest on the frame program's clouds:
//    PERF.md). It reads xyz, valid and the weights itself. A block with no
//    valid query writes zeros (split 0) and leaves, so the half of the
//    blocks past a compacted cloud's valid rows does no work. Split s of S
//    takes the candidate tiles j with j % S == s, which spreads the far
//    field's long scans over S blocks. Each warp takes the z-range of its
//    valid queries only and marks, 32 candidate tiles at a time, which
//    subtiles it may reach; a 128-candidate tile is staged in shared memory
//    (x, y, z, |c|^2 as one float4, zeros and weight 0 where invalid) only
//    if one warp needs one of its subtiles, and each warp scans only the
//    subtiles it marked: a warp-uniform branch. Each candidate read from
//    shared memory feeds both of a thread's queries. skip = 0 marks every
//    subtile (validation).
//    Each split writes its sums to its own slice of a scratch buffer and
//    takes a ticket; the split that takes the last ticket of its query
//    block adds the S slices in the order 0..S-1. So the sums do not depend
//    on which split ends first, whatever the weights (the frame program's
//    density weights divide by the pixel scale, which is not dyadic at
//    every input size).
// Products and sums use __fmul_rn/__fadd_rn/__fsub_rn in the plain
// version's order, so no FMA contraction changes a rounding, and the count
// of every pair is the plain version's. Where the weighted sums are exact
// in float32 (integer or dyadic weights, as on the frame program's clouds
// at 256x512) the counts are bit-equal to the plain version's; otherwise
// they differ from its blockwise sums only in rounding, the same on every
// run.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSub = 32;    // candidates per subtile (one z-range)
constexpr int kTile = 128;  // candidates per staged tile: 4 subtiles
constexpr int kSubs = kTile / kSub;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 2;  // consecutive queries of a thread
constexpr int kBlockQueries = kThreads * kQ;
constexpr int kMaxSplits = 16;
constexpr int kPrepThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kPrepThreads) radius_prep_kernel(
    const float* __restrict__ xyz_all, const uint8_t* __restrict__ valid_all,
    float* __restrict__ bz_all, int* __restrict__ tickets_all, int C, float r2) {
  __shared__ float red[kPrepThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t frame = static_cast<size_t>(blockIdx.x) * C;
  const float* p = xyz_all + frame * 3;
  const uint8_t* v = valid_all + frame;
  const int n_sub = C / kSub;
  float* lo = bz_all + static_cast<size_t>(blockIdx.x) * 2 * n_sub;
  float* hi = lo + n_sub;
  const int n_blocks = (C + kBlockQueries - 1) / kBlockQueries;
  for (int i = threadIdx.x; i < n_blocks; i += kPrepThreads) tickets_all[blockIdx.x * n_blocks + i] = 0;

  float m = 0.f;  // fmaxf leaves a nan |p|^2 out
#pragma unroll 8
  for (int i = threadIdx.x; i < C; i += kPrepThreads) {
    const float s = sq3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
    m = v[i] ? fmaxf(m, s) : m;
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kPrepThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float zthr = __fsqrt_rn(__fadd_rn(r2, __fmul_rn(4e-6f, m)));

#pragma unroll 4
  for (int t = warp; t < n_sub; t += kPrepThreads / 32) {
    const int i = t * kSub + lane;
    const float z = p[3 * i + 2];
    const bool ok = v[i] && !isnan(z);
    float zmin = ok ? z : CUDART_INF_F, zmax = ok ? z : -CUDART_INF_F;
    for (int o = 16; o > 0; o >>= 1) {
      zmin = fminf(zmin, __shfl_xor_sync(kFull, zmin, o));
      zmax = fmaxf(zmax, __shfl_xor_sync(kFull, zmax, o));
    }
    if (lane == 0) {
      lo[t] = __fsub_rn(zmin, zthr);
      hi[t] = __fadd_rn(zmax, zthr);
    }
  }
}

// grid (ceil(C / (128 kQ)), B, splits): split s scans the tiles j with
// j % splits == s. partial_all: (splits, B, C) sums of each split.
__global__ void __launch_bounds__(kThreads) radius_kernel(
    const float* __restrict__ xyz_all, const uint8_t* __restrict__ valid_all,
    const float* __restrict__ w_all, const float* __restrict__ bz_all,
    float* __restrict__ partial_all, int* __restrict__ tickets_all, float* __restrict__ out_all,
    int C, float r2, int skip) {
  __shared__ float4 cand[kTile];  // x, y, z, |c|^2
  __shared__ float cw[kTile];
  __shared__ uint8_t need[kWarps][32];  // per warp, per tile of the chunk: subtile bits
  __shared__ bool last;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t frame = static_cast<size_t>(blockIdx.y) * C;
  const float* p = xyz_all + frame * 3;
  const uint8_t* v = valid_all + frame;
  const float* w = w_all + frame;
  float* out = out_all + frame;
  const int n_tiles = C / kTile, n_sub = C / kSub;
  const float* bz_lo = bz_all + static_cast<size_t>(blockIdx.y) * 2 * n_sub;
  const float* bz_hi = bz_lo + n_sub;
  const int split = blockIdx.z, splits = gridDim.z;
  const int my_tiles = (n_tiles - split + splits - 1) / splits;

  const int q0 = blockIdx.x * kBlockQueries + threadIdx.x * kQ;
  float qx[kQ], qy[kQ], qz[kQ], sqq[kQ], acc[kQ];
  bool qv[kQ];
  bool any = false;
  float zmin = CUDART_INF_F, zmax = -CUDART_INF_F;  // over valid queries; fminf leaves a nan out
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + q;
    qv[q] = i < C && v[i];
    qx[q] = qv[q] ? p[3 * i] : 0.f;
    qy[q] = qv[q] ? p[3 * i + 1] : 0.f;
    qz[q] = qv[q] ? p[3 * i + 2] : 0.f;
    sqq[q] = sq3(qx[q], qy[q], qz[q]);
    acc[q] = 0.f;
    if (qv[q]) {
      any = true;
      zmin = fminf(zmin, qz[q]);
      zmax = fmaxf(zmax, qz[q]);
    }
  }
  if (!__syncthreads_or(any)) {  // no valid query in the block: its rows count 0
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (split == 0 && q0 + q < C) out[q0 + q] = 0.f;
    return;
  }
  for (int o = 16; o > 0; o >>= 1) {
    zmin = fminf(zmin, __shfl_xor_sync(kFull, zmin, o));
    zmax = fmaxf(zmax, __shfl_xor_sync(kFull, zmax, o));
  }

  for (int c0 = 0; c0 < my_tiles; c0 += 32) {
    // lane l marks the subtiles of this split's tile c0 + l that its warp may reach
    const int j = split + splits * (c0 + lane);
    uint32_t bits = 0;
    if (c0 + lane < my_tiles) {
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        const int t = j * kSubs + s;
        if (!skip || (bz_lo[t] <= zmax && bz_hi[t] >= zmin)) bits |= 1u << s;
      }
    }
    need[warp][lane] = static_cast<uint8_t>(bits);
    __syncthreads();
    const int cn = min(32, my_tiles - c0);
    for (int cc = 0; cc < cn; ++cc) {
      uint32_t block_bits = 0;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) block_bits |= need[u][cc];
      if (!block_bits) continue;  // the same in every thread
      const int ci = (split + splits * (c0 + cc)) * kTile + threadIdx.x;
      const bool ok = v[ci];
      const float x = ok ? p[3 * ci] : 0.f, y = ok ? p[3 * ci + 1] : 0.f,
                  z = ok ? p[3 * ci + 2] : 0.f;
      cand[threadIdx.x] = make_float4(x, y, z, sq3(x, y, z));
      cw[threadIdx.x] = ok ? w[ci] : 0.f;
      __syncthreads();
      const uint32_t mine = need[warp][cc];
#pragma unroll
      for (int s = 0; s < kSubs; ++s) {
        if (!((mine >> s) & 1u)) continue;  // warp-uniform
#pragma unroll 8
        for (int t = s * kSub; t < (s + 1) * kSub; ++t) {
          const float4 c = cand[t];
          const float wt = cw[t];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx[q], c.x), __fmul_rn(qy[q], c.y)),
                                          __fmul_rn(qz[q], c.z));
            float d2 = __fsub_rn(__fadd_rn(sqq[q], c.w), __fmul_rn(2.f, cross));
            d2 = d2 < 0.f ? 0.f : d2;  // nan stays nan, like torch.clamp_min
            if (d2 < r2) acc[q] = __fadd_rn(acc[q], wt);
          }
        }
      }
      __syncthreads();  // the tile is consumed
    }
    __syncthreads();  // need[] is rewritten by the next chunk
  }
  const size_t frames = gridDim.y;
  float* part = partial_all + (split * frames + blockIdx.y) * C;
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (q0 + q < C) part[q0 + q] = acc[q];
  __threadfence();  // this split's sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets_all + blockIdx.y * gridDim.x + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last split of the query block adds every split's sums in split order
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = q0 + q;
    if (i >= C) continue;
    float sum = 0.f;
    for (int t = 0; t < splits; ++t)
      sum = __fadd_rn(sum, __ldcg(partial_all + (t * frames + blockIdx.y) * C + i));
    out[i] = qv[q] ? sum : 0.f;
  }
}

}  // namespace

// scratch: float32 words, laid out as the subtile ranges (B, 2, C/32), the
// splits' sums (S, B, C) and the tickets (B, ceil(C/256)) as int32, S =
// min(16, C/128); skip = 0 scans every subtile.
extern "C" int sd_radius_counts(const void* xyz, const void* valid, const void* weights,
                                void* scratch, void* out, int B, int C, float r2, int skip,
                                void* stream) {
  if (C % kTile != 0 || C < kTile || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = C / kTile < kMaxSplits ? C / kTile : kMaxSplits;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const float*>(xyz);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto w = static_cast<const float*>(weights);
  const auto bz = static_cast<float*>(scratch);
  float* partial = bz + static_cast<size_t>(B) * 2 * (C / kSub);
  int* tickets = reinterpret_cast<int*>(partial + static_cast<size_t>(splits) * B * C);
  radius_prep_kernel<<<B, kPrepThreads, 0, s>>>(p, v, bz, tickets, C, r2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kBlockQueries - 1) / kBlockQueries, B, splits);
  radius_kernel<<<grid, kThreads, 0, s>>>(p, v, w, bz, partial, tickets, static_cast<float*>(out),
                                          C, r2, skip);
  return static_cast<int>(cudaGetLastError());
}
