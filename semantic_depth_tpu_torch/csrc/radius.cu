// Weighted radius neighbour counts over a compacted cloud.
//
// Replaces semantic_depth_tpu/ops/pallas_exact_knn.py:_radius_kernel, called
// by radius_counts_pallas.
//
// For each query q of frame b: sum of w[c] over candidates c of the same
// frame with d2 < r2 (strict), d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32.
// The wrapper (ops/radius.py) prepares the inputs exactly as the TPU
// wrapper does: invalid candidates are zeroed with weight 0, invalid query
// rows hold the frame's first valid point, and each candidate tile's valid-z
// range comes pre-widened by the radius plus the Gram identity's float32
// error bound (bz: lows then highs). A tile whose range misses the block's
// query z-range provably holds no neighbour and is skipped.
//
// Design: grid (C/128, B), one thread per query. Candidate tiles of 128
// x, y, z, w (and |c|^2, computed at staging) go through shared memory; every
// thread reads the same candidate word (a broadcast). Products and sums use
// __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order, so no FMA
// contraction changes a rounding: counts are bit-equal to the plain
// version's. The weights are integers or dyadic fractions, so the float32
// sums do not depend on their order.
//
// Bound on this card: operations (about 10 float32 operations per pair,
// against 32 bytes per point); the z-range skip is what removes most of the
// pairs on a road cloud, whose compacted rows keep image order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // queries per block == candidates per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kTile) radius_kernel(
    const float* __restrict__ q_all, const float* __restrict__ c_all,
    const float* __restrict__ w_all, const float* __restrict__ bz_all,
    float* __restrict__ out_all, int C, float r2) {
  __shared__ float cx[kTile], cy[kTile], cz[kTile], cw[kTile], csq[kTile];
  __shared__ float wmin[kTile / 32], wmax[kTile / 32];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * kTile + threadIdx.x;
  const size_t frame = static_cast<size_t>(b) * C;
  const float* q = q_all + frame * 3;
  const float* c = c_all + frame * 3;
  const float* w = w_all + frame;
  const int n_tiles = C / kTile;
  const float* bz_lo = bz_all + static_cast<size_t>(b) * 2 * n_tiles;
  const float* bz_hi = bz_lo + n_tiles;

  const float qx = q[3 * qi + 0], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float sqq = sq3(qx, qy, qz);

  // the block's query z-range
  float zmin = qz, zmax = qz;
  for (int o = 16; o > 0; o >>= 1) {
    zmin = fminf(zmin, __shfl_xor_sync(kFull, zmin, o));
    zmax = fmaxf(zmax, __shfl_xor_sync(kFull, zmax, o));
  }
  if ((threadIdx.x & 31) == 0) {
    wmin[threadIdx.x >> 5] = zmin;
    wmax[threadIdx.x >> 5] = zmax;
  }
  __syncthreads();
  zmin = wmin[0];
  zmax = wmax[0];
#pragma unroll
  for (int i = 1; i < kTile / 32; ++i) {
    zmin = fminf(zmin, wmin[i]);
    zmax = fmaxf(zmax, wmax[i]);
  }

  float acc = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    if (!(bz_lo[j] <= zmax && bz_hi[j] >= zmin)) continue;  // same for the whole block
    __syncthreads();  // the previous tile is consumed
    const int ci = j * kTile + threadIdx.x;
    const float x = c[3 * ci + 0], y = c[3 * ci + 1], z = c[3 * ci + 2];
    cx[threadIdx.x] = x;
    cy[threadIdx.x] = y;
    cz[threadIdx.x] = z;
    cw[threadIdx.x] = w[ci];
    csq[threadIdx.x] = sq3(x, y, z);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, cx[t]), __fmul_rn(qy, cy[t])), __fmul_rn(qz, cz[t]));
      float d2 = __fsub_rn(__fadd_rn(sqq, csq[t]), __fmul_rn(2.f, cross));
      d2 = d2 < 0.f ? 0.f : d2;  // nan stays nan, like torch.clamp_min
      if (d2 < r2) acc = __fadd_rn(acc, cw[t]);
    }
  }
  out_all[frame + qi] = acc;
}

}  // namespace

extern "C" int sd_radius_counts(const void* queries, const void* cands, const void* weights,
                                const void* bz, void* out, int B, int C, float r2,
                                void* stream) {
  if (C % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(C / kTile, B);
  radius_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cands),
      static_cast<const float*>(weights), static_cast<const float*>(bz),
      static_cast<float*>(out), C, r2);
  return static_cast<int>(cudaGetLastError());
}
