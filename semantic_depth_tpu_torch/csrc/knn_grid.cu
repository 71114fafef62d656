// Windowed k-nearest-neighbour mean distance on an image grid.
//
// Replaces semantic_depth_tpu/ops/pallas_knn.py:_knn_tile_body (in
// _knn_kernel, _knn_kernel_hbm and _knn_kernel_hbm_batched), called by
// knn_mean_distances_grid_pallas(_batched).
//
// For each valid pixel of a (B, H, W) back-projected grid: the mean
// Euclidean distance to its K nearest valid points inside a (WH, WW) image
// window, the pixel itself included at 0. +inf for an invalid pixel, and
// for a window with fewer than K valid candidates.
//
// Design: one thread per output pixel, blocks of 32x8 pixels, grid
// (ceil(W/32), ceil(H/8), B), so one launch covers the batch. The block
// stages its x, y, z and valid halo tile, (8+WH-1) x (32+WW-1) (about 10 KB
// for the 5x21 window), in shared memory; out-of-image candidates are
// invalid. The K smallest squared distances stay sorted in registers; each
// candidate bubble-inserts by K compare-exchanges, unrolled because K and
// the window are template parameters. The K square roots are summed in
// ascending order and divided by K, as the TPU kernel and the plain version
// do. Squared distances use __fmul_rn/__fadd_rn (no FMA contraction), so
// they round as the plain version's separate tensor ops do.
//
// Bound on this card: operations. Each pixel reads 17 bytes and does ~105
// candidates x (8 flops + 20 min/max), so the float32 pipes, not memory,
// set the floor; the shared tile makes every candidate read an on-chip load
// with neighbouring threads on neighbouring words.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;

template <int K, int WH, int WW>
__global__ void __launch_bounds__(kTx * kTy) knn_grid_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ valid,
    float* __restrict__ out, int H, int W) {
  constexpr int PH = WH / 2, PW = WW / 2;
  constexpr int SH = kTy + WH - 1, SW = kTx + WW - 1;
  __shared__ float sx[SH][SW];
  __shared__ float sy[SH][SW];
  __shared__ float sz[SH][SW];
  __shared__ uint8_t sv[SH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* p = pts + b * plane * 3;
  const uint8_t* v = valid + b * plane;

  for (int i = threadIdx.y * kTx + threadIdx.x; i < SH * SW; i += kTx * kTy) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 + r - PH, gx = x0 + c - PW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t g = inside ? static_cast<size_t>(gy) * W + gx : 0;
    const uint8_t ok = inside ? v[g] : 0;
    sv[r][c] = ok;
    sx[r][c] = ok ? p[3 * g + 0] : 0.f;
    sy[r][c] = ok ? p[3 * g + 1] : 0.f;
    sz[r][c] = ok ? p[3 * g + 2] : 0.f;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const int cr = threadIdx.y + PH, cc = threadIdx.x + PW;
  float result = INFINITY;
  if (sv[cr][cc]) {
    const float cx = sx[cr][cc], cy = sy[cr][cc], cz = sz[cr][cc];
    float buf[K];
#pragma unroll
    for (int j = 0; j < K; ++j) buf[j] = INFINITY;
    for (int dy = 0; dy < WH; ++dy) {
      const int r = threadIdx.y + dy;
#pragma unroll
      for (int dx = 0; dx < WW; ++dx) {
        const int c = threadIdx.x + dx;
        // an invalid candidate is +inf, whose insertion changes nothing
        if (!sv[r][c]) continue;
        const float ex = __fsub_rn(cx, sx[r][c]);
        const float ey = __fsub_rn(cy, sy[r][c]);
        const float ez = __fsub_rn(cz, sz[r][c]);
        float cand = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float lo = fminf(buf[j], cand);
          cand = fmaxf(buf[j], cand);
          buf[j] = lo;
        }
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = __fadd_rn(acc, __fsqrt_rn(buf[j]));
    result = __fdiv_rn(acc, static_cast<float>(K));
  }
  out[b * plane + static_cast<size_t>(gy) * W + gx] = result;
}

}  // namespace

extern "C" int sd_knn_grid(const void* pts, const void* valid, void* out, int B, int H, int W,
                           int k, int wh, int ww, void* stream) {
  if (k != 10 || wh != 5 || ww != 21) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, B);
  knn_grid_kernel<10, 5, 21><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
