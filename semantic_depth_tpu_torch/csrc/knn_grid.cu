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
// Bound on this card: bytes (17 a pixel, read once) on the frame program's
// grids; the time goes to each valid pixel's 105 distances and insertions,
// a dependent chain per thread.
//
// Design: blocks of 32 x 16 pixels, 32 x 8 threads, grid (ceil(W/32),
// ceil(H/16), B), one launch for the batch. Each thread owns two vertically
// adjacent pixels, so one staged candidate row serves both and each read
// feeds two independent chains; the taller block stages a (16+WH-1) x
// (32+WW-1) halo, 2.0 cells a pixel instead of 2.4. A candidate is one
// float4 in shared memory, (x, y, z, w) with w = 0 if it is valid and +inf if
// not (out-of-image cells are invalid): d2 + w replaces the valid flag's
// load and branch. The thread visits the union of its two windows in a
// fixed order, nearest to its two pixels first (fixed at compile time, so
// all lanes read the same offset and every address is an immediate), and
// rejects a d2 >= buf[K-1] with one compare before the insertion: once the
// nearest offsets have filled the buffer, the insertion is rare.
//
// Every value is bit-equal to ops/knn_grid.py::knn_mean_distances_grid_plain:
// distances use __fmul_rn/__fadd_rn/__fsub_rn in its order; the buffer keeps
// the multiset of the K smallest, which does not depend on the visiting
// order; the K roots (__fsqrt_rn) are summed in ascending order and divided
// (__fdiv_rn) by K. Adding w = 0 to a d2 (never -0) changes no bit. With a
// valid point whose coordinates are not all finite (d == 0 back-projects to
// +-inf, camera.py) a d2 may be nan, and then nan + inf is nan where the plain
// version's invalid candidate is +inf; torch.topk orders nan after +inf. A
// block whose halo holds such a point takes the exact path: the valid flag
// as a branch (w != 0), nan never inserted but counted, and a mean of nan
// when fewer than K of the window's WH * WW values are not nan.
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kK = 10;      // the instantiation: k = 10 in a 5 x 21 window
constexpr int kWH = 5, kWW = 21;
constexpr int kPH = kWH / 2, kPW = kWW / 2;
constexpr int kTx = 32;      // pixels across a block
constexpr int kTy = 8;       // thread rows of a block
constexpr int kRows = 2;     // vertically adjacent pixels a thread
constexpr int kBh = kTy * kRows;
constexpr int kSH = kBh + kWH - 1, kSW = kTx + kWW - 1;  // the halo tile

// The union of a thread's kRows windows as (dy, dx) offsets from its first
// pixel, nearest to the pixels' midpoint first (ties by dy, then dx).
struct Order {
  static constexpr int kN = (kWH + kRows - 1) * kWW;
  int dy[kN];
  int dx[kN];
  static constexpr int key(int y, int x) {
    return (2 * y - (kRows - 1)) * (2 * y - (kRows - 1)) + 4 * x * x;
  }
  constexpr Order() : dy(), dx() {
    int n = 0;
    for (int y = -kPH; y <= kPH + kRows - 1; ++y)
      for (int x = -kPW; x <= kPW; ++x, ++n) {
        int j = n;
        while (j > 0 && key(dy[j - 1], dx[j - 1]) > key(y, x)) {
          dy[j] = dy[j - 1];
          dx[j] = dx[j - 1];
          --j;
        }
        dy[j] = y;
        dx[j] = x;
      }
  }
};
constexpr Order kOrder{};
__host__ __device__ constexpr int order_dy(int i) { return kOrder.dy[i]; }
__host__ __device__ constexpr int order_dx(int i) { return kOrder.dx[i]; }

__device__ __forceinline__ void insert(float (&buf)[kK], float cand) {
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const float lo = fminf(buf[j], cand);
    cand = fmaxf(buf[j], cand);
    buf[j] = lo;
  }
}

// one offset of the order for both pixels of the thread
template <bool Exact, int I>
__device__ __forceinline__ void visit(const float4* row0, const float4 (&c)[kRows],
                                      float (&buf)[kRows][kK], int (&n_nan)[kRows]) {
  constexpr int dy = order_dy(I), dx = order_dx(I);
  const float4 s = row0[dy * kSW + dx];
  if (Exact && s.w != 0.f) return;  // an invalid candidate is +inf: never taken
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (dy - r < -kPH || dy - r > kPH) continue;  // compile-time
    const float ex = __fsub_rn(c[r].x, s.x);
    const float ey = __fsub_rn(c[r].y, s.y);
    const float ez = __fsub_rn(c[r].z, s.z);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
    if (Exact)
      n_nan[r] += isnan(d2) ? 1 : 0;  // nan fails the compare below
    else
      d2 = __fadd_rn(d2, s.w);
    if (d2 < buf[r][kK - 1]) insert(buf[r], d2);
  }
}

template <bool Exact, int... I>
__device__ __forceinline__ void scan(std::integer_sequence<int, I...>, const float4* row0,
                                     const float4 (&c)[kRows], float (&buf)[kRows][kK],
                                     int (&n_nan)[kRows]) {
  (visit<Exact, I>(row0, c, buf, n_nan), ...);
}

__global__ void __launch_bounds__(kTx * kTy) knn_grid_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ valid,
    float* __restrict__ out, int H, int W) {
  __shared__ float4 tile[kSH][kSW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kBh;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* p = pts + b * plane * 3;
  const uint8_t* v = valid + b * plane;

  int bad = 0;  // a valid point with a coordinate that is not finite
  for (int i = threadIdx.y * kTx + threadIdx.x; i < kSH * kSW; i += kTx * kTy) {
    const int r = i / kSW, c = i % kSW;
    const int gy = y0 + r - kPH, gx = x0 + c - kPW;
    float4 s = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t g = static_cast<size_t>(gy) * W + gx;
      if (v[g]) {
        s = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], 0.f);
        bad |= !(isfinite(s.x) && isfinite(s.y) && isfinite(s.z));
      }
    }
    tile[r][c] = s;
  }
  const bool exact = __syncthreads_or(bad);

  const int gx = x0 + threadIdx.x, gy0 = y0 + threadIdx.y * kRows;
  const int cr = threadIdx.y * kRows + kPH, cc = threadIdx.x + kPW;
  float4 c[kRows];
  float buf[kRows][kK];
  int n_nan[kRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = tile[cr + r][cc];
    const bool mine = gx < W && gy0 + r < H && c[r].w == 0.f;
    any |= mine;
#pragma unroll
    for (int j = 0; j < kK; ++j) buf[r][j] = CUDART_INF_F;
    if (!mine) buf[r][kK - 1] = -CUDART_INF_F;  // never inserts
    n_nan[r] = 0;
  }
  if (any) {
    constexpr auto order = std::make_integer_sequence<int, Order::kN>{};
    const float4* row0 = &tile[cr][cc];
    if (exact)
      scan<true>(order, row0, c, buf, n_nan);
    else
      scan<false>(order, row0, c, buf, n_nan);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (gx >= W || gy0 + r >= H) continue;
    float result = CUDART_INF_F;
    if (c[r].w == 0.f) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kK; ++j) acc = __fadd_rn(acc, __fsqrt_rn(buf[r][j]));
      // torch.topk puts nan after +inf: fewer than kK values that are not nan
      result = n_nan[r] > kWH * kWW - kK ? CUDART_NAN_F
                                         : __fdiv_rn(acc, static_cast<float>(kK));
    }
    out[b * plane + static_cast<size_t>(gy0 + r) * W + gx] = result;
  }
}

}  // namespace

extern "C" int sd_knn_grid(const void* pts, const void* valid, void* out, int B, int H, int W,
                           int k, int wh, int ww, void* stream) {
  if (k != kK || wh != kWH || ww != kWW) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kBh - 1) / kBh, B);
  knn_grid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
