// Exact k-nearest-neighbour mean distance over a masked point cloud.
//
// Replaces semantic_depth_tpu/ops/pallas_exact_knn.py:_exact_knn_kernel,
// called by knn_mean_distances_exact_pallas.
//
// For each valid row q of frame b of a (B, C, 3) cloud: the mean Euclidean
// distance to its min(K, n) nearest valid points of the same frame, q itself
// included at distance 0 and coincident points counted once each; +inf on
// an invalid row. d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32, the Gram
// identity the TPU kernel evaluates on its matrix unit. Products and sums
// use __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order, and
// __fsqrt_rn/__fdiv_rn round as IEEE, so every value is bit-equal to
// ops/exact_knn.py::knn_mean_distances_exact_plain.
//
// The K smallest squared distances of a query stay sorted in registers: a
// d2 >= buf[K-1] (or nan) is rejected by one compare, anything else
// bubble-inserts. That keeps exactly the multiset of the K smallest values,
// whatever the order in which the candidates come and whichever candidates
// are left out as long as none of them could pass the compare. The finite
// roots are summed in ascending order. So the kernels below may skip and
// reorder freely within that rule and stay bit-equal.
//
// Bound on this card: operations, ~10 float32 operations a (query,
// candidate) pair. Scanning all n^2 pairs of a frame is 1.7e10 pairs on a
// 131072-point cloud; the 10 nearest of a point lie within a few hundred
// rows of it in image order (compacted clouds keep that order), so the
// design scans only what boxes cannot rule out.
//
// 1. exact_knn_prep_kernel, grid (G, B), one block of 32 warps per group of
//    32 subtiles of 32 candidates: stages every candidate as one float4
//    (x, y, z, |c|^2; an invalid row (0, 0, 0, +inf)) and computes the box
//    of each subtile and of each group over its valid rows without a nan
//    coordinate: (lo x, y, z, m), (hi x, y, z, 0), m the largest |c|^2 in
//    it; an empty box is (+inf, -inf). Plain version:
//    ops/exact_knn.py::subtile_boxes. Block (0, 0) zeroes the counters.
// 2. exact_knn_kernel ("near walk"), grid (C / 256, B), 4 warps; a warp owns
//    64 consecutive rows, 2 a lane (rows q0 + lane and q0 + 32 + lane), so
//    each staged candidate feeds two independent chains. A warp with no
//    valid row writes +inf and leaves. It walks its own group first,
//    outward from its own subtile, then the other groups nearest first,
//    each from the side facing its own. Tests, cheapest first, each against
//    the current buffers:
//    a. the other groups, 32 at a time (lane l the group at walk position
//       p0 + l, one ballot): the gap between the group box and the box of
//       the warp's live queries against tmax, the warp's largest lane
//       threshold;
//    b. a visited group's 32 subtile boxes, one a lane, the same way;
//    c. each marked subtile, in walk order: each live lane's own gap to the
//       box against its own threshold; the warp loads the subtile if one
//       lane needs it (__any_sync);
//    d. each loaded candidate (one a lane): its gap to the queries' box
//       against tmax; the warp scans the candidates that pass (a ballot),
//       each read from shared memory as one broadcast float4.
//    Leaving its own group, the warp defers each query whose buf[K-1] has
//    a binary exponent more than 2 above the warp's mean (an outlier or a
//    far point whose reach would keep the whole warp scanning): it appends
//    the row and its buffer to a list and stops inserting for it.
// 3. exact_knn_far_kernel ("far walk"), a persistent grid: one warp a
//    deferred query, lanes over the candidates. Lane l tests group base + l
//    (rounds of 32 groups, the own group left out), then the 32 subtiles of
//    each needed group, and scans each needed subtile with candidate l into
//    its own K-deep buffer, eight subtiles' loads in flight (lanes l < K
//    start with the near walk's l-th value); the bound T starts at the near
//    walk's buf[K-1] and drops to the lanes' smallest buf[K-1] after each
//    group. The K smallest of the 32 buffers are merged by K warp minima,
//    in ascending order.
// skip = 0 turns every test and the deferral off: each warp scans every
// candidate of its frame in row order (validation).
// Each warp adds what it did to 64-bit counters: pairs of the near and the
// far walk (queries x candidates it computed d2 for), subtiles loaded and
// tested, queries deferred (ops/exact_knn.py::scratch_stats).
//
// The skip margin. For float32 q, c let E bound |d2 - |q - c|^2|, d2 the
// computed Gram value, u = 2^-24: |q|^2 and |c|^2 are each within 3u of
// their value, their sum adds u(|q|^2 + |c|^2), the cross term is within
// 3u |q||c| <= 1.5u (|q|^2 + |c|^2) (doubled: 3u), and the last subtraction
// adds u |result| <= 2u (|q|^2 + |c|^2): E <= 12u (|q|^2 + |c|^2) to first
// order. A computed squared gap g between q and a box holding c is within
// 5u of its value, so g <= (1 + 5u) |q - c|^2. A candidate is skipped only
// if g > thr (1 + 2^-20) + 2^-19 (|q|^2 + m), m >= |c|^2 the box's largest
// (each step rounded, which costs a few u more). Then d2 >= |q - c|^2 - E >
// thr (1 + 16u)(1 - 6u) + (32u (1 - 6u) - 12u)(|q|^2 + |c|^2) >= thr: the
// candidate would have failed d2 < thr. A nan query or an infinite |q|^2
// or m makes the threshold nan or +inf, so nothing is skipped for it; a
// nan threshold counts as +inf in tmax. This is tighter than radius.cu's
// 4e-6 max|p|^2 on clouds that reach far from the origin (a scene's sky).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSub = 32;    // candidates per subtile box
constexpr int kGroup = 32;  // subtiles per group box
constexpr int kQ = 2;       // queries a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpQueries = 32 * kQ;
constexpr int kBlockQueries = kWarps * kWarpQueries;
constexpr int kPrepThreads = 32 * kGroup;
constexpr int kFarBlocks = 264;  // 2 an SM; each warp loops over the deferred list
constexpr float kMarginSq = 0x1p-19f;
constexpr float kThrScale = 1.0f + 0x1p-20f;
constexpr int kDeferExp = 2;
constexpr unsigned kFull = 0xffffffffu;
enum { kPairsNear, kPairsFar, kLoads, kTests, kDeferred };

// Views into the wrapper's scratch (ops/exact_knn.py::scratch_words).
struct Scratch {
  float4* cand;   // (B, Cp): x, y, z, |c|^2; invalid (0, 0, 0, +inf)
  float4* sub;    // (B, S, 2): (lo x, y, z, m), (hi x, y, z, 0)
  float4* grp;    // (B, G, 2)
  float* dbuf;    // (B Cp, K): deferred queries' near-walk buffers
  int* drow;      // (B Cp): deferred queries' frame * Cp + row
  int* ndef;      // deferred count
  unsigned long long* stats;
};

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// gap along one axis between [lo_a, hi_a] and [lo_b, hi_b] (fmaxf drops nan)
__device__ __forceinline__ float gap(float lo_a, float hi_a, float lo_b, float hi_b) {
  return fmaxf(fmaxf(__fsub_rn(lo_b, hi_a), __fsub_rn(lo_a, hi_b)), 0.f);
}

__device__ __forceinline__ float gap2(float3 lo_a, float3 hi_a, float4 lo_b, float4 hi_b) {
  const float gx = gap(lo_a.x, hi_a.x, lo_b.x, hi_b.x);
  const float gy = gap(lo_a.y, hi_a.y, lo_b.y, hi_b.y);
  const float gz = gap(lo_a.z, hi_a.z, lo_b.z, hi_b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

__device__ __forceinline__ float margin(float m) { return __fmul_rn(m, kMarginSq); }

// a lane's threshold before the box's margin: thr (1 + 2^-20) + 2^-19 |q|^2
__device__ __forceinline__ float lane_t(float thr, float qa) {
  return __fadd_rn(__fmul_rn(thr, kThrScale), qa);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int K>
__device__ __forceinline__ void insert(float (&buf)[K], float cand) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float lo = fminf(buf[j], cand);
    cand = fmaxf(buf[j], cand);
    buf[j] = lo;
  }
}

// the mean of the finite entries' roots, ascending
template <int K>
__device__ __forceinline__ float finish(const float (&buf)[K]) {
  float acc = 0.f, cnt = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (buf[j] < CUDART_INF_F) {
      acc = __fadd_rn(acc, __fsqrt_rn(buf[j]));
      cnt += 1.f;
    }
  }
  return __fdiv_rn(acc, fmaxf(cnt, 1.f));
}

__global__ void __launch_bounds__(kPrepThreads) exact_knn_prep_kernel(
    const float* __restrict__ xyz_all, const uint8_t* __restrict__ valid_all, Scratch sc, int C,
    int S, int G) {
  __shared__ float4 red[kGroup][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, g = blockIdx.x;
  const int s = g * kGroup + warp, i = s * kSub + lane;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 16)
    reinterpret_cast<int*>(sc.ndef)[threadIdx.x] = 0;
  float x = 0.f, y = 0.f, z = 0.f;
  bool v = false;
  if (s < S) {
    const size_t row = static_cast<size_t>(b) * C + i;
    if (i < C && valid_all[row]) {
      v = true;
      x = xyz_all[3 * row];
      y = xyz_all[3 * row + 1];
      z = xyz_all[3 * row + 2];
    }
    sc.cand[static_cast<size_t>(b) * S * kSub + i] =
        v ? make_float4(x, y, z, sq3(x, y, z)) : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  }
  const bool ok = v && !isnan(x) && !isnan(y) && !isnan(z);
  float4 lo = ok ? make_float4(x, y, z, sq3(x, y, z)) : make_float4(CUDART_INF_F, CUDART_INF_F,
                                                                    CUDART_INF_F, 0.f);
  float4 hi = ok ? make_float4(x, y, z, 0.f)
                 : make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, 0.f);
  auto reduce = [&]() {  // over the warp's lanes
    for (int o = 16; o > 0; o >>= 1) {
      lo.x = fminf(lo.x, __shfl_xor_sync(kFull, lo.x, o));
      lo.y = fminf(lo.y, __shfl_xor_sync(kFull, lo.y, o));
      lo.z = fminf(lo.z, __shfl_xor_sync(kFull, lo.z, o));
      lo.w = fmaxf(lo.w, __shfl_xor_sync(kFull, lo.w, o));
      hi.x = fmaxf(hi.x, __shfl_xor_sync(kFull, hi.x, o));
      hi.y = fmaxf(hi.y, __shfl_xor_sync(kFull, hi.y, o));
      hi.z = fmaxf(hi.z, __shfl_xor_sync(kFull, hi.z, o));
    }
  };
  reduce();  // the subtile's box
  if (lane == 0) {
    if (s < S) {
      sc.sub[(static_cast<size_t>(b) * S + s) * 2] = lo;
      sc.sub[(static_cast<size_t>(b) * S + s) * 2 + 1] = hi;
    }
    red[warp][0] = lo;
    red[warp][1] = hi;
  }
  __syncthreads();
  if (warp != 0) return;
  lo = red[lane][0];
  hi = red[lane][1];
  reduce();  // the group's, over its subtiles' boxes
  if (lane == 0) {
    sc.grp[(static_cast<size_t>(b) * G + g) * 2] = lo;
    sc.grp[(static_cast<size_t>(b) * G + g) * 2 + 1] = hi;
  }
}

// the largest threshold of the warp's live lanes (nan as +inf; -inf if none)
template <int K>
__device__ __forceinline__ float warp_tmax(const float (&buf)[kQ][K], const float (&qa)[kQ],
                                           const bool (&live)[kQ]) {
  float t = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (live[j]) {
      const float tl = lane_t(buf[j][K - 1], qa[j]);
      t = fmaxf(t, tl <= CUDART_INF_F ? tl : CUDART_INF_F);
    }
  }
  return warp_max(t);
}

__device__ __forceinline__ void query_box(const float (&qx)[kQ], const float (&qy)[kQ],
                                          const float (&qz)[kQ], const bool (&live)[kQ],
                                          float3& lo, float3& hi) {
  lo = make_float3(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
  hi = make_float3(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (live[j]) {  // fminf / fmaxf leave a nan coordinate out
      lo = make_float3(fminf(lo.x, qx[j]), fminf(lo.y, qy[j]), fminf(lo.z, qz[j]));
      hi = make_float3(fmaxf(hi.x, qx[j]), fmaxf(hi.y, qy[j]), fmaxf(hi.z, qz[j]));
    }
  }
  lo.x = warp_min(lo.x);
  lo.y = warp_min(lo.y);
  lo.z = warp_min(lo.z);
  hi.x = warp_max(hi.x);
  hi.y = warp_max(hi.y);
  hi.z = warp_max(hi.z);
}

template <int K>
__global__ void __launch_bounds__(kThreads) exact_knn_kernel(
    const uint8_t* __restrict__ valid_all, float* __restrict__ out_all, Scratch sc, int C, int S,
    int G, int skip) {
  __shared__ float4 sbox[kWarps][kGroup][2];
  __shared__ float4 stage[kWarps][kSub];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int Cp = S * kSub;
  const float4* __restrict__ cand = sc.cand + static_cast<size_t>(b) * Cp;
  const float4* __restrict__ sub = sc.sub + static_cast<size_t>(b) * S * 2;
  const float4* __restrict__ grp = sc.grp + static_cast<size_t>(b) * G * 2;
  const uint8_t* valid = valid_all + static_cast<size_t>(b) * C;
  float* out = out_all + static_cast<size_t>(b) * C;
  const int q0 = (blockIdx.x * kWarps + warp) * kWarpQueries;

  float qx[kQ], qy[kQ], qz[kQ], qs[kQ], qa[kQ];
  bool act[kQ], live[kQ];
  float buf[kQ][K];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int row = q0 + 32 * j + lane;
    act[j] = row < C && valid[row];
    // an inactive lane's d2 is +inf or nan: it never inserts
    const float4 c = act[j] ? cand[row] : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    qx[j] = c.x;
    qy[j] = c.y;
    qz[j] = c.z;
    qs[j] = c.w;
    qa[j] = margin(c.w);
    live[j] = act[j];
#pragma unroll
    for (int t = 0; t < K; ++t) buf[j][t] = CUDART_INF_F;
  }
  if (!__any_sync(kFull, act[0] || act[1])) {
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      if (q0 + 32 * j + lane < C) out[q0 + 32 * j + lane] = CUDART_INF_F;
    return;
  }
  float3 qlo, qhi;
  query_box(qx, qy, qz, live, qlo, qhi);

  const int own = q0 / kSub, g0 = own / kGroup, r0 = own % kGroup;
  unsigned long long n_pairs = 0, n_loads = 0, n_tests = 0, n_def = 0;

  // b, c, d and the scan, over the subtiles of group g
  auto visit_group = [&](int g) {
    const float tmax = warp_tmax<K>(buf, qa, live);
    const int si = g * kGroup + lane;
    float4 blo = make_float4(CUDART_INF_F, 0.f, 0.f, 0.f);
    float4 bhi = make_float4(-CUDART_INF_F, 0.f, 0.f, 0.f);
    if (si < S) {
      blo = sub[2 * si];
      bhi = sub[2 * si + 1];
    }
    const bool mark =
        si < S && (!skip || (!(blo.x > bhi.x) &&
                             !(gap2(qlo, qhi, blo, bhi) > __fadd_rn(tmax, margin(blo.w)))));
    const unsigned marks = __ballot_sync(kFull, mark);
    __syncwarp();
    sbox[warp][lane][0] = blo;
    sbox[warp][lane][1] = bhi;
    __syncwarp();
    const int n_in = min(kGroup, S - g * kGroup);
    int u = 0;  // the own group's near-first counter
    for (int t = 0; t < n_in; ++t) {
      int r = t;
      if (skip && g < g0) {
        r = n_in - 1 - t;
      } else if (skip && g == g0) {
        do {
          const int d = (u + 1) >> 1;
          r = r0 + ((u & 1) ? d : -d);
          ++u;
        } while (r < 0 || r >= n_in);
      }
      if (!((marks >> r) & 1u)) continue;
      if (skip) {  // c. each live lane against its own threshold
        ++n_tests;
        const float4 lo = sbox[warp][r][0], hi = sbox[warp][r][1];
        const float mm = margin(lo.w);
        bool need = false;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float3 q = make_float3(qx[j], qy[j], qz[j]);
          need |= live[j] && !(gap2(q, q, lo, hi) > __fadd_rn(lane_t(buf[j][K - 1], qa[j]), mm));
        }
        if (!__any_sync(kFull, need)) continue;
      }
      ++n_loads;
      const float4 c = cand[(g * kGroup + r) * kSub + lane];
      bool keep = true;
      if (skip) {  // d. each candidate against the queries' box
        const float tm = warp_tmax<K>(buf, qa, live);
        keep = c.w < CUDART_INF_F && !(gap2(qlo, qhi, c, c) > __fadd_rn(tm, margin(c.w)));
      }
      unsigned todo = __ballot_sync(kFull, keep);
      if (!todo) continue;
      n_pairs += static_cast<unsigned long long>(__popc(todo)) * kWarpQueries;
      __syncwarp();
      stage[warp][lane] = c;
      __syncwarp();
      while (todo) {
        const float4 cc = stage[warp][__ffs(todo) - 1];
        todo &= todo - 1;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx[j], cc.x), __fmul_rn(qy[j], cc.y)),
                                        __fmul_rn(qz[j], cc.z));
          const float d2 = __fsub_rn(__fadd_rn(qs[j], cc.w), __fmul_rn(2.f, cross));
          // +inf and nan are never taken; the clamp as torch.clamp_min
          if (d2 < buf[j][K - 1]) insert<K>(buf[j], fmaxf(d2, 0.f));
        }
      }
    }
  };

  if (!skip) {
    for (int g = 0; g < G; ++g) visit_group(g);
  } else {
    visit_group(g0);
    bool go = G > 1;
    if (go) {  // leaving the own group: defer the far queries
      unsigned e[kQ];
      int tot = 0, n = 0;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        e[j] = (__float_as_uint(buf[j][K - 1]) >> 23) & 0xFFu;
        if (act[j]) {
          tot += static_cast<int>(e[j]);
          n += 1;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        tot += __shfl_xor_sync(kFull, tot, o);
        n += __shfl_xor_sync(kFull, n, o);
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const bool dfr = act[j] && static_cast<int>(e[j]) * n > tot + kDeferExp * n;
        n_def += __popc(__ballot_sync(kFull, dfr));
        if (dfr) {
          const int slot = atomicAdd(sc.ndef, 1);
          sc.drow[slot] = b * Cp + q0 + 32 * j + lane;
          float* keep = sc.dbuf + static_cast<size_t>(slot) * K;
#pragma unroll
          for (int t = 0; t < K; ++t) keep[t] = buf[j][t];
          live[j] = false;
          buf[j][K - 1] = -CUDART_INF_F;  // no insert from here on
        }
      }
      go = __any_sync(kFull, live[0] || live[1]);
      if (go) query_box(qx, qy, qz, live, qlo, qhi);
    }
    // a. the other groups nearest first, the side the warp leans to first;
    // lane l tests the group at walk position p0 + l against tmax
    const int first = r0 >= kGroup / 2 ? 1 : -1;
    const int a_side = first > 0 ? G - 1 - g0 : g0, b_side = G - 1 - a_side;
    const int pairs = min(a_side, b_side);
    for (int p0 = 1; go && p0 < G; p0 += 32) {
      const float tmax = warp_tmax<K>(buf, qa, live);
      const int q = p0 - 1 + lane;  // position among the other groups
      int g = -1;
      if (q < G - 1)
        g = q < 2 * pairs ? g0 + ((q & 1) ? -first : first) * (q / 2 + 1)
                          : g0 + (a_side > b_side ? first : -first) * (q - pairs + 1);
      bool gmark = false;
      if (g >= 0) {
        const float4 glo = grp[2 * g], ghi = grp[2 * g + 1];
        gmark = !(glo.x > ghi.x) && !(gap2(qlo, qhi, glo, ghi) > __fadd_rn(tmax, margin(glo.w)));
      }
      unsigned gm = __ballot_sync(kFull, gmark);
      while (gm) {
        const int l = __ffs(gm) - 1;
        gm &= gm - 1;
        visit_group(__shfl_sync(kFull, g, l));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int row = q0 + 32 * j + lane;
    if (row < C && !(act[j] && !live[j]))  // a deferred row is the far walk's
      out[row] = act[j] ? finish<K>(buf[j]) : CUDART_INF_F;
  }
  if (lane == 0) {
    atomicAdd(sc.stats + kPairsNear, n_pairs);
    atomicAdd(sc.stats + kLoads, n_loads);
    atomicAdd(sc.stats + kTests, n_tests);
    atomicAdd(sc.stats + kDeferred, n_def);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) exact_knn_far_kernel(float* __restrict__ out_all,
                                                                 Scratch sc, int C, int S, int G) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int Cp = S * kSub;
  const int n = *sc.ndef;
  unsigned long long pairs = 0;
  for (int i = blockIdx.x * kWarps + (threadIdx.x >> 5); i < n; i += n_warps) {
    const int id = sc.drow[i];
    const int b = id / Cp, row = id - b * Cp;
    const float4* __restrict__ cand = sc.cand + static_cast<size_t>(b) * Cp;
    const float4* __restrict__ sub = sc.sub + static_cast<size_t>(b) * S * 2;
    const float4* __restrict__ grp = sc.grp + static_cast<size_t>(b) * G * 2;
    const float4 q = cand[row];
    const float3 q3 = make_float3(q.x, q.y, q.z);
    const float qa = margin(q.w);
    const float* near = sc.dbuf + static_cast<size_t>(i) * K;
    float lb[K];
#pragma unroll
    for (int t = 0; t < K; ++t) lb[t] = CUDART_INF_F;
    if (lane < K) lb[0] = near[lane];
    float T = near[K - 1];
    const int g0 = row / (kSub * kGroup);
    for (int base = 0; base < G; base += 32) {
      const int gi = base + lane;
      bool need_g = false;
      if (gi < G && gi != g0) {
        const float4 lo = grp[2 * gi], hi = grp[2 * gi + 1];
        need_g = !(lo.x > hi.x) &&
                 !(gap2(q3, q3, lo, hi) > __fadd_rn(lane_t(T, qa), margin(lo.w)));
      }
      unsigned gmask = __ballot_sync(kFull, need_g);
      while (gmask) {
        const int g = base + __ffs(gmask) - 1;
        gmask &= gmask - 1;
        const int si = g * kGroup + lane;
        bool need_s = false;
        if (si < S) {
          const float4 lo = sub[2 * si], hi = sub[2 * si + 1];
          need_s = !(lo.x > hi.x) &&
                   !(gap2(q3, q3, lo, hi) > __fadd_rn(lane_t(T, qa), margin(lo.w)));
        }
        unsigned smask = __ballot_sync(kFull, need_s);
        pairs += static_cast<unsigned long long>(__popc(smask)) * kSub;
        const float bound = T;
        while (smask) {  // eight loads in flight
          float4 c[8];
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            c[v] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);  // none left: d2 = +inf
            if (smask) {
              c[v] = cand[(g * kGroup + __ffs(smask) - 1) * kSub + lane];
              smask &= smask - 1;
            }
          }
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, c[v].x), __fmul_rn(q.y, c[v].y)),
                                          __fmul_rn(q.z, c[v].z));
            const float d2 = __fsub_rn(__fadd_rn(q.w, c[v].w), __fmul_rn(2.f, cross));
            if (d2 < fminf(lb[K - 1], bound)) insert<K>(lb, fmaxf(d2, 0.f));
          }
        }
        T = fminf(T, warp_min(lb[K - 1]));
      }
    }
    // the K smallest of the lanes' buffers, ascending
    float acc = 0.f, cnt = 0.f;
    for (int r = 0; r < K; ++r) {
      const float m = warp_min(lb[0]);
      if (!(m < CUDART_INF_F)) break;
      const unsigned who = __ballot_sync(kFull, lb[0] == m);
      if (lane == __ffs(who) - 1) {
#pragma unroll
        for (int t = 0; t + 1 < K; ++t) lb[t] = lb[t + 1];
        lb[K - 1] = CUDART_INF_F;
      }
      acc = __fadd_rn(acc, __fsqrt_rn(m));
      cnt += 1.f;
    }
    if (lane == 0) out_all[static_cast<size_t>(b) * C + row] = __fdiv_rn(acc, fmaxf(cnt, 1.f));
  }
  if (lane == 0 && pairs) atomicAdd(sc.stats + kPairsFar, pairs);
}

template <int K>
int launch(const float* xyz, const uint8_t* valid, Scratch sc, float* out, int B, int C, int S,
           int G, int skip, cudaStream_t stream) {
  exact_knn_prep_kernel<<<dim3(G, B), kPrepThreads, 0, stream>>>(xyz, valid, sc, C, S, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S * kSub + kBlockQueries - 1) / kBlockQueries, B);
  exact_knn_kernel<K><<<grid, kThreads, 0, stream>>>(valid, out, sc, C, S, G, skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_knn_far_kernel<K><<<kFarBlocks, kThreads, 0, stream>>>(out, sc, C, S, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: float32 words laid out as ops/exact_knn.py::scratch_words says;
// k in [1, 32] (the buffers' depth is a template parameter); skip = 0
// scans every candidate.
extern "C" int sd_exact_knn(const void* xyz, const void* valid, void* scratch, void* out, int B,
                            int C, int k, int skip, void* stream) {
  const int S = (C + kSub - 1) / kSub, G = (S + kGroup - 1) / kGroup;
  const size_t Cp = static_cast<size_t>(S) * kSub;
  if (B < 1 || B > 65535 || C < 1 || static_cast<size_t>(B) * Cp >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(scratch);
  Scratch sc;
  sc.cand = reinterpret_cast<float4*>(w);
  w += B * Cp * 4;
  sc.sub = reinterpret_cast<float4*>(w);
  w += static_cast<size_t>(B) * S * 8;
  sc.grp = reinterpret_cast<float4*>(w);
  w += static_cast<size_t>(B) * G * 8;
  sc.dbuf = w;
  w += B * Cp * k;
  sc.drow = reinterpret_cast<int*>(w);
  w += B * Cp;
  sc.ndef = reinterpret_cast<int*>(w);
  sc.stats = reinterpret_cast<unsigned long long*>(w + 6);
  const auto x = static_cast<const float*>(xyz);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define SD_CASE(K) \
  case K:          \
    return launch<K>(x, v, sc, o, B, C, S, G, skip, s);
    SD_CASE(1) SD_CASE(2) SD_CASE(3) SD_CASE(4) SD_CASE(5) SD_CASE(6) SD_CASE(7) SD_CASE(8)
    SD_CASE(9) SD_CASE(10) SD_CASE(11) SD_CASE(12) SD_CASE(13) SD_CASE(14) SD_CASE(15)
    SD_CASE(16) SD_CASE(17) SD_CASE(18) SD_CASE(19) SD_CASE(20) SD_CASE(21) SD_CASE(22)
    SD_CASE(23) SD_CASE(24) SD_CASE(25) SD_CASE(26) SD_CASE(27) SD_CASE(28) SD_CASE(29)
    SD_CASE(30) SD_CASE(31) SD_CASE(32)
#undef SD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
