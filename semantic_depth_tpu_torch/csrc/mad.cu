// The MAD keep mask, one thread-block cluster per row.
//
// Replaces semantic_depth_tpu/ops/pallas_mad.py:_mad_kernel (with
// _masked_median_inreg), called by mad_keep_mask_pallas.
//
// For one row of N float32 values with a validity mask:
//   med  = numpy median of the valid values (mean of the order statistics
//          (n-1)/2 and n/2 in the IEEE total order of the ordered-uint32 map)
//   mad  = the same median of |x - med|, recomputed on the fly, never stored
//   keep = valid & (0.6745f * |x - med| / mad < threshold)
// nan and inf penalties compare false; an empty row keeps nothing.
//
// Bound on this card: bytes. Each point is read once (4 B value, 1 B
// validity) and its mask written once (1 B): 6 B a point, 1.9 us for the 8
// rows of 131072 of one frame-program launch at 3.35 TB/s.
//
// Design. A cluster of kCluster = 8 CTAs owns one row (a cluster of 16 was
// no faster on the frame program's launches: PERF.md), and CTA r of the
// cluster owns slice r of it, so an 8-row launch fills 64 SMs where one
// block a row filled 8.
// - Resident mode (picked while a slice fits in shared memory):
//   each CTA copies its slice once into dynamic shared memory with cp.async
//   and compacts the slice's valid values to the front in order (block
//   prefix sums over 4-value chunks), as the TPU kernel kept its row in VMEM.
//   Every later pass reads only valid values and tests no validity.
// - Streamed mode (rows too long for the cluster's shared memory, such as
//   the 2M-point rows of the native full-resolution grid, picked by N): the
//   same kernel, but each pass streams the CTA's slice from global memory.
// Selection is an exact MSB-first radix select with digits of 11, 11 and 10
// bits (three passes per order statistic; 8-bit digits were slower). In each
// pass a CTA histograms its keys that share the prefix found so far into
// 2^bits shared-memory bins; a thread adds a run of equal bins with one
// atomic, and a warp whose last runs share one bin adds them once, because
// road and fence coordinates share their top bits. Each CTA sums its bins
// into 32-bin groups; after cluster.sync() every CTA reads the groups of all
// CTAs through distributed shared memory, picks the group holding rank k,
// then reads that group's 32 bins of all CTAs and picks the digit. Every CTA
// finds the same digit, so nothing is broadcast. The histograms alternate
// between two buffers, so one cluster barrier a pass suffices. The rules are
// the first kernel's: the lower middle value by rank, the upper middle value
// of an even count from the counts when duplicates straddle the middle, else
// from a cluster-wide min over the keys above it. The output pass reads x
// and valid from global memory once and writes the mask.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;
constexpr int kCluster = 8;  // CTAs per row (portable cluster size)
constexpr int kPasses = 3;   // digits per order statistic, MSB first
__host__ __device__ constexpr int digit_bits(int p) { return p < 2 ? 11 : 10; }
constexpr int kMaxBits = 11;
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kGroup = 32;  // bins per group of the two-level digit search
constexpr int kMaxGroups = kMaxBins / kGroup;  // 64: two per lane of one warp
constexpr int kMaxSlice = 32768;  // resident slice: 5 B a point, 160 KB
static_assert(digit_bits(0) + digit_bits(1) + digit_bits(2) == 32, "the digits cover the key");

struct Shared {
  uint32_t hist[2][kMaxBins];     // this CTA's digit histogram, passes alternating
  uint32_t group[2][kMaxGroups];  // its 32-bin group sums
  uint32_t count;                 // valid values in this CTA's slice
  uint32_t minkey[2];             // smallest key above the lower middle (median, MAD)
  uint32_t red[kWarps];
  uint32_t bin, before, eq;
};

__device__ __forceinline__ uint32_t to_ordered(float x) {
  uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t u) {
  uint32_t b = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(b);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_min(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Block-wide exclusive prefix sum of v; *total gets the block's sum.
__device__ uint32_t block_excl_scan(uint32_t v, uint32_t* total, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(v, lane);
  if (lane == 31) s.red[warp] = incl;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t t = s.red[w];
    before += w < warp ? t : 0u;
    sum += t;
  }
  __syncthreads();  // s.red is rewritten by the next call
  *total = sum;
  return before + incl - v;
}

// Block-wide unsigned min (every thread gets the result).
__device__ uint32_t block_min(uint32_t v, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  uint32_t m = kNone;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = min(m, s.red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Resident mode: copy the slice into shared memory and compact its valid
// values to the front of `vals`, in order. Returns their count.
__device__ uint32_t load_compact(const float* x, const uint8_t* v, int len, float* vals,
                                 uint8_t* vbuf, Shared& s) {
  for (int i = 4 * threadIdx.x; i < len; i += 4 * kThreads) {
    cp_async16(vals + i, x + i);
    cp_async4(vbuf + i, v + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  uint32_t m = 0;
  for (int base = 0; base < len; base += 4 * kThreads) {  // the same trip count in every thread
    const int i = base + 4 * threadIdx.x;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    uchar4 vv = make_uchar4(0, 0, 0, 0);
    if (i < len) {
      xv = *reinterpret_cast<const float4*>(vals + i);
      vv = *reinterpret_cast<const uchar4*>(vbuf + i);
    }
    const uint32_t c = (vv.x != 0) + (vv.y != 0) + (vv.z != 0) + (vv.w != 0);
    uint32_t total;
    uint32_t o = m + block_excl_scan(c, &total, s);
    // the scan's barriers order this chunk's reads before its writes, and the
    // writes land below base + 4 * kThreads, where the next chunk starts
    if (vv.x) vals[o++] = xv.x;
    if (vv.y) vals[o++] = xv.y;
    if (vv.z) vals[o++] = xv.z;
    if (vv.w) vals[o++] = xv.w;
    m += total;
  }
  __syncthreads();
  return m;
}

struct Slice {
  const float* x;    // this CTA's slice of the row in global memory
  const uint8_t* v;  // and its validity
  int len;           // its length, a multiple of 4
  const float* vals; // resident mode: the slice's valid values, compacted
  uint32_t m;        // the number of valid values in the slice
};

// Calls f(value) for every valid value of this CTA's slice.
template <bool kStreamed, class F>
__device__ __forceinline__ void for_each_valid(const Slice& sl, F&& f) {
  if constexpr (kStreamed) {
    for (int i = 4 * threadIdx.x; i < sl.len; i += 4 * kThreads) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(sl.x + i));
      const uchar4 vv = __ldg(reinterpret_cast<const uchar4*>(sl.v + i));
      if (vv.x) f(xv.x);
      if (vv.y) f(xv.y);
      if (vv.z) f(xv.z);
      if (vv.w) f(xv.w);
    }
  } else {
    for (uint32_t i = threadIdx.x; i < sl.m; i += kThreads) f(sl.vals[i]);
  }
}

// Key of a value: the value itself, or |x - med| for the MAD.
template <bool kDiff>
__device__ __forceinline__ uint32_t key_of(float x, float med) {
  return to_ordered(kDiff ? fabsf(__fsub_rn(x, med)) : x);
}

// Exact median of the valid keys of the cluster's row (n >= 1 valid).
// `pass` counts the passes of the launch, so the histogram buffers alternate.
template <bool kStreamed, bool kDiff>
__device__ float cluster_median(const Slice& sl, uint32_t n, float med, int& pass, Shared& s,
                                cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t k = (n - 1u) / 2u;  // rank (0-based) of the lower middle value
  uint32_t prefix = 0, mask = 0, less = 0, eq = 0;
  int shift = 32;
#pragma unroll
  for (int p = 0; p < kPasses; ++p, ++pass) {
    const int bits = digit_bits(p);
    shift -= bits;
    const uint32_t dmask = (1u << bits) - 1u;
    const int nbins = 1 << bits, ngroups = nbins / kGroup;
    uint32_t* hist = s.hist[pass & 1];
    uint32_t* group = s.group[pass & 1];
    for (int i = threadIdx.x; i < nbins; i += kThreads) hist[i] = 0;
    __syncthreads();
    uint32_t run_bin = kNone, run = 0;
    for_each_valid<kStreamed>(sl, [&](float x) {
      const uint32_t u = key_of<kDiff>(x, med);
      if ((u & mask) != prefix) return;
      const uint32_t bin = (u >> shift) & dmask;
      if (bin != run_bin) {
        if (run) atomicAdd(&hist[run_bin], run);
        run_bin = bin;
        run = 0;
      }
      ++run;
    });
    const uint32_t mine = run ? run_bin : kNone;
    const uint32_t first = __shfl_sync(kFull, mine, 0);
    if (__all_sync(kFull, mine == first)) {  // the warp's last runs share one bin
      const uint32_t total = warp_sum(run);
      if (lane == 0 && first != kNone) atomicAdd(&hist[first], total);
    } else if (run) {
      atomicAdd(&hist[run_bin], run);
    }
    __syncthreads();
    for (int g = warp; g < ngroups; g += kWarps) {
      const uint32_t c = warp_sum(hist[g * kGroup + lane]);
      if (lane == 0) group[g] = c;
    }
    cluster.sync();  // every CTA's bins and group sums are complete
    if (warp == 0) {
      // the cluster's group sums: this lane holds groups lane and lane + 32
      // (every remote load starts before the first sum waits on one)
      uint32_t a[kCluster], b[kCluster];
#pragma unroll
      for (unsigned r = 0; r < kCluster; ++r) {
        const uint32_t* g = cluster.map_shared_rank(group, r);
        a[r] = lane < ngroups ? g[lane] : 0u;
        b[r] = lane + 32 < ngroups ? g[lane + 32] : 0u;
      }
      uint32_t c0 = 0, c1 = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        c0 += a[r];
        c1 += b[r];
      }
      const uint32_t i0 = warp_incl_scan(c0, lane);
      const uint32_t i1 = warp_incl_scan(c1, lane) + __shfl_sync(kFull, i0, 31);
      const unsigned in0 = __ballot_sync(kFull, i0 - c0 <= k && k < i0);
      const unsigned in1 = __ballot_sync(kFull, i1 - c1 <= k && k < i1);
      int gsel;
      uint32_t gbefore;
      if (in0) {
        gsel = __ffs(in0) - 1;
        gbefore = __shfl_sync(kFull, i0 - c0, gsel);
      } else {
        const int l = __ffs(in1) - 1;
        gsel = 32 + l;
        gbefore = __shfl_sync(kFull, i1 - c1, l);
      }
      // the chosen group's bins, summed over the cluster: one bin a lane
#pragma unroll
      for (unsigned r = 0; r < kCluster; ++r) a[r] = cluster.map_shared_rank(hist, r)[gsel * kGroup + lane];
      uint32_t c = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) c += a[r];
      const uint32_t incl = warp_incl_scan(c, lane) + gbefore;
      const unsigned hit = __ballot_sync(kFull, incl - c <= k && k < incl);
      if (lane == __ffs(hit) - 1) {
        s.bin = gsel * kGroup + lane;
        s.before = incl - c;
        s.eq = c;
      }
    }
    __syncthreads();
    k -= s.before;
    less += s.before;
    eq = s.eq;
    prefix |= s.bin << shift;
    mask |= dmask << shift;
    // s.bin is rewritten only after the next pass's barriers
  }
  const uint32_t u_lo = prefix;
  uint32_t u_hi = u_lo;
  // upper middle value: the same key unless n is even and no duplicate of
  // u_lo reaches rank n/2; then the smallest valid key above u_lo
  if ((n % 2u == 0u) && (less + eq < n / 2u + 1u)) {  // the same in every CTA
    uint32_t best = kNone;
    for_each_valid<kStreamed>(sl, [&](float x) {
      const uint32_t u = key_of<kDiff>(x, med);
      if (u > u_lo) best = min(best, u);
    });
    best = block_min(best, s);
    if (threadIdx.x == 0) s.minkey[kDiff] = best;
    cluster.sync();
    const uint32_t m = lane < kCluster ? *cluster.map_shared_rank(&s.minkey[kDiff], lane) : kNone;
    u_hi = warp_min(m);
  }
  return __fmul_rn(0.5f, __fadd_rn(from_ordered(u_lo), from_ordered(u_hi)));
}

__device__ __forceinline__ uint8_t keep_one(float x, uint8_t valid, float med, float mad, float t) {
  const float d = fabsf(__fsub_rn(x, med));
  const float penalty = __fdiv_rn(__fmul_rn(0.6745f, d), mad);
  return (valid && penalty < t) ? 1 : 0;
}

// grid (CS, rows), cluster (CS, 1, 1): blockIdx.x is the rank in the row's cluster.
template <bool kStreamed>
__global__ void __launch_bounds__(kThreads) mad_cluster_kernel(
    const float* __restrict__ x_all, const uint8_t* __restrict__ v_all,
    const float* __restrict__ thr, float t0, float t1, int split,
    uint8_t* __restrict__ out_all, int n_elems, int slice) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.y;
  const int begin = static_cast<int>(cluster.block_rank()) * slice;
  const int len = max(0, min(slice, n_elems - begin));
  const size_t offset = static_cast<size_t>(row) * n_elems + begin;
  const float* x = x_all + offset;
  const uint8_t* v = v_all + offset;
  uint8_t* out = out_all + offset;
  Slice sl{x, v, len, reinterpret_cast<const float*>(dyn), 0u};

  if constexpr (kStreamed) {
    uint32_t c = 0;
    for (int i = 4 * threadIdx.x; i < len; i += 4 * kThreads) {
      const uchar4 vv = __ldg(reinterpret_cast<const uchar4*>(v + i));
      c += (vv.x != 0) + (vv.y != 0) + (vv.z != 0) + (vv.w != 0);
    }
    uint32_t total;
    block_excl_scan(c, &total, s);
    sl.m = total;
  } else {
    sl.m = load_compact(x, v, len, reinterpret_cast<float*>(dyn), dyn + 4 * slice, s);
  }
  if (threadIdx.x == 0) s.count = sl.m;
  cluster.sync();
  // the row's valid count: every warp sums the slices' counts
  const unsigned lane = threadIdx.x & 31;
  const uint32_t n = warp_sum(lane < kCluster ? *cluster.map_shared_rank(&s.count, lane) : 0u);

  float med = 0.f, mad = 0.f;
  if (n > 0u) {  // the same in every CTA of the cluster
    int pass = 0;
    med = cluster_median<kStreamed, false>(sl, n, 0.f, pass, s, cluster);
    mad = cluster_median<kStreamed, true>(sl, n, med, pass, s, cluster);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory

  // with n == 0 nothing is valid, so nothing is kept
  const float t = thr != nullptr ? thr[row] : (row < split ? t0 : t1);
  for (int i = 4 * threadIdx.x; i < len; i += 4 * kThreads) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
    const uchar4 vv = __ldg(reinterpret_cast<const uchar4*>(v + i));
    uchar4 o;
    o.x = keep_one(xv.x, vv.x, med, mad, t);
    o.y = keep_one(xv.y, vv.y, med, mad, t);
    o.z = keep_one(xv.z, vv.z, med, mad, t);
    o.w = keep_one(xv.w, vv.w, med, mad, t);
    *reinterpret_cast<uchar4*>(out + i) = o;
  }
}

// The kernel's attribute, set once: the largest resident slice's dynamic
// shared memory.
template <bool kStreamed>
cudaError_t configure() {
  static const cudaError_t status = cudaFuncSetAttribute(
      mad_cluster_kernel<kStreamed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStreamed ? 0 : 5 * kMaxSlice);
  return status;
}

template <bool kStreamed>
cudaError_t launch(const float* x, const uint8_t* v, const float* thr, float t0, float t1,
                   int split, uint8_t* out, int rows, int n_elems, int slice,
                   cudaStream_t stream) {
  const cudaError_t err = configure<kStreamed>();
  if (err != cudaSuccess) return err;
  const int smem = kStreamed ? 0 : 5 * slice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mad_cluster_kernel<kStreamed>, x, v, thr, t0, t1, split, out,
                            n_elems, slice);
}

}  // namespace

// thresholds: a (rows,) device array, or null for t0 on rows < split and t1
// on the rest. A row whose slices fit in shared memory stays resident; a
// longer one streams.
extern "C" int sd_mad_keep(const void* values, const void* valid, const void* thresholds,
                           float t0, float t1, int split, void* out, int rows, int n_elems,
                           void* stream) {
  if (rows < 1 || rows > 65535 || n_elems < 4 || n_elems % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = ((n_elems + kCluster - 1) / kCluster + 3) / 4 * 4;
  const auto x = static_cast<const float*>(values);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto thr = static_cast<const float*>(thresholds);
  const auto o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      slice > kMaxSlice ? launch<true>(x, v, thr, t0, t1, split, o, rows, n_elems, slice, s)
                        : launch<false>(x, v, thr, t0, t1, split, o, rows, n_elems, slice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
