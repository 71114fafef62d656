// The MAD keep mask, one thread block per row.
//
// Replaces semantic_depth_tpu/ops/pallas_mad.py:_mad_kernel (with
// _masked_median_inreg), called by mad_keep_mask_pallas.
//
// For one row of N float32 values with a validity mask:
//   med  = numpy median of the valid values (mean of the order statistics
//          (n-1)/2 and n/2 in the IEEE total order of the ordered-uint32 map)
//   mad  = the same median of |x - med|, recomputed on the fly, never stored
//   keep = valid & (0.6745f * |x - med| / mad < threshold[row])
// nan and inf penalties compare false; an empty row keeps nothing.
//
// Selection: exact MSB-first radix select with 8-bit digits, 4 histogram
// passes per order statistic. Each pass histograms the keys that share the
// prefix found so far into 256 shared-memory bins (warp-aggregated atomics
// via __match_any_sync, since road and fence coordinates share their top
// bytes and would otherwise serialise on one bin), and one warp scans the
// bins for the digit holding rank k. The second middle value of an even
// count is the same key when duplicates straddle the middle (known from the
// counts), else one min-reduction over the keys above it.
//
// Bound on this card: bytes. A 131072-point row is 512 KB of values plus
// 128 KB of validity, read some 11 times per row, so it is served from the
// 50 MB L2 after the first pass; device memory sees each byte about once.
// The limit in practice is one SM per row: the main path has only 5 rows
// per frame (40 blocks at batch 8 on 132 SMs), so most of the card idles.
// Spreading a row over a thread-block cluster (distributed shared memory)
// is the first thing a later change should do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoBin = 0xffffffffu;

__device__ __forceinline__ uint32_t to_ordered(float x) {
  uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t u) {
  uint32_t b = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(b);
}

struct Shared {
  uint32_t hist[256];
  uint32_t red[kWarps];
  uint32_t bin, before, eq;
};

// Block-wide sum (every thread gets the result).
__device__ uint32_t block_sum(uint32_t v, Shared& s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? s.red[lane] : 0u;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide unsigned min (every thread gets the result).
__device__ uint32_t block_min(uint32_t v, Shared& s) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? s.red[lane] : 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Key of element i: the value itself, or |x - med| for the MAD pass.
template <bool kDiff>
__device__ __forceinline__ uint32_t key_of(float x, float med) {
  return to_ordered(kDiff ? fabsf(__fsub_rn(x, med)) : x);
}

// Exact median of the valid keys of one row (n >= 1 valid).
template <bool kDiff>
__device__ float block_median(const float* __restrict__ x, const uint8_t* __restrict__ v,
                              int n_elems, uint32_t n, float med, Shared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t k = (n - 1u) / 2u;  // rank (0-based) of the lower middle value
  uint32_t prefix = 0, mask = 0, less = 0, eq = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    // every thread runs the same number of iterations, so whole warps meet
    // __match_any_sync; lanes past the end carry kNoBin
    for (int base = 0; base < n_elems; base += 4 * kThreads) {
      const int i = base + 4 * tid;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      uchar4 vv = make_uchar4(0, 0, 0, 0);
      if (i < n_elems) {
        xv = *reinterpret_cast<const float4*>(x + i);
        vv = *reinterpret_cast<const uchar4*>(v + i);
      }
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const uint8_t vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t bin = kNoBin;
        if (vs[e]) {
          const uint32_t u = key_of<kDiff>(xs[e], med);
          if ((u & mask) == prefix) bin = (u >> shift) & 0xffu;
        }
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin != kNoBin && lane == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {  // find the digit whose bin holds rank k
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[lane * 8 + j];
        sum += c[j];
      }
      uint32_t incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const uint32_t excl = incl - sum;
      if (excl <= k && k < incl) {
        uint32_t run = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k < run + c[j]) {
            s.bin = lane * 8 + j;
            s.before = run;
            s.eq = c[j];
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    k -= s.before;
    less += s.before;
    eq = s.eq;
    prefix |= s.bin << shift;
    mask |= 0xffu << shift;
    __syncthreads();  // s is rewritten by the next pass
  }
  const uint32_t u_lo = prefix;
  uint32_t u_hi = u_lo;
  // upper middle value: the same key unless n is even and no duplicate of
  // u_lo reaches rank n/2; then the smallest valid key above u_lo
  if ((n % 2u == 0u) && (less + eq < n / 2u + 1u)) {
    uint32_t best = 0xffffffffu;
    for (int i = tid; i < n_elems; i += kThreads) {
      if (v[i]) {
        const uint32_t u = key_of<kDiff>(x[i], med);
        if (u > u_lo) best = min(best, u);
      }
    }
    u_hi = block_min(best, s);
  }
  return __fmul_rn(0.5f, __fadd_rn(from_ordered(u_lo), from_ordered(u_hi)));
}

__global__ void __launch_bounds__(kThreads) mad_keep_kernel(
    const float* __restrict__ x_all, const uint8_t* __restrict__ v_all,
    const float* __restrict__ thr, uint8_t* __restrict__ out_all, int n_elems) {
  __shared__ Shared s;
  const size_t row = blockIdx.x;
  const float* x = x_all + row * n_elems;
  const uint8_t* v = v_all + row * n_elems;
  uint8_t* out = out_all + row * n_elems;
  const int tid = threadIdx.x;

  uint32_t cnt = 0;
  for (int i = tid; i < n_elems; i += kThreads) cnt += v[i] ? 1u : 0u;
  const uint32_t n = block_sum(cnt, s);
  if (n == 0u) {  // nothing valid: nothing kept (the medians would be nan)
    for (int i = tid; i < n_elems; i += kThreads) out[i] = 0;
    return;
  }
  const float med = block_median<false>(x, v, n_elems, n, 0.f, s);
  const float mad = block_median<true>(x, v, n_elems, n, med, s);
  const float t = thr[row];
  for (int i = tid; i < n_elems; i += kThreads) {
    const float d = fabsf(__fsub_rn(x[i], med));
    const float penalty = __fdiv_rn(__fmul_rn(0.6745f, d), mad);
    out[i] = (v[i] && penalty < t) ? 1 : 0;
  }
}

}  // namespace

extern "C" int sd_mad_keep(const void* values, const void* valid, const void* thresholds,
                           void* out, int rows, int n_elems, void* stream) {
  mad_keep_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(thresholds), static_cast<uint8_t*>(out), n_elems);
  return static_cast<int>(cudaGetLastError());
}
