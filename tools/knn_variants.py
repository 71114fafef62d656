#!/usr/bin/env python3
"""Design variants of K4 (exact kNN) and K1 (windowed kNN) that PERF.md
compares with the kernels as they are, each as a patched copy of this
checkout, so that ``tools/time_knn.py`` times every one in the same call.

    python3 tools/knn_variants.py [--out build/variants]
    (cd build/variants/<name> && python3 tools/time_knn.py --json <name>.json)

Variants (each changes one kernel source; every other file is copied):

- ``k4_near_only``: no query drops out of its warp's tests; the near walk
  alone, no far-walk kernel.
- ``k4_in_warp_far``: a query that drops out is finished at once by its own
  warp with the far walk (lanes over the candidates) instead of by a third
  kernel; the same pairs, loads and tests.
- ``k4_no_counters``: the kernels keep no counts (``scratch_stats`` reads 0).
- ``k1_branch_only``: K1's exact path for every block: the valid flag as a
  branch and nan counting, no ``d2 + w`` path.

``--out`` must be a directory that ``.gitignore`` lists (``build/`` is).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K4 = "semantic_depth_tpu_torch/csrc/exact_knn.cu"
K1 = "semantic_depth_tpu_torch/csrc/knn_grid.cu"
FAR_LAUNCH = "  exact_knn_far_kernel<K><<<kFarBlocks, kThreads, 0, stream>>>(out, sc, C, S, G);\n"

# the far kernel's walk as a function of one query, called by the whole warp
FAR_WALK = """template <int K>
__device__ float far_walk(float4 q, float lb0, float T, const float4* __restrict__ cand,
                          const float4* __restrict__ sub, const float4* __restrict__ grp, int S,
                          int G, int g0, unsigned long long& pairs) {
  const int lane = threadIdx.x & 31;
  const float3 q3 = make_float3(q.x, q.y, q.z);
  const float qa = margin(q.w);
  float lb[K];
#pragma unroll
  for (int t = 0; t < K; ++t) lb[t] = CUDART_INF_F;
  lb[0] = lb0;
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
      while (smask) {
        float4 c[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          c[v] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
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
  return __fdiv_rn(acc, fmaxf(cnt, 1.f));
}

"""

SEARCH = "template <int K>\n__global__ void __launch_bounds__(kThreads) exact_knn_kernel("

# each variant: (file, old text, new text) replacements, applied in order
VARIANTS = {
    "k4_near_only": [
        (K4, "constexpr int kDeferExp = 2;", "constexpr int kDeferExp = 1 << 20;"),
        (K4, FAR_LAUNCH, ""),
    ],
    "k4_in_warp_far": [
        (K4, SEARCH, FAR_WALK + SEARCH),
        (K4, "unsigned long long n_pairs = 0, n_loads",
         "unsigned long long n_pairs = 0, n_far = 0, n_loads"),
        (K4, """        n_def += __popc(__ballot_sync(kFull, dfr));
        if (dfr) {
          const int slot = atomicAdd(sc.ndef, 1);
          sc.drow[slot] = b * Cp + q0 + 32 * j + lane;
          float* keep = sc.dbuf + static_cast<size_t>(slot) * K;
#pragma unroll
          for (int t = 0; t < K; ++t) keep[t] = buf[j][t];
          live[j] = false;""", """        unsigned dm = __ballot_sync(kFull, dfr);
        n_def += __popc(dm);
        while (dm) {
          const int l = __ffs(dm) - 1;
          dm &= dm - 1;
          float lb0 = CUDART_INF_F;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const float v = __shfl_sync(kFull, buf[j][t], l);
            if (lane == t) lb0 = v;
          }
          const float4 q = make_float4(__shfl_sync(kFull, qx[j], l), __shfl_sync(kFull, qy[j], l),
                                       __shfl_sync(kFull, qz[j], l), __shfl_sync(kFull, qs[j], l));
          const float res = far_walk<K>(q, lb0, __shfl_sync(kFull, buf[j][K - 1], l), cand, sub,
                                        grp, S, G, g0, n_far);
          if (lane == 0) out[q0 + 32 * j + l] = res;
        }
        if (dfr) {
          live[j] = false;"""),
        (K4, "    atomicAdd(sc.stats + kPairsNear, n_pairs);\n",
         "    atomicAdd(sc.stats + kPairsNear, n_pairs);\n"
         "    atomicAdd(sc.stats + kPairsFar, n_far);\n"),
        (K4, FAR_LAUNCH, ""),
    ],
    "k4_no_counters": [
        (K4, """  if (lane == 0) {
    atomicAdd(sc.stats + kPairsNear, n_pairs);
    atomicAdd(sc.stats + kLoads, n_loads);
    atomicAdd(sc.stats + kTests, n_tests);
    atomicAdd(sc.stats + kDeferred, n_def);
  }
""", ""),
        (K4, "  if (lane == 0 && pairs) atomicAdd(sc.stats + kPairsFar, pairs);\n", ""),
    ],
    "k1_branch_only": [
        (K1, "        bad |= !(isfinite(s.x) && isfinite(s.y) && isfinite(s.z));\n", ""),
        (K1, "  const bool exact = __syncthreads_or(bad);", "  __syncthreads();"),
        (K1, "  if (Exact && s.w != 0.f) return;", "  if (s.w != 0.f) return;"),
        (K1, """    if (Exact)
      n_nan[r] += isnan(d2) ? 1 : 0;  // nan fails the compare below
    else
      d2 = __fadd_rn(d2, s.w);
""", "    n_nan[r] += isnan(d2) ? 1 : 0;\n"),
        (K1, """    if (exact)
      scan<true>(order, row0, c, buf, n_nan);
    else
      scan<false>(order, row0, c, buf, n_nan);""", "    scan<true>(order, row0, c, buf, n_nan);"),
    ],
}


def make(name: str, out: Path) -> Path:
    """A copy of this checkout's package, ``chip_smoke.py`` and ``tools/``
    under ``out / name`` with the variant's replacements applied."""
    dst = out / name
    shutil.rmtree(dst, ignore_errors=True)
    skip = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(ROOT / "semantic_depth_tpu_torch", dst / "semantic_depth_tpu_torch",
                    ignore=skip)
    shutil.copytree(ROOT / "tools", dst / "tools", ignore=skip)
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for rel, old, new in VARIANTS[name]:
        path = dst / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace is not in {rel} once: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "variants"))
    ap.add_argument("names", nargs="*", default=list(VARIANTS), help="variants to make")
    args = ap.parse_args()
    for name in args.names:
        print(make(name, Path(args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
