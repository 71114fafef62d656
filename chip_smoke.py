#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``semantic_depth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or any check fails. Phases:

1. device: card name and power limit, torch / CUDA / nvcc versions, full fp32;
2. build: the hand-written kernels of ``csrc/`` (nvcc, sm_90a), with ptxas
   register and shared-memory lines;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: knn_grid (8, 256, 512) within rtol 1e-5 / atol 1e-6,
   mad (40 rows of 131072) and radius (8, 16384) bit-equal, radius with the
   z-range tile skip on and off; median times (CUDA events) of kernel and
   plain version beside the bound at those shapes;
4. the geometry tail on analytic scenes (true masks and disparity) on the
   card and on the CPU: dist_rw / dist_f2f agree within 1e-3 m, rw MAE
   against the analytic width under 0.1 m, launches per batch K1 x1,
   K2 x4, K3 x1;
5. end to end at full width: full-size FCN-8s/VGG16 and monodepth-vgg with
   seeded random weights, ``process_batch`` on 8 rendered 1024x2048 uint8
   frames in float32 and bfloat16, launch counts, frames/s.

The second-to-last lines are the card's name and power limit and one JSON
object with the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
_HBM_BYTES_PER_S = 3.35e12
_FP32_FLOPS = 67e12
_NO_LIBRARY = "no single PyTorch call computes it"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)
    print(f"  ok: {msg}", flush=True)


def log(msg=""):
    print(msg, flush=True)


def _run(cmd):
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return out.stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / _HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts(mods):
    for fn in mods.values():
        fn.launches = 0


def read_counts(mods):
    return {name: fn.launches for name, fn in mods.items()}


# ---------------------------------------------------------------------------
def scene_batch(n, h, w, seed, dev):
    """Rendered analytic scenes: frames, true masks and pixel disparity."""
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    imgs, labels, disp_norm, rw_true, f2f_true = scene_pool(n, h, w, seed=seed)
    mult = 2048.0 * (w / 512.0)  # scene_pool's default disparity_mult, times s_w
    return dict(
        small=torch.from_numpy(imgs.astype(np.float32)).to(dev),
        road=torch.from_numpy(labels == 7).to(dev),
        fence=torch.from_numpy(labels == 13).to(dev),
        disp=torch.from_numpy(disp_norm * np.float32(mult)).to(dev),
        rw_true=rw_true,
        f2f_true=f2f_true,
    )


def phase_kernels(dev, scenes):
    from semantic_depth_tpu_torch import camera, config
    from semantic_depth_tpu_torch.ops import knn_grid, mad, pcl, radius

    cfg = config.munich_pipeline_config()
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(1)

    # --- K1: windowed kNN at (8, 256, 512) --------------------------------
    log("[phase 3] K1 knn_grid")
    pts_scene = camera.reproject_disparity(scenes["disp"][:4], cfg.camera)
    valid_scene = scenes["road"][:4] & (pts_scene[..., 2] < -cfg.road.z_keep_beyond)
    pts_rand = torch.randn((4, 256, 512, 3), generator=g).to(dev) * torch.tensor(
        [2.0, 0.3, 5.0], device=dev)
    valid_rand = (torch.rand((4, 256, 512), generator=g) < 0.3).to(dev)
    pts = torch.cat([pts_scene, pts_rand]).contiguous()
    valid = torch.cat([valid_scene, valid_rand]).contiguous()
    got = knn_grid.knn_mean_distances_grid(pts, valid, 10, (5, 21))
    want = knn_grid.knn_mean_distances_grid_plain(pts, valid, 10, (5, 21))
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), "K1 finite maps equal")
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6),
          f"K1 within rtol 1e-5 / atol 1e-6 (max abs err {err:.3e}, bit-equal "
          f"{torch.equal(got, want)}, {int(fin.sum())} finite of {fin.numel()})")
    # the plain version on the CPU (IEEE sqrt and division for certain)
    want_cpu = knn_grid.knn_mean_distances_grid_plain(pts.cpu(), valid.cpu(), 10, (5, 21))
    fin_cpu = torch.isfinite(want_cpu)
    log(f"  K1 against the plain version on the CPU: max abs err "
        f"{(got.cpu()[fin_cpu] - want_cpu[fin_cpu]).abs().max().item():.3e}, "
        f"bit-equal {torch.equal(got.cpu(), want_cpu)}")
    b, h, w = valid.shape
    cand = torch.nn.functional.conv2d(
        valid.float()[:, None], torch.ones((1, 1, 5, 21), device=dev), padding=(2, 10))[:, 0]
    n_ops = float((cand * valid).sum()) * 28.0 + float(valid.sum()) * 21.0
    t_bound, by = bound_ms(b * h * w * (12 + 1 + 4), n_ops)
    rows["knn_grid"] = dict(
        name="knn_grid", route="cuda", source="semantic_depth_tpu_torch/csrc/knn_grid.cu",
        replaces="semantic_depth_tpu/ops/pallas_knn.py:36", max_abs_err=err,
        ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid(pts, valid, 10, (5, 21))),
        plain_ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid_plain(pts, valid, 10, (5, 21)),
                         iters=5, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        shape="points (8, 256, 512, 3) f32, valid (8, 256, 512), k=10, window (5, 21)",
    )

    # --- K2: MAD keep mask, 40 rows of 131072 -----------------------------
    log("[phase 3] K2 mad")
    n = 131072
    vals, oks = [], []
    scene_pts = camera.reproject_disparity(scenes["disp"], cfg.camera).reshape(8, n, 3)
    for i in range(8):  # the main path's planes: road y and x, fence y and x
        road_v = scenes["road"][i].reshape(n)
        fence_v = scenes["fence"][i].reshape(n)
        vals += [scene_pts[i, :, 1], scene_pts[i, :, 0], scene_pts[i, :, 1], scene_pts[i, :, 0]]
        oks += [road_v, road_v, fence_v, fence_v]
    base = torch.randn((n,), generator=g).to(dev) * 7.0 - 2.0
    rnd = lambda p: (torch.rand((n,), generator=g) < p).to(dev)  # noqa: E731
    with_inf = base.clone()
    with_inf[:50] = float("inf")
    with_inf[50:90] = float("-inf")
    odd = rnd(0.5)
    odd[0] = ~odd[1:].sum().remainder(2).bool()  # force an odd count
    even = rnd(0.5)
    even[0] = even[1:].sum().remainder(2).bool()  # force an even count
    special = [
        (base, torch.zeros(n, dtype=torch.bool, device=dev)),  # empty row
        (torch.full((n,), 3.25, device=dev), rnd(0.5)),  # constant row: MAD = 0
        (with_inf, rnd(0.6)),  # +-inf values
        (base, odd),
        (base, even),
        (torch.round(base), rnd(0.6)),  # heavy duplicates
        (base, rnd(0.001)),  # a handful of points
        (base, rnd(1.0)),  # all valid
    ]
    for v, o in special:
        vals.append(v)
        oks.append(o)
    values = torch.stack(vals).contiguous()
    valids = torch.stack(oks).contiguous()
    thr = torch.tensor([15.0, 2.0, 5.0, 1.0] * 8 + [2.0] * 8, device=dev)
    check(values.shape == (40, n), "K2 input is 40 rows of 131072")
    got = mad.mad_keep_mask(values, valids, thr)
    want = mad.mad_keep_mask_plain(values, valids, thr)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K2 keep masks bit-equal ({int(want.sum())} kept)")
    t_bound, by = bound_ms(40 * n * (4 + 1 + 1), 40 * n * 37.0)
    rows["mad"] = dict(
        name="mad", route="cuda", source="semantic_depth_tpu_torch/csrc/mad.cu",
        replaces="semantic_depth_tpu/ops/pallas_mad.py:79", max_abs_err=0.0,
        ms=cuda_ms(lambda: mad.mad_keep_mask(values, valids, thr)),
        plain_ms=cuda_ms(lambda: mad.mad_keep_mask_plain(values, valids, thr), iters=10),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        shape="values (40, 131072) f32, valid (40, 131072), thresholds (40,)",
    )

    # --- K3: weighted radius counts at (8, 16384) -------------------------
    log("[phase 3] K3 radius")
    cloud = pcl.from_dense(
        camera.reproject_disparity(scenes["disp"], cfg.camera), scenes["small"], scenes["road"])
    cloud = pcl.keep_beyond(cloud, 2, cfg.road.z_keep_beyond)
    depth_rw = cfg.depth - cfg.rw_depth_offset
    packed, weights = pcl.compact_slab_aware(
        cloud, cfg.road.neighbor_capacity, 2, -(depth_rw + cfg.rw_slab_halfwidth),
        -(depth_rw - cfg.rw_slab_halfwidth))
    xyz = packed.xyz.contiguous()
    pv = packed.valid.contiguous()
    wts = weights.contiguous()
    check(xyz.shape == (8, 16384, 3), "K3 input is (8, 16384) compacted road clouds")
    r = cfg.road.radius
    got = radius.radius_counts(xyz, pv, wts, r)
    got_noskip = radius.radius_counts(xyz, pv, wts, r, skip=False)
    want = radius.radius_counts_plain(xyz, pv, wts, r)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K3 counts bit-equal to the plain version (skip on)")
    check(torch.equal(got_noskip, want), "K3 counts bit-equal with the tile skip off")
    # pairs this data needs: (query tile, candidate tile) pairs the skip keeps
    q, _, _, bz = radius._prepare(xyz, pv, wts, r, True)
    qz = q[..., 2].reshape(8, -1, 128)
    nt = qz.shape[1]
    lo, hi = bz[:, :nt], bz[:, nt:]
    keep = (lo[:, None, :] <= qz.amax(-1)[:, :, None]) & (hi[:, None, :] >= qz.amin(-1)[:, :, None])
    pairs = float(keep.sum()) * 128 * 128
    t_bound, by = bound_ms(8 * 16384 * (12 + 1 + 4 + 4), pairs * 10.0)
    rows["radius"] = dict(
        name="radius", route="cuda", source="semantic_depth_tpu_torch/csrc/radius.cu",
        replaces="semantic_depth_tpu/ops/pallas_exact_knn.py:93", max_abs_err=0.0,
        ms=cuda_ms(lambda: radius.radius_counts(xyz, pv, wts, r)),
        ms_noskip=cuda_ms(lambda: radius.radius_counts(xyz, pv, wts, r, skip=False), iters=5),
        plain_ms=cuda_ms(lambda: radius.radius_counts_plain(xyz, pv, wts, r), iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        pairs_needed=pairs, pairs_all=8 * 16384.0 ** 2,
        shape="xyz (8, 16384, 3) f32, valid (8, 16384), weights (8, 16384), r=0.5",
    )
    for row in rows.values():
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def phase_geometry(dev, scenes, counters):
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    cfg = config.munich_pipeline_config()
    # the geometry tail does not touch the networks: tiny ones will do
    pipe_gpu, pipe_cpu = (
        pipeline.SemanticDepthPipeline(
            cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
            device=d)
        for d in (dev, "cpu")
    )
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    args = [scenes[k] for k in ("small", "road", "fence", "disp")]
    reset_counts(counters)
    with torch.inference_mode():
        out_gpu = pipe_gpu._batch_geometry(*args, cam)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        geom_ms = cuda_ms(lambda: pipe_gpu._batch_geometry(*args, cam), iters=5, warmup=1)
        log(f"  cuda geometry tail: {geom_ms:.3f} ms per batch of 8 (CUDA events, median of 5)")
        t0 = time.time()
        out_cpu = pipe_cpu._batch_geometry(*[a.cpu() for a in args], cam)
        log(f"  cpu geometry tail: {time.time() - t0:.1f} s")
    check(counts == {"knn_grid": 1, "mad": 4, "radius": 1},
          f"geometry launches per batch {counts}")
    rw_g, rw_c = out_gpu.dist_rw.cpu().numpy(), out_cpu.dist_rw.numpy()
    f2f_g, f2f_c = out_gpu.dist_f2f.cpu().numpy(), out_cpu.dist_f2f.numpy()
    log(f"  dist_rw  cuda {rw_g.tolist()}\n  dist_rw  cpu  {rw_c.tolist()}")
    log(f"  dist_f2f cuda {f2f_g.tolist()}\n  dist_f2f cpu  {f2f_c.tolist()}")
    check(np.allclose(rw_g, rw_c, atol=1e-3, rtol=0, equal_nan=True),
          f"dist_rw cuda vs cpu within 1e-3 m (max {np.nanmax(np.abs(rw_g - rw_c)):.2e})")
    check(np.allclose(f2f_g, f2f_c, atol=1e-3, rtol=0, equal_nan=True),
          f"dist_f2f cuda vs cpu within 1e-3 m (max {np.nanmax(np.abs(f2f_g - f2f_c)):.2e})")
    rw_mae = float(np.mean(np.abs(rw_g - scenes["rw_true"])))
    f2f_mae = float(np.mean(np.abs(f2f_g - scenes["f2f_true"])))
    log(f"  rw MAE {rw_mae:.4f} m, f2f MAE {f2f_mae:.4f} m against the analytic scenes")
    check(np.isfinite(rw_mae) and rw_mae < 0.1, f"cuda rw MAE {rw_mae:.4f} m < 0.1 m")
    return dict(rw_mae_m=rw_mae, f2f_mae_m=f2f_mae, launches=counts, cuda_ms=geom_ms)


def phase_end_to_end(dev, counters, n_timed=7):
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    imgs = scene_pool(8, 1024, 2048, seed=3)[0]
    frames = torch.from_numpy(imgs).to(dev)  # uint8 (8, 1024, 2048, 3)
    results = {}
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        log(f"[phase 5] process_batch 8 x 1024x2048 uint8, compute_dtype {dtype_name}")
        cfg = config.munich_pipeline_config(compute_dtype=dtype_name)
        torch.manual_seed(0)
        with torch.device(dev):
            fcn = FCN8s(num_classes=cfg.segmenter.num_classes, compute_dtype=dtype)
            torch.manual_seed(1)
            mono = Monodepth(encoder=cfg.monodepth.encoder, compute_dtype=dtype)
        pipe = pipeline.SemanticDepthPipeline(cfg, fcn, mono, device=dev)
        pipe.process_batch(frames)  # warm-up (cuDNN plans, kernel library load)
        torch.cuda.synchronize()
        reset_counts(counters)
        out = pipe.process_batch(frames)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        check(counts == {"knn_grid": 1, "mad": 4, "radius": 1},
              f"{dtype_name} main-path launches per batch {counts}")
        h, w = cfg.input_height, cfg.input_width
        check(out.disparity.shape == (8, h, w) and out.disparity.dtype == torch.float32,
              "disparity (8, 256, 512) float32")
        check(bool(torch.isfinite(out.disparity).all()), "disparity finite")
        check(out.points3d.shape == (8, h, w, 3), "points3d (8, 256, 512, 3)")
        check(out.road_mask.dtype == torch.bool and out.road_mask.shape == (8, h, w),
              "road mask (8, 256, 512) bool")
        check(out.overlay_small.shape == (8, h, w, 3)
              and float(out.overlay_small.min()) >= 0 and float(out.overlay_small.max()) <= 255,
              "overlay (8, 256, 512, 3) in 0..255")
        check(out.dist_rw.shape == (8,) and out.dist_f2f.shape == (8,), "per-frame distances")
        tensors = [v for v in vars(out).values() if isinstance(v, torch.Tensor)]
        tensors += [out.road_cloud.xyz, out.road_cloud.valid]
        check(all(t.device.type == "cuda" for t in tensors), "every output on cuda")
        times = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            pipe.process_batch(frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        results[dtype_name] = dict(batch_s_median=med, frames_per_s=8.0 / med,
                                   batch_s_all=times, launches=counts)
        log(f"  {dtype_name}: median {med * 1e3:.2f} ms per batch of 8 -> "
            f"{8.0 / med:.2f} frames/s ({n_timed} timed batches)")
        del pipe, fcn, mono, out
        torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device: this smoke run needs one GPU")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from semantic_depth_tpu_torch.ops import _cuda, knn_grid, mad, radius
        from semantic_depth_tpu_torch.runtime import set_full_fp32
    except ImportError as e:
        log(f"FAIL: the port is not importable here ({e})")
        return 2

    t_start = time.time()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("[phase 1] device")
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"  {_run([_cuda._nvcc(), '--version']).splitlines()[-1]}")
    dev = torch.device("cuda")
    set_full_fp32()

    log("[phase 2] build")
    t0 = time.time()
    _cuda.build(log=log)
    _cuda.library()
    build_s = time.time() - t0
    log(f"  kernels built and loaded in {build_s:.1f} s")

    counters = {"knn_grid": knn_grid.knn_mean_distances_grid, "mad": mad.mad_keep_mask,
                "radius": radius.radius_counts}
    log("[phase 3] kernels against their plain versions")
    scenes = scene_batch(8, 256, 512, seed=0, dev=dev)
    with torch.inference_mode():
        rows = phase_kernels(dev, scenes)
    log("[phase 4] geometry tail on analytic scenes, cuda against cpu")
    geom = phase_geometry(dev, scenes, counters)
    e2e = phase_end_to_end(dev, counters)

    for name, row in rows.items():
        row["launches"] = e2e["float32"]["launches"][name]
    summary = dict(card=smi, build_s=build_s, geometry=geom, end_to_end=e2e,
                   kernels=list(rows.values()), wall_s=time.time() - t_start)
    log("summary: " + json.dumps(summary))
    log(f"[done] wall {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
