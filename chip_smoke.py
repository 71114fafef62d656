#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``semantic_depth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or any check fails. Phases:

1. device: card name and power limit, torch / CUDA / nvcc versions, full fp32;
2. build: the hand-written kernels of ``csrc/`` (nvcc, sm_90a), with ptxas
   register and shared-memory lines;
3. kernels against their plain PyTorch versions on the card, at the paths'
   shapes: knn_grid (8, 256, 512) bit-equal, and on grids with valid +-inf
   points (its exact path); mad (the frame program's recorded launches, 40
   rows of 131072 and a streamed row of 2^21) and radius (8, 16384)
   bit-equal, radius with the z-range tile skip on and off, and with
   non-dyadic weights the same on three runs and within rtol 1e-4 of the
   plain version; exact_knn bit-equal (+inf pattern included), with its box
   skip on and off, at (8, 16384) (the exact mode's compacted road clouds),
   (1, 131072) (a whole scene cloud with outliers), on edge frames
   (duplicates, fewer than k valid points, no valid point, nan garbage, a
   ragged capacity) and on a cloud 150-250 m from the origin at cm spacing
   (where the skip margin decides), its preparation kernel's boxes equal to
   ``subtile_boxes``, and the pairs it scanned beside all n^2; median times
   (CUDA events) of kernel and plain version beside the bounds;
4. the geometry tail on analytic scenes (true masks and disparity) on the
   card and on the CPU, in both statistical modes: dist_rw / dist_f2f agree
   within 1e-3 m, rw MAE against the analytic width under 0.1 m, launches
   per batch K1 x1, K2 x4, K3 x1 (grid) and K2 x4, K3 x1, K4 x1 (exact);
5. end to end at full width: full-size FCN-8s/VGG16 and monodepth-vgg with
   seeded random weights, ``process_batch`` on 8 rendered 1024x2048 uint8
   frames in float32 and bfloat16 (grid mode) and bfloat16 (exact mode),
   launch counts, the outputs' devices, frames/s;
6. the other entry points: ``process_frame_staged`` on one 1024x2048 frame
   (its stage times; outputs equal ``process_frame``'s; K2 x5, K3 x1, K4 x1),
   and ``python -m semantic_depth_tpu_torch.utils.outlier_removal`` in a
   subprocess on a PLY of the phase-3 scene cloud, whose output must equal
   the file written from what the plain K4 and K3 versions keep on the
   card; an info line says which image codecs (cv2, PIL, matplotlib) import;
7. the native full-resolution path: K1-K3 at the shapes of the geometry
   tail of two 1024x2048 analytic scenes (K1 on (2, 1024, 2048), K2 on its
   four launches of 2^21-point rows, K3 with the 1/16 pixel-scale weights,
   three runs equal), each bit-equal to its plain version, with times and
   bounds (run within phase 3); the same tail against the CPU plain path on
   one scene within 1e-3 m and its rw MAE; ``process_batch`` of
   ``build_pipeline(native_s2d=True)`` (vgg, full width, bfloat16) on 4
   frames of 1024x2048, launches and frames/s; monodepth-resnet50
   ``process_batch`` (batch 8, float32 and bfloat16) beside phase 5's vgg
   rows, with the vgg path's launches;
8. the CLIs as subprocesses on the card at full width: msgpack weights
   written by ``models.weights.save_params`` from seeded full-width modules
   (under ``chiprun_out/smoke_cli/``, removed afterwards), the single-frame
   CLI with ``--save_data`` (every artifact of the suite) and with
   ``--profile_stages`` (9 rows of stage times), and the sequence CLI over 8
   scene PNGs with ``--batch 4``, then ``--native_s2d`` at 1024x2048 with
   random weights (one overlay PNG and one ``_rw.ply`` a frame); process
   seconds and seconds per frame;
9. the trainers at full width, 256x512, float32, in a temporary directory:
   FCN-8s/VGG16 (fc 4096) one ``train_batch`` on the card against the CPU
   from the same seeded parameters at keep 1.0 (loss, confusion matrix,
   gradients, post-step parameters), 20 steps at the reference
   hyperparameters on a ``make_mockup`` tree with a falling loss, 10 timed
   steps at batch 8; monodepth-vgg the same card-against-CPU step and 20
   steps at batch 8 on seeded stereo pairs (a smoothed base and its 4-px
   shift); no port kernel launches in either; both training CLIs as
   subprocesses (``cli.fcn`` train with ``--inference_flag`` then test on
   the ``fcn8s.msgpack`` it wrote, ``cli.monodepth_train``); the trained
   weights through ``build_pipeline`` and one ``process_batch`` of 8 frames
   (finite outputs, the grid mode's launches), and the reloaded networks'
   forward bit-equal to the trainers'. Step ms, images or pairs per second,
   peak device memory and the CLIs' seconds.

The second-to-last lines are the card's name and power limit and one JSON
object with the kernels' numbers; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / _HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_counters():
    """Each kernel wrapper by its row name; each counts its own launches."""
    from semantic_depth_tpu_torch.ops import exact_knn, knn_grid, mad, radius

    return {"knn_grid": knn_grid.knn_mean_distances_grid, "mad": mad.mad_keep_mask,
            "radius": radius.radius_counts, "exact_knn": exact_knn.knn_mean_distances_exact}


# launches per batch of each path's main run
GRID_LAUNCHES = {"knn_grid": 1, "mad": 4, "radius": 1, "exact_knn": 0}
EXACT_LAUNCHES = {"knn_grid": 0, "mad": 4, "radius": 1, "exact_knn": 1}
STAGED_LAUNCHES = {"knn_grid": 0, "mad": 5, "radius": 1, "exact_knn": 1}


def exact_config(**kw):
    from semantic_depth_tpu_torch import config

    base = config.munich_pipeline_config(**kw)
    return dataclasses.replace(base, road=dataclasses.replace(base.road, stat_mode="exact"))


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
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, cuda_ms_stream

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
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(torch.equal(got, want), f"K1 bit-equal to the plain version (max abs err {err:.3e}, "
          f"{int(fin.sum())} finite of {fin.numel()})")
    # zero disparity back-projects to +-inf (nan on the principal point's
    # row and column): the kernel's exact path keeps topk's nan after +inf
    disp0 = scenes["disp"][:2].clone()
    disp0[0, 150:170, 100:300] = 0.0
    disp0[1, 200:256, :] = 0.0
    pts_inf = camera.reproject_disparity(disp0, cfg.camera).contiguous()
    valid_inf = torch.ones((2, 256, 512), dtype=torch.bool, device=dev)
    valid_inf[1, ::3] = False
    got_inf = knn_grid.knn_mean_distances_grid(pts_inf, valid_inf, 10, (5, 21))
    want_inf = knn_grid.knn_mean_distances_grid_plain(pts_inf, valid_inf, 10, (5, 21))
    torch.cuda.synchronize()
    check(torch.equal(got_inf.isnan(), want_inf.isnan())
          and torch.equal(got_inf.nan_to_num(), want_inf.nan_to_num()),
          f"K1 with valid +-inf points bit-equal ({int(want_inf.isnan().sum())} nan, "
          f"{int(torch.isinf(want_inf[valid_inf]).sum())} +inf among the valid pixels)")
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
    pairs_all = float(valid.sum()) * 5 * 21  # the kernel scores every offset of a valid pixel
    rows["knn_grid"] = dict(
        name="knn_grid", route="cuda", source="semantic_depth_tpu_torch/csrc/knn_grid.cu",
        replaces="semantic_depth_tpu/ops/pallas_knn.py:36", max_abs_err=err,
        ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid(pts, valid, 10, (5, 21))),
        plain_ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid_plain(pts, valid, 10, (5, 21)),
                         iters=5, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        pairs_all=pairs_all, pairs_scanned=pairs_all, pairs_valid=float((cand * valid).sum()),
        ms_scene_frames=cuda_ms(lambda: knn_grid.knn_mean_distances_grid(
            pts[:4], valid[:4], 10, (5, 21))),
        ms_random_frames=cuda_ms(lambda: knn_grid.knn_mean_distances_grid(
            pts[4:], valid[4:], 10, (5, 21))),
        shape="points (8, 256, 512, 3) f32, valid (8, 256, 512), k=10, window (5, 21)",
    )

    # --- K2: MAD keep mask ------------------------------------------------
    log("[phase 3] K2 mad")
    main_mad, main_radius = record_main_path(dev, scenes)
    check([a[0].shape[0] for a in main_mad] == [8, 8, 8, 16]
          and all(a[0].shape[1] == 131072 for a in main_mad),
          "K2 main-path launches recorded: 8, 8, 8 and 16 rows of 131072")
    launches = []
    for values, valids, thr in main_mad:
        thr_rows = mad.threshold_rows(thr, values.shape[0], dev)
        got = mad.mad_keep_mask(values, valids, thr)
        want = mad.mad_keep_mask_plain(values, valids, thr_rows)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 main-path launch of {values.shape[0]} rows, "
              f"thresholds {thr}: bit-equal ({int(want.sum())} kept)")
        out = torch.empty_like(valids)
        launches.append(dict(
            rows=values.shape[0], thresholds=thr,
            ms=cuda_ms(lambda: mad.mad_keep_mask(values, valids, thr)),
            kernel_ms=cuda_ms_stream(lambda: mad._launch(values, valids, thr, out)),
            plain_ms=cuda_ms(lambda: mad.mad_keep_mask_plain(values, valids, thr_rows), iters=5)))
        log("  K2 launch of {rows} rows: wrapper {ms:.4f} ms, kernel {kernel_ms:.4f} ms, "
            "plain {plain_ms:.4f} ms".format(**launches[-1]))
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
    check(values.shape == (40, n), "K2 check input is 40 rows of 131072")
    got = mad.mad_keep_mask(values, valids, thr)
    want = mad.mad_keep_mask_plain(values, valids, thr)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K2 40 rows bit-equal ({int(want.sum())} kept)")
    ms_40 = cuda_ms(lambda: mad.mad_keep_mask(values, valids, thr))
    # one row of 2^21 (the native grid's planes) streams from global memory
    big = torch.cat([scene_pts[:, :, 1].reshape(-1), base.repeat(8)]).reshape(1, -1).contiguous()
    big_ok = torch.cat([scenes["road"].reshape(-1), rnd(0.3).repeat(8)]).reshape(1, -1).contiguous()
    big_thr = torch.full((1,), 15.0, device=dev)
    got = mad.mad_keep_mask(big, big_ok, 15.0)
    torch.cuda.synchronize()
    check(big.shape == (1, 1 << 21) and torch.equal(
        got, mad.mad_keep_mask_plain(big, big_ok, big_thr)), "K2 streamed row of 2^21 bit-equal")
    ms_big = cuda_ms(lambda: mad.mad_keep_mask(big, big_ok, 15.0), iters=10)
    t_bound, by = bound_ms(sum(a[0].numel() for a in main_mad) * (4 + 1 + 1),
                           sum(a[0].numel() for a in main_mad) * 37.0)
    rows["mad"] = dict(
        name="mad", route="cuda", source="semantic_depth_tpu_torch/csrc/mad.cu",
        replaces="semantic_depth_tpu/ops/pallas_mad.py:79", max_abs_err=0.0,
        ms=sum(x["ms"] for x in launches), kernel_ms=sum(x["kernel_ms"] for x in launches),
        plain_ms=sum(x["plain_ms"] for x in launches),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        shape="the frame program's four launches: 8, 8, 8 and 16 rows of 131072 (sums)",
        launches_timed=launches, ms_40_rows=ms_40,
        ms_streamed_row_2_21=ms_big,
    )
    log(f"  K2 40 rows {ms_40:.4f} ms; streamed row of 2^21 {ms_big:.4f} ms")

    # --- K3: weighted radius counts at (8, 16384) -------------------------
    log("[phase 3] K3 radius")
    cloud = pcl.from_dense(
        camera.reproject_disparity(scenes["disp"], cfg.camera), scenes["small"], scenes["road"])
    cloud = pcl.keep_beyond(cloud, 2, cfg.road.z_keep_beyond)
    depth_rw = cfg.depth - cfg.rw_depth_offset
    packed, weights = pcl.compact_slab_aware(
        cloud, cfg.road.neighbor_capacity, 2, -(depth_rw + cfg.rw_slab_halfwidth),
        -(depth_rw - cfg.rw_slab_halfwidth))
    r = cfg.road.radius
    xyz, pv, wts = main_radius[:3]
    check(xyz.shape == (8, 16384, 3) and main_radius[3] == r,
          f"K3 main-path input recorded: (8, 16384), {pv.sum(-1).tolist()} valid")
    empty = pv.clone()
    empty[3] = False  # a frame with no valid row
    for name, args in (("keep_beyond-only clouds", (packed.xyz.contiguous(), packed.valid,
                                                    weights.contiguous())),
                       ("main-path clouds", (xyz, pv, wts)),
                       ("main-path clouds, frame 3 empty", (xyz, empty, wts))):
        want = radius.radius_counts_plain(*args, r)
        got = radius.radius_counts(*args, r)
        got_noskip = radius.radius_counts(*args, r, skip=False)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K3 {name}: counts bit-equal to the plain version")
        check(torch.equal(got_noskip, want), f"K3 {name}: bit-equal with the z-range skip off")
    scratch = torch.empty(radius.scratch_words(8, 16384), device=dev)
    out = torch.empty((8, 16384), device=dev)
    radius._launch(xyz, pv, wts, r, True, scratch, out)
    ranges = scratch[:8 * 2 * (16384 // radius.SUBTILE)].view(8, 2, -1)
    check(torch.equal(ranges, radius.subtile_ranges(xyz, pv, r)),
          "K3 preparation kernel's subtile ranges bit-equal to subtile_ranges")
    # weights that are not dyadic (the frame program's at 384x768, px_scale
    # 2.25): the split sums add in a fixed order, so every run agrees
    w_nd = wts / torch.tensor(2.25, device=dev)
    runs = [radius.radius_counts(xyz, pv, w_nd, r) for _ in range(3)]
    want = radius.radius_counts_plain(xyz, pv, w_nd, r)
    torch.cuda.synchronize()
    err_nd = float((runs[0] - want).abs().max())
    check(all(torch.equal(x, runs[0]) for x in runs)
          and torch.allclose(runs[0], want, rtol=1e-4, atol=0),
          f"K3 non-dyadic weights: three runs equal, within rtol 1e-4 of the plain version's "
          f"blockwise sums (max abs err {err_nd:.3e}, bit-equal {torch.equal(runs[0], want)})")
    pairs, pairs_block = radius_pairs(xyz, pv, r)
    t_bound, by = bound_ms(8 * 16384 * (12 + 1 + 4 + 4), pairs * 10.0)
    rows["radius"] = dict(
        name="radius", route="cuda", source="semantic_depth_tpu_torch/csrc/radius.cu",
        replaces="semantic_depth_tpu/ops/pallas_exact_knn.py:93", max_abs_err=0.0,
        ms=cuda_ms(lambda: radius.radius_counts(xyz, pv, wts, r)),
        kernel_ms=cuda_ms_stream(lambda: radius._launch(xyz, pv, wts, r, True, scratch, out)),
        max_abs_err_non_dyadic=err_nd,
        ms_noskip=cuda_ms(lambda: radius.radius_counts(xyz, pv, wts, r, skip=False), iters=5),
        plain_ms=cuda_ms(lambda: radius.radius_counts_plain(xyz, pv, wts, r), iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, library_ms=None, library_note=_NO_LIBRARY,
        pairs_needed=pairs, bound_ms_block_rule=bound_ms(0, pairs_block * 10.0)[0],
        pairs_block_rule=pairs_block, pairs_all=8 * 16384.0 ** 2,
        shape="the frame program's launch: xyz (8, 16384, 3) f32, valid, weights, r=0.5",
    )
    for row in rows.values():
        log(f"  {row['name']}: wrapper {row['ms']:.4f} ms, kernel {row.get('kernel_ms', row['ms']):.4f} "
            f"ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def record_main_path(dev, scenes):
    """The arguments of every MAD and radius call that one grid-mode
    geometry tail makes on the 8 analytic scenes: the frame program's own
    launches (four MAD calls, one radius call)."""
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.utils.probes import recording_kernel_calls

    cfg = config.munich_pipeline_config()
    pipe = pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=dev)
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    with recording_kernel_calls() as calls:
        pipe._batch_geometry(*[scenes[k] for k in ("small", "road", "fence", "disp")], cam)
    return calls["mad"], calls["radius"][0]


def radius_pairs(xyz, valid, r):
    """The pairs K3's work needs on these clouds: (valid query, valid
    candidate) pairs with |dz| within the widened radius
    sqrt(r^2 + 4e-6 max|p|^2). Beside them, the pairs that the first
    design's skip kept: (128-query block, 128-candidate tile) pairs whose
    z-ranges meet, the rows of invalid queries filled with the frame's first
    valid point."""
    x, y, z = xyz.unbind(-1)
    sq = x * x + y * y + z * z
    zthr = torch.sqrt(float(r) ** 2 + 4e-6 * torch.where(valid, sq, 0.0).amax(-1))
    needed = 0
    for f in range(valid.shape[0]):
        zs = torch.sort(z[f][valid[f]]).values
        lo = torch.searchsorted(zs, zs - zthr[f])
        hi = torch.searchsorted(zs, zs + zthr[f], right=True)
        needed += int((hi - lo).sum())
    b, c = valid.shape
    fill = z.gather(1, valid.int().argmax(-1)[:, None])
    qz = torch.where(valid, z, fill).reshape(b, -1, 128)
    vb = valid.reshape(b, -1, 128)
    zc = z.reshape(b, -1, 128)
    lo = torch.where(vb, zc, float("inf")).amin(-1) - zthr[:, None]
    hi = torch.where(vb, zc, float("-inf")).amax(-1) + zthr[:, None]
    keep = ((lo[:, None, :] <= qz.amax(-1)[:, :, None])
            & (hi[:, None, :] >= qz.amin(-1)[:, :, None]))
    return float(needed), float(keep.sum()) * 128 * 128


def exact_road_clouds(scenes):
    """The exact mode's K4 input: the 8 scenes' road clouds through the
    chain up to the compaction (keep_beyond, MAD y and x, plane cut,
    slab-aware compaction to 16384 slots), as ``_denoise_road`` runs it."""
    from semantic_depth_tpu_torch import camera, config
    from semantic_depth_tpu_torch.ops import pcl

    cfg = config.munich_pipeline_config()
    rc = cfg.road
    cloud = pcl.from_dense(
        camera.reproject_disparity(scenes["disp"], cfg.camera), scenes["small"], scenes["road"])
    cloud = pcl.keep_beyond(cloud, 2, rc.z_keep_beyond)
    cloud = pcl.mad_filter(cloud, rc.mad_y.axis, rc.mad_y.threshold)
    cloud = pcl.mad_filter(cloud, rc.mad_x.axis, rc.mad_x.threshold)
    cloud, _ = pcl.plane_inlier_filter(cloud, rc.plane.axis, rc.plane.threshold)
    depth_rw = cfg.depth - cfg.rw_depth_offset
    packed, _ = pcl.compact_slab_aware(
        cloud, rc.neighbor_capacity, 2, -(depth_rw + cfg.rw_slab_halfwidth),
        -(depth_rw - cfg.rw_slab_halfwidth))
    return packed.xyz.contiguous(), packed.valid.contiguous()


def scene_cloud_with_outliers(scenes, dev):
    """(1, 131072): every point of scene 0's 256x512 cloud, 1% of the rows
    replaced by uniform outliers in a box around the scene."""
    from semantic_depth_tpu_torch import camera, config

    cfg = config.munich_pipeline_config()
    pts = camera.reproject_disparity(scenes["disp"][:1], cfg.camera).reshape(1, -1, 3)
    rgb = scenes["small"][:1].reshape(1, -1, 3)
    g = torch.Generator(device="cpu").manual_seed(4)
    n = pts.shape[1]
    rows = torch.randperm(n, generator=g)[: n // 100].to(dev)
    lo = torch.tensor([-40.0, -10.0, -100.0], device=dev)
    span = torch.tensor([80.0, 20.0, 96.0], device=dev)
    pts = pts.clone()
    pts[0, rows] = lo + span * torch.rand((rows.numel(), 3), generator=g).to(dev)
    return pts.contiguous(), torch.ones((1, n), dtype=torch.bool, device=dev), rgb


def exact_knn_edge_frames(xyz16k, valid16k, dev):
    """(4, 5000), a capacity off every tile: a road cloud with nan on its
    invalid rows, coincident duplicates, 4 < k valid points, none valid."""
    c = 5000
    xyz = xyz16k[:4, :c].clone()
    valid = valid16k[:4, :c].clone()
    xyz[0][~valid[0]] = float("nan")
    valid[1] = True
    xyz[1, :100] = xyz[1, 0]  # 100 coincident points
    xyz[1, 100:400:2] = xyz[1, 101:401:2]  # and 150 pairs
    valid[2] = False
    valid[2, torch.tensor([0, 777, 4096, 4999], device=dev)] = True
    valid[3] = False
    return xyz.contiguous(), valid.contiguous()


def exact_knn_bound(valid, k=10):
    """K4's bound from its inputs alone: reading each point (12 + 1 bytes)
    and writing its mean (4 bytes) once, against the pairs any exact kNN
    computes, each valid query's min(k, n) neighbours (n valid points in its
    frame) at 10 float32 operations a pair (three products and two sums of
    the cross term, the norm sum, the doubling, the subtraction, the clamp
    and the compare). Beside it, for reference only, the same rate over all
    n^2 pairs: the work of a design that computes every pair, which is no
    lower bound. Returns (ms, by, pairs needed, all-pairs ms, all pairs)."""
    n = valid.sum(-1).double()
    needed = float((n * n.clamp(max=k)).sum())
    pairs = float((n * n).sum())
    b, c = valid.shape
    n_bytes = b * c * (12 + 1 + 4)
    return bound_ms(n_bytes, needed * 10.0) + (needed, bound_ms(n_bytes, pairs * 10.0)[0], pairs)


def exact_knn_scanned(xyz, valid):
    """What the kernels did on this input (their own counts, one extra
    launch that no counter sees) and, as a diagnostic beside the bound, the
    time of that work at the card's peak rate: the pairs both walks computed
    d2 for at 10 operations each, each subtile test at 21 operations for
    each of the warp's 64 queries (three gaps of two subtractions and two
    maxima, three squares, two sums, the threshold's three operations and
    the compare), and each loaded subtile's 32 candidate tests at 21. It
    grows with what the design chooses to scan, so it bounds nothing."""
    from semantic_depth_tpu_torch.ops import exact_knn

    b, c = valid.shape
    scratch = torch.empty(exact_knn.scratch_words(b, c, 10), device=xyz.device)
    out = torch.empty((b, c), device=xyz.device)
    exact_knn._launch(xyz, valid, 10, True, scratch, out)
    stats = exact_knn.scratch_stats(scratch)
    sub, grp = exact_knn.scratch_boxes(scratch, b, c)
    want_sub, want_grp = exact_knn.subtile_boxes(xyz, valid)
    boxes_equal = bool(torch.equal(sub, want_sub) and torch.equal(grp, want_grp))
    pairs = float(stats["pairs_near"] + stats["pairs_far"])
    ops = pairs * 10.0 + 21.0 * (64 * stats["subtile_tests"] + 32 * stats["subtiles_loaded"])
    return bound_ms(b * c * (12 + 1 + 4), ops) + (pairs, stats, boxes_equal)


def far_cloud(dev):
    """(1, 9600): a 48 x 200 grid at cm spacing about 150-250 m from the
    origin, 90% valid: the Gram identity's float32 error is far above the
    spacing there, and the skip margin decides what may be skipped."""
    g = torch.Generator(device="cpu").manual_seed(5)
    ys, xs = torch.meshgrid(torch.arange(48.0), torch.arange(200.0), indexing="ij")
    grid = torch.stack([xs * 0.01, torch.randn((48, 200), generator=g) * 0.002, ys * 0.01], -1)
    xyz = grid.reshape(1, -1, 3) + torch.tensor([120.0, -80.0, -150.0])
    return xyz.to(dev).contiguous(), (torch.rand((1, 48 * 200), generator=g) < 0.9).to(dev)


def phase_exact_knn(dev, scenes):
    from semantic_depth_tpu_torch.ops import exact_knn
    from semantic_depth_tpu_torch.utils.probes import cuda_ms

    log("[phase 3] K4 exact_knn")
    knn = exact_knn.knn_mean_distances_exact
    plain = exact_knn.knn_mean_distances_exact_plain
    xyz, valid = exact_road_clouds(scenes)
    check(xyz.shape == (8, 16384, 3), "K4 input is (8, 16384) compacted road clouds "
          f"({valid.sum(-1).tolist()} valid)")
    big_xyz, big_valid, big_rgb = scene_cloud_with_outliers(scenes, dev)
    check(big_xyz.shape == (1, 131072, 3), "K4 input is (1, 131072) scene cloud with outliers")
    edge_xyz, edge_valid = exact_knn_edge_frames(xyz, valid, dev)
    far_xyz, far_valid = far_cloud(dev)
    shapes = {}
    for name, (x, v) in (("road (8, 16384)", (xyz, valid)),
                         ("scene (1, 131072)", (big_xyz, big_valid)),
                         ("edge frames (4, 5000)", (edge_xyz, edge_valid)),
                         ("far from the origin (1, 9600)", (far_xyz, far_valid))):
        got = knn(x, v, 10)
        got_noskip = knn(x, v, 10, skip=False)
        want = plain(x, v, 10)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), torch.isinf(want))
              and bool(torch.isfinite(got[v]).all()),
              f"K4 {name}: +inf pattern equal to the plain version's, valid rows finite")
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
        check(torch.equal(got, want), f"K4 {name}: bit-equal to the plain version "
              f"(max abs err {err}, {int(fin.sum())} finite)")
        check(torch.equal(got_noskip, want), f"K4 {name}: bit-equal with the box skip off")
        t_bound, by, pairs_needed, t_all, pairs_all = exact_knn_bound(v)
        t_scan, _, pairs_scanned, stats, boxes_equal = exact_knn_scanned(x, v)
        check(boxes_equal, f"K4 {name}: preparation kernel's boxes equal subtile_boxes")
        log(f"  K4 {name}: {pairs_scanned:.4g} pairs scanned of {pairs_all:.4g} ({stats})")
        if name.startswith("edge"):
            check(bool(torch.isinf(got[3]).all()) and bool(torch.isfinite(got[v]).all())
                  and float(got[1, :100].max()) == 0.0,
                  "K4 edge frames: no valid point -> +inf; duplicates at 0; 4 < k points finite")
        if name.startswith(("edge", "far")):
            continue
        iters = 20 if x.shape[1] <= 16384 else 5
        shapes[name] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: knn(x, v, 10), iters=iters),
            ms_noskip=cuda_ms(lambda: knn(x, v, 10, skip=False), iters=3, warmup=1),
            plain_ms=cuda_ms(lambda: plain(x, v, 10), iters=3 if iters == 20 else 2, warmup=1),
            bound_ms=t_bound, bound_by=by, pairs_needed=pairs_needed,
            bound_ms_all_pairs=t_all, pairs_all=pairs_all, scanned_work_ms=t_scan,
            pairs_scanned=pairs_scanned, counts=stats)
        log(f"  K4 {name}: kernel {shapes[name]['ms']:.4f} ms (skip off "
            f"{shapes[name]['ms_noskip']:.4f}), plain {shapes[name]['plain_ms']:.4f} ms, bound "
            f"{t_bound:.4f} ms ({by}); all pairs at the peak rate {t_all:.4f} ms, "
            f"the scanned work at the peak rate {t_scan:.4f} ms")
    main = shapes["road (8, 16384)"]
    row = dict(
        name="exact_knn", route="cuda", source="semantic_depth_tpu_torch/csrc/exact_knn.cu",
        replaces="semantic_depth_tpu/ops/pallas_exact_knn.py:32",
        max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], pairs_needed=main["pairs_needed"],
        bound_ms_all_pairs=main["bound_ms_all_pairs"], pairs_all=main["pairs_all"],
        scanned_work_ms=main["scanned_work_ms"], pairs_scanned=main["pairs_scanned"],
        library_ms=None, library_note=_NO_LIBRARY,
        shape="xyz (8, 16384, 3) f32, valid (8, 16384), k=10", shapes=shapes,
    )
    return row, (big_xyz, big_valid, big_rgb)


def phase_geometry(dev, scenes, counters, stat_mode="grid"):
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, sync_debug

    log(f"[phase 4] geometry tail, stat_mode {stat_mode!r}")
    cfg = exact_config() if stat_mode == "exact" else config.munich_pipeline_config()
    expected = EXACT_LAUNCHES if stat_mode == "exact" else GRID_LAUNCHES
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
        try:
            with sync_debug("error"):
                pipe_gpu._batch_geometry(*args, cam)
                torch.cuda.synchronize()
        except RuntimeError as e:
            raise SmokeFailure(f"a host sync in the MAD or radius filters: {e}") from e
        check(True, f"{stat_mode} geometry tail: no host sync in the MAD and radius filters "
              "(torch.cuda.set_sync_debug_mode('error'))")
        geom_ms = cuda_ms(lambda: pipe_gpu._batch_geometry(*args, cam), iters=5, warmup=1)
        log(f"  cuda geometry tail: {geom_ms:.3f} ms per batch of 8 (CUDA events, median of 5)")
        t0 = time.time()
        out_cpu = pipe_cpu._batch_geometry(*[a.cpu() for a in args], cam)
        cpu_s = time.time() - t0
        log(f"  cpu geometry tail: {cpu_s:.1f} s")
    check(counts == expected, f"{stat_mode} geometry launches per batch {counts}")
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
    kept = out_gpu.road_cloud.valid.sum(-1).tolist()
    log(f"  road points kept per frame: {kept}")
    return dict(rw_mae_m=rw_mae, f2f_mae_m=f2f_mae, launches=counts, cuda_ms=geom_ms,
                cpu_s=cpu_s, max_cuda_cpu_rw_m=float(np.nanmax(np.abs(rw_g - rw_c))),
                max_cuda_cpu_f2f_m=float(np.nanmax(np.abs(f2f_g - f2f_c))), road_kept=kept)


def full_pipeline(dev, dtype_name, stat_mode, encoder="vgg"):
    """Full-size FCN-8s/VGG16 and monodepth (vgg or resnet50) with seeded
    random weights."""
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.cli.common import apply_encoder_override
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    cfg = (exact_config if stat_mode == "exact" else config.munich_pipeline_config)(
        compute_dtype=dtype_name)
    cfg = apply_encoder_override(cfg, encoder)
    torch.manual_seed(0)
    with torch.device(dev):
        fcn = FCN8s(num_classes=cfg.segmenter.num_classes, compute_dtype=dtype)
        torch.manual_seed(1)
        mono = Monodepth(encoder=cfg.monodepth.encoder, compute_dtype=dtype)
    return pipeline.SemanticDepthPipeline(cfg, fcn, mono, device=dev)


def phase_end_to_end(dev, counters, frames, n_timed=7, runs=None):
    results = {}
    runs = runs or (("float32", "float32", "grid", "vgg"),
                    ("bfloat16", "bfloat16", "grid", "vgg"),
                    ("bfloat16_exact", "bfloat16", "exact", "vgg"))
    for key, dtype_name, stat_mode, encoder in runs:
        log(f"[phase {5 if encoder == 'vgg' else 7}] process_batch 8 x 1024x2048 uint8, "
            f"monodepth {encoder}, compute_dtype {dtype_name}, stat_mode {stat_mode!r}")
        pipe = full_pipeline(dev, dtype_name, stat_mode, encoder)
        cfg = pipe.config
        pipe.process_batch(frames)  # warm-up (cuDNN plans, kernel library load)
        torch.cuda.synchronize()
        reset_counts(counters)
        out = pipe.process_batch(frames)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        expected = EXACT_LAUNCHES if stat_mode == "exact" else GRID_LAUNCHES
        check(counts == expected, f"{key} main-path launches per batch {counts}")
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
        devices = sorted({str(t.device) for t in tensors})
        check(all(t.device.type == "cuda" for t in tensors), f"every output on cuda {devices}")
        times = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            pipe.process_batch(frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        results[key] = dict(batch_s_median=med, frames_per_s=8.0 / med, batch_s_all=times,
                            launches=counts, output_devices=devices,
                            road_points_kept=out.road_cloud.valid.sum(-1).tolist())
        log(f"  {key}: median {med * 1e3:.2f} ms per batch of 8 -> "
            f"{8.0 / med:.2f} frames/s ({n_timed} timed batches)")
        del pipe, out
        torch.cuda.empty_cache()
    return results


def _outputs_mismatch(a, b):
    """Names of the FrameOutputs fields that differ (nan equal to nan)."""
    from semantic_depth_tpu_torch.ops import pcl

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = ([(getattr(x, n), getattr(y, n)) for n in ("xyz", "rgb", "valid")]
                 if isinstance(x, pcl.MaskedCloud) else [(x, y)])
        for u, v in pairs:
            if not (u.shape == v.shape and torch.equal(u.isnan(), v.isnan())
                    and torch.equal(u.nan_to_num(), v.nan_to_num())):
                bad.append(f.name)
    return bad


def phase_staged(dev, counters, frame):
    log("[phase 6] process_frame_staged, one 1024x2048 frame, bfloat16, stat_mode 'exact'")
    pipe = full_pipeline(dev, "bfloat16", "exact")
    pipe.process_frame_staged(frame)  # its first call per shape warms every stage up
    reset_counts(counters)
    t0 = time.perf_counter()
    staged, times = pipe.process_frame_staged(frame)
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    check(counts == STAGED_LAUNCHES, f"staged launches per frame {counts}")
    check(set(times) == {"read", "semantic", "disparity", "to3D", "road", "rw", "fences", "f2f"},
          "staged times carry the JAX keys")
    log("  stage ms: " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items())
        + f"; wall {wall * 1e3:.3f}")
    fused = pipe.process_frame(frame)
    torch.cuda.synchronize()
    bad = _outputs_mismatch(staged, fused)
    check(not bad, f"staged outputs equal process_frame's (differ: {bad})")
    check(staged.disparity.device.type == "cuda" and staged.road_cloud.valid.is_cuda,
          "staged outputs on cuda")
    del pipe
    torch.cuda.empty_cache()
    return dict(times_s=times, wall_s=wall, launches=counts)


def phase_outlier_removal(dev, cloud):
    """The CLI in a subprocess against the plain K4 + K3 chain on the card."""
    from semantic_depth_tpu_torch.io.ply import PlyCloud, read_ply
    from semantic_depth_tpu_torch.ops import exact_knn, neighbors, radius
    from semantic_depth_tpu_torch.utils.outlier_removal import filter_ply
    from semantic_depth_tpu_torch.utils.probes import cuda_ms

    log("[phase 6] outlier_removal entry point on the (1, 131072) scene cloud")
    repo = os.path.dirname(os.path.abspath(__file__))
    xyz, _, rgb = cloud
    with tempfile.TemporaryDirectory() as tmp:
        src = PlyCloud(xyz[0].cpu().numpy(), rgb[0].cpu().numpy(),
                       os.path.join(tmp, "scene")).save()
        out = os.path.join(tmp, "inliers.ply")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "semantic_depth_tpu_torch.utils.outlier_removal", src,
             "--out", out], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=600)
        sub_s = time.time() - t0
        log("  " + "\n  ".join(proc.stdout.strip().splitlines()[-5:]))
        check(proc.returncode == 0, f"outlier_removal subprocess exits 0 ({sub_s:.1f} s)")

        # the same cloud as filter_ply builds it, through the plain versions
        pts, cols = read_ply(src)
        n = pts.shape[0]
        cap = 1 << max(10, (n - 1).bit_length())
        x = np.zeros((cap, 3), np.float32)
        rgb_np = np.zeros((cap, 3), np.float32)
        x[:n], rgb_np[:n] = pts, cols
        xt = torch.from_numpy(x)[None].to(dev)
        vt = (torch.arange(cap) < n)[None].to(dev)

        def chain(knn, counts):
            """filter_ply's two filters at its defaults, unweighted radius."""
            keep = neighbors._statistical_keep(knn(xt, vt, 10), vt, 0.5)
            return keep & (counts(xt, keep, keep.float(), 0.5) > 80)

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        keep = chain(exact_knn.knn_mean_distances_exact_plain,
                     radius.radius_counts_plain)[0].cpu().numpy()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        want = PlyCloud(x[keep], rgb_np[keep], os.path.join(tmp, "plain")).save()
        with open(out, "rb") as a, open(want, "rb") as b:
            same = a.read() == b.read()
        check(same, f"the CLI keeps what the plain K4 + K3 versions keep on the card "
              f"({int(keep.sum())} of {n} points)")
        kernel_ms = cuda_ms(
            lambda: chain(exact_knn.knn_mean_distances_exact, radius.radius_counts), iters=5,
            warmup=1)
        t0 = time.perf_counter()
        filter_ply(src, os.path.join(tmp, "again.ply"))
        inproc_s = time.perf_counter() - t0
    log(f"  CLI subprocess {sub_s:.2f} s; filter_ply in process {inproc_s * 1e3:.1f} ms; "
        f"K4 + K3 chain {kernel_ms:.3f} ms on the kernels, {plain_ms:.1f} ms on the plain "
        f"versions (capacity {cap}, {n} points read)")
    return dict(points=n, capacity=cap, kept=int(keep.sum()), subprocess_s=sub_s,
                filter_ply_in_process_s=inproc_s, kernel_chain_ms=kernel_ms,
                plain_chain_ms=plain_ms)


def native_config(**kw):
    """munich_pipeline_config at the native full resolution 1024x2048."""
    from semantic_depth_tpu_torch import config

    return config.munich_pipeline_config(input_height=1024, input_width=2048, **kw)


def knn_grid_bound(valid):
    """K1's bound on these inputs (phase 3's rule): each point read and each
    mean written once; each (valid pixel, valid candidate) pair at 28
    operations plus 21 a valid pixel for its selection."""
    b, h, w = valid.shape
    cand = torch.nn.functional.conv2d(
        valid.float()[:, None], torch.ones((1, 1, 5, 21), device=valid.device),
        padding=(2, 10))[:, 0]
    n_ops = float((cand * valid).sum()) * 28.0 + float(valid.sum()) * 21.0
    return bound_ms(b * h * w * (12 + 1 + 4), n_ops)


def phase_native_kernels(dev):
    """K1-K3 at the native path's own launches: the geometry tail of two
    1024x2048 analytic scenes, recorded, each call against its plain
    version; then the same tail on the CPU plain path for one scene."""
    from semantic_depth_tpu_torch import pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.ops import knn_grid, mad, radius
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, recording_kernel_calls

    log("[phase 3] native shapes: the geometry tail of two 1024x2048 analytic scenes")
    scenes = scene_batch(2, 1024, 2048, seed=7, dev=dev)
    cfg = native_config()
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    args = [scenes[k] for k in ("small", "road", "fence", "disp")]
    # the geometry tail does not touch the networks: tiny ones will do
    pipes = {d: pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=d)
        for d in (dev, "cpu")}
    with torch.inference_mode(), recording_kernel_calls() as calls:
        out = pipes[dev]._batch_geometry(*args, cam)
    torch.cuda.synchronize()
    rows = {}

    (pts, valid, k, window), = calls["knn_grid"]
    check(tuple(pts.shape) == (2, 1024, 2048, 3), "K1 native launch: points (2, 1024, 2048, 3)")
    got = knn_grid.knn_mean_distances_grid(pts, valid, k, window)
    want = knn_grid.knn_mean_distances_grid_plain(pts, valid, k, window)
    torch.cuda.synchronize()
    check(torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(),
                                                                 want.nan_to_num()),
          f"K1 native (2, 1024, 2048) bit-equal to the plain version "
          f"({int(torch.isfinite(want).sum())} finite)")
    t_bound, by = knn_grid_bound(valid)
    rows["knn_grid"] = dict(
        shape="points (2, 1024, 2048, 3), k=10, window (5, 21)",
        ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid(pts, valid, k, window)),
        plain_ms=cuda_ms(lambda: knn_grid.knn_mean_distances_grid_plain(pts, valid, k, window),
                         iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, max_abs_err=0.0)

    shapes = [tuple(a[0].shape) for a in calls["mad"]]
    check(shapes == [(2, 1 << 21)] * 3 + [(4, 1 << 21)],
          f"K2 native launches recorded: {shapes}")
    launches = []
    for values, valids, thr in calls["mad"]:
        thr_rows = mad.threshold_rows(thr, values.shape[0], dev)
        got = mad.mad_keep_mask(values, valids, thr)
        want = mad.mad_keep_mask_plain(values, valids, thr_rows)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 native launch of {values.shape[0]} rows of 2^21, "
              f"thresholds {thr}: bit-equal ({int(want.sum())} kept)")
        launches.append(dict(
            rows=values.shape[0], thresholds=thr,
            ms=cuda_ms(lambda: mad.mad_keep_mask(values, valids, thr), iters=10),
            plain_ms=cuda_ms(lambda: mad.mad_keep_mask_plain(values, valids, thr_rows),
                             iters=3, warmup=1)))
    n_vals = sum(a[0].numel() for a in calls["mad"])
    t_bound, by = bound_ms(n_vals * (4 + 1 + 1), n_vals * 37.0)
    rows["mad"] = dict(shape="the native tail's four launches: 2, 2, 2 and 4 rows of 2^21 (sums)",
                       ms=sum(x["ms"] for x in launches),
                       plain_ms=sum(x["plain_ms"] for x in launches),
                       bound_ms=t_bound, bound_by=by, max_abs_err=0.0, launches_timed=launches)

    (xyz, pv, wts, r), = calls["radius"]
    dyadic = bool((wts[pv] * 16 == torch.round(wts[pv] * 16)).all())
    check(tuple(xyz.shape) == (2, 16384, 3) and dyadic,
          f"K3 native launch: (2, 16384), weights in 1/16 steps, {pv.sum(-1).tolist()} valid")
    runs = [radius.radius_counts(xyz, pv, wts, r) for _ in range(3)]
    want = radius.radius_counts_plain(xyz, pv, wts, r)
    torch.cuda.synchronize()
    check(all(torch.equal(x, runs[0]) for x in runs) and torch.equal(runs[0], want),
          "K3 native: three runs equal, bit-equal to the plain version")
    pairs, _ = radius_pairs(xyz, pv, r)
    t_bound, by = bound_ms(2 * 16384 * (12 + 1 + 4 + 4), pairs * 10.0)
    rows["radius"] = dict(
        shape="xyz (2, 16384, 3), weights / 16, r=0.5",
        ms=cuda_ms(lambda: radius.radius_counts(xyz, pv, wts, r)),
        plain_ms=cuda_ms(lambda: radius.radius_counts_plain(xyz, pv, wts, r), iters=3, warmup=1),
        bound_ms=t_bound, bound_by=by, max_abs_err=0.0, pairs_needed=pairs)
    for name, row in rows.items():
        log(f"  {name} native: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")

    t0 = time.time()
    with torch.inference_mode():
        out_cpu = pipes["cpu"]._batch_geometry(*[a[:1].cpu() for a in args], cam)
    cpu_s = time.time() - t0
    rw_g, f2f_g = out.dist_rw.cpu().numpy(), out.dist_f2f.cpu().numpy()
    rw_c, f2f_c = out_cpu.dist_rw.numpy(), out_cpu.dist_f2f.numpy()
    log(f"  native tail: dist_rw cuda {rw_g.tolist()} cpu {rw_c.tolist()}; dist_f2f cuda "
        f"{f2f_g.tolist()} cpu {f2f_c.tolist()} (CPU {cpu_s:.1f} s for one scene)")
    check(np.allclose(rw_g[:1], rw_c, atol=1e-3, rtol=0, equal_nan=True)
          and np.allclose(f2f_g[:1], f2f_c, atol=1e-3, rtol=0, equal_nan=True),
          "native tail: scene 0 on the card within 1e-3 m of the CPU plain path")
    rw_mae = float(np.mean(np.abs(rw_g - scenes["rw_true"])))
    check(np.isfinite(rw_mae) and rw_mae < 0.1, f"native tail: rw MAE {rw_mae:.4f} m < 0.1 m")
    geometry = dict(rw_mae_m=rw_mae, f2f_mae_m=float(np.mean(np.abs(f2f_g - scenes["f2f_true"]))),
                    max_cuda_cpu_rw_m=float(np.nanmax(np.abs(rw_g[:1] - rw_c))),
                    cpu_s_one_scene=cpu_s)
    return rows, geometry


def phase_native_end_to_end(dev, counters, frames, n_timed=7):
    """``build_pipeline(native_s2d=True)``: the input_s2d networks at full
    width on 1024x2048 frames, bfloat16, no flip-average pass."""
    from semantic_depth_tpu_torch.cli.common import build_pipeline

    log("[phase 7] native process_batch 4 x 1024x2048 uint8, vgg, bfloat16")
    pipe = build_pipeline(native_config(compute_dtype="bfloat16"), "random", "random",
                          native_s2d=True, device=dev)
    check(pipe.fcn.input_s2d and pipe.mono.input_s2d
          and pipe.config.monodepth.flip_average is False,
          "native pipeline: input_s2d networks, flip-average off")
    batch = frames[:4]
    pipe.process_batch(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts(counters)
    out = pipe.process_batch(batch)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    check(counts == GRID_LAUNCHES, f"native launches per batch {counts}")
    check(out.disparity.shape == (4, 1024, 2048) and bool(torch.isfinite(out.disparity).all()),
          "native disparity (4, 1024, 2048) finite")
    check(out.points3d.shape == (4, 1024, 2048, 3) and out.road_cloud.xyz.shape == (4, 16384, 3),
          "native points3d (4, 1024, 2048, 3), road cloud (4, 16384)")
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        pipe.process_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  native: median {med * 1e3:.2f} ms per batch of 4 -> {4.0 / med:.2f} frames/s")
    del pipe, out
    torch.cuda.empty_cache()
    return dict(batch_s_median=med, frames_per_s=4.0 / med, batch_s_all=times, launches=counts)


def _run_cli(name, args, repo, cwd=None):
    """One CLI as a subprocess on the card, run in ``cwd`` (the repo by
    default); its failure fails the run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd or repo, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    secs = time.time() - t0
    log(f"  {name}: {secs:.2f} s as a process\n    "
        + "\n    ".join(proc.stdout.strip().splitlines()[-3:]))
    check(proc.returncode == 0, f"{name} exits 0")
    return secs, proc.stdout


def phase_clis(dev, frames):
    """Both CLIs as subprocesses at full width, on msgpack weights written by
    the port's save_params from seeded full-width modules."""
    import cv2

    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.models.from_flax import flax_from_module
    from semantic_depth_tpu_torch.models.weights import save_params

    log("[phase 8] the CLIs as subprocesses on the card")
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "chiprun_out", "smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    wdir, fdir = os.path.join(work, "weights"), os.path.join(work, "frames")
    os.makedirs(wdir)
    os.makedirs(fdir)
    try:
        t0 = time.time()
        with torch.device(dev):
            torch.manual_seed(0)
            fcn = FCN8s()
            torch.manual_seed(1)
            mono = Monodepth()
        save_params(flax_from_module(fcn), os.path.join(wdir, "fcn8s.msgpack"))
        save_params(flax_from_module(mono), os.path.join(wdir, "monodepth.msgpack"))
        del fcn, mono
        write_s = time.time() - t0
        mb = sum(os.path.getsize(os.path.join(wdir, f)) for f in os.listdir(wdir)) / 2**20
        log(f"  weights written in {write_s:.1f} s ({mb:.0f} MiB)")
        paths = []
        for i, img in enumerate(frames.cpu().numpy()):
            paths.append(os.path.join(fdir, f"scene_{i}.png"))
            cv2.imwrite(paths[-1], img)
        sd = "semantic_depth_tpu_torch.cli.semantic_depth"
        seq = "semantic_depth_tpu_torch.cli.sequence"
        weights = ["--semantic_model", wdir, "--monodepth_checkpoint", wdir]
        res = {}

        single = os.path.join(work, "single")
        secs, _ = _run_cli("single frame --save_data", [sd, "--input_frame", paths[0], *weights,
                                                         "--save_data", "--results_dir", single],
                           repo)
        base = os.path.join(single, "scene_0", "scene_0_output")
        suffixes = [".png", "_only_segmentation.png", "_disp.png", "_road_mask.png",
                    "_fence_mask.png", "_raw.ply", "_pointCloud.npz", "_ROAD.ply", "_ALL.ply",
                    "_times.txt", "_distances.txt"]
        missing = [s for s in suffixes if not os.path.exists(base + s)]
        check(not missing, f"single frame: every artifact of the suite written (missing {missing})")
        dist = [float(ln.split(":")[1]) for ln in open(base + "_distances.txt").read().splitlines()]
        check(len(dist) == 2, f"single frame: _distances.txt parses ({dist})")
        t_global = float(open(base + "_times.txt").read().splitlines()[-1].split(":")[1])
        res["single_save_data"] = dict(process_s=secs, frame_s=t_global, distances=dist)

        staged = os.path.join(work, "staged")
        secs, _ = _run_cli("single frame --profile_stages",
                           [sd, "--input_frame", paths[1], *weights, "--profile_stages",
                            "--results_dir", staged], repo)
        rows = open(os.path.join(staged, "scene_1", "scene_1_output_times.txt")).read()
        times = {ln.split(":")[0]: float(ln.split(":")[1]) for ln in rows.splitlines()}
        check(len(times) == 9 and all(times[f"Time {k}"] > 0 for k in
                                      ("semantic", "disparity", "to3D", "road", "rw", "global")),
              f"--profile_stages: 9 rows, stage times nonzero ({times})")
        res["single_profile_stages"] = dict(process_s=secs, times_s=times)

        for key, extra in (("sequence_batch4", weights),
                           ("sequence_native_batch4",
                            ["--native_s2d", "--input_height", "1024", "--input_width", "2048",
                             "--semantic_model", "random", "--monodepth_checkpoint", "random"])):
            out_dir = os.path.join(work, key)
            secs, text = _run_cli(key, [seq, "--input_folder", os.path.join(fdir, "*.png"),
                                        *extra, "--batch", "4", "--results_dir", out_dir,
                                        "--output_name", "seq"], repo)
            imgs = sorted(os.listdir(os.path.join(out_dir, "seq", "result_sequence_imgs")))
            plys = sorted(os.listdir(os.path.join(out_dir, "seq", "result_sequence_ply")))
            check(imgs == [f"scene_{i}.png" for i in range(8)]
                  and plys == [f"scene_{i}_rw.ply" for i in range(8)],
                  f"{key}: one overlay PNG and one _rw.ply a frame")
            summary = text.strip().splitlines()[-1].split()
            res[key] = dict(process_s=secs, loop_s=float(summary[3]),
                            frame_s=float(summary[3]) / 8.0, process_frame_s=secs / 8.0)
        res["weights_write_s"] = write_s
        res["weights_mib"] = mb
    finally:
        shutil.rmtree(work, ignore_errors=True)  # 660 MB of weights: none of it kept
    return res


def _card_against_cpu(name, make_trainer, model, batch, lr):
    """One train step from the same parameters on the card and on the CPU:
    the losses within rel 1e-4, the gradients within 1e-3 of their norm
    (all parameters together) and 1e-2 of it in each parameter, the
    post-step parameters within 1% of lr where |g| > 1e-4 of the model's
    largest (``probes.train_step_agreement``)."""
    import copy

    from semantic_depth_tpu_torch.utils.probes import train_step_agreement

    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    card = make_trainer(copy.deepcopy(model), "cuda")
    t0 = time.perf_counter()
    got = card.train_batch(*batch)
    card_s = time.perf_counter() - t0
    cpu = make_trainer(model, "cpu")
    t0 = time.perf_counter()
    want = cpu.train_batch(*batch)
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want if k not in ("cm", "iou")}
    check(all(v <= 1e-4 for v in rel.values()),
          f"{name}: card step losses within rel 1e-4 of the CPU's ({rel})")
    agree = train_step_agreement(cpu, card, before, lr)
    check(agree["grad_rel"] < 1e-3 and agree["grad_rel_param"] < 1e-2
          and agree["step_err_lr"] < 1e-2 and agree["moved"] > 0.99,
          f"{name}: card gradients and post-step parameters agree with the CPU's ({agree})")
    out = dict(loss_card=got["loss"], loss_cpu=want["loss"], rel_err=rel,
               first_step_card_s=card_s, step_cpu_s=cpu_s, **agree)
    if "cm" in want:
        off = float(np.abs(got["cm"] - want["cm"]).sum() / 2 / want["cm"].sum())
        check(off <= 1e-3, f"{name}: confusion matrices differ on {off:.2e} of the pixels "
              "(at most 1e-3)")
        out["cm_pixels_off"] = off
    del card, cpu
    torch.cuda.empty_cache()
    return out


def _timed_steps(trainer, batches, n):
    """Wall seconds of each of ``n`` steps (a step ends in a host read of its
    loss), the losses, and the peak device memory over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(trainer.train_batch(*batch)["loss"])
        times.append(time.perf_counter() - t0)
        if len(times) == n:
            break
    return times, losses, torch.cuda.max_memory_allocated()


def _falls(name, losses):
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(np.isfinite(losses).all() and last < first,
          f"{name}: mean loss of the last 3 steps {last:.5f} below the first 3's {first:.5f}")


def phase_trainers(dev, counters, frames):
    """Both trainers at full width, their CLIs, and their weights served."""
    import cv2

    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import TrainConfig, munich_pipeline_config
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.train.data import SegmentationDataset
    from semantic_depth_tpu_torch.train.monodepth_trainer import (
        MonodepthTrainConfig, MonodepthTrainer)
    from semantic_depth_tpu_torch.train.trainer import FCNTrainer
    from semantic_depth_tpu_torch.utils.make_mockup import make_mockup

    repo = os.path.dirname(os.path.abspath(__file__))
    res = dict(fcn={}, monodepth={})
    with tempfile.TemporaryDirectory() as tmp:
        make_mockup(os.path.join(tmp, "data"), counts=(8, 2, 2), hw=(256, 512), seed=0)
        ds = SegmentationDataset(os.path.join(tmp, "data"), "roborace_mockup", seed=0)
        reset_counts(counters)

        log("[phase 9] FCN-8s/VGG16 full width (fc 4096), 256x512, float32")
        cfg = TrainConfig()  # the reference's: lr 1e-5, batch 1, keep 0.5
        model = FCN8s(dropout_keep_prob=1.0, generator=torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params > 134e6, f"FCN-8s at full width: {n_params} parameters")
        test_batch = next(iter(ds.batches(1, mode="test", prefetch=0)))  # draws nothing
        res["fcn"]["card_vs_cpu"] = _card_against_cpu(
            "FCN-8s", lambda m, d: FCNTrainer(cfg, model=m, device=d), model, test_batch,
            cfg.learning_rate)
        del model
        fcn = FCNTrainer(cfg, seed=0, device=dev)

        def epochs(batch_size):
            while True:
                yield from ds.batches(batch_size, mode="train")

        times, losses, _ = _timed_steps(fcn, epochs(1), 20)
        _falls("FCN-8s, 20 steps at batch 1", losses)
        batch8 = next(iter(ds.batches(8, mode="train", prefetch=0)))
        fcn.train_batch(*batch8)  # cuDNN picks its algorithms for batch 8
        times8, losses8, peak = _timed_steps(fcn, iter(lambda: batch8, None), 10)
        med = statistics.median(times8)
        res["fcn"].update(params=n_params, losses_batch1=losses, step_s_batch1=times,
                          step_ms_batch1_median=statistics.median(times[1:]) * 1e3,
                          step_ms_batch8_median=med * 1e3, images_per_s_batch8=8 / med,
                          step_s_batch8=times8, losses_batch8=losses8,
                          peak_mem_gib_batch8=peak / 2**30)
        log(f"  FCN-8s: batch 1 {res['fcn']['step_ms_batch1_median']:.2f} ms a step; "
            f"batch 8 {med * 1e3:.2f} ms a step, {8 / med:.2f} images/s, peak "
            f"{peak / 2**30:.2f} GiB")
        fcn_path = fcn.save_msgpack(os.path.join(tmp, "fcn8s.msgpack"))

        log("[phase 9] monodepth-vgg full width, 256x512, batch 8, float32")
        rng = np.random.default_rng(0)
        base = rng.uniform(0, 1, (8, 256, 512, 3)).astype(np.float32)
        for _ in range(2):  # smoothed, so the photometric loss has gradients toward alignment
            base[:, :, 1:-1] = (base[:, :, :-2] + base[:, :, 1:-1] + base[:, :, 2:]) / 3
            base[:, 1:-1] = (base[:, :-2] + base[:, 1:-1] + base[:, 2:]) / 3
        pair = (base, np.roll(base, -4, axis=2))
        mcfg = MonodepthTrainConfig()
        res["monodepth"]["card_vs_cpu"] = _card_against_cpu(
            "monodepth", lambda m, d: MonodepthTrainer(mcfg, model=m, device=d),
            Monodepth(generator=torch.Generator().manual_seed(1)), pair, mcfg.learning_rate)
        mono = MonodepthTrainer(mcfg, seed=1, device=dev)
        mono.train_batch(*pair)  # cuDNN picks its algorithms
        times, losses, peak = _timed_steps(mono, iter(lambda: pair, None), 20)
        _falls("monodepth, 20 steps at batch 8", losses)
        med = statistics.median(times)
        res["monodepth"].update(losses=losses, step_s=times, step_ms_median=med * 1e3,
                                pairs_per_s=8 / med, peak_mem_gib=peak / 2**30)
        log(f"  monodepth: {med * 1e3:.2f} ms a step of 8 pairs, {8 / med:.2f} pairs/s, peak "
            f"{peak / 2**30:.2f} GiB")
        mono_path = mono.save_msgpack(os.path.join(tmp, "monodepth.msgpack"))
        res["launches"] = read_counts(counters)
        check(not any(res["launches"].values()),
              f"the trainers launch no port kernel ({res['launches']})")

        log("[phase 9] the training CLIs as subprocesses")
        fcn_cli = "semantic_depth_tpu_torch.cli.fcn"
        args = ["--dataset", "roborace_mockup", "--data_dir", os.path.join(tmp, "data"),
                "--model_dir", os.path.join(tmp, "models"), "--logging_dir",
                os.path.join(tmp, "log"), "--runs_dir", os.path.join(tmp, "runs")]
        name = "1-Epochs-roborace_mockup"
        secs, text = _run_cli("fcn --mode train --epochs 1 --inference_flag",
                              [fcn_cli, "--mode", "train", "--epochs", "1", "--inference_flag",
                               *args], repo, cwd=tmp)
        iou_train = float(text.split("TEST: mean iou of test set:")[1].split()[0])
        (run_dir,) = os.listdir(os.path.join(tmp, "runs", name))
        pngs = sorted(os.listdir(os.path.join(tmp, "runs", name, run_dir)))
        check(len(pngs) == 2 and os.path.isfile(os.path.join(tmp, "times.txt"))
              and os.listdir(os.path.join(tmp, "log", name, "iou"))
              and os.path.isfile(os.path.join(tmp, "models", name, "fcn8s.msgpack")),
              f"fcn train: overlays {pngs}, times.txt, the IoU log and fcn8s.msgpack written")
        test_secs, text = _run_cli("fcn --mode test", [fcn_cli, "--mode", "test", "--model",
                                                       name, *args], repo, cwd=tmp)
        iou_test = float(text.split("TEST: mean iou of test set:")[1].split()[0])
        check(abs(iou_test - iou_train) <= 1e-3,
              f"fcn test on the written fcn8s.msgpack: IoU {iou_test} (the train run's "
              f"inference: {iou_train})")
        for i in range(8):
            for side, img in zip(("left", "right"), pair):
                os.makedirs(os.path.join(tmp, "stereo", side), exist_ok=True)
                cv2.imwrite(os.path.join(tmp, "stereo", side, f"{i}.png"),
                            np.round(img[i, :, :, ::-1] * 255).astype(np.uint8))
        mono_secs, _ = _run_cli(
            "monodepth_train --epochs 1 --batch_size 8",
            ["semantic_depth_tpu_torch.cli.monodepth_train", "--data_dir",
             os.path.join(tmp, "stereo"), "--epochs", "1", "--batch_size", "8", "--model_dir",
             os.path.join(tmp, "mono")], repo, cwd=tmp)
        check(os.path.isfile(os.path.join(tmp, "mono", "monodepth.msgpack")),
              "monodepth_train wrote monodepth.msgpack")
        res["clis"] = dict(fcn_train_s=secs, fcn_test_s=test_secs, fcn_iou_train=iou_train,
                           fcn_iou_test=iou_test, monodepth_train_s=mono_secs)

        log("[phase 9] the trained weights served by build_pipeline")
        pipe = build_pipeline(munich_pipeline_config(), fcn_path, mono_path, device=dev)
        reset_counts(counters)
        with torch.inference_mode():
            out = pipe.process_batch(frames)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        check(counts == GRID_LAUNCHES, f"trained weights: launches per batch {counts}")
        fields = ("disparity", "overlay_small", "frame_small", "colors")
        check(all(bool(torch.isfinite(getattr(out, f)).all()) for f in fields)
              and bool(torch.isfinite(out.road_cloud.xyz[out.road_cloud.valid]).all())
              and bool(torch.isfinite(out.dist_rw[out.rw_found]).all()),
              f"trained weights: {', '.join(fields)}, the valid road cloud and each found "
              f"dist_rw finite ({int(out.rw_found.sum())} of 8 found)")
        small = torch.from_numpy(batch8[0]).to(dev)
        left = torch.from_numpy(pair[0]).to(dev)
        pairs = ((pipe.fcn, fcn.model), (pipe.mono, mono.model))
        same_params = all(torch.equal(a.state_dict()[k], v) for a, b in pairs
                          for k, v in b.state_dict().items())

        def max_diff(a, b):
            outs = [(a(small), b(small))] if a is pipe.fcn else zip(a(left), b(left))
            return max(float((x - y).abs().max()) for x, y in outs)

        with torch.no_grad():
            again = max_diff(fcn.model, fcn.model)  # cuDNN's default choice of algorithms
            # cuDNN's default algorithms need not give the same bits twice;
            # deterministic ones do, so the comparison runs with them
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                diffs = [max_diff(a, b) for a, b in pairs]
        check(same_params and diffs == [0.0, 0.0],
              f"the reloaded networks' parameters and forward (deterministic cuDNN) equal the "
              f"trainers' bit for bit (max abs diff FCN-8s {diffs[0]}, monodepth {diffs[1]}; "
              f"FCN-8s against itself with the default algorithms: {again})")
        res["serve"] = dict(launches=counts, rw_found=int(out.rw_found.sum()),
                            dist_rw=out.dist_rw.tolist(), fcn_self_diff_default_cudnn=again)
        del pipe, fcn, mono, out
        torch.cuda.empty_cache()
    return res


def codec_info():
    """Which image codecs import on this host (information, not a check)."""
    code = ("import importlib\n"
            "for m in ('cv2', 'PIL', 'matplotlib'):\n"
            "    try:\n"
            "        print(m, 'imports', getattr(importlib.import_module(m), '__version__', ''))\n"
            "    except Exception as e:\n"
            "        print(m, 'does not import:', type(e).__name__, e)\n")
    found = _run([sys.executable, "-c", code]).splitlines()
    log("info: image codecs on this host: " + "; ".join(found))
    return found


def main() -> int:
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device: this smoke run needs one GPU")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from semantic_depth_tpu_torch.ops import _cuda
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

    counters = kernel_counters()
    log("[phase 3] kernels against their plain versions")
    scenes = scene_batch(8, 256, 512, seed=0, dev=dev)
    with torch.inference_mode():
        rows = phase_kernels(dev, scenes)
        rows["exact_knn"], scene_cloud = phase_exact_knn(dev, scenes)
        native_rows, native_geom = phase_native_kernels(dev)
    geom = {mode: phase_geometry(dev, scenes, counters, mode) for mode in ("grid", "exact")}
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    frames = torch.from_numpy(scene_pool(8, 1024, 2048, seed=3)[0]).to(dev)  # uint8
    e2e = phase_end_to_end(dev, counters, frames)
    entry = dict(staged=phase_staged(dev, counters, frames[0]),
                 outlier_removal=phase_outlier_removal(dev, scene_cloud),
                 codecs=codec_info())

    native = dict(geometry=native_geom,
                  end_to_end=phase_native_end_to_end(dev, counters, frames))
    e2e.update(phase_end_to_end(dev, counters, frames, runs=(
        ("resnet50_float32", "float32", "grid", "resnet50"),
        ("resnet50_bfloat16", "bfloat16", "grid", "resnet50"))))
    check(e2e["resnet50_float32"]["launches"] == e2e["float32"]["launches"],
          "resnet50 launches per batch equal the vgg path's")
    entry["clis"] = phase_clis(dev, frames)
    trainers = phase_trainers(dev, counters, frames)

    for name, row in rows.items():
        row["launches"] = e2e["bfloat16_exact" if name == "exact_knn" else "float32"][
            "launches"][name]
        if name in native_rows:
            row["native"] = dict(native_rows[name],
                                 launches=native["end_to_end"]["launches"][name])
    summary = dict(card=smi, build_s=build_s, geometry=geom, end_to_end=e2e, native=native,
                   entry_points=entry, trainers=trainers, kernels=list(rows.values()),
                   wall_s=time.time() - t_start)
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
