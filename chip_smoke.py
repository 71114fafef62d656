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
   peak device memory and the CLIs' seconds;
10. frozen serving and the tools: (a) ``export.export_pipeline`` of the
   bfloat16 grid-mode program for (8, 1024, 2048, 3) uint8 batches,
   scalars only; its size, its load seconds in a fresh process; the 8
   scene frames at two focals (the config's and 0.8 of it) against live
   ``process_batch`` with deterministic cuDNN on both sides (rw_found equal,
   distances within 1e-4 m, the max difference printed), the launches
   counted inside the ops (K1 1, K2 4, K3 1), frozen and live frames/s in
   turns; (b) the float32 exact-mode single-frame program with full
   outputs: every field equal to ``process_frame``'s, K4 launched once;
   (c) inside phase 8's weights, ``cli.export_pipeline`` and both CLIs with
   ``--use_frozen`` as subprocesses (the single frame's ``--save_data``
   file names and ``_distances.txt`` equal to phase 8's live run, both with
   deterministic cuDNN; the sequence over the 8 PNGs with a ``--batch 3``
   program: a ragged tail, 8 overlay PNGs and 8 ``_rw.ply``); (d) the
   native PLY library loaded, a 131072-point write native against numpy
   ``savetxt``, byte-equal; (e) ``cli.monodepth_infer`` over the 8 PNGs,
   ``utils.video`` writing them as an mp4 that ``cli.segment_video`` reads
   back (8 frames), ``render_points`` of the phase-3 scene cloud equal on
   the card and the CPU, and one ``process_batch`` under ``runtime.trace``
   whose trace holds its ``annotate`` span and kernel events; (f) the
   fence chain on real points: stand-in networks (``SceneFCN``,
   ``SceneMono``) give 8 bench scenes' analytic logits and disparity, and
   a batched program in bfloat16 grid mode and in float32 exact mode gives
   a finite ``dist_f2f`` on every frame within 1e-4 m of live
   ``process_batch`` and 1e-3 m of the scenes' f2f_true (launches inside
   each program);
11. multi-device serving (``parallel/``) with two ranks sharing the card
   (``parallel.launch.run_ranks``, gloo), full width, seeded weights, the 8
   scene frames, deterministic cuDNN and TF32 off in every rank: (a) dp=2,
   bfloat16, batch 8; (b) pp=2, bfloat16, microbatch 4; (d) dp=2 sharded
   frozen programs (bfloat16 at export batch 4, float32 exact mode at
   export batch 1): each rank's shard bit-equal to its own single-process
   ``process_batch`` on every FrameOutputs field, the gathered outputs the
   same on both ranks; (c) sp=2 float32 ``process_frame`` within the JAX sp
   test's tolerances (disparity 1e-5, dist_rw 1e-4, nan pattern equal),
   and sp=2 on the native bfloat16 network, gated at bfloat16's own
   rounding (``sp_bf16_gate``): with E the unsharded bfloat16 network's
   largest disparity difference from float32 (same seeded weights, same
   frame, this run), sp within 1.5 E of float32 and 2 E of the unsharded
   bfloat16 network, its road mask disagreement at most twice the
   bfloat16-against-float32 one; the same sp with its halo rows zeroed
   must fail that gate; (f) the fence chain
   with one stand-in scene on every frame, dp=2 live and a sharded frozen
   program (dp=2), ``dist_f2f`` finite on every frame, within 1e-4 m of
   the single process and 1e-3 m of the scenes' f2f_true; K1-K4 launches counted on each rank against each
   case's expected counts; frames/s (ms per frame for sp) against the
   single process, and the collectives' bytes and ms; which collectives
   gloo takes on CUDA tensors (information); (e) one rank over NCCL (world
   size 1, dp=1): outputs equal ``process_batch``, the collectives exact;
12. multi-device training with two ranks sharing the card (gloo), full
   width, 256x512, batch 8, float32, deterministic cuDNN: (a) FCN-8s (fc
   4096, keep 0.5) on meshes (dp 1, tp 2) and (2, 1), (b) monodepth-vgg at
   dp 2, each 3 steps against the single-process trainer from the same
   parameters and seed run on rank 0 alone (the losses within rel 1e-4, the
   first step's gathered gradients and parameters by
   ``probes.train_step_agreement``'s rule), the replicated parameters and
   Adam moments bit-equal on both ranks, no port kernel launched; ms a
   step, the reduce bytes and ms a step, peak memory a rank; (c) ``cli.fcn
   --mode train --mesh`` under torchrun (2 processes) on a ``make_mockup``
   tree, one epoch, its ``fcn8s.msgpack`` served by ``build_pipeline``; (d)
   ``tools/train_bench_weights_torch.py`` at 30 steps a network: falling
   losses, both msgpacks read back, the sets served by ``process_batch``
   on bench scenes (K1-K3's launches; the rw MAE printed, not gated);
13. K1 and K4 at every parameter the JAX package takes, and the offline
   tools: (a) K1's general kernel (any (k, window) but the road chain's)
   bit-equal to its plain version at (8, 256, 512) for (k, window) = (20,
   (5, 21)), (10, (7, 21)), (10, (5, 31)), (10, (7, 31)), (6, (4, 20)),
   (40, (9, 33)), (32, (7, 31)) (registers) against (33, (7, 31)) (the
   k > 32 buffers) and (20, (7, 31)), on grids with valid +-inf points, and
   at the native (2, 1024, 2048) launch under stat_window (7, 31); the road
   chain's (10, (5, 21)) still on the specialised kernel; (b) K4's large-k
   walks at k = 33, 50, 64 and 100 (and k = 32 on the register walks)
   bit-equal on (8, 16384) (skip on and off) and (1, 131072); kernel,
   plain and bound ms and the kernels' counts of each; (c) the outlier
   tool with ``--nb_neighbors 50`` as a subprocess, its PLY equal to the
   plain versions' keep set, and ``filter_ply`` in process (K4 large-k x1,
   K3 x1); (d) the geometry tail under stat_window (7, 31), k = 20 on the
   card against the CPU (1e-3 m), and full-width bfloat16 ``process_batch``
   at batch 8 under it (K1 general x1, K2 x4, K3 x1) and under the default
   setting (no general launch); (e) ``tools/pin_window_torch.py`` at
   1024x2048, all four windows; (f) ``tools/train_monodepth_synth_torch.py``
   at 30 full-width steps with a falling loss; (g) one native
   ``tools/profile_blocks_torch.py`` call (float32 and bfloat16, the
   longest kernels of each block); (h) ``tools/native_mae_curve_torch.py``
   at 4 full-width steps a network, one eval point on 4 scenes, in a
   temporary directory, with each training's seconds a step at 1024x2048;
14. K1-K4 at every shape and batch the JAX package takes: (a) K3 at capacities
   1, 100, 1000 and 16383 (padded to its 128-candidate tiles), ones and
   dyadic weights, skip on and off, bit-equal; non-dyadic weights at 1000
   the same on three runs and within rtol 1e-4; 65537 frames in two
   launches; (b) K2 at row lengths 1, 3, 1022, 1025 and 2^21 + 3 (streamed),
   a view 4 bytes into its storage and 65538 rows (two launches), each
   bit-equal; (c) ``process_batch`` at ``neighbor_capacity=1000`` with the
   stand-in networks in grid and exact mode, within 1e-3 m of the CPU port,
   the default launches and one padded call (K3's), and at the default
   capacity no padded call; (d) K1 (specialised, general at (20, (7, 31))
   and (40, (5, 11))) and K4 (k = 10 and 50) on 65,537 small frames in two
   launches each, bit-equal; the padded launches' wrapper, plain and bound
   ms, and phase 5's bfloat16 frames/s beside the rate recorded before
   the padding (358.13, PERF.md);
15. the published TF1 weight sets with no TensorFlow: (a) the committed
   fixtures (``tests/fixtures/tf1``, TensorFlow-written tiny FCN-8s,
   encoder-only VGG16 and monodepth-vgg with Adam slots) converted
   bit-equal to the JAX converters' committed .msgpack, loaded on the card
   by the CLI loaders (the VGG16 by ``graft_partial``) and served by
   ``process_batch`` (K1 x1, K2 x4, K3 x1); (b) full-width FCN-8s and
   monodepth-vgg bundles written from seeded parameters under the
   reference's names with Adam slots and ``global_step``
   (``tools/tf_bundle_writer_torch.py``), loaded through
   ``load_fcn_params`` / ``load_mono_params`` (bundle bytes, read + crc +
   convert seconds a set, the crc32c share), bfloat16 ``process_batch`` at
   batch 8 bit-equal to the same sets from .msgpack (K1 x1, K2 x4, K3 x1,
   frames/s), and ``cli.semantic_depth --save_data`` on the TF paths equal
   to the .msgpack paths' run. The seconds each phase took close the run
   (``phase walls``).

The second-to-last lines are the card's name and power limit and one JSON
object with the kernels' numbers (``frozen_launches``: phase 10's programs';
null, not measured, for phase 13's general K1 and large-k K4, whose
``launches`` are phase 13's paths': (d)'s ``process_batch`` and (c)'s
``filter_ply``);
the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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


def launch_registry():
    """The port's kernel launch counts by key (``_cuda.launches``)."""
    from semantic_depth_tpu_torch.ops import _cuda

    return _cuda.launches


def kernel_counters():
    """K1-K4's keys in the launch registry by row name."""
    return {name: name for name in ("knn_grid", "mad", "radius", "exact_knn")}


# launches per batch of each path's main run
GRID_LAUNCHES = {"knn_grid": 1, "mad": 4, "radius": 1, "exact_knn": 0}
EXACT_LAUNCHES = {"knn_grid": 0, "mad": 4, "radius": 1, "exact_knn": 1}
STAGED_LAUNCHES = {"knn_grid": 0, "mad": 5, "radius": 1, "exact_knn": 1}


def exact_config(**kw):
    from semantic_depth_tpu_torch import config

    base = config.munich_pipeline_config(**kw)
    return dataclasses.replace(base, road=dataclasses.replace(base.road, stat_mode="exact"))


def reset_counts():
    launch_registry().clear()


def read_counts(counters):
    launches = launch_registry()
    return {name: launches[key] for name, key in counters.items()}


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
    t_bound, by = knn_grid_bound(valid)
    cand = torch.nn.functional.conv2d(
        valid.float()[:, None], torch.ones((1, 1, 5, 21), device=dev), padding=(2, 10))[:, 0]
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
    if c % 128:  # the block rule counts whole 128-candidate tiles
        return float(needed), float("nan")
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


def exact_knn_scanned(xyz, valid, k=10):
    """What the kernels did on this input at k (their own counts, one extra
    launch that no counter sees) and, as a diagnostic beside the bound, the
    time of that work at the card's peak rate: the pairs both walks computed
    d2 for at 10 operations each, each subtile test at 21 operations for
    each of the warp's 64 queries (three gaps of two subtractions and two
    maxima, three squares, two sums, the threshold's three operations and
    the compare), and each loaded subtile's 32 candidate tests at 21. It
    grows with what the design chooses to scan, so it bounds nothing."""
    from semantic_depth_tpu_torch.ops import exact_knn

    b, c = valid.shape
    scratch = torch.empty(exact_knn.scratch_words(b, c, k), device=xyz.device)
    out = torch.empty((b, c), device=xyz.device)
    exact_knn._launch(xyz, valid, k, True, scratch, out)
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
    reset_counts()
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


class SceneFCN(torch.nn.Module):
    """Stand-in for FCN-8s (phases 10, 11, 14): the analytic class logits of
    ``n`` bench scenes (+8 on the true class of road, fence, background),
    frame i of a batch getting scene i, or every frame the one scene when
    ``n`` is 1 (a dp shard then sees what the whole batch sees). Seeded random networks put no pixel
    on the fence; these put every true road and fence pixel there, so the
    fence chain (f2f) runs on real points."""

    def __init__(self, labels):
        super().__init__()
        lab = torch.from_numpy(labels)
        onehot = torch.stack([lab == 7, lab == 13, (lab != 7) & (lab != 13)], -1)
        self.register_buffer("logits", onehot.float() * 8.0)

    def forward(self, images, rows=None):
        if rows is not None:
            raise ValueError("the stand-in networks have no row-sharded form")
        return _take(self.logits, images.shape[0])


class SceneMono(torch.nn.Module):
    """Stand-in for monodepth: the scenes' normalised disparity; on the flip
    batch (the B frames, then their mirrors) the second half is the mirror,
    so the flip blend gives the scene's disparity back."""

    def __init__(self, disp_norm, flip):
        super().__init__()
        self.register_buffer("disp", torch.from_numpy(disp_norm))
        self.flip = flip

    def disp_left(self, images, rows=None):
        if rows is not None:
            raise ValueError("the stand-in networks have no row-sharded form")
        if not self.flip:
            return _take(self.disp, images.shape[0])
        d = _take(self.disp, images.shape[0] // 2)
        return torch.cat([d, d.flip(-1)])


def _take(scenes, b):
    """The first ``b`` scenes, or the one scene ``b`` times."""
    return scenes.expand(b, *scenes.shape[1:]) if scenes.shape[0] == 1 else scenes[:b]


def scene_pipeline(dev, dtype_name="bfloat16", stat_mode="grid", capacity=None, n=8, seed=0):
    """``munich_pipeline_config`` with the stand-in networks of ``n`` bench
    scenes at 256x512 (seed ``seed``, phase 3's scenes); served on 1024x2048
    frames at the config's focal and a multiplier of 2048 it measures those
    scenes. Returns (pipeline, (focal, multiplier), f2f_true)."""
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    cfg = (exact_config if stat_mode == "exact" else config.munich_pipeline_config)(
        compute_dtype=dtype_name)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, road=dataclasses.replace(cfg.road,
                                                                neighbor_capacity=capacity))
    _, labels, disp_norm, _, f2f_true = scene_pool(n, cfg.input_height, cfg.input_width,
                                                   seed=seed)
    pipe = pipeline.SemanticDepthPipeline(
        cfg, SceneFCN(labels), SceneMono(disp_norm, cfg.monodepth.flip_average), device=dev)
    return pipe, (cfg.camera.focal, 2048.0), f2f_true


# |dist_f2f - f2f_true| on the stand-in scenes: 2.2e-4 m at most on an H100
# (PERF.md §6); the card's own limit against the CPU port is also 1e-3 m
F2F_TRUE_LIMIT_M = 1e-3


def fence_gate(label, f2f, live_f2f, f2f_true):
    """dist_f2f finite on every frame, within 1e-4 m of live
    ``process_batch`` and within ``F2F_TRUE_LIMIT_M`` of the scenes'
    analytic f2f_true (the side that does not run the port)."""
    f2f, live = np.asarray(f2f, np.float64), np.asarray(live_f2f, np.float64)
    check(f2f.size > 0 and bool(np.isfinite(f2f).all()),
          f"{label}: dist_f2f finite on every frame {f2f.tolist()}")
    diff = float(np.abs(f2f - live).max())
    check(diff <= 1e-4, f"{label}: dist_f2f within 1e-4 m of live process_batch "
          f"(max diff {diff}; bit-equal: {bool(np.array_equal(f2f, live))})")
    err = np.abs(f2f - np.asarray(f2f_true[:f2f.size], np.float64))
    check(err.max() <= F2F_TRUE_LIMIT_M,
          f"{label}: |dist_f2f - f2f_true| mean {err.mean()} m, max {err.max()} m "
          f"<= {F2F_TRUE_LIMIT_M} m")
    return dict(max_diff_m=diff, f2f_err_mean_m=float(err.mean()),
                f2f_err_max_m=float(err.max()), dist_f2f=f2f.tolist())


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
        reset_counts()
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
    reset_counts()
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


def knn_grid_bound(valid, k=10, window=(5, 21)):
    """K1's bound on these inputs: each point read and each mean written
    once; 9 float32 operations for each (valid pixel, valid candidate)
    pair (three differences, three squares, two sums and the compare that
    selects it or not), whatever k is; and 2k + 1 for each valid pixel with
    at least k valid candidates (k square roots, k - 1 sums, the division
    and the select), the others' +inf needing none."""
    b, h, w = valid.shape
    wh, ww = window
    cand = torch.nn.functional.conv2d(
        valid.float()[:, None], torch.ones((1, 1, wh, ww), device=valid.device),
        padding=(wh // 2, ww // 2))[:, 0, :h, :w]
    n_ops = (float((cand * valid).sum()) * 9.0
             + float((valid & (cand >= k)).sum()) * (2.0 * k + 1))
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
    reset_counts()
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


# runs a module as ``python -m`` does, with cuDNN's deterministic algorithms
# (its default ones need not give the same bits twice)
_DETERMINISTIC = ("import runpy, sys, torch; torch.backends.cudnn.deterministic = True; "
                  "torch.backends.cudnn.benchmark = False; mod = sys.argv[1]; "
                  "sys.argv = sys.argv[1:]; runpy.run_module(mod, run_name='__main__', "
                  "alter_sys=True)")


def _run_cli(name, args, repo, cwd=None, deterministic=False):
    """One CLI as a subprocess on the card, run in ``cwd`` (the repo by
    default); its failure fails the run. ``deterministic``: with cuDNN's
    deterministic algorithms."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    t0 = time.time()
    launch = ["-c", _DETERMINISTIC] if deterministic else ["-m"]
    proc = subprocess.run([sys.executable, *launch, *args], cwd=cwd or repo, env=env,
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
                           repo, deterministic=True)
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
        res["frozen"] = phase_frozen_clis(work, paths, weights, repo, single)
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
        reset_counts()

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
        reset_counts()
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


def measurable(pipe, frames):
    """Make ``pipe`` measure a road width on ``frames``; returns the (focal,
    disparity multiplier) pairs to serve them with. Seeded random networks
    give a near-constant logit map (std ~0.02 at 1024x2048) that puts no
    pixel over the road threshold, so every distance is nan. A +2 bias on
    the road logit makes every pixel road; a multiplier of 250 px at the
    config's focal (scaled with the focal, so the cloud stays put) puts the
    cloud ~10 m out; and the measuring depth moves to the median depth of
    the denoised road cloud, so its slab holds points on any card and in
    any compute type."""
    with torch.no_grad():
        pipe.fcn.upscore8.bias[0] += 2.0
    focal = pipe.config.camera.focal
    out = pipe.process_batch(frames, focal, 250.0)
    z = out.road_cloud.xyz[..., 2][out.road_cloud.valid]
    check(z.numel() > 0, f"a +2 road bias leaves {z.numel()} denoised road points")
    depth = -float(z.median()) + pipe.config.rw_depth_offset
    pipe.config = dataclasses.replace(pipe.config, depth=depth)
    return [(focal, 250.0), (0.8 * focal, 200.0)]


def phase_frozen(dev, counters, frames, n_timed=7):
    """Phase 10 (a), (b): frozen programs against the live pipeline, and
    (e) one process_batch under ``runtime.trace``."""
    from semantic_depth_tpu_torch import export, runtime

    res = {}
    deterministic = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    with tempfile.TemporaryDirectory() as tmp:
        log("[phase 10] frozen serving (a): batched (8, 1024, 2048, 3) uint8 program, "
            "bfloat16, grid mode, scalars only")
        pipe = full_pipeline(dev, "bfloat16", "grid")
        scalars = measurable(pipe, frames)
        t0 = time.time()
        path = export.export_pipeline(pipe, os.path.join(tmp, "b8.pt2"), tuple(frames.shape),
                                      batched=True, scalars_only=True)
        export_s = time.time() - t0
        size_mb = os.path.getsize(path) / 1e6
        code = ("import sys, time; t0 = time.perf_counter(); "
                "from semantic_depth_tpu_torch.export import load_pipeline; "
                "call = load_pipeline(sys.argv[1]); print(time.perf_counter() - t0)")
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", code, path], cwd=repo, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
        load_process_s = time.time() - t0
        check(proc.returncode == 0, f"a fresh process loads the program ({proc.stdout[-300:]})")
        load_s = float(proc.stdout.strip().splitlines()[-1])
        call = export.load_pipeline(path)
        diffs, launches = {}, None
        with torch.backends.cudnn.flags(**deterministic):
            for f, mult in scalars:
                live = pipe.process_batch(frames, focal=f, disparity_mult=mult)
                torch.cuda.synchronize()
                reset_counts()
                rw, f2f, found = call(frames, f, mult)
                torch.cuda.synchronize()
                launches = read_counts(counters)
                check(launches == GRID_LAUNCHES,
                      f"frozen focal {f:g}: launches per batch inside the program {launches}")
                check(torch.equal(found, live.rw_found) and bool(found.any()),
                      f"frozen focal {f:g}: rw_found equal ({int(found.sum())} of 8 found)")
                d = max(float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
                        for a, b in ((rw, live.dist_rw), (f2f, live.dist_f2f)))
                same_nan = torch.equal(rw.isnan(), live.dist_rw.isnan()) and torch.equal(
                    f2f.isnan(), live.dist_f2f.isnan())
                bits = bool(torch.equal(rw.nan_to_num(), live.dist_rw.nan_to_num())
                            and torch.equal(f2f.nan_to_num(), live.dist_f2f.nan_to_num()))
                check(same_nan and d <= 1e-4,
                      f"frozen focal {f:g}: dist_rw / dist_f2f within 1e-4 m of live "
                      f"process_batch (max diff {d}; bit-equal: {bits})")
                diffs[f"{f:g}"] = dict(max_abs_diff_m=d, bit_equal=bits,
                                       dist_rw=rw.tolist(), dist_f2f=f2f.tolist())
        live_t, frozen_t = [], []
        for i in range(2 * n_timed):  # live, frozen, frozen, live, ...
            first_live = i % 2 == 0
            for which in ((0, 1) if first_live else (1, 0)):
                t0 = time.perf_counter()
                if which == 0:
                    pipe.process_batch(frames, *scalars[0])
                else:
                    call(frames, *scalars[0])
                torch.cuda.synchronize()
                (live_t if which == 0 else frozen_t).append(time.perf_counter() - t0)
        live_fps = 8.0 / statistics.median(live_t)
        frozen_fps = 8.0 / statistics.median(frozen_t)
        log(f"  export {export_s:.1f} s, program {size_mb:.1f} MB, load {load_s:.2f} s in a "
            f"fresh process ({load_process_s:.1f} s the process); frozen {frozen_fps:.2f} "
            f"frames/s, live process_batch {live_fps:.2f} ({2 * n_timed} batches each, in turns)")
        res["batched_bf16"] = dict(export_s=export_s, program_mb=size_mb, load_s=load_s,
                                   load_process_s=load_process_s, launches=launches,
                                   focals=diffs, frozen_frames_per_s=frozen_fps,
                                   live_frames_per_s=live_fps, frozen_batch_s=frozen_t,
                                   live_batch_s=live_t)

        log("[phase 10] (e) one process_batch under runtime.trace")
        with runtime.trace(os.path.join(tmp, "trace")) as tr:
            with runtime.annotate("smoke_process_batch"):
                pipe.process_batch(frames)
                torch.cuda.synchronize()
        with open(tr.path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        check(any(e.get("name") == "smoke_process_batch" for e in events) and kernels > 0,
              f"the trace holds the annotated span and {kernels} kernel events")
        res["trace"] = dict(events=len(events), kernel_events=kernels)
        del pipe, call
        torch.cuda.empty_cache()

        log("[phase 10] frozen serving (b): single (1024, 2048, 3) frame, float32, exact mode, "
            "full outputs")
        pipe = full_pipeline(dev, "float32", "exact")
        focal, mult = measurable(pipe, frames[:1])[0]
        t0 = time.time()
        path = export.export_pipeline(pipe, os.path.join(tmp, "exact.pt2"),
                                      tuple(frames.shape[1:]), scalars_only=False)
        export_s = time.time() - t0
        call = export.load_pipeline(path)
        with torch.backends.cudnn.flags(**deterministic):
            live = pipe.process_frame(frames[0], focal, mult)
            torch.cuda.synchronize()
            reset_counts()
            got = call(frames[0], focal, mult)
            torch.cuda.synchronize()
            launches = read_counts(counters)
        check(launches == EXACT_LAUNCHES, f"exact program: launches inside it {launches}")
        bad = _outputs_mismatch(got, live)
        check(not bad and bool(live.rw_found), f"exact program: every FrameOutputs field "
              f"equals live process_frame (differ: {bad}; dist_rw {float(live.dist_rw)} m, "
              f"{int(live.road_cloud.valid.sum())} road points)")
        res["single_exact_f32"] = dict(export_s=export_s, launches=launches,
                                       program_mb=os.path.getsize(path) / 1e6)
        del pipe, call, live, got
        torch.cuda.empty_cache()

        res.update(phase_frozen_fence(dev, counters, frames, tmp))
    return res


def phase_frozen_fence(dev, counters, frames, tmp):
    """Phase 10 (f): the fence chain on real points (stand-in networks) in a
    frozen program, grid and exact mode, against live ``process_batch``."""
    from semantic_depth_tpu_torch import export

    res = {}
    for key, dtype_name, mode in (("fence_grid_bf16", "bfloat16", "grid"),
                                  ("fence_exact_f32", "float32", "exact")):
        log(f"[phase 10] (f) the fence chain: a batched (8, 1024, 2048, 3) program, "
            f"{dtype_name}, {mode} mode, stand-in networks of 8 bench scenes")
        pipe, scalars, f2f_true = scene_pipeline(dev, dtype_name, mode)
        path = export.export_pipeline(pipe, os.path.join(tmp, f"{key}.pt2"),
                                      tuple(frames.shape), batched=True, scalars_only=True)
        call = export.load_pipeline(path)
        live = pipe.process_batch(frames, *scalars)
        torch.cuda.synchronize()
        reset_counts()
        rw, f2f, found = call(frames, *scalars)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        check(launches == (EXACT_LAUNCHES if mode == "exact" else GRID_LAUNCHES),
              f"{key}: launches inside the program {launches}")
        check(torch.equal(found, live.rw_found) and bool(found.all()),
              f"{key}: rw_found equal, every frame's width found")
        res[key] = dict(launches=launches, **fence_gate(
            f"frozen {key}", f2f.cpu(), live.dist_f2f.cpu(), f2f_true))
        del pipe, call, live
        torch.cuda.empty_cache()
    return res


def phase_frozen_clis(work, paths, weights, repo, single):
    """Phase 10 (c), inside phase 8's weights: ``cli.export_pipeline`` and
    both CLIs with ``--use_frozen``, against phase 8's live single run."""
    log("[phase 10] (c) the CLIs with --use_frozen")
    exp = "semantic_depth_tpu_torch.cli.export_pipeline"
    res = {}
    full, b3 = os.path.join(work, "full.pt2"), os.path.join(work, "b3.pt2")
    # the two exports at once (each process is mostly start-up and tracing)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jobs = [ex.submit(_run_cli, name, [exp, *weights, "--full_outputs", *extra], repo)
                for name, extra in (("export_pipeline --full_outputs", ["--output", full]),
                                    ("export_pipeline --batch 3 --full_outputs",
                                     ["--batch", "3", "--output", b3]))]
        (res["export_full_s"], _), (res["export_batch3_s"], _) = (j.result() for j in jobs)
    frozen = os.path.join(work, "frozen_single")
    res["single_save_data_s"], _ = _run_cli("single frame --use_frozen --save_data", [
        "semantic_depth_tpu_torch.cli.semantic_depth", "--input_frame", paths[0],
        "--use_frozen", full, "--save_data", "--results_dir", frozen], repo, deterministic=True)
    live_dir, frozen_dir = (os.path.join(d, "scene_0") for d in (single, frozen))
    names = sorted(os.listdir(live_dir))
    check(sorted(os.listdir(frozen_dir)) == names,
          f"--use_frozen --save_data: the live run's {len(names)} artifact file names")
    text = [open(os.path.join(d, "scene_0_output_distances.txt")).read()
            for d in (live_dir, frozen_dir)]
    check(text[0] == text[1], f"--use_frozen: _distances.txt equals the live run's "
          f"({text[1].strip()!r})")
    out_dir = os.path.join(work, "frozen_seq")
    secs, text = _run_cli("sequence --use_frozen --batch 3", [
        "semantic_depth_tpu_torch.cli.sequence", "--input_folder",
        os.path.join(os.path.dirname(paths[0]), "*.png"), "--use_frozen", b3, "--batch", "3",
        "--results_dir", out_dir, "--output_name", "seq"], repo)
    imgs = sorted(os.listdir(os.path.join(out_dir, "seq", "result_sequence_imgs")))
    plys = sorted(os.listdir(os.path.join(out_dir, "seq", "result_sequence_ply")))
    check(imgs == [f"scene_{i}.png" for i in range(8)]
          and plys == [f"scene_{i}_rw.ply" for i in range(8)],
          "sequence --use_frozen --batch 3 (a ragged tail of 2): 8 overlay PNGs, 8 _rw.ply")
    res["sequence_batch3_s"] = secs
    res["sequence_batch3_loop_s"] = float(text.strip().splitlines()[-1].split()[3])
    return res


def phase_native_ply_and_tools(dev, scene_cloud, frames):
    """Phase 10 (d) the native PLY writer, (e) the tools."""
    import cv2

    from semantic_depth_tpu_torch.io import ply
    from semantic_depth_tpu_torch.native import build as native
    from semantic_depth_tpu_torch.utils.render_ply import render_points
    from semantic_depth_tpu_torch.utils.video import create_video_from_frames

    repo = os.path.dirname(os.path.abspath(__file__))
    res = {}
    log("[phase 10] (d) native PLY: a 131072-row cloud")
    xyz, _, rgb = scene_cloud
    pts, cols = xyz[0].cpu().numpy(), rgb[0].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        check(native.library() is not None, f"the native library loads ({native.library_path()})")
        cloud = ply.PlyCloud(pts, cols, os.path.join(tmp, "native"))
        keep = cloud.points3d[:, 2] > cloud.points3d[:, 2].min()
        rows, row_cols = cloud.points3d[keep], cloud.colors[keep]
        header = ply._PLY_HEADER.format(vertex_count=len(rows))
        native_ms, numpy_ms = [], []
        for _ in range(3):
            before = ply._native_write.calls
            t0 = time.perf_counter()
            cloud.save()
            native_ms.append((time.perf_counter() - t0) * 1e3)
            check(ply._native_write.calls == before + 1, "PlyCloud.save wrote through the "
                  "native library")
            t0 = time.perf_counter()
            ply._numpy_write(os.path.join(tmp, "numpy.ply"), header, rows, row_cols)
            numpy_ms.append((time.perf_counter() - t0) * 1e3)
        with open(os.path.join(tmp, "native.ply"), "rb") as a, \
                open(os.path.join(tmp, "numpy.ply"), "rb") as b:
            same = a.read() == b.read()
        check(same, f"native and numpy PLY byte-equal ({len(rows)} rows)")
        t0 = time.perf_counter()
        back, _ = ply.read_ply(os.path.join(tmp, "native.ply"))
        read_ms = (time.perf_counter() - t0) * 1e3
        check(back.shape == (len(rows), 3), "read_ply reads the rows back")
        log(f"  write {len(pts)} points: native {statistics.median(native_ms):.1f} ms, numpy "
            f"savetxt {statistics.median(numpy_ms):.1f} ms (medians of 3); native read "
            f"{read_ms:.1f} ms")
        res["ply"] = dict(points=len(pts), rows=len(rows), native_write_ms=native_ms,
                          numpy_write_ms=numpy_ms, native_read_ms=read_ms)

        log("[phase 10] (e) the tools")
        fdir = os.path.join(tmp, "frames")
        os.makedirs(fdir)
        for i, img in enumerate(frames.cpu().numpy()):
            cv2.imwrite(os.path.join(fdir, f"scene_{i}.png"), img)
        video = create_video_from_frames(os.path.join(fdir, "*.png"),
                                         os.path.join(tmp, "scenes.mp4"), fps=10)
        # both tools at once, seeded random weights
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            infer = ex.submit(_run_cli, "monodepth_infer over 8 PNGs", [
                "semantic_depth_tpu_torch.cli.monodepth_infer", "--input",
                os.path.join(fdir, "*.png"), "--out_dir", os.path.join(tmp, "disp"),
                "--save_npy"], repo)
            seg = ex.submit(_run_cli, "segment_video", [
                "semantic_depth_tpu_torch.cli.segment_video", "--input_video", video,
                "--semantic_model", "random", "--output_video", os.path.join(tmp, "seg.mp4")],
                repo)
            (res["monodepth_infer_s"], _), (res["segment_video_s"], text) = (
                infer.result(), seg.result())
        disp = sorted(os.listdir(os.path.join(tmp, "disp")))
        check(len(disp) == 16, f"monodepth_infer: 8 _disp.png and 8 _disp.npy ({len(disp)})")
        n = int(text.strip().splitlines()[-1].split()[1])
        cap = cv2.VideoCapture(os.path.join(tmp, "seg.mp4"))
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        check(n == count == 8, f"segment_video: 8 frames read back and written ({n}, {count})")
        t0 = time.perf_counter()
        on_card = render_points(pts, cols, device=dev)
        card_s = time.perf_counter() - t0
        on_cpu = render_points(pts, cols, device="cpu")
        painted = float((on_card != 255).any(-1).mean())
        check(np.array_equal(on_card, on_cpu) and painted > 0.01,
              f"render_points of the scene cloud: the card's image equals the CPU's "
              f"({painted:.3f} of the pixels painted)")
        res["render"] = dict(card_s=card_s, painted=painted)
    return res


# --- phase 11: multi-device serving, two ranks sharing the one card -----------
_DETERMINISTIC_CUDNN = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
# per-rank launches of each case's sharded call
_PP_STAGE_LAUNCHES = ({"knn_grid": 0, "mad": 0, "radius": 0, "exact_knn": 0},
                      {"knn_grid": 2, "mad": 8, "radius": 2, "exact_knn": 0})


def _shard_mismatch(out, ref, lo, hi):
    """Fields of frames lo:hi of the gathered ``out`` that differ from ``ref``."""
    return _outputs_mismatch(out.map(lambda x: x[lo:hi]), ref)


def _timed(fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _same_on_every_rank(x: torch.Tensor) -> bool:
    from semantic_depth_tpu_torch.parallel import comm

    got = comm.all_gather_dim(x.reshape(1, -1), 0, None)
    return bool((got == got[:1]).all())


def _single_alone(fn, n):
    """``fn`` timed on rank 0 while the other ranks wait (the card to
    itself); every rank gets rank 0's median."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.parallel import comm

    med = torch.zeros(1, dtype=torch.float64)
    if dist.get_rank() == 0:
        med[0] = _timed(fn, n)[0]
    dist.barrier()
    return float(comm.broadcast(med if dist.get_rank() == 0 else None, 0, None, "cpu")[0])


def _rank_device():
    """This rank's card (``init_distributed`` set it current)."""
    return torch.device("cuda", torch.cuda.current_device())


# sp's own departure from float32 over the unsharded bfloat16 network's (E):
# 1.028 on an H100 (PERF.md §6), 1.5 leaves half of E for another draw
SP_F32_FACTOR = 1.5


def sp_bf16_readings(got, want, want32):
    """The sp bfloat16 gate's readings of sp's output ``got`` against the
    unsharded bfloat16 ``want`` and float32 ``want32`` outputs."""
    def max_diff(a, b):
        return float((a.disparity - b.disparity).abs().max())

    def agreement(a, b):
        return float((a.road_mask == b.road_mask).float().mean())

    return dict(disparity_max_diff=max_diff(got, want),
                f32_disparity_max_diff=max_diff(want, want32),
                sp_f32_disparity_max_diff=max_diff(got, want32),
                mask_agreement=agreement(got, want), f32_mask_agreement=agreement(want, want32))


def sp_bf16_gate(r):
    """(passed, why) of phase 11 (c)'s sp bfloat16 gate on ``sp_bf16_readings``
    ``r``, E the unsharded bfloat16 network's largest disparity difference
    from float32 in the same run: sp within SP_F32_FACTOR * E of float32
    and, by the triangle inequality on two evaluations each within E of
    float32, within 2E of the unsharded bfloat16 network; its road mask
    disagreement at most twice bfloat16-against-float32's (vacuous while
    neither mask holds a road pixel, as with seeded random networks)."""
    e = r["f32_disparity_max_diff"]
    dis, e_dis = 1.0 - r["mask_agreement"], 1.0 - r["f32_mask_agreement"]
    ok = (r["sp_f32_disparity_max_diff"] <= SP_F32_FACTOR * e
          and r["disparity_max_diff"] <= 2.0 * e and dis <= 2.0 * e_dis)
    return ok, (f"sp against float32 {r['sp_f32_disparity_max_diff']} <= {SP_F32_FACTOR} E; "
                f"sp against unsharded bfloat16 {r['disparity_max_diff']} <= 2 E; "
                f"E = {e}; road mask disagreement {dis} <= twice {e_dis}")


def _multi_device_rank(frames_np, work, n_timed):
    """Phase 11 on one of two ranks sharing the card (gloo): (a) dp, (b) pp,
    (c) sp in float32 and on the native network, (d) sharded frozen
    programs, each against this process's single-process port; then which
    collectives gloo takes on CUDA tensors (information)."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch import export
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.export import load_pipeline_sharded
    from semantic_depth_tpu_torch.parallel import (PipelinedPipeline, ShardedPipeline, comm,
                                                   make_mesh, make_pp_mesh, make_spatial_mesh)
    from semantic_depth_tpu_torch.runtime import set_full_fp32

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _rank_device()
    set_full_fp32()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    counters = kernel_counters()
    frames = torch.from_numpy(frames_np).to(dev)
    n, per = frames.shape[0], frames.shape[0] // world
    lo, hi = rank * per, (rank + 1) * per
    res = dict(rank=rank, backend=str(dist.get_backend()), world=world)

    def run(fn):
        """fn's output and launches, counts set to 0 just before."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts(counters)

    def traffic_of(fn):
        comm.traffic.reset()
        fn()
        torch.cuda.synchronize()
        return comm.traffic.as_dict()

    # (a) dp=2, bfloat16, grid mode, batch 8 (4 a rank)
    pipe = full_pipeline(dev, "bfloat16", "grid")
    scalars = measurable(pipe, frames)[0]
    res["same_depth"] = _same_on_every_rank(torch.tensor([pipe.config.depth]))
    dp = ShardedPipeline(pipe, make_mesh(world, dp=world, tp=1))
    dp.process_batch(frames, *scalars)  # warm-up
    out, launches = run(lambda: dp.process_batch(frames, *scalars))
    ref = pipe.process_batch(frames[lo:hi], *scalars)
    res["dp"] = dict(launches=launches, mismatch=_shard_mismatch(out, ref, lo, hi),
                     rw_found=int(out.rw_found.sum()),
                     digest_same=_same_on_every_rank(out.dist_rw.nan_to_num(-1.0)))
    res["dp"]["traffic"] = traffic_of(lambda: dp.process_batch(frames, *scalars))
    res["dp"]["batch_s"] = _timed(lambda: dp.process_batch(frames, *scalars), n_timed)[0]
    res["dp"]["single_batch_s"] = _single_alone(lambda: pipe.process_batch(frames, *scalars),
                                                n_timed)

    # (b) pp=2 (dp=1), bfloat16, batch 8, microbatch 4
    pp = PipelinedPipeline(pipe, make_pp_mesh(world, dp=1, pp=world))
    pp.process_stream(frames, 4, *scalars)
    out, launches = run(lambda: pp.process_stream(frames, 4, *scalars))
    bad = []
    for i in range(n // 4):
        ref = pipe.process_batch(frames[4 * i:4 * i + 4], *scalars)
        bad += _shard_mismatch(out, ref, 4 * i, 4 * i + 4)
    res["pp"] = dict(launches=launches, mismatch=sorted(set(bad)),
                     rw_found=int(out.rw_found.sum()), expected=_PP_STAGE_LAUNCHES[rank])
    res["pp"]["traffic"] = traffic_of(lambda: pp.process_stream(frames, 4, *scalars))
    res["pp"]["batch_s"] = _timed(lambda: pp.process_stream(frames, 4, *scalars), n_timed)[0]
    del dp, pp, pipe, out, ref
    torch.cuda.empty_cache()

    # (c) sp=2: float32, one frame; the native input_s2d network in bfloat16
    pipe = full_pipeline(dev, "float32", "grid")
    scalars = measurable(pipe, frames[:1])[0]
    sp = ShardedPipeline(pipe, make_spatial_mesh(world))
    sp.process_frame(frames[0], *scalars)
    got, launches = run(lambda: sp.process_frame(frames[0], *scalars))
    want = pipe.process_frame(frames[0], *scalars)
    a, b = got.dist_rw, want.dist_rw
    res["sp_f32"] = dict(
        launches=launches,
        disparity_ok=bool(torch.allclose(got.disparity, want.disparity, rtol=1e-5, atol=1e-5)),
        disparity_max_diff=float((got.disparity - want.disparity).abs().max()),
        nan_same=bool(torch.equal(a.isnan(), b.isnan())),
        dist_rw_ok=bool(torch.allclose(a.nan_to_num(), b.nan_to_num(), rtol=1e-4)),
        dist_rw=[float(a), float(b)], rw_found=bool(got.rw_found),
        mask_agreement=float((got.road_mask == want.road_mask).float().mean()))
    res["sp_f32"]["traffic"] = traffic_of(lambda: sp.process_frame(frames[0], *scalars))
    res["sp_f32"]["frame_s"] = _timed(lambda: sp.process_frame(frames[0], *scalars),
                                      n_timed)[0]
    res["sp_f32"]["single_frame_s"] = _single_alone(
        lambda: pipe.process_frame(frames[0], *scalars), n_timed)
    del sp, pipe
    torch.cuda.empty_cache()
    pipe = build_pipeline(native_config(compute_dtype="bfloat16"), "random", "random",
                          native_s2d=True, device=dev)
    sp = ShardedPipeline(pipe, make_spatial_mesh(world))
    sp.process_frame(frames[0])
    got, launches = run(lambda: sp.process_frame(frames[0]))
    want = pipe.process_frame(frames[0])
    # the bound: the unsharded bfloat16 network against float32 (same seeded
    # weights) on the same frame, bfloat16's own rounding
    pipe32 = build_pipeline(native_config(compute_dtype="float32"), "random", "random",
                            native_s2d=True, device=dev)
    want32 = pipe32.process_frame(frames[0])
    del pipe32
    # a planted fault the gate must reject: the halo rows zeroed where the
    # ranks' blocks meet (every exchange of both networks)
    halo_rows = comm.halo_rows

    def zeroed(x, top, bottom, group, dim=-2):
        y = halo_rows(x, top, bottom, group, dim)
        if top or bottom:
            y.narrow(dim, 0, top).zero_()
            y.narrow(dim, y.shape[dim] - bottom, bottom).zero_()
        return y

    comm.halo_rows = zeroed
    try:
        bad = sp.process_frame(frames[0])
    finally:
        comm.halo_rows = halo_rows
    res["sp_native_bf16"] = dict(
        launches=launches, disparity_max=float(want.disparity.abs().max()),
        road_pixels=[int(o.road_mask.sum()) for o in (got, want, want32)],
        **sp_bf16_readings(got, want, want32),
        fault=sp_bf16_readings(bad, want, want32))
    del want32, bad
    res["sp_native_bf16"]["traffic"] = traffic_of(lambda: sp.process_frame(frames[0]))
    res["sp_native_bf16"]["frame_s"] = _timed(lambda: sp.process_frame(frames[0]), n_timed)[0]
    res["sp_native_bf16"]["single_frame_s"] = _single_alone(
        lambda: pipe.process_frame(frames[0]), n_timed)
    del sp, pipe
    torch.cuda.empty_cache()

    # (d) sharded frozen dp=2: a bfloat16 batch-4 program at global batch 8, and a
    # float32 exact-mode batch-1 program at global batch 2 (K4 on every rank)
    mesh = make_mesh(world, dp=world, tp=1)
    for key, dtype_name, mode, batch in (("frozen_bf16", "bfloat16", "grid", per),
                                         ("frozen_exact_f32", "float32", "exact", 1)):
        pipe = full_pipeline(dev, dtype_name, mode)
        sub = frames[:batch * world]
        scalars = measurable(pipe, sub)[0]
        path = os.path.join(work, f"{key}.pt2")
        if rank == 0:
            export.export_pipeline(pipe, path, (batch,) + tuple(frames.shape[1:]),
                                   batched=True, scalars_only=False)
        dist.barrier()
        t0 = time.time()
        call = load_pipeline_sharded(path, mesh)
        load_s = time.time() - t0
        call(sub, *scalars)
        out, launches = run(lambda: call(sub, *scalars))
        ref = pipe.process_batch(sub[rank * batch:(rank + 1) * batch], *scalars)
        r = dict(launches=launches, load_s=load_s, global_batch=call.global_batch,
                 mismatch=_shard_mismatch(out, ref, rank * batch, (rank + 1) * batch),
                 rw_found=int(out.rw_found.sum()),
                 digest_same=_same_on_every_rank(out.dist_rw.nan_to_num(-1.0)))
        r["traffic"] = traffic_of(lambda: call(sub, *scalars))
        r["batch_s"] = _timed(lambda: call(sub, *scalars), n_timed)[0]
        r["single_batch_s"] = _single_alone(lambda: pipe.process_batch(sub, *scalars), n_timed)
        res[key] = r
        del pipe, call, out, ref
        torch.cuda.empty_cache()

    res.update(_fence_rank(dev, frames, work, mesh, run))

    # which collectives gloo takes on CUDA tensors as they are (information;
    # comm.py stages CUDA tensors through host memory either way)
    takes = {}
    x = torch.arange(4.0, device=dev) + rank
    for name, fn in (("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(x) for _ in range(world)], x)),
                     ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
                     ("all_reduce", lambda: dist.all_reduce(x.clone()))):
        try:
            fn()
            torch.cuda.synchronize()
            takes[name] = True
        except (RuntimeError, ValueError) as e:
            takes[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    res["gloo_cuda_collectives"] = takes
    return res


def _fence_rank(dev, frames, work, mesh, run):
    """Phase 11 (f) on one rank: the fence chain on real points (stand-in
    networks), dp=2 live and a sharded frozen program, against the single
    process's whole batch (checked by the parent). ``run(fn)`` gives fn's
    output and launches."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch import export
    from semantic_depth_tpu_torch.export import load_pipeline_sharded
    from semantic_depth_tpu_torch.parallel import ShardedPipeline

    res = {}
    rank, world = dist.get_rank(), dist.get_world_size()
    per = frames.shape[0] // world
    pipe, scalars, f2f_true = scene_pipeline(dev, "bfloat16", "grid", n=1)
    f2f_true = f2f_true.repeat(frames.shape[0])
    live = pipe.process_batch(frames, *scalars)
    dp = ShardedPipeline(pipe, mesh)
    dp.process_batch(frames, *scalars)
    out, launches = run(lambda: dp.process_batch(frames, *scalars))
    res["fence_dp"] = dict(launches=launches, dist_f2f=out.dist_f2f.tolist(),
                           live_dist_f2f=live.dist_f2f.tolist(), f2f_true=f2f_true.tolist())
    path = os.path.join(work, "fence.pt2")
    if rank == 0:
        export.export_pipeline(pipe, path, (per,) + tuple(frames.shape[1:]), batched=True,
                               scalars_only=False)
    dist.barrier()
    call = load_pipeline_sharded(path, mesh)
    call(frames, *scalars)
    out, launches = run(lambda: call(frames, *scalars))
    res["fence_frozen_dp"] = dict(launches=launches, dist_f2f=out.dist_f2f.tolist(),
                                  live_dist_f2f=live.dist_f2f.tolist(),
                                  f2f_true=f2f_true.tolist())
    return res


def _nccl_rank(frames_np):
    """Phase 11 (e): one rank over NCCL (world size 1): dp=1 serving and each
    collective of comm.py on CUDA tensors, without host staging."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.parallel import ShardedPipeline, comm, make_mesh
    from semantic_depth_tpu_torch.runtime import set_full_fp32

    dev = _rank_device()
    set_full_fp32()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    counters = kernel_counters()
    frames = torch.from_numpy(frames_np).to(dev)
    pipe = full_pipeline(dev, "bfloat16", "grid")
    dp = ShardedPipeline(pipe, make_mesh(1, dp=1, tp=1))
    dp.process_batch(frames)
    reset_counts()
    out = dp.process_batch(frames)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    ref = pipe.process_batch(frames)
    x = torch.randn(2, 6, 5, device=dev)
    x[0, 0, 0] = -0.0
    comm.traffic.reset()
    gathered = comm.all_gather_dim(x, 1, None)
    halo = comm.halo_rows(x, 2, 1, None, dim=1)
    back = comm.broadcast(x, 0, None, dev)
    zero = torch.zeros(2, 2, 5, device=dev)
    ok = (torch.equal(gathered, x) and torch.equal(back, x)
          and torch.equal(halo, torch.cat([zero, x, zero[:, :1]], 1))
          and bool(torch.signbit(back[0, 0, 0])))
    return dict(backend=str(dist.get_backend()), launches=launches,
                mismatch=_outputs_mismatch(out, ref), comm_ok=ok,
                traffic=comm.traffic.as_dict())


def phase_multi_device(frames, smi, n_timed=5):
    """Phase 11: multi-device serving with two ranks sharing the card
    (``parallel/launch.run_ranks``), then one rank over NCCL."""
    from semantic_depth_tpu_torch.parallel.launch import run_ranks

    log("[phase 11] multi-device serving: 2 ranks on one card (gloo), 8 x 1024x2048 frames")
    frames_np = frames.cpu().numpy()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks(_multi_device_rank, 2, frames_np, work, n_timed, timeout_s=600)
    wall = time.time() - t0
    for r in ranks:
        k = r["rank"]
        check(r["backend"] == "gloo" and r["world"] == 2, f"rank {k}: backend {r['backend']}")
        check(r["same_depth"], f"rank {k}: both ranks measure at the same depth")
        for key in ("dp", "frozen_bf16", "frozen_exact_f32"):
            expect = EXACT_LAUNCHES if key == "frozen_exact_f32" else GRID_LAUNCHES
            check(r[key]["launches"] == expect, f"rank {k} {key}: launches {r[key]['launches']}")
            check(not r[key]["mismatch"] and r[key]["digest_same"] and r[key]["rw_found"] > 0,
                  f"rank {k} {key}: its shard bit-equal to single-process process_batch "
                  f"(differ: {r[key]['mismatch']}; {r[key]['rw_found']} widths found), the "
                  "gathered outputs the same on both ranks")
        check(r["pp"]["launches"] == r["pp"]["expected"],
              f"rank {k} pp stage {k}: launches {r['pp']['launches']}")
        check(not r["pp"]["mismatch"] and r["pp"]["rw_found"] > 0,
              f"rank {k} pp: every microbatch bit-equal to process_batch "
              f"(differ: {r['pp']['mismatch']})")
        sp = r["sp_f32"]
        check(sp["launches"] == GRID_LAUNCHES, f"rank {k} sp: launches {sp['launches']}")
        check(sp["disparity_ok"] and sp["nan_same"] and sp["dist_rw_ok"] and sp["rw_found"],
              f"rank {k} sp float32: disparity within 1e-5 (max diff "
              f"{sp['disparity_max_diff']}), dist_rw {sp['dist_rw']} within rtol 1e-4")
        check(sp["traffic"]["halo"]["calls"] > 0, f"rank {k} sp: halo rows exchanged")
        nat = r["sp_native_bf16"]
        check(nat["launches"] == GRID_LAUNCHES, f"rank {k} sp native: launches {nat['launches']}")
        ok, why = sp_bf16_gate(nat)
        check(ok, f"rank {k} sp native bfloat16 within bfloat16's own rounding (disparity of "
              f"{nat['disparity_max']}; road pixels sp / bf16 / f32 {nat['road_pixels']}): {why}")
        ok, why = sp_bf16_gate(nat["fault"])
        check(not ok, f"rank {k} sp native bfloat16 with the halo rows zeroed fails that gate: "
              f"{why}")
        for key in ("fence_dp", "fence_frozen_dp"):
            fen = r[key]
            check(fen["launches"] == GRID_LAUNCHES, f"rank {k} {key}: launches {fen['launches']}")
            fen.update(fence_gate(f"rank {k} {key}", fen["dist_f2f"], fen["live_dist_f2f"],
                                  fen["f2f_true"]))
    r0 = ranks[0]
    log(f"  {smi}: backend gloo, world size 2, ranks sharing one card; gloo on CUDA tensors: "
        f"{r0['gloo_cuda_collectives']}")
    for key, label in (("dp", "dp=2"), ("pp", "pp=2"), ("frozen_bf16", "frozen dp=2 bf16"),
                       ("frozen_exact_f32", "frozen dp=2 exact f32")):
        r = r0[key]
        nb = 8 if key in ("dp", "pp", "frozen_bf16") else 2
        single = r0["dp"]["single_batch_s"] if key == "pp" else r["single_batch_s"]
        t = r["traffic"]
        moved = {kind: (t[kind]["bytes"], round(t[kind]["ms"], 3)) for kind in t
                 if t[kind]["calls"]}
        log(f"  {smi}: {label}: {nb / r['batch_s']:.2f} frames/s with two ranks on one card, "
            f"single process {nb / single:.2f}; rank 0 collectives per batch "
            f"(bytes, ms) {moved}")
    for key in ("sp_f32", "sp_native_bf16"):
        r = r0[key]
        t = r["traffic"]
        log(f"  {smi}: {key}: {r['frame_s'] * 1e3:.2f} ms per frame with two ranks on one "
            f"card, process_frame alone {r['single_frame_s'] * 1e3:.2f}; halo "
            f"{t['halo']['calls']} exchanges, {t['halo']['bytes']} bytes, "
            f"{t['halo']['ms']:.2f} ms per frame; gathers {t['gather']['bytes']} bytes")

    log("[phase 11] (e) one rank over NCCL (world size 1, dp=1)")
    t1 = time.time()
    (nccl,) = run_ranks(_nccl_rank, 1, frames_np[:4], timeout_s=300)
    check(nccl["backend"] == "nccl", f"one rank on its own card: backend {nccl['backend']}")
    check(nccl["launches"] == GRID_LAUNCHES and not nccl["mismatch"],
          f"NCCL dp=1: launches {nccl['launches']}, outputs equal process_batch "
          f"(differ: {nccl['mismatch']})")
    check(nccl["comm_ok"], "NCCL: all_gather_dim, halo_rows and broadcast exact on CUDA tensors")
    log(f"  phase 11 wall {wall:.1f} s (2 ranks), {time.time() - t1:.1f} s (NCCL rank)")
    return dict(ranks=ranks, nccl=nccl, wall_s=wall)

# --- phase 12: multi-device training, two ranks sharing the one card ----------
def _as_trainer(state, grads):
    """Full parameters and gradients by name, as ``probes.train_step_agreement``
    reads a trainer (``.model.named_parameters()`` with ``.grad``)."""
    from types import SimpleNamespace

    params = []
    for name, t in state.items():  # host copies: the card's memory stays the trainer's
        p = torch.nn.Parameter(t.detach().to("cpu", copy=True), requires_grad=False)
        p.grad = grads[name].detach().to("cpu", copy=True)
        params.append((name, p))
    return SimpleNamespace(model=SimpleNamespace(named_parameters=lambda: list(params)))


def _full_state(trainer, mesh):
    """The trainer's full parameters and gradients (gathered over tp under a
    mesh; every rank of the mesh must call this)."""
    from semantic_depth_tpu_torch.parallel.train_step import gather_state_dict

    named = dict(trainer.model.named_parameters())
    grads = {k: p.grad for k, p in named.items()}
    if mesh is not None:
        return gather_state_dict(mesh, named), gather_state_dict(mesh, grads)
    return named, grads


def _replica_digests(trainer):
    """sha256 of this rank's replicated parameters with their Adam moments,
    and of its tp blocks with theirs."""
    import hashlib

    from semantic_depth_tpu_torch.parallel.train_step import SPLIT_DIMS

    hashes = {True: hashlib.sha256(), False: hashlib.sha256()}
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state[p]
        for t in (p, st["exp_avg"], st["exp_avg_sq"]):
            hashes[name in SPLIT_DIMS].update(
                t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return dict(replicated=hashes[False].hexdigest(), blocks=hashes[True].hexdigest())


def _train_case(make, batch, mesh, n_steps, single):
    """``n_steps`` steps of ``make(mesh)`` on ``batch``: the losses, the
    first step's full parameters and gradients (on rank 0, as a trainer
    view), ms of the later steps (median), the reduce traffic per later
    step, this rank's peak device memory over the later steps and the
    replica digests.
    ``single``: rank 0 alone, with the card to itself, the others waiting."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.parallel import comm

    rank = dist.get_rank()
    res = {}
    if not single or rank == 0:
        trainer = make(mesh)
        before = ({k: v.detach().cpu().clone() for k, v in trainer.model.named_parameters()}
                  if mesh is None else None)
        losses = [trainer.train_batch(*batch)["loss"]]
        state, grads = _full_state(trainer, mesh)
        view = _as_trainer(state, grads) if rank == 0 else None
        del state, grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comm.traffic.reset()
        times = []
        for _ in range(n_steps - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_batch(*batch)["loss"])
            times.append(time.perf_counter() - t0)
        t = comm.traffic.as_dict()["reduce"]
        res = dict(losses=losses, step_ms=statistics.median(times) * 1e3, view=view,
                   before=before, step_ms_all=[x * 1e3 for x in times],
                   reduce_bytes_per_step=t["bytes"] / (n_steps - 1),
                   reduce_ms_per_step=t["ms"] / (n_steps - 1),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if mesh is not None:
            res["digests"] = _replica_digests(trainer)
        del trainer
        torch.cuda.empty_cache()
    if single:
        dist.barrier()
    return res


def _training_rank(fcn_batch, stereo, n_steps):
    """Phase 12 (a) and (b) on one of two ranks sharing the card (gloo):
    FCN-8s at full width on meshes (dp 1, tp 2) and (2, 1), monodepth-vgg at
    dp 2, each against the single-process trainer from the same parameters
    and seed, run on rank 0 with the card to itself."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.config import TrainConfig
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.parallel import make_mesh
    from semantic_depth_tpu_torch.runtime import set_full_fp32
    from semantic_depth_tpu_torch.train.monodepth_trainer import (MonodepthTrainConfig,
                                                                  MonodepthTrainer)
    from semantic_depth_tpu_torch.train.trainer import FCNTrainer
    from semantic_depth_tpu_torch.utils.probes import train_step_agreement

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _rank_device()
    set_full_fp32()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    counters = kernel_counters()
    reset_counts()
    cfg = TrainConfig(batch_size=8)  # lr 1e-5, keep 0.5: the reference's

    def fcn(mesh):
        model = FCN8s(dropout_keep_prob=cfg.dropout, generator=torch.Generator().manual_seed(0))
        return FCNTrainer(cfg, model=model, seed=3, device=dev, mesh=mesh)

    mcfg = MonodepthTrainConfig()

    def mono(mesh):
        return MonodepthTrainer(mcfg, model=Monodepth(generator=torch.Generator().manual_seed(1)),
                                device=dev, mesh=mesh)

    out = dict(backend=str(dist.get_backend()), world=world)
    for key, make, batch, meshes, lr in (
            ("fcn", fcn, fcn_batch, ((1, 2), (2, 1)), cfg.learning_rate),
            ("monodepth", mono, stereo, ((2, 1),), mcfg.learning_rate)):
        single = _train_case(make, batch, None, n_steps, single=True)
        for dp, tp in meshes:
            got = _train_case(make, batch, make_mesh(world, dp=dp, tp=tp), n_steps, False)
            if rank == 0:
                got["agreement"] = train_step_agreement(single["view"], got["view"],
                                                        single["before"], lr)
                got["single_losses"] = single["losses"]
                got["single_step_ms"] = single["step_ms"]
                got["single_peak_mem_gib"] = single["peak_mem_gib"]
            got.pop("view"), got.pop("before")
            out[f"{key} dp={dp} tp={tp}"] = got
        del single
    out["launches"] = read_counts(counters)
    return out


def phase_multi_device_training(dev, frames, smi, n_steps=3):
    """Phase 12: multi-device training with two ranks sharing the card
    (``parallel.launch.run_ranks``), ``cli.fcn --mesh`` under torchrun, and
    the bench-weight tool in short phases at full width."""
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.models import weights
    from semantic_depth_tpu_torch.parallel.launch import run_ranks
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool
    from semantic_depth_tpu_torch.utils.make_mockup import make_mockup
    from tools import train_bench_weights_torch as tool

    log("[phase 12] multi-device training: 2 ranks on one card (gloo), full width, 256x512, "
        "batch 8, float32")
    t_phase = time.time()
    imgs, labels = scene_pool(8, 256, 512, seed=5)[:2]
    fcn_batch = (imgs.astype(np.float32), tool._onehot_labels(labels))
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (8, 256, 512, 3)).astype(np.float32)
    for _ in range(2):
        base[:, :, 1:-1] = (base[:, :, :-2] + base[:, :, 1:-1] + base[:, :, 2:]) / 3
        base[:, 1:-1] = (base[:, :-2] + base[:, 1:-1] + base[:, 2:]) / 3
    stereo = (base, np.roll(base, -4, axis=2))
    ranks = run_ranks(_training_rank, 2, fcn_batch, stereo, n_steps, timeout_s=900)
    wall = time.time() - t_phase
    r0 = ranks[0]
    check(r0["backend"] == "gloo" and r0["world"] == 2, f"training ranks: backend {r0['backend']}")
    res = dict(wall_s=wall, cases={}, launches=[r["launches"] for r in ranks])
    check(not any(v for r in ranks for v in r["launches"].values()),
          f"the training ranks launch no port kernel ({res['launches']})")
    for key in [k for k in r0 if k.startswith(("fcn ", "monodepth "))]:
        got = r0[key]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], got["single_losses"]))
        check(rel <= 1e-4, f"{key}: {n_steps} step losses within rel 1e-4 of the single "
              f"process's (worst {rel:.2e}; {got['losses']} against {got['single_losses']})")
        agree = got["agreement"]
        check(agree["grad_rel"] < 1e-3 and agree["grad_rel_param"] < 1e-2
              and agree["step_err_lr"] < 1e-2 and agree["moved"] > 0.99,
              f"{key}: the first step's gathered gradients and parameters agree with the "
              f"single process's ({agree})")
        digests = [r[key]["digests"] for r in ranks]
        check(digests[0]["replicated"] == digests[1]["replicated"],
              f"{key}: replicated parameters and Adam moments bit-equal on both ranks after "
              f"{n_steps} steps")
        tp = int(key.split("tp=")[1])
        check((digests[0]["blocks"] == digests[1]["blocks"]) == (tp == 1),
              f"{key}: the tp blocks {'differ' if tp > 1 else 'agree'} between the ranks")
        log(f"  {smi}: {key}: {got['step_ms']:.2f} ms a step with two ranks on one card "
            f"(single process {got['single_step_ms']:.2f}); reduce "
            f"{got['reduce_bytes_per_step']:.0f} bytes, {got['reduce_ms_per_step']:.2f} ms a step "
            f"(rank 0); peak {got['peak_mem_gib']:.2f} / {ranks[1][key]['peak_mem_gib']:.2f} GiB "
            f"a rank (single {got['single_peak_mem_gib']:.2f})")
        res["cases"][key] = dict(got, peak_mem_gib_rank1=ranks[1][key]["peak_mem_gib"])
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        log("[phase 12] (c) cli.fcn --mode train --mesh under torchrun, 2 processes")
        make_mockup(os.path.join(tmp, "data"), counts=(8, 2, 2), hw=(256, 512), seed=0)
        name = "1-Epochs-roborace_mockup"
        cmd = ["torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m",
               "semantic_depth_tpu_torch.cli.fcn", "--mode", "train", "--epochs", "1",
               "--dataset", "roborace_mockup", "--data_dir", os.path.join(tmp, "data"),
               "--model_dir", os.path.join(tmp, "models"), "--logging_dir",
               os.path.join(tmp, "log"), "--runs_dir", os.path.join(tmp, "runs"), "--mesh"]
        secs, text = _run_cli("torchrun cli.fcn --mesh", cmd, repo, cwd=tmp)
        fcn_path = os.path.join(tmp, "models", name, "fcn8s.msgpack")
        check("backend gloo, world size 2" in text and text.count("Epoch 1/1:") == 1
              and os.path.isfile(fcn_path)
              and os.path.isfile(os.path.join(tmp, "models", name, "checkpoints", "step_8",
                                              "state.pt")),
              "cli.fcn --mesh: two gloo ranks, rank 0 alone prints, fcn8s.msgpack and the "
              "step-8 checkpoint written")
        pipe = build_pipeline(munich_pipeline_config(), fcn_path, "random", device=dev)
        with torch.inference_mode():
            out = pipe.process_batch(frames)
        check(bool(torch.isfinite(out.overlay_small).all()) and pipe.fcn.fc6.weight.shape[0]
              == 4096, "cli.fcn --mesh's fcn8s.msgpack (full fc6) served by build_pipeline")
        res["cli"] = dict(process_s=secs)
        del pipe, out

        log("[phase 12] (d) tools/train_bench_weights_torch.py, 30 steps a network, "
            "256x512, batch 8")
        lines = []
        t0 = time.time()
        phases = [((256, 512), 16, 8, 30)]
        paths = tool.ensure_bench_weights(os.path.join(tmp, "bench"), fcn_phases=phases,
                                          mono_phases=phases, log=lines.append)
        train_s = time.time() - t0
        for net in ("fcn", "mono"):
            ls = [float(x.split("loss ")[1].split()[0]) for x in lines
                  if x.startswith(f"  {net} ph0")]
            check(len(ls) == 2 and np.isfinite(ls).all() and ls[1] < ls[0],
                  f"bench-weight tool, {net}: loss {ls[0]} at step 0, {ls[1]} at step 29")
        trees = [weights.load_params(p) for p in paths]
        check(all("params" in t for t in trees), f"both sets load through models/weights "
              f"({[os.path.basename(p) for p in paths]})")
        mae, finite, counts = tool.serve_rw_mae(*paths, n_frames=8, device=dev)
        check(counts == GRID_LAUNCHES, f"the tool's sets served: launches {counts}")
        log(f"  {smi}: bench-weight tool: 2 x 30 steps and the msgpacks in {train_s:.1f} s; "
            f"bfloat16 process_batch rw MAE {mae} m over the finite {finite:.3f} of 8 scenes "
            "(30 steps train nothing: not gated)")
        res["bench_weights"] = dict(train_s=train_s, rw_mae_m=mae, finite=finite,
                                    launches=counts, log=lines)
    res["wall_s"] = time.time() - t_phase
    log(f"  phase 12 wall {res['wall_s']:.1f} s ({wall:.1f} s the two training ranks)")
    return res


# --- phase 13: K1 and K4 at every parameter, and the offline tools ------------
# (k, window) cases of the general K1 kernel; (20, (7, 31)) is the path's
K1_GENERAL_CASES = ((20, (5, 21)), (10, (7, 21)), (10, (5, 31)), (10, (7, 31)), (6, (4, 20)),
                    (40, (9, 33)), (32, (7, 31)), (33, (7, 31)), (20, (7, 31)))
K1_PATH = (20, (7, 31))  # the road config phase 13's process_batch runs
K1_ROAD = (10, (5, 21))  # the road chain's setting: the specialised kernel
# k = 32 takes the register walks: the reference for the large-k walks' k = 33
K4_LARGE_K = (32, 33, 50, 64, 100)
K4_PATH_K = 50  # the outlier tool's --nb_neighbors in phase 13


def param_counters():
    """``kernel_counters`` and the two kernels phase 13 adds, by row name."""
    return dict(kernel_counters(), knn_grid_general="knn_grid.general",
                exact_knn_large_k="exact_knn.large_k")


def _same(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def phase_k1_general(dev, scenes):
    """The general K1 kernel against its plain version at every case, on
    grids with valid +-inf points, at the native size, and the road chain's
    setting still on the specialised kernel."""
    from semantic_depth_tpu_torch import camera, config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.ops import knn_grid
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, recording_kernel_calls

    log("[phase 13] (a) K1 general kernel at other (k, window), (8, 256, 512)")
    fn, plain = knn_grid.knn_mean_distances_grid, knn_grid.knn_mean_distances_grid_plain
    cfg = config.munich_pipeline_config()
    g = torch.Generator(device="cpu").manual_seed(13)
    pts_scene = camera.reproject_disparity(scenes["disp"][:4], cfg.camera)
    valid_scene = scenes["road"][:4] & (pts_scene[..., 2] < -cfg.road.z_keep_beyond)
    pts_rand = torch.randn((4, 256, 512, 3), generator=g).to(dev) * torch.tensor(
        [2.0, 0.3, 5.0], device=dev)
    valid_rand = (torch.rand((4, 256, 512), generator=g) < 0.3).to(dev)
    pts = torch.cat([pts_scene, pts_rand]).contiguous()
    valid = torch.cat([valid_scene, valid_rand]).contiguous()
    cases = {}
    launches = launch_registry()
    for k, window in K1_GENERAL_CASES:
        before = launches["knn_grid.general"]
        got, want = fn(pts, valid, k, window), plain(pts, valid, k, window)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        check(launches["knn_grid.general"] == before + 1 and torch.equal(got, want),
              f"K1 general k={k} window={window}: one general launch, bit-equal to the plain "
              f"version ({int(fin.sum())} finite of {fin.numel()})")
        tx, ty, smem = knn_grid.general_block(k, window)
        t_bound, by = knn_grid_bound(valid, k, window)
        case = dict(k=k, window=list(window), block=[tx, ty], smem_bytes=smem,
                    ms=cuda_ms(lambda: fn(pts, valid, k, window), iters=10),
                    plain_ms=cuda_ms(lambda: plain(pts, valid, k, window), iters=2, warmup=1),
                    bound_ms=t_bound, bound_by=by, finite=int(fin.sum()))
        cases[f"k={k} window={window}"] = case
        log(f"  K1 general k={k} {window}: block {tx}x{ty} ({smem} B shared), kernel "
            f"{case['ms']:.4f} ms, plain {case['plain_ms']:.3f} ms, bound {t_bound:.4f} ms ({by})")

    disp0 = scenes["disp"][:2].clone()
    disp0[0, 150:170, 100:300] = 0.0
    disp0[1, 200:256, :] = 0.0
    pts_inf = camera.reproject_disparity(disp0, cfg.camera).contiguous()
    valid_inf = torch.ones((2, 256, 512), dtype=torch.bool, device=dev)
    valid_inf[1, ::3] = False
    for k, window in ((20, (7, 31)), (6, (4, 20)), (40, (9, 33))):
        got, want = fn(pts_inf, valid_inf, k, window), plain(pts_inf, valid_inf, k, window)
        torch.cuda.synchronize()
        check(_same(got, want), f"K1 general k={k} {window} with valid +-inf points bit-equal "
              f"({int(want.isnan().sum())} nan, {int(torch.isinf(want[valid_inf]).sum())} +inf "
              "among the valid pixels)")

    log("[phase 13] (a) K1 general at the native (2, 1024, 2048), window (7, 31)")
    nat = scene_batch(2, 1024, 2048, seed=7, dev=dev)
    base = native_config()
    ncfg = dataclasses.replace(base, road=dataclasses.replace(base.road, stat_window=(7, 31)))
    cam, _ = pipeline._scaled_camera(ncfg, ncfg.camera.focal)
    tiny = pipeline.SemanticDepthPipeline(
        ncfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=dev)
    with torch.inference_mode(), recording_kernel_calls() as calls:
        tiny._batch_geometry(*[nat[k] for k in ("small", "road", "fence", "disp")], cam)
    (npts, nvalid, nk, nwin), = calls["knn_grid"]
    check(tuple(npts.shape) == (2, 1024, 2048, 3) and (nk, tuple(nwin)) == (10, (7, 31)),
          f"K1 native launch under stat_window (7, 31): {tuple(npts.shape)}, k={nk}")
    got, want = fn(npts, nvalid, nk, nwin), plain(npts, nvalid, nk, nwin)
    torch.cuda.synchronize()
    check(_same(got, want), f"K1 general native (2, 1024, 2048) k=10 (7, 31) bit-equal "
          f"({int(torch.isfinite(want).sum())} finite)")
    t_bound, by = knn_grid_bound(nvalid, nk, tuple(nwin))
    native = dict(ms=cuda_ms(lambda: fn(npts, nvalid, nk, nwin), iters=10),
                  plain_ms=cuda_ms(lambda: plain(npts, nvalid, nk, nwin), iters=2, warmup=1),
                  bound_ms=t_bound, bound_by=by)
    log(f"  K1 general native k=10 (7, 31): kernel {native['ms']:.4f} ms, plain "
        f"{native['plain_ms']:.3f} ms, bound {t_bound:.4f} ms ({by})")
    del nat, tiny, calls, npts, nvalid

    before = launches.copy()
    got = fn(pts, valid, knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW)
    torch.cuda.synchronize()
    check(launches - before == {"knn_grid": 1}
          and torch.equal(got, plain(pts, valid, knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW)),
          "K1 at the road chain's k=10 (5, 21) launches the specialised kernel, bit-equal")
    main = cases[f"k={K1_PATH[0]} window={K1_PATH[1]}"]
    row = dict(name="knn_grid_general", route="cuda",
               source="semantic_depth_tpu_torch/csrc/knn_grid.cu",
               replaces="semantic_depth_tpu/ops/pallas_knn.py:36", max_abs_err=0.0,
               ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None, library_note=_NO_LIBRARY,
               shape=f"points (8, 256, 512, 3) f32, valid (8, 256, 512), k={K1_PATH[0]}, "
                     f"window {K1_PATH[1]}", cases=cases, native=native)
    return row, (pts, valid)


def phase_k4_large_k(dev, scenes, scene_cloud):
    """The large-k K4 kernel against its plain version at k = 33, 50, 64 and
    100 on the exact mode's road clouds and the scene cloud."""
    from semantic_depth_tpu_torch.ops import exact_knn
    from semantic_depth_tpu_torch.utils.probes import cuda_ms

    log("[phase 13] (b) K4 large-k kernels at k = 33, 50, 64, 100 (k = 32: the register walks)")
    fn, plain = exact_knn.knn_mean_distances_exact, exact_knn.knn_mean_distances_exact_plain
    xyz, valid = exact_road_clouds(scenes)
    big_xyz, big_valid, _ = scene_cloud
    cases = {}
    launches = launch_registry()
    for k in K4_LARGE_K:
        for name, (x, v) in (("road (8, 16384)", (xyz, valid)),
                             ("scene (1, 131072)", (big_xyz, big_valid))):
            before = launches["exact_knn.large_k"]
            got, want = fn(x, v, k), plain(x, v, k)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
            large = int(k > exact_knn.REGISTER_MAX_K)
            check(launches["exact_knn.large_k"] == before + large and torch.equal(got, want)
                  and bool(torch.isfinite(got[v]).all()),
                  f"K4 k={k} {name}: {large} large-k launch, bit-equal to the plain version "
                  f"(max abs err {err}, {int(fin.sum())} finite)")
            if name.startswith("road"):
                check(torch.equal(fn(x, v, k, skip=False), want),
                      f"K4 k={k} {name}: bit-equal with the box skip off")
            t_bound, by, needed, _, _ = exact_knn_bound(v, k)
            case = dict(k=k, ms=cuda_ms(lambda: fn(x, v, k), iters=5, warmup=1),
                        bound_ms=t_bound, bound_by=by, pairs_needed=needed, max_abs_err=err,
                        counts=exact_knn_scanned(x, v, k)[3])
            if k == K4_PATH_K or name.startswith("road"):
                case["plain_ms"] = cuda_ms(lambda: plain(x, v, k), iters=1, warmup=1)
            cases[f"k={k} {name}"] = case
            log(f"  K4 k={k} {name}: kernel {case['ms']:.4f} ms, plain "
                f"{case.get('plain_ms', float('nan')):.3f} ms, bound {t_bound:.5f} ms ({by}); "
                f"counts {case['counts']}")
    main = cases[f"k={K4_PATH_K} scene (1, 131072)"]
    cases = {key: c for key, c in cases.items() if c["k"] > exact_knn.REGISTER_MAX_K} | {
        key + " (register walks)": c for key, c in cases.items()
        if c["k"] <= exact_knn.REGISTER_MAX_K}
    row = dict(name="exact_knn_large_k", route="cuda",
               source="semantic_depth_tpu_torch/csrc/exact_knn.cu",
               replaces="semantic_depth_tpu/ops/pallas_exact_knn.py:32",
               max_abs_err=max(c["max_abs_err"] for c in cases.values()),
               ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None, library_note=_NO_LIBRARY,
               shape=f"xyz (1, 131072, 3) f32 (a scene cloud with outliers), k={K4_PATH_K}",
               cases=cases)
    return row


def phase_outlier_large_k(dev, scene_cloud, counters):
    """The outlier tool at --nb_neighbors 50: as a subprocess against the
    plain versions' keep set, and ``filter_ply`` in process with the
    launches counted (the large-k K4 row's path)."""
    from semantic_depth_tpu_torch.io.ply import PlyCloud, read_ply
    from semantic_depth_tpu_torch.ops import exact_knn, neighbors, radius
    from semantic_depth_tpu_torch.utils.outlier_removal import filter_ply

    log(f"[phase 13] (c) outlier_removal --nb_neighbors {K4_PATH_K} on the (1, 131072) scene "
        "cloud")
    repo = os.path.dirname(os.path.abspath(__file__))
    xyz, _, rgb = scene_cloud
    with tempfile.TemporaryDirectory() as tmp:
        src = PlyCloud(xyz[0].cpu().numpy(), rgb[0].cpu().numpy(),
                       os.path.join(tmp, "scene")).save()
        out = os.path.join(tmp, "inliers.ply")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "semantic_depth_tpu_torch.utils.outlier_removal", src,
             "--out", out, "--nb_neighbors", str(K4_PATH_K)], cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
        sub_s = time.time() - t0
        log("  " + "\n  ".join(proc.stdout.strip().splitlines()[-3:]))
        check(proc.returncode == 0, f"outlier_removal --nb_neighbors {K4_PATH_K} exits 0 "
              f"({sub_s:.1f} s)")
        pts, cols = read_ply(src)
        n = pts.shape[0]
        cap = 1 << max(10, (n - 1).bit_length())
        x = np.zeros((cap, 3), np.float32)
        rgb_np = np.zeros((cap, 3), np.float32)
        x[:n], rgb_np[:n] = pts, cols
        xt = torch.from_numpy(x)[None].to(dev)
        vt = (torch.arange(cap) < n)[None].to(dev)
        keep = neighbors._statistical_keep(
            exact_knn.knn_mean_distances_exact_plain(xt, vt, K4_PATH_K), vt, 0.5)
        keep = (keep & (radius.radius_counts_plain(xt, keep, keep.float(), 0.5) > 80))[0]
        keep = keep.cpu().numpy()
        want = PlyCloud(x[keep], rgb_np[keep], os.path.join(tmp, "plain")).save()
        with open(out, "rb") as a, open(want, "rb") as b:
            same = a.read() == b.read()
        check(same, f"the CLI at --nb_neighbors {K4_PATH_K} keeps what the plain K4 + K3 "
              f"versions keep on the card ({int(keep.sum())} of {n} points)")
        reset_counts()
        t0 = time.perf_counter()
        filter_ply(src, os.path.join(tmp, "again.ply"), nb_neighbors=K4_PATH_K)
        inproc_s = time.perf_counter() - t0
        counts = read_counts(counters)
    check(counts["exact_knn"] == 1 and counts["exact_knn_large_k"] == 1
          and counts["radius"] == 1 and counts["knn_grid"] == 0,
          f"filter_ply --nb_neighbors {K4_PATH_K}: launches {counts}")
    return dict(points=n, kept=int(keep.sum()), subprocess_s=sub_s,
                filter_ply_in_process_s=inproc_s, launches=counts)


def phase_frame_program_7_31(dev, scenes, frames, counters):
    """process_batch under stat_window (7, 31), k = 20: the geometry tail on
    the card against the CPU on analytic scenes, and the full-width bfloat16
    program's launches (the general K1 row's path), with the road chain's
    default setting on the same networks beside it."""
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    k, window = K1_PATH
    log(f"[phase 13] (d) process_batch under stat_window {window}, stat_nb_neighbors {k}")

    def road_cfg(**kw):
        base = config.munich_pipeline_config(**kw)
        return dataclasses.replace(base, road=dataclasses.replace(
            base.road, stat_window=window, stat_nb_neighbors=k))

    cfg = road_cfg()
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    args = [scenes[key] for key in ("small", "road", "fence", "disp")]
    pipes = {d: pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=d)
        for d in (dev, "cpu")}
    reset_counts()
    with torch.inference_mode():
        out_gpu = pipes[dev]._batch_geometry(*args, cam)
        torch.cuda.synchronize()
        tail_counts = read_counts(counters)
        t0 = time.time()
        out_cpu = pipes["cpu"]._batch_geometry(*[a[:2].cpu() for a in args], cam)
        cpu_s = time.time() - t0
    rw_g, rw_c = out_gpu.dist_rw.cpu().numpy(), out_cpu.dist_rw.numpy()
    f2f_g, f2f_c = out_gpu.dist_f2f.cpu().numpy(), out_cpu.dist_f2f.numpy()
    check(np.allclose(rw_g[:2], rw_c, atol=1e-3, rtol=0, equal_nan=True)
          and np.allclose(f2f_g[:2], f2f_c, atol=1e-3, rtol=0, equal_nan=True)
          and np.array_equal(out_gpu.rw_found[:2].cpu().numpy(), out_cpu.rw_found.numpy()),
          f"(7, 31) k=20 tail: scenes 0-1 on the card within 1e-3 m of the CPU "
          f"(rw {rw_g[:2].tolist()} / {rw_c.tolist()}; CPU {cpu_s:.1f} s)")
    rw_mae = float(np.mean(np.abs(rw_g - scenes["rw_true"])))
    check(np.isfinite(rw_mae) and rw_mae < 0.1, f"(7, 31) k=20 tail: rw MAE {rw_mae:.4f} m "
          "< 0.1 m over the 8 scenes")
    del pipes

    pipe = full_pipeline(dev, "bfloat16", "grid")
    expect = dict(GRID_LAUNCHES, knn_grid_general=1, exact_knn_large_k=0)
    check(tail_counts == expect, f"(7, 31) k=20 tail launches per batch {tail_counts}")
    res = dict(rw_mae_m=rw_mae, max_cuda_cpu_rw_m=float(np.nanmax(np.abs(rw_g[:2] - rw_c))),
               cpu_s_two_scenes=cpu_s, tail_launches=tail_counts)
    for key, c in (("(7, 31) k=20", road_cfg(compute_dtype="bfloat16")),
                   ("default (5, 21) k=10", pipe.config)):
        pipe.config = c
        pipe.process_batch(frames)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        out = pipe.process_batch(frames)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        want = dict(expect, knn_grid_general=int(key.startswith("(7")))
        check(counts == want and bool(torch.isfinite(out.disparity).all()),
              f"process_batch bf16 batch 8, {key}: launches {counts}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe.process_batch(frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[key] = dict(launches=counts, frames_per_s=8.0 / statistics.median(times),
                        batch_s=times)
        log(f"  {key}: {8.0 / statistics.median(times):.2f} frames/s (median of 3)")
    del pipe
    torch.cuda.empty_cache()
    return res


def phase_offline_tools(dev, smi):
    """pin_window at 1024x2048, the synthetic-stereo proof at a few steps,
    one native profile_blocks call and the accuracy curve on a tiny budget."""
    from tools import native_mae_curve_torch as curve_tool
    from tools import pin_window_torch, profile_blocks_torch
    from tools import train_bench_weights_torch as tbw
    from tools import train_monodepth_synth_torch as synth

    res = {}
    log("[phase 13] (e) tools/pin_window_torch.py at 1024x2048")
    t0 = time.time()
    pin = pin_window_torch.run(1024, 2048, device=dev, log=lambda m: log("  " + m))
    check(all(w["keep"] > 0 for w in pin["windows"].values()) and len(pin["windows"]) == 4,
          f"pin_window: all four windows on the card ({time.time() - t0:.1f} s)")
    res["pin_window"] = pin

    log("[phase 13] (f) tools/train_monodepth_synth_torch.py, 30 steps, full width, 256x512")
    args = synth.parser().parse_args(["--steps", "30"])
    syn = synth.run(args, log=lambda m: None)
    ls = syn["losses"]
    check(len(ls) == 30 and np.isfinite(ls).all() and np.mean(ls[-5:]) < np.mean(ls[:5]),
          f"synthetic stereo: loss {np.mean(ls[:5]):.4f} (steps 0-4) -> {np.mean(ls[-5:]):.4f} "
          f"(steps 25-29); held-out corr {syn['corr']:.3f}, MAE {syn['mae_px']:.2f} px; "
          f"{syn['step_s'] * 1e3:.1f} ms a step at batch 4")
    res["synthetic_stereo"] = syn

    log("[phase 13] (g) tools/profile_blocks_torch.py, native 4 x 1024x2048")
    blocks = profile_blocks_torch.run(profile_blocks_torch.parser().parse_args(
        ["--iters", "3", "--kernels"]), log=lambda m: log("  " + m))
    check(all(np.isfinite(list(blocks["nets"][n][d].values())).all()
              for n in ("fcn", "mono") for d in ("float32", "bfloat16")),
          "profile_blocks: every block timed, both networks, float32 and bfloat16")
    res["profile_blocks"] = blocks

    log("[phase 13] (h) tools/native_mae_curve_torch.py, 4 steps a network, one eval point, "
        "4 scenes, full width at 1024x2048")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        curve = curve_tool.main([
            "--out_dir", os.path.join(tmp, "w"), "--curve", os.path.join(tmp, "curve.json"),
            "--warm_steps", "4", "--train_scenes", "4", "--fcn_steps", "4", "--mono_steps", "4",
            "--eval_every", "4", "--eval_scenes", "4", "--batch", "4"])
        wall = time.time() - t0
    step_s = curve["step_s"]
    check(len(curve["curve"]) == 1 and curve["curve"][0]["step"] == 4
          and {"fcn_fullres", "monodepth_fullres", "fcn_native", "monodepth_native"} <= set(step_s),
          f"native_mae_curve: one eval point, seconds a step {step_s} ({wall:.1f} s)")
    est = {"_fullres": (tbw.FCN_FR_PHASES[0][3] * step_s["fcn_fullres"],
                        tbw.MONO_FR_PHASES[0][3] * step_s["monodepth_fullres"]),
           "_native": (tbw.FCN_NATIVE_PHASES[0][3] * step_s["fcn_native"],
                       tbw.MONO_NATIVE_PHASES[0][3] * step_s["monodepth_native"])}
    log(f"  {smi}: the recipes' training seconds at these rates (FCN-8s, monodepth): {est}")
    res["native_mae_curve"] = dict(curve, wall_s=wall, est_train_s=est)
    return res


def phase_params_and_tools(dev, scenes, scene_cloud, frames, smi):
    """Phase 13: K1 and K4 at every parameter the JAX package takes, and the
    offline tools."""
    t_phase = time.time()
    counters = param_counters()
    res = {}
    with torch.inference_mode():
        k1_row, _ = phase_k1_general(dev, scenes)
        k4_row = phase_k4_large_k(dev, scenes, scene_cloud)
    res["outlier_removal"] = phase_outlier_large_k(dev, scene_cloud, counters)
    res["frame_program"] = phase_frame_program_7_31(dev, scenes, frames, counters)
    k1_row["launches"] = res["frame_program"]["(7, 31) k=20"]["launches"]["knn_grid_general"]
    k4_row["launches"] = res["outlier_removal"]["launches"]["exact_knn_large_k"]
    for row in (k1_row, k4_row):
        row["frozen_launches"] = None  # not measured: phase 10 exports the default setting
    res.update(phase_offline_tools(dev, smi))
    res["wall_s"] = time.time() - t_phase
    log(f"  phase 13 wall {res['wall_s']:.1f} s")
    return res, {"knn_grid_general": k1_row, "exact_knn_large_k": k4_row}


# --- phase 14: K1-K4 at every shape, process_batch at capacity 1000 -----------
# phase 5's bf16 grid rate before the ops padded (PERF.md, NVIDIA H100 80GB HBM3, 700 W)
UNPADDED_BF16_FRAMES_PER_S = 358.13


@contextlib.contextmanager
def pad_copies():
    """Counts, by kernel, the calls whose inputs K2's and K3's CUDA ops
    copied into their kernels' layout (``kernel_layout`` returning anything
    but the inputs themselves)."""
    from semantic_depth_tpu_torch.ops import mad, radius

    counts = {"mad": 0, "radius": 0}
    orig = {"mad": mad.kernel_layout, "radius": radius.kernel_layout}

    def wrap(key):
        def layout(*args):
            out = orig[key](*args)
            counts[key] += any(o is not a for o, a in zip(out, args))
            return out
        return layout

    mad.kernel_layout, radius.kernel_layout = wrap("mad"), wrap("radius")
    try:
        yield counts
    finally:
        mad.kernel_layout, radius.kernel_layout = orig["mad"], orig["radius"]


def _radius_cloud(b, c, rng, weights="ones", dev="cuda"):
    """(b, c) compacted-cloud-like frames, 85% valid, inf garbage on invalid
    rows; weights all ones, dyadic (1, 2, 0.5) or not (integers / 2.25)."""
    pts = rng.normal(size=(b, c, 3)) * [0.8, 0.1, 1.5] + [0.0, -1.5, -10.0]
    pts[..., 2] = np.sort(pts[..., 2], axis=-1)
    valid = rng.random((b, c)) < 0.85
    pts[~valid] = np.inf
    w = {"ones": np.ones((b, c)), "dyadic": rng.choice([1.0, 2.0, 0.5], size=(b, c)),
         "non_dyadic": rng.integers(1, 9, size=(b, c)) / 2.25}[weights]
    return (torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.from_numpy(valid).to(dev), torch.from_numpy(w.astype(np.float32)).to(dev))


def _mad_rows(rows, n, rng, dev="cuda"):
    """Rows like the frame program's MAD planes: a coordinate around -1.5
    with 1% far outliers, 7% or 30% of the points valid, row 1 all valid."""
    x = (rng.normal(size=(rows, n)) * 0.2 - 1.5).astype(np.float32)
    far = rng.random((rows, n)) < 0.01
    x[far] = rng.uniform(-40, 40, size=int(far.sum()))
    ok = rng.random((rows, n)) < np.where(np.arange(rows) % 2 == 0, 0.07, 0.3)[:, None]
    ok[min(1, rows - 1)] = True
    return torch.from_numpy(x).to(dev), torch.from_numpy(ok).to(dev)


def _launched(fn, key):
    """fn's output and the launches counted under ``key`` in it."""
    before = launch_registry()[key]
    out = fn()
    torch.cuda.synchronize()
    return out, launch_registry()[key] - before


def phase_any_shape(dev, counters, frames, rows, e2e):
    """Phase 14: (a) K3 and (b) K2 at shapes off their kernels' layouts,
    bit-equal to the plain versions, with times and bounds; (c)
    ``process_batch`` at ``neighbor_capacity=1000`` (stand-in networks) in
    grid and exact mode against the CPU port, and no pad copy at the
    default capacity; (d) K1 (specialised and general) and K4 (k = 10 and
    50) on 65,537 small frames, two launches each."""
    from semantic_depth_tpu_torch.ops import mad, radius
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, recording_kernel_calls

    res = {}
    t_phase = time.time()
    rng = np.random.default_rng(14)
    log("[phase 14] (a) K3 at capacities 1, 100, 1000, 16383 (padded to 128-candidate tiles) "
        "and at 65537 frames")
    for c in (1, 100, 1000, 16383):
        for kind in ("ones", "dyadic"):
            xyz, v, w = _radius_cloud(8, c, rng, kind, dev)
            want = radius.radius_counts_plain(xyz, v, w, 0.5)
            got, n = _launched(lambda: radius.radius_counts(xyz, v, w, 0.5), "radius")
            got_noskip = radius.radius_counts(xyz, v, w, 0.5, skip=False)
            check(n == 1 and got.shape == (8, c) and torch.equal(got, want)
                  and torch.equal(got_noskip, want),
                  f"K3 (8, {c}) {kind} weights: bit-equal, skip on and off, {n} launch "
                  f"(largest count {float(want.max())})")
    xyz, v, w = _radius_cloud(8, 1000, rng, "non_dyadic", dev)
    runs = [radius.radius_counts(xyz, v, w, 0.5) for _ in range(3)]
    want = radius.radius_counts_plain(xyz, v, w, 0.5)
    err = float((runs[0] - want).abs().max())
    check(all(torch.equal(x, runs[0]) for x in runs)
          and torch.allclose(runs[0], want, rtol=1e-4, atol=0),
          f"K3 (8, 1000) non-dyadic weights: three runs equal, within rtol 1e-4 (max abs err "
          f"{err:.3e})")
    xyz, v, w = _radius_cloud(65537, 4, rng, "ones", dev)
    xyz = xyz * 0.05
    got, n = _launched(lambda: radius.radius_counts(xyz, v, w, 0.5), "radius")
    check(n == 2 and torch.equal(got, radius.radius_counts_plain(xyz, v, w, 0.5)),
          f"K3 65537 frames of 4: {n} launches (65535 frames each at most), bit-equal")

    log("[phase 14] (b) K2 at row lengths 1, 3, 1022, 1025 and 2^21 + 3 (padded to 4-value "
        "vectors), a misaligned view, 65538 rows")
    for n_el in (1, 3, 1022, 1025, (1 << 21) + 3):
        r = 2 if n_el > 1 << 20 else 8
        x, ok = _mad_rows(r, n_el, rng, dev)
        thr = mad.threshold_rows((5.0, 1.0), r, dev)
        want = mad.mad_keep_mask_plain(x, ok, thr)
        got, n = _launched(lambda: mad.mad_keep_mask(x, ok, (5.0, 1.0)), "mad")
        check(n == 1 and got.shape == (r, n_el) and torch.equal(got, want)
              and torch.equal(mad.mad_keep_mask(x, ok, thr), want),
              f"K2 ({r}, {n_el}): bit-equal, {n} launch ({int(want.sum())} kept)")
    x, ok = _mad_rows(2, 1028, rng, dev)
    xv = x.reshape(-1)[1:2049].reshape(2, 1024)
    okv = ok.reshape(-1)[1:2049].reshape(2, 1024)
    want = mad.mad_keep_mask_plain(xv, okv, torch.full((2,), 2.0, device=dev))
    check(xv.data_ptr() % 16 != 0 and torch.equal(mad.mad_keep_mask(xv, okv, 2.0), want),
          "K2 on a view 4 bytes into its storage: copied, bit-equal")
    x = torch.from_numpy(rng.normal(size=(65538, 4)).astype(np.float32)).to(dev)
    x[:, 3] = 30.0
    ok = torch.from_numpy(rng.random((65538, 4)) < 0.9).to(dev)
    want = mad.mad_keep_mask_plain(x, ok, mad.threshold_rows((5.0, 1.0), 65538, dev))
    got, n = _launched(lambda: mad.mad_keep_mask(x, ok, (5.0, 1.0)), "mad")
    check(n == 2 and torch.equal(got, want),
          f"K2 65538 rows of 4, threshold pair: {n} launches, bit-equal")

    log("[phase 14] (c) process_batch at neighbor_capacity=1000, stand-in networks, 8 frames")
    cap = {}
    for mode in ("grid", "exact"):
        pipe, scalars, _ = scene_pipeline(dev, "bfloat16", mode, capacity=1000)
        cpu_pipe, _, _ = scene_pipeline("cpu", "bfloat16", mode, capacity=1000)
        pipe.process_batch(frames, *scalars)
        torch.cuda.synchronize()
        reset_counts()
        with pad_copies() as pads:
            out = pipe.process_batch(frames, *scalars)
            torch.cuda.synchronize()
        launches = read_counts(counters)
        expected = EXACT_LAUNCHES if mode == "exact" else GRID_LAUNCHES
        check(launches == expected and pads == {"mad": 0, "radius": 1},
              f"capacity 1000, {mode}: launches {launches}, calls padded {pads} (K3's one)")
        t0 = time.time()
        ref = cpu_pipe.process_batch(frames.cpu(), *scalars)
        cpu_s = time.time() - t0
        d = {}
        for f in ("dist_rw", "dist_f2f"):
            a, b = getattr(out, f).cpu().numpy(), getattr(ref, f).numpy()
            check(bool(np.isfinite(a).all()) and np.allclose(a, b, atol=1e-3, rtol=0),
                  f"capacity 1000, {mode}: {f} finite, within 1e-3 m of the CPU port (max "
                  f"diff {float(np.abs(a - b).max())}, {a.tolist()})")
            d[f] = float(np.abs(a - b).max())
        check(out.road_cloud.valid.shape == (8, 1000), "the road cloud holds 1000 rows a frame")
        cap[mode] = dict(launches=launches, pads=pads, max_diff_m=d, cpu_s=cpu_s,
                         road_kept=out.road_cloud.valid.sum(-1).tolist())
        if mode == "grid":  # the padded launch of the path, timed
            # recorded on a new pipeline's first call, which runs the tail
            # eagerly: a replayed tail makes no Python call to record
            fresh, _, _ = scene_pipeline(dev, "bfloat16", mode, capacity=1000)
            with recording_kernel_calls() as calls:
                fresh.process_batch(frames, *scalars)
            del fresh
            xyz, v, w, r = calls["radius"][0]
            t_bound, by = bound_ms(xyz.shape[0] * 1000 * (12 + 1 + 4 + 4),
                                   radius_pairs(xyz, v, r)[0] * 10.0)
            cap["radius_launch"] = dict(
                shape=list(v.shape), ms=cuda_ms(lambda: radius.radius_counts(xyz, v, w, r)),
                plain_ms=cuda_ms(lambda: radius.radius_counts_plain(xyz, v, w, r), iters=5),
                bound_ms=t_bound, bound_by=by)
        del pipe, cpu_pipe
    pipe, scalars, _ = scene_pipeline(dev, "bfloat16", "grid")
    reset_counts()
    with pad_copies() as pads:
        pipe.process_batch(frames, *scalars)
        torch.cuda.synchronize()
    launches = read_counts(counters)
    check(launches == GRID_LAUNCHES and pads == {"mad": 0, "radius": 0},
          f"default capacity 16384: launches {launches}, no call padded {pads}")
    cap["default"] = dict(launches=launches, pads=pads)
    del pipe
    res["capacity_1000"] = cap

    log("[phase 14] (d) K1 and K4 at 65537 frames, in chunks of at most 65535")
    from semantic_depth_tpu_torch.ops import exact_knn, knn_grid

    grid_fn, knn_fn = knn_grid.knn_mean_distances_grid, exact_knn.knn_mean_distances_exact
    pts = torch.from_numpy((rng.normal(size=(65537, 6, 16, 3)) * [2.0, 0.3, 5.0])
                           .astype(np.float32)).to(dev)
    ok = torch.from_numpy(rng.random((65537, 6, 16)) < 0.9).to(dev)
    chunks = {}
    for k, window in ((knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW), K1_PATH, (40, (5, 11))):
        general = launch_registry()["knn_grid.general"]
        got, n = _launched(lambda: grid_fn(pts, ok, k, window), "knn_grid")
        n_general = launch_registry()["knn_grid.general"] - general
        want = knn_grid.knn_mean_distances_grid_plain(pts, ok, k, window)
        check(n == 2 and n_general == 2 * ((k, window) != K1_ROAD) and _same(got, want),
              f"K1 65537 frames of 6x16, k={k} {window}: {n} launches ({n_general} general), "
              f"bit-equal ({int(torch.isfinite(want).sum())} finite)")
        chunks[f"K1 k={k} {window}"] = dict(launches=n, general_launches=n_general)
    xyz = torch.from_numpy((rng.normal(size=(65537, 40, 3)) * [2.0, 0.3, 5.0])
                           .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.random((65537, 40)) < 0.8).to(dev)
    for k in (10, 50):
        large = launch_registry()["exact_knn.large_k"]
        got, n = _launched(lambda: knn_fn(xyz, v, k), "exact_knn")
        n_large = launch_registry()["exact_knn.large_k"] - large
        check(n == 2 and n_large == 2 * (k > exact_knn.REGISTER_MAX_K)
              and torch.equal(got, exact_knn.knn_mean_distances_exact_plain(xyz, v, k)),
              f"K4 65537 clouds of 40 rows, k={k}: {n} launches ({n_large} large-k), bit-equal")
        chunks[f"K4 k={k}"] = dict(launches=n, large_k_launches=n_large)
    res["past_65535_frames"] = chunks
    del pts, ok, xyz, v

    # times and bounds at padded shapes beside the aligned ones of phase 3
    x, ok = _mad_rows(8, 131073, rng, dev)
    x2, ok2 = _mad_rows(2, (1 << 21) + 3, rng, dev)
    padded = {}
    for key, (vals, oks) in (("mad_8x131073", (x, ok)), ("mad_2x2097155", (x2, ok2))):
        thr = torch.full((vals.shape[0],), 5.0, device=dev)
        t_bound, by = bound_ms(vals.numel() * (4 + 1 + 1), vals.numel() * 37.0)
        padded[key] = dict(ms=cuda_ms(lambda: mad.mad_keep_mask(vals, oks, 5.0), iters=10),
                           plain_ms=cuda_ms(lambda: mad.mad_keep_mask_plain(vals, oks, thr),
                                            iters=5),
                           bound_ms=t_bound, bound_by=by)
    padded["radius_8x1000"] = cap["radius_launch"]
    for key, t in padded.items():
        log(f"  {key}: wrapper {t['ms']:.4f} ms (pad copy included), plain {t['plain_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    rows["mad"]["padded"] = {k: v for k, v in padded.items() if k.startswith("mad")}
    rows["radius"]["padded"] = padded["radius_8x1000"]
    res["padded"] = padded
    fps = e2e["bfloat16"]["frames_per_s"]
    log(f"  the default path (phase 5, bfloat16, grid, batch 8): {fps:.2f} frames/s; before "
        f"the ops padded: {UNPADDED_BF16_FRAMES_PER_S}")
    res["default_bf16_frames_per_s"] = fps
    res["wall_s"] = time.time() - t_phase
    log(f"  phase 14 wall {res['wall_s']:.1f} s")
    return res


def _tf1_load(label, load, stats_mod):
    """One TF1 set through a CLI loader: (seconds, bytes read, read seconds,
    crc32c seconds), the card synchronized before the clock stops."""
    stats_mod.reset_read_stats()
    t0 = time.perf_counter()
    load()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = dict(stats_mod.READ_STATS)
    log(f"  {label}: read + crc + convert + load {secs:.3f} s, {st['bytes'] / 1e6:.1f} MB "
        f"read in {st['seconds']:.3f} s, crc32c {st['crc_seconds']:.3f} s "
        f"({st['crc_seconds'] / secs:.3f} of the whole)")
    return dict(seconds=secs, bytes_read=st["bytes"], read_s=st["seconds"],
                crc_s=st["crc_seconds"], crc_share=st["crc_seconds"] / secs)


def phase_tf1_weights(dev, counters, frames, smi, n_timed=7):
    """Phase 15: the published TF1 weight sets on the card host, with no
    TensorFlow. (a) The committed fixtures (``tests/fixtures/tf1``, written
    by TensorFlow) converted bit-equal to the JAX converters' committed
    .msgpack, loaded into tiny networks on the card through the CLI loaders
    and served by ``process_batch``. (b) Full-width FCN-8s and monodepth-vgg
    bundles written from seeded parameters under the reference's names
    (Adam slots, ``beta1_power``, ``beta2_power`` and ``global_step``
    beside them) by ``tools/tf_bundle_writer_torch.py``, loaded through
    ``load_fcn_params`` / ``load_mono_params``: ``process_batch`` at batch 8
    in bfloat16 bit-equal to the same sets loaded from .msgpack, K1 x1, K2
    x4, K3 x1; one ``cli.semantic_depth`` frame on the TF paths equal to the
    .msgpack paths' run (distances, disparity and segmentation PNGs; the
    seeded networks mark no road or fence, so the distances read nan and
    the PNGs carry the comparison). Each Adam slot holds values of its own,
    so a reader that returned a slot for its variable fails the bit-equal
    checks."""
    import importlib.util

    import cv2

    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.cli import common
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.models import tf_checkpoint
    from semantic_depth_tpu_torch.models import weights as W
    from semantic_depth_tpu_torch.models.from_flax import flax_from_module
    from tools.tf_bundle_writer_torch import seeded_bundle

    repo = os.path.dirname(os.path.abspath(__file__))
    fixtures = os.path.join(repo, "tests", "fixtures", "tf1")
    res = {"card": smi, "tensorflow_on_host": importlib.util.find_spec("tensorflow") is not None}
    log("[phase 15] TF1 weights on the card host (no TensorFlow; tensorflow importable here: "
        f"{res['tensorflow_on_host']})")

    def same_tree(a, b):
        fa = {(k, n): np.asarray(v) for k, leaf in a["params"].items() for n, v in leaf.items()}
        fb = {(k, n): np.asarray(v) for k, leaf in b["params"].items() for n, v in leaf.items()}
        return fa.keys() == fb.keys() and all(
            fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
            and fa[k].tobytes() == fb[k].tobytes() for k in fa)

    # (a) the committed fixtures
    t0 = time.perf_counter()
    converted = {
        "fcn8s_tiny": W.convert_fcn_checkpoint(os.path.join(fixtures, "fcn8s_tiny", "variables")),
        "vgg16_tiny": W.convert_vgg_checkpoint(
            os.path.join(fixtures, "vgg16_tiny", "variables", "variables")),
        "monodepth_tiny": W.convert_monodepth_checkpoint(os.path.join(fixtures, "monodepth_tiny")),
    }
    for name, tree in converted.items():
        check(same_tree(tree, W.load_params(os.path.join(fixtures, f"{name}.msgpack"))),
              f"fixture {name}: converted bit-equal to the JAX converter's .msgpack")
    with torch.device(dev):
        torch.manual_seed(0)
        fcn = FCN8s(num_classes=3, width_mult=0.03125, fc_channels=8)
        mono = Monodepth("vgg", width_mult=0.03125)
        torch.manual_seed(1)
        warm = FCN8s(num_classes=3, width_mult=0.03125, fc_channels=8)
    common.load_fcn_params(fcn, os.path.join(fixtures, "fcn8s_tiny"))
    common.load_mono_params(mono, os.path.join(fixtures, "monodepth_tiny"))
    decoder_before = {k: v.clone() for k, v in warm.state_dict().items() if "score" in k}
    loaded = W.graft_partial(warm, converted["vgg16_tiny"])
    check(len(loaded) == 15 and all(torch.equal(warm.state_dict()[k], v)
                                    for k, v in decoder_before.items()),
          f"encoder-only VGG16 grafted on the card: {len(loaded)} layers, decoder kept")
    check(same_tree(flax_from_module(fcn), converted["fcn8s_tiny"])
          and same_tree(flax_from_module(mono), converted["monodepth_tiny"]),
          "fixtures loaded on the card equal their conversion")
    pipe = pipeline.SemanticDepthPipeline(config.munich_pipeline_config(), fcn, mono, device=dev)
    pipe.process_batch(frames)
    torch.cuda.synchronize()
    reset_counts()
    out = pipe.process_batch(frames)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    check(counts == GRID_LAUNCHES, f"fixture networks' process_batch launches {counts}")
    check(out.disparity.shape == (8, 256, 512) and bool(torch.isfinite(out.disparity).all()),
          "fixture networks' disparity finite (8, 256, 512)")
    res["fixtures"] = dict(seconds=time.perf_counter() - t0, launches=counts)
    log(f"  (a) fixtures: bit-equal to the JAX .msgpack, served in "
        f"{res['fixtures']['seconds']:.2f} s, launches {counts}")
    del pipe, fcn, mono, warm, out

    # (b) full width
    work = os.path.join(repo, "chiprun_out", "smoke_tf1")
    shutil.rmtree(work, ignore_errors=True)
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        fcn_prefix = os.path.join(work, "fcn", "variables", "saved_model")
        mono_prefix = os.path.join(work, "model_city", "model_city")
        fcn_tree, fcn_bytes = seeded_bundle("fcn", fcn_prefix, seed=0)
        mono_tree, mono_bytes = seeded_bundle("monodepth", mono_prefix, seed=1)
        mdir = os.path.join(work, "msgpack")
        os.makedirs(mdir)
        W.save_params(fcn_tree, os.path.join(mdir, "fcn8s.msgpack"))
        W.save_params(mono_tree, os.path.join(mdir, "monodepth.msgpack"))
        del fcn_tree, mono_tree
        res["write_s"] = time.perf_counter() - t0
        res["bundle_bytes"] = dict(fcn=fcn_bytes, monodepth=mono_bytes)
        log(f"  (b) full-width bundles written in {res['write_s']:.2f} s: FCN-8s "
            f"{fcn_bytes / 1e6:.1f} MB, monodepth-vgg {mono_bytes / 1e6:.1f} MB "
            "(Adam slots included)")
        with torch.device(dev):
            fcn = FCN8s(compute_dtype=torch.bfloat16)
            mono = Monodepth(compute_dtype=torch.bfloat16)
        res["fcn"] = _tf1_load("FCN-8s from TF1 (<dir>/variables)",
                               lambda: common.load_fcn_params(fcn, os.path.join(work, "fcn")),
                               tf_checkpoint)
        res["monodepth"] = _tf1_load("monodepth-vgg from TF1 (prefix)",
                                     lambda: common.load_mono_params(mono, mono_prefix),
                                     tf_checkpoint)
        check("tensorflow" not in sys.modules, "no TensorFlow module loaded")
        from_tf = {k: v.clone() for m in (fcn, mono) for k, v in m.state_dict().items()}
        pipe = pipeline.SemanticDepthPipeline(
            config.munich_pipeline_config(compute_dtype="bfloat16"), fcn, mono, device=dev)
        pipe.process_batch(frames)
        torch.cuda.synchronize()
        reset_counts()
        out_tf = pipe.process_batch(frames)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        check(counts == GRID_LAUNCHES, f"TF1-loaded process_batch launches {counts}")
        times = []
        for _ in range(n_timed):
            t1 = time.perf_counter()
            pipe.process_batch(frames)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        fps = 8.0 / statistics.median(times)
        t1 = time.perf_counter()
        common.load_fcn_params(fcn, mdir)
        common.load_mono_params(mono, mdir)
        torch.cuda.synchronize()
        res["msgpack_load_s"] = time.perf_counter() - t1
        same = all(torch.equal(v, from_tf[k]) for m in (fcn, mono)
                   for k, v in m.state_dict().items())
        check(same, "TF1-loaded parameters bit-equal to the .msgpack-loaded ones")
        out_mp = pipe.process_batch(frames)
        torch.cuda.synchronize()
        bad = _outputs_mismatch(out_tf, out_mp)
        check(not bad,
              f"bf16 process_batch from TF1 weights bit-equal to .msgpack's (differ: {bad})")
        res["process_batch"] = dict(launches=counts, frames_per_s=fps, batch_s_all=times)
        log(f"  bf16 process_batch, batch 8, from TF1 weights: bit-equal to .msgpack's, "
            f"launches {counts}, {fps:.2f} frames/s ({n_timed} timed batches); .msgpack load "
            f"{res['msgpack_load_s']:.3f} s")
        del pipe, fcn, mono, out_tf, out_mp, from_tf
        torch.cuda.empty_cache()

        frame_png = os.path.join(work, "scene_0.png")
        cv2.imwrite(frame_png, frames[0].cpu().numpy())
        sd = "semantic_depth_tpu_torch.cli.semantic_depth"
        def cli(key, fcn_path, mono_path):
            out_dir = os.path.join(work, f"cli_{key}")
            secs, _ = _run_cli(f"single frame on {key} weights",
                               [sd, "--input_frame", frame_png, "--semantic_model", fcn_path,
                                "--monodepth_checkpoint", mono_path, "--save_data",
                                "--results_dir", out_dir], repo, deterministic=True)
            base = os.path.join(out_dir, "scene_0", "scene_0_output")
            return dict(process_s=secs, files={
                s: open(base + s, "rb").read()
                for s in ("_distances.txt", "_disp.png", "_only_segmentation.png")})

        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:  # two processes at once
            futures = {key: pool.submit(cli, key, *paths) for key, paths in (
                ("tf1", (os.path.join(work, "fcn"), mono_prefix)), ("msgpack", (mdir, mdir)))}
            runs = {key: f.result() for key, f in futures.items()}
        res["cli_wall_s"] = time.perf_counter() - t1
        dist = runs["tf1"]["files"]["_distances.txt"].decode().strip()
        check(runs["tf1"]["files"] == runs["msgpack"]["files"],
              "cli.semantic_depth on TF1 paths: _distances.txt, _disp.png and "
              f"_only_segmentation.png equal the .msgpack run's (distances {dist!r}: nan "
              "where the seeded networks mark no road or fence, so the PNGs carry the check)")
        res["cli"] = {k: dict(process_s=v["process_s"],
                              distances=v["files"]["_distances.txt"].decode())
                      for k, v in runs.items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        shutil.rmtree(work, ignore_errors=True)  # 2.2 GB of bundles and weights: none kept
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

    walls = {"1-2": time.time() - t_start}  # seconds by phase (the whole run's split)
    t_mark = [time.time()]

    def mark(name):
        now = time.time()
        walls[name] = now - t_mark[0]
        t_mark[0] = now

    counters = kernel_counters()
    log("[phase 3] kernels against their plain versions")
    scenes = scene_batch(8, 256, 512, seed=0, dev=dev)
    with torch.inference_mode():
        rows = phase_kernels(dev, scenes)
        rows["exact_knn"], scene_cloud = phase_exact_knn(dev, scenes)
        native_rows, native_geom = phase_native_kernels(dev)
    mark("3")
    geom = {mode: phase_geometry(dev, scenes, counters, mode) for mode in ("grid", "exact")}
    mark("4")
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    frames = torch.from_numpy(scene_pool(8, 1024, 2048, seed=3)[0]).to(dev)  # uint8
    e2e = phase_end_to_end(dev, counters, frames)
    mark("5")
    entry = dict(staged=phase_staged(dev, counters, frames[0]),
                 outlier_removal=phase_outlier_removal(dev, scene_cloud),
                 codecs=codec_info())
    mark("6")

    native = dict(geometry=native_geom,
                  end_to_end=phase_native_end_to_end(dev, counters, frames))
    e2e.update(phase_end_to_end(dev, counters, frames, runs=(
        ("resnet50_float32", "float32", "grid", "resnet50"),
        ("resnet50_bfloat16", "bfloat16", "grid", "resnet50"))))
    check(e2e["resnet50_float32"]["launches"] == e2e["float32"]["launches"],
          "resnet50 launches per batch equal the vgg path's")
    mark("7")
    entry["clis"] = phase_clis(dev, frames)
    mark("8 (10 c)")
    trainers = phase_trainers(dev, counters, frames)
    mark("9")
    frozen = phase_frozen(dev, counters, frames)
    frozen.update(phase_native_ply_and_tools(dev, scene_cloud, frames))
    mark("10")
    multi = phase_multi_device(frames, smi)
    mark("11")
    training = phase_multi_device_training(dev, frames, smi)
    mark("12")
    params, new_rows = phase_params_and_tools(dev, scenes, scene_cloud, frames, smi)
    mark("13")
    any_shape = phase_any_shape(dev, counters, frames, rows, e2e)
    mark("14")
    tf1 = phase_tf1_weights(dev, counters, frames, smi)
    mark("15")
    log("  phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))

    for name, row in rows.items():
        row["launches"] = e2e["bfloat16_exact" if name == "exact_knn" else "float32"][
            "launches"][name]
        if name in native_rows:
            row["native"] = dict(native_rows[name],
                                 launches=native["end_to_end"]["launches"][name])
        row["frozen_launches"] = frozen["single_exact_f32" if name == "exact_knn" else
                                        "batched_bf16"]["launches"][name]
    rows.update(new_rows)
    summary = dict(card=smi, build_s=build_s, geometry=geom, end_to_end=e2e, native=native,
                   entry_points=entry, trainers=trainers, frozen=frozen, multi_device=multi,
                   multi_device_training=training, params_and_tools=params,
                   any_shape=any_shape, tf1_weights=tf1, phase_walls_s=walls,
                   kernels=list(rows.values()),
                   wall_s=time.time() - t_start)
    log("summary: " + json.dumps(summary))
    log(f"[done] wall {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "frozen_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
