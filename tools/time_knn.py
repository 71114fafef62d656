#!/usr/bin/env python3
"""K1 (windowed kNN) and K4 (exact kNN) at the frame program's own launches
and on the outlier tool's scene cloud, on one GPU.

    python3 tools/time_knn.py [--iters 20] [--json out.json]

It records the K1 call of one grid-mode geometry tail and the K4 call of
one exact-mode tail (``_batch_geometry``) on the 8 analytic scenes at
256x512 (K1 at (8, 256, 512), K4 at (8, 16384)) and replays them; K1 also
on ``chip_smoke.py``'s input (4 scene frames and 4 frames of random points,
30% valid) and on each half apart; K4 also on ``chip_smoke.py``'s
(1, 131072) scene cloud with 1% outliers. Then the other parameters
(``chip_smoke.py`` phase 13's cases, written out here so that an older
checkout times the same): the general K1 kernel at each (k, window) of
``K1_GENERAL`` on ``chip_smoke.py``'s input and at the native tail's
launch under stat_window (7, 31), (2, 1024, 2048), and K4 at each k of
``K4_K`` (k = 32 on the register walks, the rest on the large-k kernels)
on the exact tail's launch and the scene cloud (``--no_params`` leaves
them out). For each: wrapper ms (CUDA events, median of ``--iters``) and
kernel ms (the kernels' device time in a ``torch.profiler`` pass, per
call), each call checked bit-equal to its plain version, K4's counts of
scanned pairs where its kernels report them, and how many warps hold work
(a valid pixel or row).

It goes through the wrappers' public names, ``chip_smoke.py``'s inputs and
``utils/probes.py``, so it times whichever kernels the checkout holds: to
compare with an older checkout, copy this file and
``semantic_depth_tpu_torch/utils/probes.py`` into it and run both in one
call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K1_GENERAL = ((20, (5, 21)), (10, (7, 21)), (10, (5, 31)), (10, (7, 31)), (6, (4, 20)),
              (40, (9, 33)), (32, (7, 31)), (33, (7, 31)), (20, (7, 31)))
K4_K = (32, 33, 50, 64, 100)
KERNEL_MARKS = {"K1": ("knn_grid_kernel",), "K1 general": ("knn_grid",), "K4": ("exact_knn",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", help="write the result to this file")
    ap.add_argument("--no_params", action="store_true",
                    help="leave out the general K1 and the k != 10 K4 cases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    import chip_smoke
    from semantic_depth_tpu_torch import camera, config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.ops import _cuda, exact_knn, knn_grid
    from semantic_depth_tpu_torch.utils.probes import cuda_ms, device_ms, recording_kernel_calls

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _cuda.library()
    dev = torch.device("cuda")
    scenes = chip_smoke.scene_batch(8, 256, 512, seed=0, dev=dev)
    args4 = [scenes[k] for k in ("small", "road", "fence", "disp")]
    result = dict(card=card, torch=torch.__version__)

    def replay(name, kernel, fn, plain, iters):
        got, want = fn(), plain()
        equal = bool(torch.equal(got.isnan(), want.isnan())
                     and torch.equal(got.nan_to_num(), want.nan_to_num()))
        row = dict(wrapper_ms=cuda_ms(fn, iters),
                   kernel_ms=device_ms(fn, iters, KERNEL_MARKS[kernel])[0], bit_equal=equal)
        print(f"{name}: wrapper {row['wrapper_ms']:.4f} ms, kernel {row['kernel_ms']:.4f} ms, "
              f"bit-equal {equal}", flush=True)
        return row

    def busy_warps(valid):
        """Warps holding a valid pixel: 32 columns by 1 row (one pixel a
        thread) and by 2 rows (two)."""
        b, h, w = valid.shape
        v = F.pad(valid, (0, -w % 32, 0, -h % 2))
        return {f"{rows} row(s)": int(v.reshape(b, -1, rows, v.shape[-1] // 32, 32)
                                         .any(4).any(2).sum()) for rows in (1, 2)}

    def k4_counts(xyz, valid, k=10):
        if not hasattr(exact_knn, "scratch_stats"):  # kernels that keep no counts
            return {}
        b, c = valid.shape
        scratch = torch.empty(exact_knn.scratch_words(b, c, k), device=dev)
        exact_knn._launch(xyz, valid, k, True, scratch, torch.empty((b, c), device=dev))
        counts = exact_knn.scratch_stats(scratch)
        n = valid.sum(-1).double()
        counts.update(pairs_all=float((n * n).sum()),
                      pairs_scanned=float(counts["pairs_near"] + counts["pairs_far"]))
        print(f"  counts {counts}", flush=True)
        return counts

    with torch.inference_mode():
        cfg = config.munich_pipeline_config()
        cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
        recorded = {}
        for mode, cfg_m in (("grid", cfg), ("exact", chip_smoke.exact_config())):
            pipe = pipeline.SemanticDepthPipeline(
                cfg_m, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
                device=dev)
            with recording_kernel_calls() as calls:
                pipe._batch_geometry(*args4, cam)
            recorded[mode] = calls
        torch.cuda.synchronize()

        # K1: the grid tail's own launch, then chip_smoke.py's input and its halves
        k1 = {}
        pts, ok, k, window = recorded["grid"]["knn_grid"][0]
        k1["grid tail (8, 256, 512)"] = replay(
            "K1 grid tail (8, 256, 512)", "K1",
            lambda: knn_grid.knn_mean_distances_grid(pts, ok, k, window),
            lambda: knn_grid.knn_mean_distances_grid_plain(pts, ok, k, window), args.iters)
        g = torch.Generator(device="cpu").manual_seed(1)
        pts_s = camera.reproject_disparity(scenes["disp"][:4], cfg.camera)
        ok_s = scenes["road"][:4] & (pts_s[..., 2] < -cfg.road.z_keep_beyond)
        pts_r = torch.randn((4, 256, 512, 3), generator=g).to(dev) * torch.tensor(
            [2.0, 0.3, 5.0], device=dev)
        ok_r = (torch.rand((4, 256, 512), generator=g) < 0.3).to(dev)
        for name, (p, v) in (("smoke input (8, 256, 512)", (torch.cat([pts_s, pts_r]),
                                                            torch.cat([ok_s, ok_r]))),
                             ("smoke scene frames (4, 256, 512)", (pts_s, ok_s)),
                             ("smoke random frames (4, 256, 512)", (pts_r, ok_r))):
            p, v = p.contiguous(), v.contiguous()
            k1[name] = dict(valid_fraction=float(v.float().mean()),
                            warps_with_a_valid_pixel=busy_warps(v), **replay(
                f"K1 {name}", "K1", lambda: knn_grid.knn_mean_distances_grid(p, v, 10, (5, 21)),
                lambda: knn_grid.knn_mean_distances_grid_plain(p, v, 10, (5, 21)), args.iters))
        result["K1"] = k1

        # K4: the exact tail's own launch, then the outlier tool's scene cloud
        k4 = {}
        xyz, valid, _ = recorded["exact"]["exact_knn"][0]
        big_xyz, big_valid, _ = chip_smoke.scene_cloud_with_outliers(scenes, dev)
        for name, (x, v, iters) in (("exact tail (8, 16384)", (xyz, valid, args.iters)),
                                    ("scene cloud (1, 131072)", (big_xyz, big_valid, 5))):
            b, c = v.shape
            live = F.pad(v, (0, -c % 64)).reshape(b, -1, 64).any(-1)
            k4[name] = dict(valid_per_frame=v.sum(-1).tolist(),
                            warps_with_a_valid_row=int(live.sum()), **replay(
                f"K4 {name}", "K4", lambda: exact_knn.knn_mean_distances_exact(x, v, 10),
                lambda: exact_knn.knn_mean_distances_exact_plain(x, v, 10), iters))
            k4[name]["counts"] = k4_counts(x, v)
        result["K4"] = k4

        if not args.no_params:
            p = torch.cat([pts_s, pts_r]).contiguous()
            v = torch.cat([ok_s, ok_r]).contiguous()
            k1g = {}
            for k, window in K1_GENERAL:
                name = f"k={k} window={window}"
                k1g[name] = replay(
                    f"K1 general {name} (8, 256, 512)", "K1 general",
                    lambda: knn_grid.knn_mean_distances_grid(p, v, k, window),
                    lambda: knn_grid.knn_mean_distances_grid_plain(p, v, k, window), args.iters)
            # the native tail's launch under stat_window (7, 31), as phase 13 (a) records it
            nat = chip_smoke.scene_batch(2, 1024, 2048, seed=7, dev=dev)
            base = chip_smoke.native_config()
            ncfg = dataclasses.replace(base, road=dataclasses.replace(base.road,
                                                                      stat_window=(7, 31)))
            ncam, _ = pipeline._scaled_camera(ncfg, ncfg.camera.focal)
            tiny = pipeline.SemanticDepthPipeline(
                ncfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
                device=dev)
            with recording_kernel_calls() as calls:
                tiny._batch_geometry(*[nat[k] for k in ("small", "road", "fence", "disp")], ncam)
            (npts, nvalid, nk, nwin), = calls["knn_grid"]
            k1g[f"native {tuple(npts.shape[:3])} k={nk} window={tuple(nwin)}"] = replay(
                f"K1 general native {tuple(npts.shape[:3])} k={nk} {tuple(nwin)}", "K1 general",
                lambda: knn_grid.knn_mean_distances_grid(npts, nvalid, nk, nwin),
                lambda: knn_grid.knn_mean_distances_grid_plain(npts, nvalid, nk, nwin), args.iters)
            del nat, tiny, calls
            result["K1 general"] = k1g
            k4l = {}
            for k in K4_K:
                for name, (x, v, iters) in (("exact tail (8, 16384)", (xyz, valid, args.iters)),
                                            ("scene cloud (1, 131072)", (big_xyz, big_valid, 5))):
                    row = replay(f"K4 k={k} {name}", "K4",
                                 lambda: exact_knn.knn_mean_distances_exact(x, v, k),
                                 lambda: exact_knn.knn_mean_distances_exact_plain(x, v, k), iters)
                    row["counts"] = k4_counts(x, v, k)
                    k4l[f"k={k} {name}"] = row
            result["K4 large k"] = k4l
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
