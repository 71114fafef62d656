#!/usr/bin/env python3
"""Whether the grid statistical filter's (5, 21) window has converged at the
native 1024x2048, measured with the PyTorch port (port of
``tools/pin_window.py``).

    python3 tools/pin_window_torch.py [--h 1024 --w 2048] [--device cpu]

The scene: ``utils.bench_scenes.render_scene`` with ``default_rng(0)`` at
``--h x --w``, its road mask with 30% of the pixels punched out (sparse
neighbourhoods, where a larger window could matter), back-projected with
the config's camera scaled to the frame. For each window of (5, 21),
(5, 31), (7, 21) and (7, 31), the keep set of
``neighbors.statistical_outlier_filter_grid`` at the road config's k and
std ratio (``munich_pipeline_config(h, w)``); then, for each larger
window, the pixels whose keep flag differs from (5, 21)'s, as a share of
(5, 21)'s kept set. On the card every window runs through K1 (the road
chain's window through its specialised kernel, the others through the
general one); ``--device cpu`` takes the plain version (minutes at the
native size).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOWS = ((5, 21), (5, 31), (7, 21), (7, 31))
HOLES = 0.3


def scene(h, w):
    """(points (H, W, 3) float32, valid (H, W) bool) of the holed scene."""
    import torch

    from semantic_depth_tpu_torch import camera
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.utils.bench_scenes import render_scene, scaled_camera

    cfg = munich_pipeline_config(input_height=h, input_width=w)
    rng = np.random.default_rng(0)
    _, labels, disp_norm, _, _ = render_scene(rng, h, w)
    cam = scaled_camera(cfg.camera, h, w)
    d_px = torch.from_numpy((disp_norm * 2048.0 * (w / 512.0)).astype(np.float32))
    pts = camera.reproject_disparity(d_px, cam)
    holes = rng.uniform(size=labels.shape) < HOLES
    return pts, torch.from_numpy((labels == 7) & ~holes), cfg


def run(h=1024, w=2048, device=None, windows=WINDOWS, log=print):
    """Keep sets of every window on the holed scene. Returns a dict: the
    valid count, and per window its keep count, seconds (card synchronised)
    and, beside the first window, the differing pixels and their share of
    its kept set."""
    import torch

    from semantic_depth_tpu_torch.ops import neighbors
    from semantic_depth_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    pts, valid, cfg = scene(h, w)
    pts, valid = pts[None].contiguous().to(dev), valid[None].to(dev)
    k, ratio = cfg.road.stat_nb_neighbors, cfg.road.stat_std_ratio
    res = dict(h=h, w=w, k=k, std_ratio=ratio, device=str(dev),
               valid=int(valid.sum()), windows={})
    keeps = {}
    for window in windows:
        t0 = time.time()
        with torch.inference_mode():
            keep = neighbors.statistical_outlier_filter_grid(pts, valid, k, ratio, window)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        keeps[window] = keep.cpu().numpy()
        res["windows"][str(window)] = dict(keep=int(keeps[window].sum()),
                                           seconds=time.time() - t0)
        log(f"window {window}: keep {int(keeps[window].sum())} / {res['valid']} "
            f"({time.time() - t0:.2f} s)")
    base_window = windows[0]
    base = keeps[base_window]
    for window in windows[1:]:
        diff = int((keeps[window] != base).sum())
        share = 100.0 * diff / max(int(base.sum()), 1)
        res["windows"][str(window)].update(differ=diff, differ_pct=share)
        log(f"{base_window} vs {window}: {diff} pixels differ ({share:.4f}% of kept set)")
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--h", type=int, default=1024)
    p.add_argument("--w", type=int, default=2048)
    p.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: the card)")
    args = p.parse_args(argv)
    return run(args.h, args.w, args.device)


if __name__ == "__main__":
    main()
