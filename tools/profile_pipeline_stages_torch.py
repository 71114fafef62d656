#!/usr/bin/env python3
"""The stage split of the PyTorch port's ``process_batch`` (port of
``tools/profile_pipeline_stages.py``).

    python3 tools/profile_pipeline_stages_torch.py            # 256x512 networks, batch 8
    python3 tools/profile_pipeline_stages_torch.py --native   # 1024x2048 input_s2d, batch 8
        [--batch 8] [--h 1024 --w 2048] [--tiny] [--device cpu]

Times each stage of the frame program on its own, in bfloat16 as the bench
serves it: resize, FCN-8s forward, softmax and mask thresholds, monodepth
forward with the flip blend (none in the native networks), reprojection,
the road geometry chain (cloud, denoise, road width) and the overlay, then
the whole ``process_batch``. Frames: ``--batch`` rendered bench scenes of
``--h x --w`` uint8 (``utils.bench_scenes.scene_pool``, seed 0) on the
device; the networks run at the config's 256x512, or with ``--native`` at
the frame size. ``--tiny`` builds width-scaled networks (smoke runs).
Weights: the bench-weight tool's sets under ``.bench_weights``
(``fcn8s[_native].msgpack``, ``monodepth[_native].msgpack``) where both
exist, else seeded random ones (whose road masks are nearly empty, so the
geometry stage is light). A stage re-runs what it needs of the ones before
it, so the stages add up to more than the whole program: the split is the
point. Each number is the median of 8 runs after a warm-up one: CUDA
events on the card, the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage_ms(torch, fn, iters, cuda):
    """Median ms of ``fn()`` over ``iters`` runs after one warm-up."""
    fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _weights(native):
    suffix = "_native" if native else ""
    fcn = os.path.join(".bench_weights", f"fcn8s{suffix}.msgpack")
    mono = os.path.join(".bench_weights", f"monodepth{suffix}.msgpack")
    if os.path.isfile(fcn) and os.path.isfile(mono):
        return fcn, mono, "trained"
    return "random", "random", "random"


def run(args, log=print, iters=8):
    import torch

    from semantic_depth_tpu_torch import camera as camera_lib
    from semantic_depth_tpu_torch import pipeline as pipeline_lib
    from semantic_depth_tpu_torch.cli.common import build_pipeline
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.ops import pcl
    from semantic_depth_tpu_torch.ops.overlay import segmentation_overlay
    from semantic_depth_tpu_torch.ops.resize import resize_clip_u8
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    size = dict(input_height=args.h, input_width=args.w) if args.native else {}
    cfg = munich_pipeline_config(compute_dtype="bfloat16", **size)
    fcn_w, mono_w, kind = _weights(args.native)
    device = "cpu" if args.device == "cpu" else None
    pipe = build_pipeline(cfg, fcn_w, mono_w, tiny=args.tiny, native_s2d=args.native,
                          device=device)
    cfg = pipe.config  # native: flip_average off
    dev = pipe.device
    cuda = dev.type == "cuda"
    b, (h, w) = args.batch, (cfg.input_height, cfg.input_width)
    frames = torch.from_numpy(scene_pool(b, args.h, args.w, seed=0)[0]).to(dev)
    focal, mult = pipeline_lib.resolve_frame_scalars(cfg, args.w, None, None)
    cam, s_w = pipeline_lib._scaled_camera(cfg, pipeline_lib._scalar(focal))
    mult = pipeline_lib._scalar(mult) * s_w

    res = dict(native=args.native, batch=b, frames=[args.h, args.w], networks=[h, w],
               weights=kind, device=str(dev), stages={})
    if cuda:
        res["card"] = torch.cuda.get_device_name(dev)

    def timed(name, fn):
        with torch.inference_mode():
            ms = stage_ms(torch, fn, iters, cuda)
            out = fn()
        res["stages"][name] = ms
        log(f"{name:34s} {ms:10.3f} ms / batch of {b}")
        return out

    log(f"{'native 1024x2048 input_s2d' if args.native else 'headline'} networks at {h}x{w}, "
        f"bfloat16, batch {b} of {args.h}x{args.w} frames, {kind} weights, {dev}")
    small = timed("resize", lambda: resize_clip_u8(frames.float(), (h, w)))
    logits = timed("fcn forward", lambda: pipe.fcn(small))
    road, fence = timed("softmax + thresholds",
                        lambda: pipe._masks(torch.softmax(logits, dim=-1)))
    disps = timed("mono forward" + (" + flip blend" if cfg.monodepth.flip_average else ""),
                  lambda: pipe._batch_disparity(small, mult))
    pts = timed("reproject", lambda: camera_lib.reproject_disparity(disps, cam))

    def geometry():
        cloud = pcl.from_dense(pts, small.flip(-1), road)
        cloud, plane = pipeline_lib._denoise_road(cloud, cfg, (h, w))
        return pipeline_lib._road_width(cfg, cloud, plane, cam)[3]

    timed("geometry (road + rw)", geometry)
    timed("overlay", lambda: segmentation_overlay(small, road, fence, cfg.segmenter.road_rgba,
                                                  cfg.segmenter.fence_rgba))
    timed("whole process_batch", lambda: pipe.process_batch(frames))
    return res


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--native", action="store_true",
                   help="the native full-resolution input_s2d networks at the frame size")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--h", type=int, default=1024, help="frame height")
    p.add_argument("--w", type=int, default=2048, help="frame width")
    p.add_argument("--tiny", action="store_true", help="width-scaled networks (smoke runs)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
