#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's frame program on one GPU.

    python3 tools/profile_torch_port.py [--iters 10] [--json out.json]

Full width: FCN-8s/VGG16 + monodepth-vgg with seeded random weights, 8
rendered 1024x2048 uint8 frames, 256x512 networks, float32 and bfloat16.
For each compute dtype it reports

* host wall ms of one ``process_batch`` (median, ``synchronize`` after);
* device ms of each stage, by CUDA events (median): resize + FCN-8s
  (``_batch_segment``), monodepth flip batch (``_batch_disparity``), and the
  geometry tail (``_batch_geometry``) on the networks' outputs and on the
  analytic scenes' true masks and disparity (random networks leave the road
  masks nearly empty, so only the latter loads the kernels as real frames do);
* a ``torch.profiler`` pass over one batch and over one analytic geometry
  call: device ms by kernel group, the ten longest kernels, and the device's
  idle share of the profiled wall time (the profiler's own host overhead
  inflates it).

``--json`` writes everything to one file. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PORT_KERNELS = ("knn_grid_kernel", "mad_keep_kernel", "radius_kernel")
_CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "fft", "dse::", "pointwise_mult_and_sum")


def _group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in _PORT_KERNELS):
        return "port kernels (knn_grid, mad, radius)"
    if any(k in low for k in _CONV_MARKS):
        return "convolutions (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "matrix products"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, sort, scan, reductions)"


def _events_ms(torch, fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _profile(torch, fn):
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            kernels[ev.name] += ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    return dict(
        profiled_wall_ms=wall_ms,
        device_busy_ms=busy,
        device_idle_share=1.0 - busy / wall_ms if busy else None,
        groups_ms=dict(sorted(groups.items(), key=lambda x: -x[1])),
        top_kernels_ms=[(k[:110], v) for k, v in sorted(kernels.items(), key=lambda x: -x[1])[:10]],
    )


def run_dtype(torch, dtype_name, frames, scenes, iters):
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    cfg = config.munich_pipeline_config(compute_dtype=dtype_name)
    torch.manual_seed(0)
    with torch.device("cuda"):
        fcn = FCN8s(num_classes=cfg.segmenter.num_classes, compute_dtype=dtype)
        torch.manual_seed(1)
        mono = Monodepth(encoder=cfg.monodepth.encoder, compute_dtype=dtype)
    pipe = pipeline.SemanticDepthPipeline(cfg, fcn, mono)
    cam, s_w = pipeline._scaled_camera(cfg, cfg.camera.focal)
    mult = 2048.0 * s_w
    with torch.inference_mode():
        small, road, fence = pipe._batch_segment(frames)
        disp = pipe._batch_disparity(small, mult)
        walls = []
        for i in range(iters + 2):
            t0 = time.perf_counter()
            pipe.process_batch(frames)
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        out = dict(
            wall_ms_process_batch=statistics.median(walls),
            stage_device_ms=dict(
                resize_fcn=_events_ms(torch, lambda: pipe._batch_segment(frames), iters),
                monodepth=_events_ms(torch, lambda: pipe._batch_disparity(small, mult), iters),
                geometry_on_network_outputs=_events_ms(
                    torch, lambda: pipe._batch_geometry(small, road, fence, disp, cam), iters),
                geometry_on_analytic_scenes=_events_ms(
                    torch, lambda: pipe._batch_geometry(*scenes, cam), iters),
            ),
            profile_batch=_profile(torch, lambda: pipe.process_batch(frames)),
            profile_analytic_geometry=_profile(
                torch, lambda: pipe._batch_geometry(*scenes, cam)),
        )
    del pipe, fcn, mono
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", help="write the full result to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    from semantic_depth_tpu_torch.runtime import set_full_fp32
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

    set_full_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    frames = torch.from_numpy(scene_pool(8, 1024, 2048, seed=3)[0]).cuda()
    imgs, labels, disp_norm = scene_pool(8, 256, 512, seed=0)[:3]
    scenes = tuple(torch.from_numpy(a).cuda() for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0)))
    result = dict(card=card, batch=8, frames="1024x2048 uint8", network_input="256x512")
    for dtype_name in ("float32", "bfloat16"):
        r = run_dtype(torch, dtype_name, frames, scenes, args.iters)
        result[dtype_name] = r
        print(f"[{dtype_name}] process_batch wall {r['wall_ms_process_batch']:.2f} ms "
              f"(median of {args.iters})", flush=True)
        for stage, ms in r["stage_device_ms"].items():
            print(f"    stage {stage:30s} {ms:9.3f} ms", flush=True)
        for key in ("profile_batch", "profile_analytic_geometry"):
            p = r[key]
            print(f"  {key}: profiled wall {p['profiled_wall_ms']:.2f} ms, device busy "
                  f"{p['device_busy_ms']:.2f} ms, idle share {p['device_idle_share']}", flush=True)
            for g, ms in p["groups_ms"].items():
                print(f"    {ms:9.3f} ms  {g}", flush=True)
            for name, ms in p["top_kernels_ms"]:
                print(f"    {ms:9.3f} ms  {name}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
