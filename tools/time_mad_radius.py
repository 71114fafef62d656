#!/usr/bin/env python3
"""K2 (MAD keep mask) and K3 (weighted radius counts) at the frame program's
own launches, and the geometry tail around them, on one GPU.

    python3 tools/time_mad_radius.py [--iters 20] [--json out.json]

It records the arguments of every MAD and radius call of one grid-mode
geometry tail (``_batch_geometry``) on the 8 analytic scenes at 256x512
(four MAD launches of 8, 8, 8 and 16 rows of 131072, one radius launch at
(8, 16384)) and replays them: wrapper ms (CUDA events, median of
``--iters``) and kernel ms (the port's kernels' device time in a
``torch.profiler`` pass, per call), each call checked bit-equal to its plain
version, and K2 on one streamed row of 2^21. Then the tail: host wall ms
(median, synchronised), the profiled device busy ms and idle share, and the
synchronising CUDA calls inside the MAD and radius filters.

It goes through the wrappers' public names and ``utils/probes.py``, so it
times whichever kernels the checkout holds: to compare with an older
checkout, copy this file and ``semantic_depth_tpu_torch/utils/probes.py``
into it and run both in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def thresholds_per_row(thr, rows, dev):
    """A recorded threshold argument (float, pair or (R,) tensor) as (R,)."""
    t = thr if isinstance(thr, torch.Tensor) else torch.tensor(thr, dtype=torch.float32)
    return t.to(dev).reshape(-1).repeat_interleave(rows // t.numel())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", help="write the result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.ops import _cuda, mad, radius
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool
    from semantic_depth_tpu_torch.utils.probes import (cuda_ms, device_ms, recording_kernel_calls,
                                                       sync_debug)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _cuda.library()
    dev = torch.device("cuda")
    imgs, labels, disp_norm = scene_pool(8, 256, 512, seed=0)[:3]
    scenes = [torch.from_numpy(a).to(dev) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0))]
    cfg = config.munich_pipeline_config()
    pipe = pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=dev)
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    tail = lambda: pipe._batch_geometry(*scenes, cam)  # noqa: E731
    kernel_marks = ("mad_", "radius_")  # csrc/mad.cu and csrc/radius.cu's kernels
    result = dict(card=card, torch=torch.__version__)

    def replay(name, fn, plain, iters):
        equal = bool(torch.equal(fn(), plain()))
        row = dict(wrapper_ms=cuda_ms(fn, iters), kernel_ms=device_ms(fn, iters, kernel_marks)[0],
                   bit_equal=equal)
        print(f"{name}: wrapper {row['wrapper_ms']:.4f} ms, kernel {row['kernel_ms']:.4f} ms, "
              f"bit-equal {equal}", flush=True)
        return row

    with torch.inference_mode():
        # the first call runs the tail eagerly (later ones replay its CUDA
        # graph, which makes no Python call to record)
        with recording_kernel_calls() as calls:
            tail()
        torch.cuda.synchronize()
        launches = []
        for values, valid, thr in calls["mad"]:
            rows = values.shape[0]
            thr_rows = thresholds_per_row(thr, rows, dev)
            launches.append(dict(rows=rows, valid_per_row=valid.sum(-1).tolist(), **replay(
                f"K2 {rows} x {values.shape[1]}", lambda: mad.mad_keep_mask(values, valid, thr),
                lambda: mad.mad_keep_mask_plain(values, valid, thr_rows), args.iters)))
        g = torch.Generator(device="cpu").manual_seed(7)
        big = (torch.randn((1, 1 << 21), generator=g) * 3.0).to(dev)
        big_ok = (torch.rand((1, 1 << 21), generator=g) < 0.6).to(dev)
        big_thr = torch.full((1,), 2.0, device=dev)
        result["mad"] = dict(
            launches=launches,
            sum_wrapper_ms=sum(x["wrapper_ms"] for x in launches),
            sum_kernel_ms=sum(x["kernel_ms"] for x in launches),
            streamed_row=replay("K2 1 x 2^21", lambda: mad.mad_keep_mask(big, big_ok, big_thr),
                                lambda: mad.mad_keep_mask_plain(big, big_ok, big_thr), 5))
        a = calls["radius"][0]
        result["radius"] = dict(valid_per_frame=a[1].sum(-1).tolist(), **replay(
            f"K3 {tuple(a[0].shape)}", lambda: radius.radius_counts(*a),
            lambda: radius.radius_counts_plain(*a), args.iters))

        walls = []
        for i in range(args.iters + 2):
            t0 = time.perf_counter()
            tail()
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        busy, prof_wall = device_ms(tail, 1)
        with sync_debug("warn") as syncs:
            tail()
        torch.cuda.synchronize()
        result["tail"] = dict(wall_ms_median=statistics.median(walls), wall_ms_all=walls,
                              profiled_wall_ms=prof_wall, device_busy_ms=busy,
                              device_idle_share=1.0 - busy / prof_wall,
                              syncs_in_mad_and_radius=len(syncs), sync_messages=syncs[:5])
        print(f"tail: wall {result['tail']['wall_ms_median']:.3f} ms (median of {args.iters}), "
              f"profiled wall {prof_wall:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{result['tail']['device_idle_share']:.3f}, syncs in MAD/radius {len(syncs)}",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
