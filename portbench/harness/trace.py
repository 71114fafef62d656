"""The traced run: what the per-layer metrics read.

1. A profiled window of real calls (``torch.profiler``, CPU and CUDA
   activity), the harness's spans ``portbench.call`` around each call and
   ``portbench.readback`` around its scalars' copy: frames per second,
   the device's busy seconds (the union of kernels, copies and sets),
   the window's length, each kernel's device time, and the idle gaps
   labelled by the harness span and the innermost host event (an op or a
   CUDA runtime call) open when the gap began. The profiler's host overhead widens the gaps.
2. CUDA-event spans around the port's three stages, called in
   ``_process_batch_impl``'s order on the same inputs (the median of
   ``stage_repeats``): networks (``_batch_segment`` + ``_batch_disparity``)
   and tail (``_batch_geometry``); and, where the frames are on the host,
   around the entry's upload of one call's frames
   (``torch.as_tensor(frames).to(device)``, as ``process_batch`` does it).
3. A profiled run of the tail alone, under the span ``portbench.tail``:
   the device kernels it launches.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .loop import failed_frames, read_back

WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(prof):
    return prof.profiler.kineto_results.events()


def _kind(ev) -> str:
    """The activity of a device event: kernel, gpu_memcpy, gpu_memset or an
    annotation (from its name where the event does not say)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    annotation = name.startswith("portbench.") or (
        hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
    return "gpu_user_annotation" if annotation else "kernel"


def _on_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _gpu_work(ev) -> bool:
    return _on_device(ev) and _kind(ev) in WORK


def _union(intervals: List[Tuple[int, int]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiled_window(bench, seconds: float, on_call=None) -> Dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n_in = len(bench.batches)
    need_f2f = bench.scenes is not None and bench.cell.config["approach"] == "both"
    calls = failed = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while True:
            with record_function("portbench.call"):
                out = bench.call(bench.batches[calls % n_in])
            with record_function("portbench.readback"):
                host = read_back(out)
            failed += failed_frames(host, need_f2f)
            if on_call is not None:
                on_call(calls, out)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize()
    events = _events(prof)
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in events
             if e.name() in ("portbench.call", "portbench.readback")
             and e.device_type() == torch.autograd.DeviceType.CPU]
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    work = [(max(e.start_ns(), w0), min(e.end_ns(), w1), e.name()) for e in events if _gpu_work(e)]
    work = [w for w in work if w[1] > w[0]]
    busy = _union([(s, e) for s, e, _ in work])
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if _gpu_work(e):
            by_name[e.name()] += e.duration_ns() * 1e-9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events if not _on_device(e))
    labelled = []
    for length, at in gaps[:10]:
        open_ = [h for h in host if h[0] <= at < h[1]]
        span = next((h[2] for h in open_ if h[2].startswith("portbench.")), "outside")
        inner = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "none"
        labelled.append([f"{span} / {inner}", length * 1e-9])
    return dict(calls=calls, frames=calls * bench.batch, failed=failed, window_s=(w1 - w0) * 1e-9,
                busy_s=sum(e - s for s, e in busy) * 1e-9, kernel_s=dict(by_name),
                idle_gaps=labelled)


def stage_spans(bench) -> Dict[str, float]:
    """Median ms a frame of the networks' stages and of the tail."""
    from semantic_depth_tpu_torch import pipeline as port

    pipe = bench.pipe
    frames = torch.as_tensor(bench.batches[0]).to(bench.device)
    focal, mult = port._scalar(bench.focal), port._scalar(bench.mult)
    nets, tail = [], []
    with torch.inference_mode():
        for _ in range(int(bench.cell.traffic["stage_repeats"])):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            cam, s_w = port._scaled_camera(pipe.config, focal)
            ev[0].record()
            small, road, fence = pipe._batch_segment(frames)
            disps = pipe._batch_disparity(small, mult * s_w)
            ev[1].record()
            pipe._batch_geometry(small, road, fence, disps, cam)
            ev[2].record()
            torch.cuda.synchronize()
            nets.append(ev[0].elapsed_time(ev[1]))
            tail.append(ev[1].elapsed_time(ev[2]))
    b = frames.shape[0]
    out = dict(networks_ms=statistics.median(nets) / b, tail_ms=statistics.median(tail) / b)
    host = bench.batches[0]
    if not isinstance(host, torch.Tensor):
        ms = []
        for _ in range(int(bench.cell.traffic["stage_repeats"])):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            torch.as_tensor(host).to(bench.device)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        out["upload_gbps"] = host.nbytes / (statistics.median(ms) * 1e-3) / 1e9
    return out


def tail_kernels(bench) -> float:
    """Device kernels a frame that the tail launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from semantic_depth_tpu_torch import pipeline as port

    pipe = bench.pipe
    frames = torch.as_tensor(bench.batches[0]).to(bench.device)
    reps = int(bench.cell.traffic["tail_profile_repeats"])
    with torch.inference_mode():
        cam, s_w = port._scaled_camera(pipe.config, port._scalar(bench.focal))
        small, road, fence = pipe._batch_segment(frames)
        disps = pipe._batch_disparity(small, port._scalar(bench.mult) * s_w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function("portbench.tail"):
                    pipe._batch_geometry(small, road, fence, disps, cam)
            torch.cuda.synchronize()
    n = sum(1 for e in _events(prof) if _on_device(e) and _kind(e) == "kernel")
    return n / (reps * frames.shape[0])
