"""The program's own spans: a second profiled window of the cell's traffic
with the port's tracing on (``semantic_depth_tpu_torch.runtime.tracing``),
and what it gives, per frame of that window:

* ``spans``: ``runtime.stats()`` of the window, each ``sd.*`` span's calls,
  device ms (the program's CUDA-event pairs) and host ms;
* ``idle_s``: the device's idle seconds put down to the stage the host was
  in. The idle intervals are found as ``trace.profiled_window`` finds them
  (the complement of the union of kernels, copies and sets between the
  first and the last harness span); each is cut at the host bounds of the
  profiler's ``sd.*`` ranges, and each piece is charged to the innermost
  range open over it: ``sd.upload``, or ``sd.call`` outside its stages ->
  entry; the ``sd.networks`` subtree -> networks; the ``sd.tail`` subtree
  and the kernel spans -> tail; no range open (the harness's loop and
  readback) -> outside. The four add up to the window's idle time;
* ``syncs``: the host runtime calls of ``SYNCS`` that start inside an
  ``sd.call``, by the innermost range open at their start;
* ``kernel_ms``: K1-K3's device ms by the profiler (``bounds.kernel_of``).

``window`` returns None where the program has no ``runtime.tracing``.
``sync_sites`` pairs each sync of one call with the line of Python that
made it (``probes.sync_debug("warn")``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import bounds, trace
from .loop import read_back

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
STAGES = ("entry", "networks", "tail", "outside")
NETWORKS = frozenset(("sd.networks", "sd.resize", "sd.fcn", "sd.monodepth"))
TAIL = frozenset(("sd.tail", "sd.road", "sd.fence", "sd.overlay",
                  "sd.k1", "sd.k2", "sd.k3", "sd.k4"))
KERNEL_SPANS = ("sd.k1", "sd.k2", "sd.k3", "sd.k4")
HARNESS = ("portbench.call", "portbench.readback")

Span = Tuple[int, int, str]  # host start ns, end ns, name


def stage_of(names) -> str:
    """The stage of a piece of time from the names of the ranges open over it."""
    names = set(names)
    if names & TAIL:
        return "tail"
    if names & NETWORKS:
        return "networks"
    return "entry" if names else "outside"


def _innermost(open_: Dict[int, Span]) -> Optional[str]:
    if not open_:
        return None
    return max(open_.values(), key=lambda s: (s[0], -s[1]))[2]


def sweep(spans: Sequence[Span], idle: Sequence[Tuple[int, int]], marks: Sequence[int]):
    """One pass over time. Returns (idle ns by stage, idle ns by innermost
    range name, or "outside"; for each mark, the names open at it and the
    innermost). A range holds [start, end); so does an idle interval."""
    ev = []
    for i, (s, e, _) in enumerate(spans):
        ev += [(s, 1, i), (e, 0, i)]
    for a, b in idle:
        ev += [(a, 2, -1), (b, 3, -1)]
    ev += [(x, 4, j) for j, x in enumerate(marks)]
    ev.sort(key=lambda x: (x[0], x[1]))  # at one instant: ends, starts, idle, marks
    by_stage = dict.fromkeys(STAGES, 0)
    by_span: Dict[str, int] = defaultdict(int)
    at_marks: List = [None] * len(marks)
    open_: Dict[int, Span] = {}
    idle_open, prev = 0, None
    for t, kind, i in ev:
        if idle_open and t > prev:
            names = [s[2] for s in open_.values()]
            by_stage[stage_of(names)] += t - prev
            by_span[_innermost(open_) or "outside"] += t - prev
        prev = t
        if kind == 0:
            del open_[i]
        elif kind == 1:
            open_[i] = spans[i]
        elif kind == 2:
            idle_open += 1
        elif kind == 3:
            idle_open -= 1
        else:
            at_marks[i] = ({s[2] for s in open_.values()}, _innermost(open_))
    return by_stage, dict(by_span), at_marks


def idle_intervals(work: Sequence[Span], w0: int, w1: int):
    """[w0, w1) less the union of the device's work clipped to it."""
    clipped = [(max(s, w0), min(e, w1)) for s, e, _ in work]
    busy = trace._union([w for w in clipped if w[1] > w[0]])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def reduce(work, spans: Sequence[Span], syncs: Sequence[int], harness: Sequence[Span],
           frames: int) -> Dict:
    """The window's numbers from its device work [(start, end, name)], the
    program's host ranges, the start of each synchronising runtime call and
    the harness's host spans (which bound the window)."""
    w0, w1 = min(s for s, _, _ in harness), max(e for _, e, _ in harness)
    idle = idle_intervals(work, w0, w1)
    by_stage, by_span, at_syncs = sweep(spans, idle, sorted(syncs))
    in_call = [inner for names, inner in at_syncs if "sd.call" in names]
    sync_by_span: Dict[str, int] = defaultdict(int)
    for inner in in_call:
        sync_by_span[inner] += 1
    kernel_ms: Dict[str, float] = defaultdict(float)
    for s, e, name in work:
        key = bounds.kernel_of(name)
        if key is not None:
            kernel_ms[key] += (e - s) * 1e-6
    return dict(frames=frames, window_s=(w1 - w0) * 1e-9,
                idle_window_s=sum(b - a for a, b in idle) * 1e-9,
                idle_s={k: v * 1e-9 for k, v in by_stage.items()},
                idle_by_span={k: v * 1e-9 for k, v in by_span.items()},
                syncs=len(in_call), syncs_by_span=dict(sync_by_span), sync_spans=in_call,
                kernel_ms=dict(kernel_ms))


def from_events(events) -> Tuple[List, List[Span], List[int], List[Span]]:
    """(device work, program ranges, sync starts, harness spans) of a
    profile's kineto events."""
    work, spans, syncs, harness = [], [], [], []
    for e in events:
        name = e.name()
        if trace._on_device(e):
            if trace._kind(e) in trace.WORK:
                work.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("sd."):
            spans.append((e.start_ns(), e.end_ns(), name))
        elif name in SYNCS:
            syncs.append(e.start_ns())
        elif name in HARNESS:
            harness.append((e.start_ns(), e.end_ns(), name))
    return work, spans, syncs, harness


def _profile(on_card: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=acts)


def window(bench, seconds: float) -> Optional[Dict]:
    """The second window: a closed loop of the traffic for ``seconds`` under
    ``torch.profiler`` and ``runtime.tracing()``, reduced; None where the
    program cannot trace itself."""
    from torch.profiler import record_function

    from semantic_depth_tpu_torch import runtime

    if not hasattr(runtime, "tracing"):
        return None
    on_card = bench.device.type == "cuda"
    n_in = len(bench.batches)
    calls = 0
    with _profile(on_card) as prof, runtime.tracing():
        t0 = time.perf_counter()
        while True:
            with record_function("portbench.call"):
                out = bench.call(bench.batches[calls % n_in])
            with record_function("portbench.readback"):
                read_back(out)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
    spans = runtime.stats()
    out = reduce(*from_events(trace._events(prof)), frames=calls * bench.batch)
    out.update(calls=calls, spans=spans)
    return out


def sync_sites(call) -> Dict:
    """``call()``, one call of the program on the card, under the profiler,
    program tracing and ``probes.sync_debug("warn")`` on ``process_batch``:
    the innermost span of each sync the profiler saw inside ``sd.call``, and
    the site (``file:line: warning``) of each warning, both in order."""
    from torch.profiler import record_function

    from semantic_depth_tpu_torch import runtime
    from semantic_depth_tpu_torch.pipeline import SemanticDepthPipeline
    from semantic_depth_tpu_torch.utils.probes import sync_debug

    target = [(SemanticDepthPipeline, "process_batch")]
    with _profile(True) as prof, runtime.tracing(), sync_debug("warn", target) as warned:
        with record_function("portbench.call"):
            call()
        torch.cuda.synchronize()
    runtime.stats()
    red = reduce(*from_events(trace._events(prof)), frames=1)
    return dict(spans=red["sync_spans"], sites=list(warned))


def span_ms(t: Dict, names: Sequence[str]) -> Optional[float]:
    """Device ms a frame of the window's spans ``names`` together; None
    where none of them opened on the card."""
    p = t.get("program")
    if p is None:
        return None
    ms = [p["spans"][n]["device_ms"] for n in names
          if n in p["spans"] and p["spans"][n]["device_ms"] is not None]
    return sum(ms) / p["frames"] if ms else None


def called(t: Dict) -> Optional[Dict]:
    """The second window's numbers where the program opened ``sd.call``."""
    p = t.get("program")
    return p if p is not None and "sd.call" in p["spans"] else None


def idle_share(t: Dict, stage: str) -> Optional[float]:
    p = called(t)
    return 100.0 * p["idle_s"][stage] / p["window_s"] if p is not None else None
