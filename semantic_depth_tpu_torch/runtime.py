"""Device selection, numeric mode, device constants and tracing for the
PyTorch port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do). A missing card raises instead of dropping quietly to the
CPU: a CPU run is never a measurement of the port. ``trace`` and
``annotate`` are the port of the JAX package's ``runtime.trace`` /
``runtime.annotate`` on ``torch.profiler``.

``device_constant`` keeps the frame program's float constants on the card:
a constant copied from the host drains the card's queue, and a CUDA graph
cannot capture the copy.

Program tracing is off unless ``tracing()`` (or ``trace``) is entered.
Off, ``annotate`` returns one shared null context; on, each span is a
``torch.profiler.record_function`` range (on the profiler's timeline,
beside the device's kernels) and, with ``device=True``, a pair of CUDA
events, read by ``stats()``. The program opens these spans:

    sd.call        process_batch (process_frame goes through it); device
      sd.upload    the frames' copy to the pipeline's device; device
      sd.networks  _batch_segment + _batch_disparity; device
        sd.resize, sd.fcn
        sd.monodepth  the flip batch and its blend; device
          sd.mono.encoder, sd.mono.decoder  Monodepth.forward's or DPT.forward's
                      halves; device
      sd.tail      _batch_geometry; device
        sd.road    the road chain and its width (sd.k1 or sd.k4, sd.k2 x2, sd.k3)
        sd.fence   the fence chains and f2f (sd.k2 x2)
        sd.overlay
    sd.k1 .. sd.k4 the kernel wrappers (knn_grid, mad, radius, exact_knn); device

A span opened while its stream is being captured into a CUDA graph records
no CUDA events, and a graph's replay opens none of the spans inside it: on
the card the spans below ``sd.tail`` and ``sd.monodepth`` appear on eager
calls only (``pipeline._batch_geometry``, ``pipeline._batch_disparity``).

``launches`` counts, by op over the process, the hand-written kernels'
launches (the kernel layer counts them, ``ops._cuda.launch_chunks``) and
DPT's attention calls, ``sdpa`` (``F.scaled_dot_product_attention``, one a
block; ``models.dpt``). A CUDA graph's replay adds what its capture
counted (``graphs.Captured``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch

CALL = "sd.call"  # the span that starts a new call id
launches = collections.Counter()  # kernel launches and attention calls by op, over the process


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def set_full_fp32() -> None:
    """Full-precision float32 convolutions and matrix products.

    cuDNN runs float32 convolutions in TF32 by default, and the resize and
    Gram-identity products lose digits below full float32. The port's
    default (``SemanticDepthPipeline`` calls this) matches the JAX tests'
    ``jax_default_matmul_precision="highest"``; TF32 is a later, opt-in
    change.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_CONSTANTS: Dict = {}


def device_constant(value, device) -> torch.Tensor:
    """``value`` (a float, or a tuple of floats) as a float32 tensor on
    ``device``, made once per value and device and kept for the process (a
    captured CUDA graph reads it at every replay). While torch.export or
    torch.compile traces, a fresh tensor, so a traced program holds no
    cached one."""
    if torch.compiler.is_compiling():
        return torch.tensor(value, dtype=torch.float32, device=device)
    key = (value, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):  # usable in and out of inference mode
            t = _CONSTANTS.setdefault(key, torch.tensor(value, dtype=torch.float32,
                                                        device=device))
    return t


_on = False  # program tracing; set only by ``tracing``
_NULL = contextlib.nullcontext()


class _Recorder:
    """What tracing keeps: the last call id given, the open call's (0
    outside a call), the spans closed since the outermost ``tracing()`` was
    entered (name, call id, host ns, CUDA event pair or None) and the CUDA
    events free for reuse."""

    def __init__(self):
        self.last_call = self.call = 0
        self.spans = []
        self.free = []

    def event(self) -> torch.cuda.Event:
        return self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)

    def clear(self) -> None:
        for *_, events in self.spans:
            if events is not None:
                self.free.extend(events)
        self.spans.clear()


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "device", "call", "outer", "rf", "events", "t0")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.outer = _REC.call
        if self.name == CALL:
            _REC.last_call += 1
            _REC.call = _REC.last_call
        self.call = _REC.call
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        timed = self.device and not torch.cuda.is_current_stream_capturing()
        self.events = (_REC.event(), _REC.event()) if timed else None
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        _REC.call = self.outer
        _REC.spans.append((self.name, self.call, host_ns, self.events))
        return False


@contextlib.contextmanager
def tracing(on: bool = True):
    """Program tracing on (or, with ``on=False``, off) inside the block;
    the state outside it is restored on exit. Entering it from off starts
    afresh: spans not yet read by ``stats()`` are dropped."""
    global _on
    was = _on
    if on and not was:
        _REC.clear()
    _on = on
    try:
        yield
    finally:
        _on = was


def annotate(name: str, device: bool = False):
    """A named span of the program. With tracing off (the default) this
    reads one flag and returns a shared null context. With it on, a
    ``torch.profiler.record_function`` range and, where ``device`` is true
    (the caller's tensors are on the card) and the stream is not being
    captured into a CUDA graph, CUDA events on the current stream around
    the block. Spans opened inside an ``sd.call`` carry its call id."""
    if not _on:
        return _NULL
    return _Span(name, device)


def stats() -> Dict[str, Dict]:
    """The spans closed since tracing was entered, by name, and forget them:
    ``calls``, ``host_ms`` (summed), ``device_ms`` (the sum of the CUDA
    event pairs; None for a span with none) and ``call_ids`` (the distinct
    ids of the ``sd.call`` each was opened in; 0 outside any). Synchronises
    with the card where a span recorded events."""
    if any(events is not None for *_, events in _REC.spans):
        torch.cuda.synchronize()
    out: Dict[str, Dict] = {}
    for name, call, host_ns, events in _REC.spans:
        row = out.setdefault(name, dict(calls=0, host_ms=0.0, device_ms=None, call_ids=set()))
        row["calls"] += 1
        row["host_ms"] += host_ns * 1e-6
        row["call_ids"].add(call)
        if events is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + events[0].elapsed_time(events[1])
    for row in out.values():
        row["call_ids"] = sorted(row["call_ids"])
    _REC.clear()
    return out


class trace:
    """``torch.profiler`` around a block (host and, where there is a card,
    device activity), with program tracing on, so the program's ``sd.*``
    spans lie beside its kernels; on exit a Chrome trace (Perfetto,
    chrome://tracing) is written to ``log_dir``, its path in ``self.path``.

        with runtime.trace("traces"):
            with runtime.annotate("batch"):
                pipe.process_batch(frames)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None
        self._tracing = None

    def __enter__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._tracing = tracing()
        self._tracing.__enter__()
        return self

    def __exit__(self, *exc):
        self._tracing.__exit__(*exc)
        self._prof.__exit__(*exc)
        self.path = os.path.join(self.log_dir, f"trace_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return False
