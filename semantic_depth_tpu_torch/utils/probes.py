"""Measurement helpers for the port on a CUDA card, shared by
``chip_smoke.py``, ``tools/time_mad_radius.py``, ``tools/time_knn.py`` and the
card tests:

* ``cuda_ms`` and ``cuda_ms_stream``: device milliseconds by CUDA events;
  ``device_ms``: the profiler's device time of chosen kernels per call;
* ``recording_kernel_calls``: the arguments of every kernel call (K1-K4)
  that a block of code makes (run the geometry tail inside it to get the
  frame program's own launches);
* ``sync_debug``: the geometry tail's MAD and radius filters (or other
  functions) under ``torch.cuda.set_sync_debug_mode``, so that a
  synchronising CUDA call in them (a host-to-device copy of a threshold or
  a radius) raises or is collected;
* ``train_step_agreement``: how one trainer step on the card agrees with
  the same step on the CPU.
"""

from __future__ import annotations

import contextlib
import statistics
import time
import warnings

import torch

from ..ops import exact_knn, knn_grid, mad, neighbors, pcl, radius

# the filters whose kernels take their thresholds and radius by value
SYNC_FREE_FILTERS = ((pcl, "mad_filter"), (pcl, "mad_filter_pair"),
                     (neighbors, "radius_outlier_filter"))


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of one call of ``fn`` on the card (CUDA events
    around each call, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_stream(fn, reps=20, iters=5):
    """Median over ``iters`` of the mean milliseconds of ``reps`` calls of
    ``fn`` back to back (CUDA events around the run): the device's time per
    call while the host stays ahead of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, iters, marks=None):
    """(device ms of the kernels whose names hold one of ``marks``, or of
    every kernel, per call; profiled wall ms per call) over ``iters`` calls
    of ``fn`` in one ``torch.profiler`` pass."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type.name == "CUDA"
               and (marks is None or any(m in ev.name for m in marks)))
    if busy == 0.0:
        raise RuntimeError(f"no kernel matching {marks} ran")
    return busy / iters, wall / iters


@contextlib.contextmanager
def _wrapped(targets, wrap):
    """Replace each ``(module, name)`` by ``wrap(original, name)`` inside the
    block."""
    saved = [(m, n, getattr(m, n)) for m, n in targets]
    for m, n, fn in saved:
        setattr(m, n, wrap(fn, n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


# the kernel wrappers by the recorder's key
_WRAPPERS = {"mad": (mad, "mad_keep_mask"), "radius": (radius, "radius_counts"),
             "exact_knn": (exact_knn, "knn_mean_distances_exact"),
             "knn_grid": (knn_grid, "knn_mean_distances_grid")}


@contextlib.contextmanager
def recording_kernel_calls():
    """Yields ``{"mad": [...], "radius": [...], "exact_knn": [...],
    "knn_grid": [...]}``, which collects the positional arguments (tensors
    cloned) of every call of those wrappers made inside the block. The
    calls still run."""
    calls = {key: [] for key in _WRAPPERS}
    keys = {name: key for key, (_, name) in _WRAPPERS.items()}

    def wrap(fn, name):
        store = calls[keys[name]]

        def rec(*args, **kw):
            store.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return fn(*args, **kw)

        return rec

    with _wrapped(_WRAPPERS.values(), wrap):
        yield calls


@contextlib.contextmanager
def sync_debug(mode="error", targets=SYNC_FREE_FILTERS):
    """Inside the block, every call of the ``(module or class, name)``
    functions of ``targets`` runs under
    ``torch.cuda.set_sync_debug_mode(mode)``. With ``"error"`` a
    synchronising CUDA call in them raises a RuntimeError; with ``"warn"``
    the yielded list collects each such warning as ``"<file>:<line>:
    <first line>"``, the line of Python that made the call."""
    found = []

    def wrap(fn, _name):
        def run(*args, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    found.extend(f"{w.filename}:{w.lineno}: {str(w.message).splitlines()[0]}"
                                 for w in caught
                                 if "called a synchronizing" in str(w.message))
        return run

    with _wrapped(targets, wrap):
        yield found


def train_step_agreement(ref, other, before, lr):
    """Compare one step of two trainers (``ref`` on the CPU, ``other`` on the
    card, say) taken from the same parameters ``before`` ({name: CPU
    tensor}). Returns ``grad_rel``, ||g_other - g_ref|| / ||g_ref|| over all
    parameters together; ``grad_rel_param`` and ``worst_param``, the largest
    such ratio of one parameter and its name (a parameter whose every
    gradient is near Adam's eps, as FCN-8s's conv5 and fc layers at init,
    carries float32 summation noise of a few 1e-3 of its own norm);
    ``step_err_lr``, the largest |p_other - p_ref| / lr over the elements
    whose |g_ref| exceeds 1e-4 of the largest gradient of the model (Adam's
    first step is lr * g / (|g| + eps), so where g is near eps or float32
    noise it may go either way); and ``moved``, the share of the elements
    with |g_ref| >= 100 eps (where that step is at least 0.99 lr) that the
    step changed."""
    others = dict(other.model.named_parameters())
    grads = {name: (p.grad.detach().cpu().double(), others[name].grad.detach().cpu().double())
             for name, p in ref.model.named_parameters()}
    g_max = max(float(g.abs().max()) for g, _ in grads.values())
    err2 = norm2 = step_err = 0.0
    worst, worst_rel, moved, checked = "", 0.0, 0, 0
    for name, p_ref in ref.model.named_parameters():
        g_ref, g_oth = grads[name]
        d2, n2 = float(((g_oth - g_ref) ** 2).sum()), float((g_ref ** 2).sum())
        err2, norm2 = err2 + d2, norm2 + n2
        rel = (d2 / max(n2, 1e-60)) ** 0.5
        if rel > worst_rel:
            worst, worst_rel = name, rel
        big = g_ref.abs() > 1e-4 * g_max
        a, b = p_ref.detach().cpu(), others[name].detach().cpu()
        if big.any():
            step_err = max(step_err, float((a[big].double() - b[big].double()).abs().max()) / lr)
        full = g_ref.abs() >= 1e-6  # 100 eps
        moved += int((a[full] != before[name][full]).sum())
        checked += int(full.sum())
    return dict(grad_rel=(err2 / max(norm2, 1e-60)) ** 0.5, grad_rel_param=worst_rel,
                worst_param=worst, step_err_lr=step_err, moved=moved / max(checked, 1))
