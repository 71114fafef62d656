"""Device selection, numeric mode and profiling for the PyTorch port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do). A missing card raises instead of dropping quietly to the
CPU: a CPU run is never a measurement of the port. ``trace`` and
``annotate`` are the port of the JAX package's ``runtime.trace`` /
``runtime.annotate`` on ``torch.profiler``.
"""

from __future__ import annotations

import os
import time

import torch


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


class trace:
    """``torch.profiler`` around a block (host and, where there is a card,
    device activity); on exit a Chrome trace (Perfetto, chrome://tracing)
    is written to ``log_dir``, its path in ``self.path``.

        with runtime.trace("traces"):
            with runtime.annotate("batch"):
                pipe.process_batch(frames)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None
        self._prof = None

    def __enter__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self.path = os.path.join(self.log_dir, f"trace_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return False


def annotate(name: str):
    """A named span inside a ``trace`` (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
