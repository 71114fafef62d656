"""conv_layout_share: the percentage of the networks stage's device time
spent in cuDNN's layout conversions around convolutions, the kernels whose
names hold ``nchwToNhwc`` or ``nhwcToNchw``. The numerator is those kernels'
device seconds in the profiled window; the denominator is the stage's
CUDA-event span (``networks_ms``, a frame) times the window's frames. Kernel
names cannot set the networks apart from the tail (both launch torch's
elementwise and copy kernels), and the upload is no part of the stage, so
the denominator is the stage's own span. Only convolutions convert layouts,
and they all run in the networks stage. None where the window ran no frame."""

LAYOUT = ("nchwToNhwc", "nhwcToNchw")


def read(t):
    prof, networks_ms = t["profile"], t["stages"]["networks_ms"]
    stage_s = networks_ms * 1e-3 * prof["frames"]
    if stage_s <= 0:
        return None
    layout = sum(s for name, s in prof["kernel_s"].items() if any(k in name for k in LAYOUT))
    return 100.0 * layout / stage_s
