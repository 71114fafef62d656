"""networks_ms: device ms a frame of the networks' stages (resize, FCN-8s and
its masks, monodepth with the flip blend), a CUDA-event span from the
harness around ``_batch_segment`` and ``_batch_disparity``."""


def read(t):
    return t["stages"]["networks_ms"] if t["networks"] == "seeded" else None
