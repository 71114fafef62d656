"""tail_ms: device ms a frame of the geometry tail, a CUDA-event span from the
harness around ``_batch_geometry`` (idle device time inside the span, while
the host enqueues or waits, counts)."""


def read(t):
    return t["stages"]["tail_ms"]
