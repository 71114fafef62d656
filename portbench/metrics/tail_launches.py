"""tail_launches: device kernels a frame inside the harness's
``portbench.tail`` span around ``_batch_geometry``, from the profiler's
trace: the host-bound tail's launch count."""


def read(t):
    return t["tail_kernels"]
