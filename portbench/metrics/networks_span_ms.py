"""networks_span_ms: device ms a frame of the program's own ``sd.networks``
span (``_batch_segment`` + ``_batch_disparity`` inside ``process_batch``,
CUDA events of ``runtime.annotate``) in the second window."""

from portbench.harness import program


def read(t):
    return program.span_ms(t, ["sd.networks"])
