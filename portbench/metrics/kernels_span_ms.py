"""kernels_span_ms: device ms a frame of the kernel wrappers' spans
``sd.k1``-``sd.k4`` together (each op call, its layout copies included) in
the second window."""

from portbench.harness import program


def read(t):
    return program.span_ms(t, program.KERNEL_SPANS)
