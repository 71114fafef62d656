"""tail_span_ms: device ms a frame of the program's own ``sd.tail`` span
(``_batch_geometry`` inside ``process_batch``; idle device time inside the
span counts) in the second window."""

from portbench.harness import program


def read(t):
    return program.span_ms(t, ["sd.tail"])
