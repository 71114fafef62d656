"""upload_span_ms: device ms a frame of the program's own ``sd.upload`` span
(``torch.as_tensor(frames).to(device)`` in ``process_batch``) in the second
window."""

from portbench.harness import program


def read(t):
    return program.span_ms(t, ["sd.upload"])
