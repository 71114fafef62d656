"""idle_outside_share: the percentage of the second window in which the device
was idle while the host was in no program span (the harness's loop and
readback) (``harness.program``)."""

from portbench.harness import program


def read(t):
    return program.idle_share(t, "outside")
