"""idle_tail_share: the percentage of the second window in which the device was
idle while the host was in the ``sd.tail`` subtree or a kernel span
(``harness.program``)."""

from portbench.harness import program


def read(t):
    return program.idle_share(t, "tail")
