"""idle_entry_share: the percentage of the second window in which the device
was idle while the host was in ``sd.upload``, or in ``sd.call`` outside its
three stages (``harness.program``)."""

from portbench.harness import program


def read(t):
    return program.idle_share(t, "entry")
