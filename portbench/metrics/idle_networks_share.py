"""idle_networks_share: the percentage of the second window in which the device
was idle while the host was in the ``sd.networks`` subtree (resize, FCN-8s,
monodepth) (``harness.program``)."""

from portbench.harness import program


def read(t):
    return program.idle_share(t, "networks")
