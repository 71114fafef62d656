"""host_syncs: synchronising host runtime calls a frame (``program.SYNCS``)
that start inside the program's ``sd.call``, from the second window's
profile."""

from portbench.harness import program


def read(t):
    p = program.called(t)
    return p["syncs"] / p["frames"] if p is not None else None
