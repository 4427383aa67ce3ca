"""From the start of the benchmark's process to the window's start: torch
and the program imported, the graph and the source pool made from the
seed, the program's operands built and placed, kernels built or loaded,
and the warm-up served (host clock, s)."""


def read(run):
    return run.setup_seconds()
