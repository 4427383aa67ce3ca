"""Mean time of the program's ``service.unpack`` span (a finalized
batch's levels copied to the host and ``unpack_levels``), over the
finalizes that ended in the window (host clock, ms)."""
from harness import program_spans

install = program_spans.install


def read(run):
    return program_spans.mean_ms(run, "service.unpack")
