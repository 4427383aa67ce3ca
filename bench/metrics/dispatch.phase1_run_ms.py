"""Mean time of the program's ``dispatch.phase1`` span on the phase-1
worker (from the start of the engine call to its end event), over the
batches whose phase 1 ended in the window (host clock, ms)."""
from harness import program_spans

install = program_spans.install


def read(run):
    return program_spans.mean_ms(run, "dispatch.phase1")
