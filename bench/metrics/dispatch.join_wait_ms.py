"""Mean time of the program's ``dispatch.join`` span (the serving
thread's wait for phase 1 in ``QueryDispatcher._await``), over the joins
that ended in the window, one a batch (host clock, ms)."""
from harness import program_spans

install = program_spans.install


def read(run):
    return program_spans.mean_ms(run, "dispatch.join")
