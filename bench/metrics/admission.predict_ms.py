"""Time of the program's ``admission.predict`` spans (the deadline pass's
depth estimates of a packed batch's members, each pass of the eviction
fixpoint), summed over the plan rounds that ended in the window, a plan
round (host clock, ms). Nothing to read where no batch was packed."""
from harness import program_spans

install = program_spans.install


def read(run):
    parts = program_spans.in_window(run, "admission.predict")
    plans = len(program_spans.in_window(run, "admission.plan"))
    if not parts or not plans:
        return None
    return sum(r.host_ms for r in parts) / plans
