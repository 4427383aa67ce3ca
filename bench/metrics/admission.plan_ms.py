"""Mean time of the program's ``admission.plan`` span (all of
``AdmissionQueue.plan``), over the plan rounds that ended in the window
(host clock, ms)."""
from harness import program_spans

install = program_spans.install


def read(run):
    return program_spans.mean_ms(run, "admission.plan")
