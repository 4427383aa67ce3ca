"""Device kernels the program launched in the traced part of the window,
over the batches begun in it (the launch probes' own kernels left out)."""


def read(run):
    ts = run.trace_summary
    n = run.spans.batches_begun_traced
    if ts is None or not n or not ts.kernels:
        return None
    return ts.kernels / n
