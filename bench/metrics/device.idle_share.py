"""Share of the traced window in which no operation of the program ran on
the device: 1 minus the union of its kernel, copy and set intervals over
the window's length (%)."""


def read(run):
    ts = run.trace_summary
    if ts is None or ts.window_s <= 0 or ts.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ts.busy_s / ts.window_s)
