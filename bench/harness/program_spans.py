"""The program's own spans (``repro_torch.trace``), read by the per-layer
readers whose metrics they feed.

``install`` turns the program's facility on in the set-up of a traced run
(only traced runs call a reader's ``install``, so the runs that give the
end-to-end metrics keep it off) and off again where the window closes,
before the traced part's profiler is armed: the device figures of the
traced part are taken from the program as an untraced run drives it. A
reader reads the records that ended inside the window, the batches that
``service.finalize_ms`` and ``dispatch.phase1_ms`` average over. A
program without the facility gives every reader nothing to read.
"""
from __future__ import annotations

from . import stats

try:
    from repro_torch import trace
except ImportError:  # a program from before the facility
    trace = None


def install(run) -> None:
    """On until the window closes; once a run, however many readers ask."""
    if trace is None or getattr(run, "program_spans", False):
        return
    run.program_spans = True
    trace.enable()
    close = run._close_window

    def off_then_close():
        trace.disable()
        close()

    run._close_window = off_then_close


def in_window(run, name: str) -> list:
    """The records of span ``name`` that ended inside the window."""
    a, b = run.spans.window
    if trace is None or a is None:
        return []
    return [r for r in trace.records(a, b) if r.name == name]


def mean_ms(run, name: str) -> float | None:
    """Mean host time of span ``name`` (ms)."""
    return stats.mean(r.host_ms for r in in_window(run, name))

