"""Mean phase-1 time of the batches finalized in the window, as the
dispatcher reports it (``QueryOutcome.phase_ms["phase1"]``, through
``on_finalized``; host clock at the join, ms)."""
from harness import stats


def read(run):
    return stats.mean(run.spans.phase1_ms)
