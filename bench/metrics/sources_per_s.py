"""Sources of every query delivered in the window, over the window's
seconds (host clock)."""
from harness import stats


def read(run):
    return stats.rate(run.spans.sources_delivered, run.seconds)
