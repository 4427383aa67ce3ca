"""95th percentile of the time from a query's submit to its delivery, over
every query delivered in the window (host clock, ms)."""
from harness import stats


def read(run):
    p = stats.percentile(run.spans.latency_s, 95)
    return None if p is None else 1e3 * p
