"""Mean time from a settled batch's ``finalize`` to the delivery of its
last query (the deferred state stitch, ``unpack_levels`` and the
deliveries), over the batches finalized in the window (host clock, ms)."""
from harness import stats


def read(run):
    m = stats.mean(run.spans.finalize_s)
    return None if m is None else 1e3 * m
