"""Sources per packed (lane-shared MS-BFS) batch over the morsel's lanes,
over the batches the admission planned in the window (%). Nothing to read
where no batch was packed."""
from harness import stats


def read(run):
    fills = [n / run.spans.lanes for n, packed in run.spans.planned
             if packed]
    m = stats.mean(fills)
    return None if m is None else 100.0 * m
