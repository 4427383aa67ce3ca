"""Device time between one engine iteration's last launch and the next
iteration's first (the program's ``engine.iter_gap`` records: the events
of its ``engine.iter`` spans on the engine's stream), summed over every
engine call of both phases that ended in the window, over the batches
whose phase 1 ended in it (ms): how long the device waited on the
engines' host loop. Nothing to read off the card."""
from harness import program_spans

install = program_spans.install


def read(run):
    gaps = [r.device_ms
            for r in program_spans.in_window(run, "engine.iter_gap")
            if r.device_ms is not None]
    batches = len(program_spans.in_window(run, "dispatch.phase1"))
    if not gaps or not batches:
        return None
    return sum(gaps) / batches
