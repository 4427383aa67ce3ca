"""Seconds spent building and placing the program's operands (the
benchmark's span around each ``prepare_graph`` call, to the card's
synchronize), all in set-up."""


def read(run):
    return run.spans.operands_s or None
