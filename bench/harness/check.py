"""How ``correct`` is decided: every kept query's delivered level rows
against the plain BFS of ``reference/``, exactly.

The configuration's guarantee is exact BFS levels over the whole edge
set, so every number compared has the limit 0: the level entries that
differ from the reference, the queries sent in the window that were never
delivered, and those shed. A run must also have compared at least one
query.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"wrong_levels": 0, "undelivered": 0, "shed": 0}
MIN_CHECKED = 1


def compare(sample, table, n_nodes: int) -> dict:
    """``sample``: ``(qid, sources, rows)`` kept from the run; ``table``
    gives the reference row of a source. Returns the figures compared and
    the queries found wrong."""
    wrong_levels = wrong_rows = 0
    wrong = set()
    for qid, sources, rows in sample:
        rows = np.asarray(rows)
        if rows.shape != (len(sources), n_nodes):
            wrong.add(qid)
            wrong_rows += len(sources)
            wrong_levels += len(sources) * n_nodes
            continue
        for src, row in zip(sources, rows):
            d = int(np.count_nonzero(row != table.row(int(src))))
            if d:
                wrong.add(qid)
                wrong_rows += 1
                wrong_levels += d
    return {"wrong_levels": wrong_levels, "wrong_rows": wrong_rows,
            "wrong_queries": len(wrong), "checked_queries": len(sample),
            "checked_rows": int(sum(len(s) for _, s, _ in sample)),
            "distinct_sources": len(table)}


def verdict(figures: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number compared with its limit."""
    checks = {k: {"value": figures[k], "limit": v} for k, v in LIMITS.items()}
    checks["checked_queries"] = {"value": figures["checked_queries"],
                                 "min": MIN_CHECKED}
    ok = all(figures[k] <= v for k, v in LIMITS.items()) and (
        figures["checked_queries"] >= MIN_CHECKED)
    return ok, checks
