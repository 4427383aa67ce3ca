"""``correct`` comes out false when the timed path is broken underneath:
the program's own control (its adjacency cut to a few neighbours a node,
which breaks the exact levels the configurations state), and each fault
the cells can have, planted in the program on the CPU while the rest of
a run is driven as on the card. A sound run of the same size comes out
correct."""
from __future__ import annotations

import numpy as np
import pytest

from bench_cpu import tiny_run
from repro_torch.core import edge_compute
from repro_torch.runtime import dispatch, service

CELL = "ldbc-knows-n160k.reach1-c128"


def test_sound_run_is_correct():
    r = tiny_run(CELL)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["checked_queries"]["value"] > 0


def test_control_cut_adjacency_is_not_correct():
    r = tiny_run(CELL, control={"max_deg": 2})
    assert not r["correct"]
    assert r["checks"]["wrong_levels"]["value"] > 0
    assert r["failed"] > 0


@pytest.fixture
def unchanged_step(monkeypatch):
    """Every extension step returns its state unchanged."""
    for ec in edge_compute.EDGE_COMPUTES.values():
        monkeypatch.setattr(ec, "apply", staticmethod(
            lambda state, reached, it: state), raising=False)


@pytest.fixture
def half_batch(monkeypatch):
    """Half of each batch's sources left out, the other half served in
    their place."""
    begin = dispatch.QueryDispatcher.begin_batch

    def halved(self, sources, *args, **kw):
        s = np.asarray(sources).copy()
        h = len(s) // 2
        if h:
            s[h:2 * h] = s[:h]
        return begin(self, s, *args, **kw)

    monkeypatch.setattr(dispatch.QueryDispatcher, "begin_batch", halved)


@pytest.fixture
def altered_answer(monkeypatch):
    """One level of each batch's first row altered where it is
    produced."""
    unpack = service.unpack_levels

    def altered(*args, **kw):
        out = unpack(*args, **kw)
        first = next(iter(out.values()))
        first[0, -1] += 1
        return out

    monkeypatch.setattr(service, "unpack_levels", altered)


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer"])
def test_fault_is_not_correct(fault, request):
    request.getfixturevalue(fault)
    r = tiny_run(CELL, seconds=0.5)
    assert not r["correct"], (fault, r["checks"])
    assert r["checks"]["wrong_levels"]["value"] > 0
