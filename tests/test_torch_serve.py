"""The port's closed-loop server against the JAX package's ``QueryService``.

``repro_torch.launch.serve.main`` with ``--closed-loop --device cpu`` on
the LDBC proxy at scale 0.1 must exit 0, and every served batch's levels,
iteration counts and policy must equal what JAX's ``QueryService`` returns
for the same sources; a ``--query-kind`` neither package serves is refused
by both loops (the open loop and ``--mutate-stream`` are held against
JAX in ``test_torch_service.py``, the non-reach kinds in
``test_torch_queries.py``).
"""
import numpy as np
import pytest

from repro.graph.generators import PAPER_DATASET_FAMILIES, PAPER_DATASETS
from repro.launch.mesh import make_mesh
from repro.launch.serve import QueryService as JQueryService

from repro_torch.launch import serve

from test_torch_graph import np_of


@pytest.mark.parametrize("per_batch", [8, 64])
def test_closed_loop_serve_matches_jax(per_batch, capsys):
    records = []
    argv = ["--closed-loop", "--device", "cpu", "--dataset", "ldbc",
            "--scale", "0.1", "--batches", "2",
            "--sources-per-batch", str(per_batch)]
    assert serve.main(argv, on_batch=records.append) == 0
    out = capsys.readouterr().out
    assert "served 2 batches" in out and "warm p50" in out
    assert [r.index for r in records] == [0, 1]
    assert records[0].cold

    csr = PAPER_DATASETS["ldbc"](0.1)
    jsvc = JQueryService(make_mesh((1, 1), ("data", "model")), csr,
                         family=PAPER_DATASET_FAMILIES["ldbc"])
    for r in records:
        res, pol = jsvc.query(r.sources)
        assert r.policy == pol == ("ntkms" if per_batch >= 64 else "ntks")
        np.testing.assert_array_equal(np.asarray(res.iterations),
                                      np_of(r.result.iterations))
        np.testing.assert_array_equal(np.asarray(res.state.levels),
                                      np_of(r.result.state.levels))


@pytest.mark.parametrize("extra", [
    ["--closed-loop", "--query-kind", "nope"],
    ["--query-kind", "nope"],  # the open loop refuses it too
])
def test_unported_flags_raise(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--scale", "0.05", *extra])
    assert exc.value.code == 2
    assert "invalid choice: 'nope'" in capsys.readouterr().err
