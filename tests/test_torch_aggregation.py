"""MIS-2 coarsening of the port (``basic``, ``two_phase``, ``serial``)
against the JAX package: equal label digests, aggregate counts, roots,
phases and MIS-2 iteration counts."""
from __future__ import annotations

import numpy as np
import pytest

import repro_torch as rt

from _torch_common import (
    CPU,
    GRAPHS,
    port_graph,
    ref_coarsen,
)


def _same(r, ref):
    assert (r.digest, r.num_aggregates, r.iterations, r.converged) == (
        ref.digest, ref.num_aggregates, ref.iterations, ref.converged)
    np.testing.assert_array_equal(r.roots, ref.roots)
    np.testing.assert_array_equal(r.phase, ref.phase)
    assert r.labels.dtype == np.int32 and (r.labels >= 0).all()


@pytest.mark.parametrize("method", ["basic", "two_phase", "serial"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_coarsen_digest_matches_reference(name, method):
    r = rt.coarsen(port_graph(name), method=method, backend=CPU)
    _same(r, ref_coarsen(name, method))


@pytest.mark.parametrize("name", ["laplace3d(12)", "uniform(2000,6)"])
def test_two_phase_min_secondary_matches_reference(name):
    r = rt.coarsen(port_graph(name), method="two_phase",
                   min_secondary_neighbors=3, backend=CPU)
    _same(r, ref_coarsen(name, "two_phase", 3))


@pytest.mark.parametrize("method", ["basic", "two_phase"])
def test_dense_inner_engine_gives_same_labels(method):
    r = rt.coarsen(port_graph("elasticity3d(4)"), method=method,
                   mis2_engine="dense", backend=CPU)
    _same(r, ref_coarsen("elasticity3d(4)", method))
    assert r.engine == "dense"


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="aggregation"):
        rt.coarsen(port_graph("laplace3d(8)"), method="no_such_method",
                   backend=CPU)
