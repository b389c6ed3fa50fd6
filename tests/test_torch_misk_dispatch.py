"""The distance-k MIS fixed point of the port as one call
(``kernels.misk.ops.misk_fixed_point``, one cooperative launch on the card)
against the JAX package's jitted loops ``_misk_fixpoint`` (engine
``dense``) and ``_misk_resident_fixpoint`` (engine ``resident``), on the
CPU, where the call runs the engine's plain-torch twin: T bitwise (the
stored int32 words read as uint32), the rounds run, the live count and
``converged``, for k = 1, 2, 3, capped at 1 and 2 rounds and uncapped, on
the graphs of the reference's hybrid tests.  Also the wrapper's argument
checks and the facade's ``host_syncs`` on the CPU (the twin's live reads).
The kernel itself is held against the twin on the card in
``test_torch_cuda.py``."""
from __future__ import annotations

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels.misk import ops

from _torch_common import CPU, HYBRID_GRAPHS, port_hybrid_graph, \
    ref_hybrid_graph

# the module (``repro.core`` exports a function of its name)
ref_misk = importlib.import_module("repro.core.misk")

UNCAPPED = 256
CAPS = [1, 2, UNCAPPED]


@functools.lru_cache(maxsize=None)
def reference(name: str, k: int, max_iters: int, engine: str):
    """``(T uint32, rounds, live count)`` of the reference's loop."""
    nb = ref_hybrid_graph(name).ell.neighbors
    if engine == "dense":
        t, it = ref_misk._misk_fixpoint(nb, k, "xorshift_star", max_iters)
        t = np.asarray(t)
        n = int(((t != 0) & (t != np.uint32(0xFFFFFFFF))).sum())
    else:
        t, it, n = jax.block_until_ready(ref_misk._misk_resident_fixpoint(
            nb, k, "xorshift_star", max_iters))
        t, n = np.asarray(t), int(n)
    return t, int(it), n


def _cases():
    """Every graph, k and cap on the ``dense`` reference; the ``resident``
    one (bit-identical) capped at 2 and uncapped."""
    for name in HYBRID_GRAPHS:
        for k in (1, 2, 3):
            for cap in CAPS:
                for engine in ("dense", "resident"):
                    if engine == "dense" or cap != 1:
                        yield name, k, cap, engine


@pytest.mark.parametrize("name,k,max_iters,engine", list(_cases()))
def test_misk_twin_matches_reference_loop(name, k, max_iters, engine):
    t_ref, it_ref, n_ref = reference(name, k, max_iters, engine)
    nb = port_hybrid_graph(name).ell.neighbors
    t, stats = ops.misk_fixed_point(nb, k=k, priority="xorshift_star",
                                    max_iters=max_iters,
                                    dense=engine == "dense")
    assert t.dtype == torch.int32 and stats.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), t_ref)
    assert stats.tolist() == [it_ref, n_ref]
    if max_iters == UNCAPPED:
        assert n_ref == 0


@pytest.mark.parametrize("engine", ["dense", "resident"])
@pytest.mark.parametrize("max_iters", CAPS)
def test_misk_facade_counts_the_twins_reads(engine, max_iters):
    """``host_syncs`` on the CPU: the twin reads the live count before each
    round and once more unless the cap stopped it; a ``resident`` solve
    counts one dispatch."""
    g = port_hybrid_graph("er_random")
    t_ref, it_ref, n_ref = reference("er_random", 2, max_iters, "dense")
    with rt.obs.capture() as cap:
        r = rt.misk(g, k=2, max_iters=max_iters, engine=engine, backend=CPU)
    assert (r.iterations, r.converged) == (it_ref, n_ref == 0)
    np.testing.assert_array_equal(r.in_set, t_ref == 0)
    assert r.host_syncs == min(it_ref + 1, max_iters)
    assert cap.value("mis2.host_syncs") == r.host_syncs
    assert cap.value("mis2.resident_dispatches") == (engine == "resident")


def _ell():
    return port_hybrid_graph("laplace3d").ell.neighbors


@pytest.mark.parametrize("bad,exc,match", [
    (dict(neighbors=lambda: _ell().long()), TypeError, "int32"),
    (dict(neighbors=lambda: _ell().reshape(-1)), ValueError, r"\[V, D\]"),
    (dict(neighbors=lambda: _ell()[:, :0]), ValueError, r"\[V, D\]"),
    (dict(neighbors=lambda: _ell().t()), ValueError, "contiguous"),
    (dict(k=0), ValueError, "k >= 1"),
    (dict(max_iters=-1), ValueError, "negative"),
    (dict(priority="nope"), ValueError, "unknown priority"),
])
def test_misk_fixed_point_checks_its_arguments(bad, exc, match):
    args = dict(neighbors=_ell, k=2, priority="xorshift_star", max_iters=8)
    args.update(bad)
    nb = args.pop("neighbors")()
    with pytest.raises(exc, match=match):
        ops.misk_fixed_point(nb, **args)
