"""The port on a CUDA card: the hand-written kernels against their torch
twins, and the main path against the JAX package's digests (recorded
below, from ``repro.mis2`` / ``repro.coarsen`` with the
``compacted_resident`` engine).  Every test skips without a card.

This file imports neither jax nor ``repro``, so that it runs on a machine
with only torch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.tuples import id_bits
from repro_torch.graphs import generators as gen
from repro_torch.kernels import _build
from repro_torch.kernels.minprop_ell import ops, ref

pytestmark = pytest.mark.gpu

# graph -> (mis2 size, iterations, digest), (aggregates, MIS-2 iterations,
# two_phase digest); the reference's values
ANCHORS = {
    "laplace3d(8)": ((55, 6, "4dfc7dee5f0f7c7f"),
                     (82, 10, "dfda3c0aa9776009")),
    "laplace3d(12)": ((181, 7, "c179301ca5a7f8bf"),
                      (267, 12, "d8f3265623dd5f02")),
    "elasticity3d(4)": ((5, 5, "775ec02a191d8677"),
                        (7, 7, "af316f92f21b9539")),
}
GRAPHS = {
    "laplace3d(8)": lambda: gen.laplace3d(8),
    "laplace3d(12)": lambda: gen.laplace3d(12),
    "elasticity3d(4)": lambda: gen.elasticity3d(4),
}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(graph, device, seed: int):
    ell = rt.Graph(graph, device=device).ell
    v = ell.num_vertices
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    wl = rng.permutation(v).astype(np.int32)      # real rows past count
    wl[rng.random(v) < 0.1] = v                   # sentinels
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(t=to(t.view(np.int32)), m=to(m.view(np.int32)),
                active=to(rng.random(v) < 0.9),
                nbrs_flat=ell.neighbors.reshape(-1), wl=to(wl),
                count=torch.tensor([int(v * 0.6)], dtype=torch.int32,
                                   device=device),
                it=torch.tensor([3], dtype=torch.int32, device=device))


@pytest.mark.parametrize("priority", ["xorshift_star", "xorshift", "fixed"])
@pytest.mark.parametrize("name", ["laplace3d(12)", "elasticity3d(4)"])
def test_kernels_match_twins(cuda_device, name, priority):
    x = _state(GRAPHS[name](), cuda_device, seed=len(priority))
    y = {k: v.clone() for k, v in x.items()}
    kw = dict(priority=priority, b=id_bits(x["t"].shape[0]))
    before = dict(ops.LAUNCHES)
    ops.fused_refresh_columns(x["t"], x["m"], x["nbrs_flat"], x["wl"],
                              x["count"], x["it"], **kw)
    ref.fused_refresh_columns_ref(y["t"], y["m"], y["nbrs_flat"], y["wl"],
                                  y["count"], y["it"], **kw)
    ops.fused_decide(x["t"], x["m"], x["active"], x["nbrs_flat"], x["wl"],
                     x["count"], x["it"], **kw)
    ref.fused_decide_ref(y["t"], y["m"], y["active"], y["nbrs_flat"],
                         y["wl"], y["count"], y["it"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(x["m"], y["m"]) and torch.equal(x["t"], y["t"])
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 1, "fused_decide": 1}


def test_wrapper_on_cuda_raises_instead_of_falling_back(cuda_device):
    x = _state(GRAPHS["laplace3d(8)"](), cuda_device, seed=0)
    with pytest.raises(ValueError, match="is on"):
        ops.fused_refresh_columns(x["t"], x["m"].cpu(), x["nbrs_flat"],
                                  x["wl"], x["count"], x["it"],
                                  priority="fixed", b=10)
    with pytest.raises(TypeError):
        ops.fused_decide(x["t"], x["m"], x["active"].to(torch.uint8),
                         x["nbrs_flat"], x["wl"], x["count"], x["it"],
                         priority="fixed", b=10)


def test_build_is_cached_by_source_hash(cuda_device):
    first = _build.build_all()
    assert first == _build.build_all()
    assert all(p.is_file() for p in first.values())


@pytest.mark.parametrize("name", list(ANCHORS))
def test_main_path_matches_reference_digests(cuda_device, name):
    (size, iters, digest), (nagg, agg_iters, agg_digest) = ANCHORS[name]
    g = rt.Graph(GRAPHS[name]())
    before = dict(ops.LAUNCHES)
    r = rt.mis2(g)
    assert (r.engine, r.size, r.iterations, r.digest) == (
        "cuda_resident", size, iters, digest)
    assert all(ops.LAUNCHES[k] - before[k] == iters for k in before)
    assert rt.mis2(g, engine="dense").digest == digest
    a = rt.coarsen(g, method="two_phase")
    assert (a.num_aggregates, a.iterations, a.digest) == (
        nagg, agg_iters, agg_digest)
    assert rt.coarsen(g, method="basic").digest == rt.coarsen(
        g, method="basic", backend=rt.Backend(device="cpu")).digest
