"""Shared helpers of the ``tests/test_torch_*.py`` files that compare the
port with the JAX package: the CPU backend and reference runs cached per
graph."""
from __future__ import annotations

import functools

import numpy as np

import repro
from repro.graphs import generators as ref_gen
from repro_torch import Backend, Graph
from repro_torch.graphs import generators as port_gen

CPU = Backend(device="cpu")

#: small graphs of the parity matrix: name -> generator call
GRAPHS = {
    "laplace3d(8)": ("laplace3d", (8,), {}),
    "laplace3d(12)": ("laplace3d", (12,), {}),
    "elasticity3d(4)": ("elasticity3d", (4,), {}),
    "uniform(2000,6)": ("random_uniform_graph", (2000, 6.0), {"seed": 7}),
}


#: further graphs of the multilevel and solver tests (not in the matrix)
_MORE = {"laplace3d(16)": ("laplace3d", (16,), {}),
         "laplace3d(4)": ("laplace3d", (4,), {})}


@functools.lru_cache(maxsize=None)
def ref_graph(name: str):
    fn, args, kw = {**GRAPHS, **_MORE}[name]
    return repro.Graph(getattr(ref_gen, fn)(*args, **kw))


def port_graph(name: str, device="cpu") -> Graph:
    fn, args, kw = {**GRAPHS, **_MORE}[name]
    return Graph(getattr(port_gen, fn)(*args, **kw), device=device)


@functools.lru_cache(maxsize=None)
def ref_mis2(name: str, priority: str = "xorshift_star", max_iters: int = 128,
             active_seed: int | None = None):
    opts = repro.Mis2Options(priority=priority, max_iters=max_iters)
    g = ref_graph(name)
    return repro.mis2(g, active=active_mask(name, active_seed), options=opts,
                      engine="compacted_resident")


@functools.lru_cache(maxsize=None)
def ref_coarsen(name: str, method: str, min_secondary: int = 2):
    kw = {} if method == "serial" else {"mis2_engine": "compacted_resident"}
    return repro.coarsen(ref_graph(name), method=method,
                         min_secondary_neighbors=min_secondary, **kw)


def active_mask(name: str, seed: int | None):
    if seed is None:
        return None
    v = ref_graph(name).num_vertices
    return np.random.default_rng(seed).random(v) < 0.7


@functools.lru_cache(maxsize=None)
def ref_amg(name: str, explicit_restriction: bool = True,
            coarse_dtype: str = "float32", coarse_size: int = 200):
    """The reference's ``host`` multilevel engine (the ``resident`` one
    cannot run on this JAX version)."""
    return repro.amg_setup(ref_graph(name), engine="host",
                           mis2_engine="compacted_resident",
                           explicit_restriction=explicit_restriction,
                           coarse_dtype=coarse_dtype,
                           coarse_size=coarse_size)


def ref_level_arrays(setup) -> list:
    """A reference hierarchy's per-level arrays, as numpy, in the form
    ``repro_torch.multilevel.hierarchy_from_arrays`` takes."""
    out = []
    for lvl in setup.hierarchy.levels:
        d = dict(a=tuple(np.asarray(x) for x in lvl.a_ell),
                 diag=np.asarray(lvl.diag), n=lvl.n, nnz=lvl.nnz)
        for key, m in (("p", lvl.p_ell), ("r", lvl.r_ell)):
            if m is not None:
                d[key] = tuple(np.asarray(x) for x in m)
        out.append(d)
    return out


def rhs(n: int, seed: int = 0) -> np.ndarray:
    """The right-hand side of the solver anchors: standard normal, f32."""
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


#: the graphs of the hybrid-layout tests (the reference's
#: ``tests/test_hybrid.py`` cases), structure only
HYBRID_GRAPHS = {
    "laplace3d": lambda: ref_gen.laplace3d(8).graph,
    "er_random": lambda: ref_gen.random_uniform_graph(600, 5.0, seed=21),
    "powerlaw": lambda: ref_gen.powerlaw_graph(900, 8.0, seed=4),
}


@functools.lru_cache(maxsize=None)
def ref_hybrid_graph(name: str):
    return repro.Graph(HYBRID_GRAPHS[name]())


def port_hybrid_graph(name: str, device="cpu") -> Graph:
    """The port's graph of the same CSR (equal ``digest``)."""
    csr = ref_hybrid_graph(name).csr
    return Graph.from_reference(csr.indptr, csr.indices, device=device)


@functools.lru_cache(maxsize=None)
def ref_hybrid_mis2(name: str, priority: str = "xorshift_star",
                    active: str | None = None):
    """The reference's ``pallas_hybrid`` (Pallas in interpret mode);
    ``active`` is None, ``"random"`` or ``"none"``."""
    return repro.mis2(ref_hybrid_graph(name), engine="pallas_hybrid",
                      active=hybrid_active(name, active),
                      options=repro.Mis2Options(priority=priority))


def hybrid_active(name: str, kind: str | None):
    if kind is None:
        return None
    v = ref_hybrid_graph(name).num_vertices
    if kind == "none":
        return np.zeros(v, dtype=bool)
    return np.random.default_rng(2).random(v) < 0.6


@functools.lru_cache(maxsize=None)
def ref_hybrid_coarsen(name: str, method: str):
    return repro.coarsen(ref_hybrid_graph(name), method=method,
                         mis2_engine="pallas_hybrid")


@functools.lru_cache(maxsize=None)
def ref_hybrid_color(name: str):
    return repro.color(ref_hybrid_graph(name), engine="luby_hybrid")


@functools.lru_cache(maxsize=None)
def ref_ablation(name: str, entry: str, priority: str | None = None,
                 active_seed: int | None = None, engine: str = "compacted",
                 **replace):
    """The reference's host-driven ``compacted`` driver (or ``engine``) on
    an ``ABLATION_CHAIN`` entry, ``priority`` and further fields replaced;
    returns ``(Mis2Result, host syncs counted by the reference)``."""
    import dataclasses

    from repro.core.mis2 import ABLATION_CHAIN, HOTLOOP_STATS

    opts = ABLATION_CHAIN[entry]
    if priority is not None:
        replace["priority"] = priority
    opts = dataclasses.replace(opts, **replace)
    before = HOTLOOP_STATS.host_syncs
    r = repro.mis2(ref_graph(name), active=active_mask(name, active_seed),
                   options=opts, engine=engine)
    return r, HOTLOOP_STATS.host_syncs - before


@functools.lru_cache(maxsize=None)
def ref_misk(name: str, k: int, engine: str = "dense",
             priority: str = "xorshift_star", max_iters: int = 256):
    return repro.misk(ref_graph(name), k=k, engine=engine, priority=priority,
                      max_iters=max_iters)


#: the partitions of the parity matrix: (graph, parts, coarse_target); the
#: facade's where its compiles are cheap, else the reference's core with
#: its digest-equal compacted_resident inner engine (one compile a shape)
PARTITIONS = {
    "laplace3d(8)/4": ("laplace3d(8)", 4, None, "facade"),
    "laplace3d(8)/8": ("laplace3d(8)", 8, None, "facade"),
    "laplace3d(12)/8": ("laplace3d(12)", 8, None, "core"),
    "laplace3d(12)/4/target50": ("laplace3d(12)", 4, 50, "core"),
    "elasticity3d(4)/4/target20": ("elasticity3d(4)", 4, 20, "core"),
    "elasticity3d(4)/3": ("elasticity3d(4)", 3, None, "facade"),
    "uniform(2000,6)/4": ("uniform(2000,6)", 4, None, "core"),
}


@functools.lru_cache(maxsize=None)
def ref_partition(case: str):
    """``(parts digest, edge_cut, levels, history, converged)`` of the
    reference on a ``PARTITIONS`` case."""
    from repro.api.result import determinism_digest
    from repro.core.partition import _partition_impl

    name, parts, target, how = PARTITIONS[case]
    if how == "facade":
        r = repro.partition(ref_graph(name), parts, coarse_target=target)
        return r.digest, r.edge_cut, r.levels, r.history, r.converged
    r = _partition_impl(ref_graph(name), parts, target,
                        engine="compacted_resident")
    return (determinism_digest(r.parts), r.edge_cut, r.levels, r.history,
            r.converged)
