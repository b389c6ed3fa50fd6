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


# ---------------------------------------------------------------------------
# the coarsening's joins (tests/test_torch_joins_dispatch.py)
# ---------------------------------------------------------------------------

def _star(leaves: int):
    from repro.graphs.csr import csr_from_coo

    hub = np.zeros(leaves, dtype=np.int64)
    tips = np.arange(1, leaves + 1)
    return csr_from_coo(np.concatenate([hub, tips]),
                        np.concatenate([tips, hub]), leaves + 1)


#: the joins' graphs: the hybrid tests' three and a star of 60 leaves (one
#: row of 60 slots; the reference's phase 3 stalls on stars past ~185)
JOIN_GRAPHS = {**HYBRID_GRAPHS, "star60": lambda: _star(60)}


@functools.lru_cache(maxsize=None)
def ref_join_graph(name: str):
    return repro.Graph(JOIN_GRAPHS[name]())


def port_join_graph(name: str, device="cpu") -> Graph:
    csr = ref_join_graph(name).csr
    return Graph.from_reference(csr.indptr, csr.indices, device=device)


@functools.lru_cache(maxsize=None)
def join_inputs(name: str, state: str) -> dict:
    """Numpy inputs of every join on graph ``name``: ``state`` ``coarsening``
    takes the states a two-phase coarsening reaches (the reference's MIS-2
    roots, its phase-1 labels, the second MIS-2's set, its phase-2
    labels), ``seeded`` draws them from a seed (random roots and sets,
    labels a third to nine tenths unlabeled, every other heavy row
    unlabeled)."""
    import jax.numpy as jnp

    from repro.core.aggregation import (
        _join_adjacent_root,
        _phase2_join_resident,
    )

    g = ref_join_graph(name)
    v = g.num_vertices
    if state == "seeded":
        rng = np.random.default_rng(sum(map(ord, name)))
        heavy = np.asarray(g.hybrid().spill_rows)

        def labels(frac):
            lab = np.where(rng.random(v) < frac,
                           rng.integers(0, max(v // 5, 1), v), -1)
            lab[heavy[::2]] = -1
            return lab.astype(np.int32)

        return dict(roots=rng.random(v) < 0.05, labels1=labels(0.6),
                    phase1=rng.integers(0, 3, v).astype(np.uint8),
                    in_set2=rng.random(v) < 0.3, nagg=v // 5,
                    labels2=labels(0.5),
                    phase2=rng.integers(0, 3, v).astype(np.uint8))
    ell = g.ell
    roots = np.asarray(repro.mis2(g, engine="dense").in_set)
    ids = np.cumsum(roots) - 1
    rl = np.where(roots, ids, 2**31 - 1).astype(np.int32)
    labels1 = np.asarray(_join_adjacent_root(ell.neighbors, jnp.asarray(rl)))
    phase1 = (labels1 >= 0).astype(np.uint8)
    in_set2 = np.asarray(repro.mis2(g, active=labels1 < 0,
                                    engine="dense").in_set)
    labels2, _, newly = _phase2_join_resident(
        ell.neighbors, ell.mask, jnp.asarray(labels1), jnp.asarray(in_set2),
        jnp.int32(int(roots.sum())), 2)
    phase2 = np.where(np.asarray(newly), 2, phase1).astype(np.uint8)
    return dict(roots=roots, labels1=labels1, phase1=phase1, in_set2=in_set2,
                nagg=int(roots.sum()), labels2=np.asarray(labels2),
                phase2=phase2)


@functools.lru_cache(maxsize=None)
def ref_join(name: str, layout: str, join: str, state: str,
             min_secondary: int = 2) -> tuple:
    """The reference's jitted join ``join`` (``root``, ``root_cleanup``,
    ``cleanup``, ``phase2``, ``phase3``) over the ``ell`` or ``hybrid``
    layout of graph ``name`` on :func:`join_inputs`, as numpy: labels,
    phase marks (the driver's: 1 / 0 from the root join, 2 where phase 2
    joined) and, for ``phase2``, roots2 and the aggregates after."""
    import jax.numpy as jnp

    from repro.core import aggregation as agg

    g = ref_join_graph(name)
    x = join_inputs(name, state)
    ell = g.ell
    if layout == "ell":
        head, head_mask = (ell.neighbors,), (ell.neighbors, ell.mask)
        root_fn, cleanup_fn = agg._join_adjacent_root, agg._cleanup_join_resident
        phase2_fn, phase3_fn = (agg._phase2_join_resident,
                                agg._phase3_resident)
    else:
        h = g.hybrid()
        head = head_mask = (tuple(h.slices), h.spill_rows, h.spill_seg,
                            h.spill_cols)
        root_fn, cleanup_fn = (agg._hybrid_join_jit,
                               agg._cleanup_join_resident_hybrid)
        phase2_fn, phase3_fn = (agg._phase2_join_resident_hybrid,
                                agg._phase3_resident_hybrid)
    if join in ("root", "root_cleanup"):
        ids = np.cumsum(x["roots"]) - 1
        rl = np.where(x["roots"], ids, 2**31 - 1).astype(np.int32)
        labels = np.asarray(root_fn(*head, jnp.asarray(rl)))
        phase = (labels >= 0).astype(np.uint8)
        if join == "root_cleanup":
            labels, phase = cleanup_fn(*head, jnp.asarray(labels),
                                       jnp.asarray(phase))
        return np.asarray(labels), np.asarray(phase)
    if join == "cleanup":
        out = cleanup_fn(*head, jnp.asarray(x["labels1"]),
                         jnp.asarray(x["phase1"]))
        return tuple(np.asarray(a) for a in out)
    if join == "phase2":
        labels, roots2, newly = phase2_fn(
            *head_mask, jnp.asarray(x["labels1"]), jnp.asarray(x["in_set2"]),
            jnp.int32(x["nagg"]), min_secondary)
        roots2 = np.asarray(roots2)
        return (np.asarray(labels),
                np.where(np.asarray(newly), 2, x["phase1"]).astype(np.uint8),
                roots2, x["nagg"] + int(roots2.sum()))
    if layout == "ell" and ell.neighbors.shape[1] > 64:
        # the reference's ELL phase 3 unrolls D^2 compares, which XLA takes
        # minutes to compile at the power-law graph's D = 199; its hybrid
        # phase 3, which it holds bit-identical to the ELL one
        # (tests/test_hybrid.py), stands in
        return ref_join(name, "hybrid", join, state)
    out = phase3_fn(*head_mask, jnp.asarray(x["labels2"]),
                    jnp.asarray(x["phase2"]))
    return tuple(np.asarray(a) for a in out)
