"""Graph / matrix generators (numpy only), bit-identical to
``repro.graphs.generators``.

* ``laplace3d``     — Galeri-style 7-point Poisson matrix (diag 6,
  offdiag -1), self loops included.
* ``elasticity3d``  — 27-point stencil with ``dof`` dofs per grid point
  (81 entries per interior row at dof=3); values are a diagonally dominant
  SPD surrogate.
* ``random_uniform_graph`` / ``random_skewed_graph`` / ``path_graph`` —
  the random and toy graphs of the test and benchmark suites;
  ``er_laplacian`` — the Laplacian (+I) of such a random graph.
* ``powerlaw_graph`` — the Chung-Lu power-law graph whose hub rows make
  the monolithic padded ELL infeasible at V = 1M (the hybrid layout's
  case).

Every generator draws from ``np.random.default_rng(seed)`` and goes through
:func:`csr_from_coo`, so equal arguments give equal CSR bytes — and equal
``Graph.digest`` — in both packages.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, CSRMatrix, csr_from_coo


def _grid_offsets_7pt():
    return [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]


def _grid_offsets_27pt():
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if not (dx == dy == dz == 0)]


def _stencil_coo(nx: int, ny: int, nz: int, offsets):
    """COO (row, col) pairs for a structured grid stencil (no diagonal)."""
    ids = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    rows_list, cols_list = [], []
    for dx, dy, dz in offsets:
        sx = slice(max(0, -dx), nx - max(0, dx))
        sy = slice(max(0, -dy), ny - max(0, dy))
        sz = slice(max(0, -dz), nz - max(0, dz))
        tx = slice(max(0, dx), nx - max(0, -dx))
        ty = slice(max(0, dy), ny - max(0, -dy))
        tz = slice(max(0, dz), nz - max(0, -dz))
        rows_list.append(ids[sx, sy, sz].ravel())
        cols_list.append(ids[tx, ty, tz].ravel())
    return np.concatenate(rows_list), np.concatenate(cols_list)


def laplace3d(nx: int, ny: int | None = None,
              nz: int | None = None) -> CSRMatrix:
    """Galeri-style Laplace3D: 7-point stencil, diag 6, offdiag -1."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    v = nx * ny * nz
    rows, cols = _stencil_coo(nx, ny, nz, _grid_offsets_7pt())
    vals = np.full(len(rows), -1.0)
    diag = np.arange(v, dtype=np.int64)
    rows = np.concatenate([rows, diag])
    cols = np.concatenate([cols, diag])
    vals = np.concatenate([vals, np.full(v, 6.0)])
    return csr_from_coo(rows, cols, v, vals)


def elasticity3d(nx: int, ny: int | None = None, nz: int | None = None,
                 dof: int = 3) -> CSRMatrix:
    """Elasticity3D structure: 27-point stencil, ``dof`` dofs per point,
    diagonally dominant SPD surrogate values."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    npts = nx * ny * nz
    prow, pcol = _stencil_coo(nx, ny, nz, _grid_offsets_27pt())
    d = dof
    # block expansion: point p adjacent to q -> dof x dof dense block
    pr = np.repeat(prow * d, d * d) + np.tile(np.repeat(np.arange(d), d), len(prow))
    pc = np.repeat(pcol * d, d * d) + np.tile(np.tile(np.arange(d), d), len(prow))
    diagp = np.arange(npts, dtype=np.int64)
    dr = np.repeat(diagp * d, d * d) + np.tile(np.repeat(np.arange(d), d), npts)
    dc = np.repeat(diagp * d, d * d) + np.tile(np.tile(np.arange(d), d), npts)
    rows = np.concatenate([pr, dr])
    cols = np.concatenate([pc, dc])
    vals = np.full(len(rows), -1.0)
    vals[len(pr):] = -0.25            # weaker intra-block coupling
    vals[len(pr):][dr == dc] = 0.0    # placeholder; set below
    m =csr_from_coo(rows, cols, npts * d, vals)
    # diagonally dominant SPD: diag = sum |offdiag| + 1
    values = m.values.copy()
    r = np.repeat(np.arange(npts * d), np.diff(m.indptr))
    offd = r != m.indices
    rowsum = np.zeros(npts * d)
    np.add.at(rowsum, r[offd], np.abs(values[offd]))
    values[~offd] = rowsum[r[~offd]] + 1.0
    return CSRMatrix(m.indptr, m.indices, values.astype(np.float32))


def _symmetric(rows, cols, num_vertices: int, with_self_loops: bool):
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    all_rows = np.concatenate([rows, cols])
    all_cols = np.concatenate([cols, rows])
    if with_self_loops:
        diag = np.arange(num_vertices, dtype=np.int64)
        all_rows = np.concatenate([all_rows, diag])
        all_cols = np.concatenate([all_cols, diag])
    return csr_from_coo(all_rows, all_cols, num_vertices)


def random_uniform_graph(num_vertices: int, avg_degree: float, seed: int = 0,
                         with_self_loops: bool = True) -> CSRGraph:
    """Erdos-Renyi-ish symmetric graph with ~avg_degree neighbors/vertex."""
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree / 2)
    rows = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    cols = rng.integers(0, num_vertices, size=m, dtype=np.int64)
    return _symmetric(rows, cols, num_vertices, with_self_loops)


def er_laplacian(num_vertices: int, avg_degree: float,
                 seed: int = 0) -> CSRMatrix:
    """Graph Laplacian (+I, so it is SPD with a full diagonal) of an
    Erdos-Renyi graph: the random *matrix* companion of
    :func:`random_uniform_graph` (host, scipy, float32 values)."""
    import scipy.sparse as sp

    g = random_uniform_graph(num_vertices, avg_degree, seed=seed,
                             with_self_loops=False)
    off = sp.csr_matrix((np.ones(len(g.indices)), g.indices, g.indptr),
                        shape=(num_vertices, num_vertices))
    lap = sp.diags(np.asarray(off.sum(axis=1)).ravel() + 1.0) - off
    lap = lap.tocsr()
    lap.sort_indices()
    return CSRMatrix(lap.indptr.astype(np.int32),
                     lap.indices.astype(np.int32),
                     lap.data.astype(np.float32))


def random_skewed_graph(num_vertices: int, avg_degree: float, seed: int = 0,
                        alpha: float = 1.5,
                        with_self_loops: bool = True) -> CSRGraph:
    """Preferential-style skewed-degree graph (stress for ELL padding)."""
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree / 2)
    u = rng.random(size=2 * m)
    end = ((num_vertices ** (1 - alpha) - 1) * u + 1) ** (1 / (1 - alpha))
    end = np.minimum(num_vertices - 1, end.astype(np.int64))
    perm = rng.permutation(num_vertices)
    return _symmetric(perm[end[:m]], perm[end[m:]], num_vertices,
                      with_self_loops)


def powerlaw_graph(num_vertices: int, avg_degree: float = 8.0,
                   exponent: float = 2.5, seed: int = 0,
                   with_self_loops: bool = True) -> CSRGraph:
    """Deterministic Chung-Lu power-law graph (degree exponent ``exponent``).

    Endpoints of ``V * avg_degree / 2`` undirected edges are drawn i.i.d.
    with probability proportional to ``w_i = (i + 1)^(-1/(exponent - 1))``:
    the expected degree distribution is ``P(deg = k) ~ k^-exponent``, with a
    hub of expected degree ``~ V^(1/(exponent-1)) * avg_degree``.  At
    V = 1M, exponent 2.5, that hub makes the ``[V, max_degree]`` padded ELL
    ~120 GB while the edge count stays ~9M.
    """
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree / 2)
    w = (np.arange(1, num_vertices + 1, dtype=np.float64)
         ** (-1.0 / (exponent - 1.0)))
    p = w / w.sum()
    ends = rng.choice(num_vertices, size=2 * m, p=p)
    return _symmetric(ends[:m], ends[m:], num_vertices, with_self_loops)


def path_graph(num_vertices: int) -> CSRGraph:
    r = np.arange(num_vertices - 1, dtype=np.int64)
    diag = np.arange(num_vertices, dtype=np.int64)
    rows = np.concatenate([r, r + 1, diag])
    cols = np.concatenate([r + 1, r, diag])
    return csr_from_coo(rows, cols, num_vertices)


def paper_suite(scale: str = "small"):
    """Named graph suite: 'small' for tests/benches, 'paper' for the paper's
    Table III generated problems."""
    if scale == "small":
        return {
            "laplace3d_16": laplace3d(16).graph,
            "elasticity3d_8": elasticity3d(8).graph,
            "uniform_50k": random_uniform_graph(50_000, 8.0, seed=1),
            "skewed_50k": random_skewed_graph(50_000, 8.0, seed=2),
        }
    if scale == "paper":
        return {
            "Laplace3D_100": laplace3d(100).graph,
            "Elasticity3D_60": elasticity3d(60).graph,
        }
    raise ValueError(scale)
