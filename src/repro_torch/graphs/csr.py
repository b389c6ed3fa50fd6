"""Graph and sparse-matrix containers (PyTorch port of ``repro.graphs.csr``).

Two structural formats:

* ``CSRGraph`` / ``CSRMatrix`` — compressed sparse row, the interchange
  format.  Host-side numpy arrays: construction is setup-time work.
* ``ELLGraph`` / ``ELLMatrix`` — padded ELLPACK on a torch device.  Every
  row is padded to a common width ``D`` so that a kernel reads row ``v`` at
  ``neighbors[v * D : (v + 1) * D]``.

Padding convention: padded ``neighbors`` entries point at the row's own
vertex (self), with ``mask == False``.  The MIS-2 reductions (min / forall /
exists) run over *closed* neighborhoods, so self-padding is inert for them;
operations that must not see padding (coupling counts) consult ``mask``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CSRGraph(NamedTuple):
    """Symmetric graph in CSR form (structure only), host numpy."""

    indptr: np.ndarray   # int32 [V+1]
    indices: np.ndarray  # int32 [E]

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_entries(self) -> int:
        return int(self.indices.shape[0])


class CSRMatrix(NamedTuple):
    """Square sparse matrix in CSR form, host numpy."""

    indptr: np.ndarray   # int32 [V+1]
    indices: np.ndarray  # int32 [E]
    values: np.ndarray   # float32 [E]

    @property
    def num_rows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_entries(self) -> int:
        return int(self.indices.shape[0])

    @property
    def graph(self) -> CSRGraph:
        return CSRGraph(self.indptr, self.indices)


class ELLGraph(NamedTuple):
    """Padded (ELLPACK) graph on a device. ``neighbors[v, j]`` is the j-th
    neighbor of v; padded slots hold ``v`` itself with ``mask`` False."""

    neighbors: torch.Tensor  # int32 [V, D], contiguous
    mask: torch.Tensor       # bool  [V, D]

    @property
    def num_vertices(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def width(self) -> int:
        return int(self.neighbors.shape[1])


class ELLMatrix(NamedTuple):
    """Padded (ELLPACK) matrix on a device; padded slots hold column=row,
    value=0."""

    cols: torch.Tensor   # int32 [V, D]
    vals: torch.Tensor   # float32 [V, D]
    mask: torch.Tensor   # bool  [V, D]

    @property
    def num_rows(self) -> int:
        return int(self.cols.shape[0])

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def graph(self) -> ELLGraph:
        return ELLGraph(self.cols, self.mask)


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, num_vertices: int,
                 vals: np.ndarray | None = None, *,
                 sum_duplicates: bool = True):
    """Build CSR (graph or matrix) from COO triples, deduplicating.

    Entries are ordered by (row, col) with a stable sort, so duplicate
    values are summed in input order — the same order, and therefore the
    same float bits, as ``np.lexsort((cols, rows))``.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.argsort(rows * max(num_vertices, 1) + cols, kind="stable")
    rows, cols = rows[order], cols[order]
    if vals is not None:
        vals = np.asarray(vals)[order]
    if len(rows):
        keep = np.ones(len(rows), dtype=bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        if vals is not None and sum_duplicates:
            seg = np.cumsum(keep) - 1
            vals = np.bincount(seg, weights=vals, minlength=int(keep.sum()))
        elif vals is not None:
            vals = vals[keep]
        rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    if vals is None:
        return CSRGraph(indptr, cols.astype(np.int32))
    return CSRMatrix(indptr, cols.astype(np.int32), vals.astype(np.float32))


def _ell_slots(indptr: np.ndarray, width: int | None):
    """(rows, slot, width) placing each CSR entry in its padded ELL row."""
    v = len(indptr) - 1
    deg = np.diff(indptr)
    d = int(deg.max()) if width is None else int(width)
    if (deg > d).any():
        raise ValueError(f"ELL width {d} < max degree {int(deg.max())}")
    slot = np.arange(int(indptr[-1])) - np.repeat(indptr[:-1], deg)
    rows = np.repeat(np.arange(v), deg)
    return rows, slot, d


def _self_padded(v: int, d: int) -> np.ndarray:
    return np.repeat(np.arange(v, dtype=np.int32)[:, None], d, axis=1)


def csr_to_ell_graph(g: CSRGraph, width: int | None = None, *,
                     device: torch.device | str) -> ELLGraph:
    """CSR -> self-padded ELL on ``device``. ``width`` defaults to the max
    degree (a row longer than ``width`` raises)."""
    v = len(g.indptr) - 1
    rows, slot, d = _ell_slots(g.indptr, width)
    neighbors = _self_padded(v, d)
    mask = np.zeros((v, d), dtype=bool)
    neighbors[rows, slot] = g.indices
    mask[rows, slot] = True
    return ELLGraph(torch.from_numpy(neighbors).to(device),
                    torch.from_numpy(mask).to(device))


def csr_to_ell_arrays(m: CSRMatrix, width: int | None = None):
    """CSR matrix -> self-padded ELL ``(cols, vals, mask)`` as host numpy
    (padded values 0): the host setup reads these, the device gets a copy."""
    v = m.num_rows
    rows, slot, d = _ell_slots(m.indptr, width)
    cols = _self_padded(v, d)
    vals = np.zeros((v, d), dtype=m.values.dtype)
    mask = np.zeros((v, d), dtype=bool)
    cols[rows, slot] = m.indices
    vals[rows, slot] = m.values
    mask[rows, slot] = True
    return cols, vals, mask


def ell_matrix_to(arrays, device: torch.device | str) -> ELLMatrix:
    """Host ``(cols, vals, mask)`` numpy arrays -> ELLMatrix on ``device``."""
    return ELLMatrix(*(torch.from_numpy(np.require(a, requirements="CW"))
                       .to(device) for a in arrays))


def csr_to_ell_matrix(m: CSRMatrix, width: int | None = None, *,
                      device: torch.device | str) -> ELLMatrix:
    """CSR matrix -> self-padded ELL matrix (padded values 0) on ``device``."""
    return ell_matrix_to(csr_to_ell_arrays(m, width), device)


def pad_ell_graph(g: ELLGraph, num_rows: int, width: int) -> ELLGraph:
    """Pad an ELL graph to ``[num_rows, width]`` (both >= current shape) on
    its own device; every new slot points at its row's own vertex with
    ``mask == False``."""
    v, d = g.neighbors.shape
    if num_rows < v or width < d:
        raise ValueError(
            f"pad_ell_graph target [{num_rows}, {width}] smaller than "
            f"current [{v}, {d}]")
    if num_rows == v and width == d:
        return g
    dev = g.neighbors.device
    neighbors = torch.arange(num_rows, dtype=torch.int32, device=dev)[:, None]
    neighbors = neighbors.repeat(1, width)
    mask = torch.zeros((num_rows, width), dtype=torch.bool, device=dev)
    neighbors[:v, :d] = g.neighbors
    mask[:v, :d] = g.mask
    return ELLGraph(neighbors, mask)


def ell_to_csr_graph(g: ELLGraph) -> CSRGraph:
    """Device ELL -> host CSR (the real slots, sorted and deduplicated)."""
    neighbors = g.neighbors.cpu().numpy()
    mask = g.mask.cpu().numpy()
    rows = np.repeat(np.arange(neighbors.shape[0]), mask.sum(axis=1))
    return csr_from_coo(rows, neighbors[mask], neighbors.shape[0])


def ensure_self_loops(g: CSRGraph) -> CSRGraph:
    """Add any missing diagonal entries (closed-neighborhood semantics)."""
    v = g.num_vertices
    rows = np.repeat(np.arange(v), np.diff(g.indptr))
    has_self = np.zeros(v, dtype=bool)
    has_self[rows[rows == g.indices]] = True
    missing = np.flatnonzero(~has_self)
    rows = np.concatenate([rows, missing])
    cols = np.concatenate([g.indices, missing])
    return csr_from_coo(rows.astype(np.int64), cols.astype(np.int64), v)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """The graph plus its transpose (host; sorted, deduplicated)."""
    v = g.num_vertices
    rows = np.repeat(np.arange(v), np.diff(g.indptr))
    return csr_from_coo(np.concatenate([rows, g.indices]),
                        np.concatenate([g.indices, rows]), v)


def degrees(g: CSRGraph) -> np.ndarray:
    """Entries per row (host)."""
    return np.diff(g.indptr)


# ---------------------------------------------------------------------------
# degree-bucketed ELL: one padded block per degree class, so a skewed graph
# does not pay max-degree padding on every row
# ---------------------------------------------------------------------------

class BucketedELL(NamedTuple):
    """``rows[i]`` (int32 vertex ids) and ``graphs[i]`` (their ELL block,
    padding = the row's own id) of degree bucket ``i``, on one device."""

    rows: tuple       # tuple of int32 tensors
    graphs: tuple     # tuple of ELLGraph

    @property
    def num_vertices(self) -> int:
        return int(sum(len(r) for r in self.rows))

    @property
    def padding_ratio(self) -> float:
        """Padded slots / real entries (1.0 = no waste)."""
        padded = sum(g.neighbors.shape[0] * g.width for g in self.graphs)
        real = sum(int(g.mask.sum()) for g in self.graphs)
        return padded / max(1, real)

    def to(self, device: torch.device | str) -> "BucketedELL":
        return BucketedELL(
            tuple(r.to(device) for r in self.rows),
            tuple(ELLGraph(*(x.to(device) for x in g)) for g in self.graphs))


def csr_to_bucketed_ell(g: CSRGraph, boundaries=(8, 32, 128), *,
                        device: torch.device | str) -> BucketedELL:
    """Split the rows into degree buckets (``<= 8``, ``<= 32``, ``<= 128``,
    the rest; rows of degree 0 in none), each padded to its own widest row,
    on ``device``: the JAX package's buckets, built without a row loop."""
    deg = np.diff(g.indptr)
    top = int(deg.max())
    edges = [0] + [b for b in boundaries if b < top] + [top]
    rows_out, graphs_out = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = np.flatnonzero((deg > lo) & (deg <= hi))
        if len(sel) == 0:
            continue
        d = deg[sel]
        width = int(d.max())
        pos = np.repeat(np.arange(len(sel)), d)
        slot = np.arange(len(pos)) - np.repeat(np.cumsum(d) - d, d)
        nbrs = np.repeat(sel.astype(np.int32)[:, None], width, axis=1)
        mask = np.zeros((len(sel), width), dtype=bool)
        nbrs[pos, slot] = g.indices[np.repeat(g.indptr[sel], d) + slot]
        mask[pos, slot] = True
        rows_out.append(torch.from_numpy(sel.astype(np.int32)).to(device))
        graphs_out.append(ELLGraph(torch.from_numpy(nbrs).to(device),
                                   torch.from_numpy(mask).to(device)))
    return BucketedELL(tuple(rows_out), tuple(graphs_out))
