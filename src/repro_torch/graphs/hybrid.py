"""Degree-aware hybrid sparse layout: sliced ELL plus a sorted-COO spill
(PyTorch port of ``repro.graphs.hybrid``).

The padded ELL layout pads every row to the max degree; on a power-law
graph at V = 1M one hub row makes that ``[V, max_degree]`` slab ~120 GB
(``Graph.ell`` refuses it with ``LayoutOverflowError``).  This layout
keeps memory O(E):

* rows are sorted into a pow2 width ladder (8, 16, 32, ... up to the spill
  cap); each non-empty bucket becomes one **slice**, a ``[R_i, W_i]`` ELL
  slab padded only to its own width, plus the global ids of its rows;
* rows past the **spill cap** (the hubs) go to a sorted-COO segment
  (``spill_rows`` / ``spill_seg`` / ``spill_cols``) that segment
  reductions consume.

Padded slab slots hold the row's own **global** id with ``mask == False``,
as in ``csr.ELLGraph``, so the closed-neighbourhood MIS-2 reductions never
read the mask.  Every vertex lies in exactly one slice or in the spill.

Host numpy builds the arrays, bit-identical to the JAX package's; then one
copy of each goes to the graph's device.

:data:`HYBRID_AUTO_BYTES` is read at call time by the ``engine=None`` rule
(``api.backend.default_mis2_engine``), so a test can lower it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .csr import CSRGraph

# int32 neighbor id + bool mask byte per ELL slot
ELL_BYTES_PER_SLOT = 5

#: auto-selection threshold: engine=None takes the hybrid layout once the
#: padded-ELL estimate crosses this (256 MiB)
HYBRID_AUTO_BYTES = 256 * 1024 ** 2

#: smallest slice width of the default pow2 ladder
MIN_SLICE_WIDTH = 8


class HybridSlice(NamedTuple):
    """One degree bucket: ``neighbors[j]`` are the (global) neighbors of
    vertex ``rows[j]``; padded slots hold ``rows[j]`` with mask False."""

    rows: torch.Tensor       # int32 [R]   global vertex ids (ascending)
    neighbors: torch.Tensor  # int32 [R, W] global neighbor ids
    mask: torch.Tensor       # bool  [R, W]

    @property
    def num_rows(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def width(self) -> int:
        return int(self.neighbors.shape[1])


class HybridEllGraph(NamedTuple):
    """Sliced-ELL + sorted-COO spill decomposition of one graph."""

    slices: tuple                # tuple[HybridSlice, ...], ascending widths
    spill_rows: torch.Tensor     # int32 [H] heavy vertex ids (ascending)
    spill_seg: torch.Tensor      # int32 [S] index into spill_rows per entry
    spill_cols: torch.Tensor     # int32 [S] neighbor ids (CSR order)
    num_vertices: int
    spill_cap: int               # rows with degree > spill_cap are spilled

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def slice_widths(self) -> tuple:
        return tuple(s.width for s in self.slices)

    @property
    def slice_num_rows(self) -> tuple:
        return tuple(s.num_rows for s in self.slices)

    @property
    def num_spill_rows(self) -> int:
        return int(self.spill_rows.shape[0])

    @property
    def num_spill_entries(self) -> int:
        return int(self.spill_cols.shape[0])

    @property
    def padded_bytes(self) -> int:
        """Bytes the slabs and the spill hold (what the padded monolith is
        compared against)."""
        slab = sum(s.num_rows * s.width for s in self.slices)
        return slab * ELL_BYTES_PER_SLOT + self.num_spill_entries * 2 * 4

    @property
    def padding_ratio(self) -> float:
        """Padded slab slots / real entries (1.0 = no waste); the spill is
        unpadded by construction."""
        padded = sum(s.num_rows * s.width for s in self.slices)
        real = sum(int(s.mask.sum()) for s in self.slices)
        real += self.num_spill_entries
        return (padded + self.num_spill_entries) / max(1, real)

    def to(self, device: torch.device | str) -> "HybridEllGraph":
        """The same layout with every tensor on ``device``."""
        slices = tuple(HybridSlice(*(x.to(device) for x in s))
                       for s in self.slices)
        return self._replace(slices=slices,
                             spill_rows=self.spill_rows.to(device),
                             spill_seg=self.spill_seg.to(device),
                             spill_cols=self.spill_cols.to(device))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def default_spill_cap(degrees: np.ndarray) -> int:
    """The smallest pow2 >= 4x the mean degree (floor
    :data:`MIN_SLICE_WIDTH`); on bounded-degree meshes the spill is
    empty."""
    if len(degrees) == 0:
        return MIN_SLICE_WIDTH
    mean = float(degrees.mean())
    return max(MIN_SLICE_WIDTH, _next_pow2(int(np.ceil(4.0 * max(1.0, mean)))))


def slice_width_ladder(max_slab_degree: int,
                       min_width: int = MIN_SLICE_WIDTH) -> tuple:
    """Pow2 ladder ``min_width, 2*min_width, ...`` covering every non-spill
    degree, the top rung clamped to the actual max slab degree."""
    widths = []
    w = min_width
    while w < max_slab_degree:
        widths.append(w)
        w *= 2
    widths.append(min(w, max(max_slab_degree, min_width)))
    return tuple(widths)


def _build_slab(sel: np.ndarray, deg: np.ndarray, indptr: np.ndarray,
                indices: np.ndarray, width: int):
    """Host ``(rows, neighbors, mask)`` of the selected rows' slab."""
    r = len(sel)
    nbrs = np.repeat(sel.astype(np.int32)[:, None], width, axis=1)
    mask = np.zeros((r, width), dtype=bool)
    dsel = deg[sel].astype(np.int64)
    flat_rows = np.repeat(np.arange(r), dsel)
    slot = np.arange(int(dsel.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(dsel) - dsel, dsel)
    src = np.repeat(indptr[sel].astype(np.int64), dsel) + slot
    nbrs[flat_rows, slot] = indices[src]
    mask[flat_rows, slot] = True
    return sel.astype(np.int32), nbrs, mask


def csr_to_hybrid_ell(g: CSRGraph, widths: Optional[Sequence[int]] = None,
                      spill_cap: Optional[int] = None, *,
                      device: torch.device | str) -> HybridEllGraph:
    """CSR -> hybrid layout on ``device``.

    ``widths`` (ascending) overrides the pow2 ladder; ``spill_cap``
    overrides :func:`default_spill_cap`.  Empty buckets give no slice;
    degree-0 rows ride in the first bucket.
    """
    indptr = np.asarray(g.indptr)
    indices = np.asarray(g.indices)
    v = len(indptr) - 1
    deg = np.diff(indptr)

    if spill_cap is None:
        spill_cap = default_spill_cap(deg)
    spill_cap = int(spill_cap)
    heavy = deg > spill_cap
    max_slab_deg = int(deg[~heavy].max()) if (~heavy).any() else 0

    if widths is None:
        widths = slice_width_ladder(max(max_slab_deg, 1))
    widths = tuple(sorted(int(w) for w in widths))
    if max_slab_deg > widths[-1]:
        raise ValueError(
            f"explicit widths {widths} do not cover max non-spill degree "
            f"{max_slab_deg} (spill_cap={spill_cap})")

    slabs = []
    lo = 0
    for w in widths:
        sel = np.flatnonzero((deg > lo) & (deg <= w) & ~heavy)
        lo = w
        if len(sel):
            slabs.append(_build_slab(sel, deg, indptr, indices, w))
    zero = np.flatnonzero(deg == 0)
    if len(zero):
        slabs.insert(0, _build_slab(zero, deg, indptr, indices, widths[0]))

    hsel = np.flatnonzero(heavy)
    hdeg = deg[hsel].astype(np.int64)
    spill_seg = np.repeat(np.arange(len(hsel), dtype=np.int32), hdeg)
    spill_cols = np.concatenate(
        [indices[indptr[r]:indptr[r + 1]] for r in hsel]) if len(hsel) \
        else np.zeros(0, dtype=np.int32)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return HybridEllGraph(
        tuple(HybridSlice(*(to_dev(a) for a in slab)) for slab in slabs),
        to_dev(hsel.astype(np.int32)), to_dev(spill_seg),
        to_dev(spill_cols.astype(np.int32)), v, spill_cap)
