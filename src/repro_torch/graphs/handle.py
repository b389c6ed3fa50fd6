"""The ``Graph`` handle: one object, every structural format, computed once
(PyTorch port of ``repro.graphs.handle``).

The CSR form stays on the host as numpy; the ELL forms and the hybrid
layout are built from it lazily, once, on the handle's device
(``Graph.place``) and cached.  A handle may also start from a device
``ELLGraph`` / ``ELLMatrix`` (each coarse level of the ``resident``
multilevel setup is one): its sizes then come from the ELL's shape and
mask on the device, and the host CSR is built only when asked for
(``ell_to_csr``).
``graph.conversions`` counts the times each conversion's work actually ran,
so a second ``.ell`` access is visibly a cache hit, and
``graph.conversion_timings`` sums the host seconds each kind took (no
device synchronize: a conversion that ends in an asynchronous copy is timed
to its enqueue).

``Graph.digest`` hashes the CSR bytes exactly as the JAX package does
(numpy dtype names, shapes, raw bytes), so a graph and its reference twin
share a digest.
"""
from __future__ import annotations

import hashlib
import time
from contextlib import contextmanager
from typing import Any, Iterable

import numpy as np
import torch

from ..obs import metrics as _obs
from .csr import (
    BucketedELL,
    CSRGraph,
    CSRMatrix,
    ELLGraph,
    ELLMatrix,
    csr_from_coo,
    csr_to_bucketed_ell,
    csr_to_ell_graph,
    csr_to_ell_matrix,
    ell_to_csr_graph,
    pad_ell_graph,
)
from .hybrid import ELL_BYTES_PER_SLOT, HybridEllGraph, csr_to_hybrid_ell

#: hard allocation cap for the monolithic padded-ELL formats (2 GiB)
ELL_BYTE_LIMIT = 2 * 1024 ** 3


class LayoutOverflowError(MemoryError):
    """A monolithic padded-ELL materialization was refused *before*
    allocation: the ``[V, max_degree]`` bytes estimate exceeds the limit."""

    def __init__(self, estimate: int, limit: int, v: int, max_degree: int):
        self.estimate = int(estimate)
        self.limit = int(limit)
        super().__init__(
            f"padded ELL [{v} x {max_degree}] needs ~{estimate:,} bytes "
            f"(> limit {limit:,}): the max-degree padding of a skewed graph "
            f"blows out memory before the solve starts. Use the hybrid "
            f"layout instead (engine='cuda_hybrid' / Graph.hybrid(): sliced "
            f"ELL + COO spill, O(E) memory), or raise "
            f"repro_torch.graphs.handle.ELL_BYTE_LIMIT if the allocation is "
            f"intentional.")


#: cache entries of an ELL-seeded handle that hold a scalar, not a format
_SCALAR_KEYS = ("num_entries", "max_degree")


def _default_device() -> torch.device | str:
    """The default backend's device, ``cuda`` where it names none."""
    from ..api.backend import get_default_backend

    device = get_default_backend().device
    return "cuda" if device is None else device


def ell_bytes_estimate(num_rows: int, width: int) -> int:
    """Bytes a monolithic padded-ELL graph would allocate."""
    return int(num_rows) * int(width) * ELL_BYTES_PER_SLOT


class Graph:
    """Cached-format handle around one immutable graph (or square matrix).

    ``Graph(structure, device=...)`` with a host ``CSRGraph`` /
    ``CSRMatrix`` (the device defaults to the default backend's:
    ``cuda``, unless ``api.set_default_backend`` installed one with a
    device) or a device
    ``ELLGraph`` / ``ELLMatrix`` (the device defaults to its tensors').
    ``g.csr`` / ``g.csr_matrix`` are host numpy, ``g.ell`` /
    ``g.ell_matrix`` / ``g.padded_ell(rows, width)`` / ``g.bucketed()`` /
    ``g.hybrid()`` are tensors on ``g.device``.
    """

    def __init__(self, structure, device: torch.device | str | None = None):
        if isinstance(structure, Graph):
            raise TypeError("Graph(Graph) — use the handle itself, or "
                            "as_graph()")
        if not isinstance(structure, (CSRGraph, CSRMatrix, ELLGraph,
                                      ELLMatrix)):
            raise TypeError(f"Graph() expects CSRGraph/CSRMatrix/ELLGraph/"
                            f"ELLMatrix, got {type(structure).__name__}")
        self._cache: dict[str, Any] = {}
        self._counts: dict[str, int] = {}
        self._timings: dict[str, float] = {}
        if isinstance(structure, CSRMatrix):
            self._cache["csr_matrix"] = structure
            self._cache["csr"] = structure.graph
        elif isinstance(structure, CSRGraph):
            self._cache["csr"] = structure
        elif isinstance(structure, ELLMatrix):
            self._cache["ell_matrix"] = structure
            self._cache["ell"] = structure.graph
        else:
            self._cache["ell"] = structure
        if "ell" in self._cache:
            self._device = self._cache["ell"].neighbors.device
            if device is not None:
                self.place(device)
        else:
            self._device = torch.device(_default_device() if device is None
                                        else device)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, num_vertices: int, vals=None,
                 device: torch.device | str | None = None) -> "Graph":
        """A graph (``vals`` None) or matrix from COO triples, sorted and
        deduplicated (duplicate values summed) by ``csr_from_coo``."""
        return cls(csr_from_coo(np.asarray(rows), np.asarray(cols),
                                num_vertices, vals), device)

    @classmethod
    def from_reference(cls, indptr, indices, values=None,
                       device: torch.device | str | None = None) -> "Graph":
        """A port graph from the JAX package's CSR arrays (as numpy): the
        same structure, the same values and the same ``digest``."""
        indptr = np.ascontiguousarray(np.asarray(indptr), dtype=np.int32)
        indices = np.ascontiguousarray(np.asarray(indices), dtype=np.int32)
        if values is None:
            return cls(CSRGraph(indptr, indices), device)
        values = np.ascontiguousarray(np.asarray(values), dtype=np.float32)
        return cls(CSRMatrix(indptr, indices, values), device)

    # -- device placement ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    def place(self, device: torch.device | str) -> "Graph":
        """Move the cached device formats to ``device`` (in place); later
        conversions build there."""
        device = torch.device(device)
        if device != self._device:
            for key, val in self._cache.items():
                if isinstance(val, (ELLGraph, ELLMatrix)):
                    self._cache[key] = type(val)(*(x.to(device) for x in val))
                elif isinstance(val, (HybridEllGraph, BucketedELL)):
                    self._cache[key] = val.to(device)
                elif key == "csr_edges":
                    self._cache[key] = tuple(x.to(device) for x in val)
            self._device = device
        return self

    # -- cache plumbing -----------------------------------------------------

    @contextmanager
    def _convert(self, name: str):
        """Count and time one conversion's work, on the handle and in the
        ``repro_torch.obs`` registry as ``graph.conversions{kind}`` /
        ``graph.conversion_seconds{kind}`` (a conversion that raises is not
        counted).  Callers read the formats it needs (``self.csr``,
        ``self.ell``) before entering, so a nested conversion is counted and
        timed under its own kind."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._counts[name] = self._counts.get(name, 0) + 1
        self._timings[name] = self._timings.get(name, 0.0) + dt
        _obs.counter("graph.conversions", labels={"kind": name}).inc()
        _obs.histogram("graph.conversion_seconds",
                       labels={"kind": name}).observe(dt)

    @property
    def conversions(self) -> dict[str, int]:
        """Times each conversion's work actually ran (cache hits excluded)."""
        return dict(self._counts)

    @property
    def conversion_timings(self) -> dict[str, float]:
        """Host seconds spent per conversion kind (this handle)."""
        return dict(self._timings)

    # -- structural formats -------------------------------------------------

    @property
    def has_values(self) -> bool:
        return "csr_matrix" in self._cache or "ell_matrix" in self._cache

    @property
    def csr(self) -> CSRGraph:
        if "csr" not in self._cache:       # ELL-seeded: one host copy
            with self._convert("ell_to_csr"):
                self._cache["csr"] = ell_to_csr_graph(self._cache["ell"])
        return self._cache["csr"]

    @property
    def csr_matrix(self) -> CSRMatrix:
        if "csr_matrix" not in self._cache:
            if "ell_matrix" in self._cache:
                raise ValueError("this Graph holds its values as a device "
                                 "ELLMatrix, not as host CSR")
            raise ValueError("this Graph carries structure only (no values)")
        return self._cache["csr_matrix"]

    @property
    def ell(self) -> ELLGraph:
        if "ell" not in self._cache:
            csr = self.csr
            self._check_ell_budget(self.num_vertices, self.max_degree)
            with self._convert("csr_to_ell"):
                self._cache["ell"] = csr_to_ell_graph(csr,
                                                      device=self._device)
        return self._cache["ell"]

    @property
    def ell_matrix(self) -> ELLMatrix:
        if "ell_matrix" not in self._cache:
            csr_matrix = self.csr_matrix
            self._check_ell_budget(self.num_vertices, self.max_degree)
            with self._convert("csr_to_ell_matrix"):
                self._cache["ell_matrix"] = csr_to_ell_matrix(
                    csr_matrix, device=self._device)
        return self._cache["ell_matrix"]

    @property
    def csr_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """COO edge list ``(edge_rows, edge_cols)``, int32 tensors on the
        handle's device, one entry per CSR entry in CSR order: the
        ``csr_segment`` layout of the segment-reduction MIS-2 steps."""
        if "csr_edges" not in self._cache:
            csr = self.csr
            with self._convert("csr_edges"):
                rows = np.repeat(np.arange(csr.num_vertices, dtype=np.int32),
                                 np.diff(csr.indptr))
                self._cache["csr_edges"] = (
                    torch.from_numpy(rows).to(self._device),
                    torch.from_numpy(np.array(csr.indices,
                                              dtype=np.int32)).to(
                        self._device))
        return self._cache["csr_edges"]

    def padded_ell(self, num_rows: int, width: int) -> ELLGraph:
        """``.ell`` padded to ``[num_rows, width]`` (self slots, mask off)
        on the handle's device, cached per shape; the target's bytes are
        checked against ``ELL_BYTE_LIMIT`` before anything is built."""
        key = f"padded_ell({num_rows},{width})"
        if key not in self._cache:
            self._check_ell_budget(num_rows, width)
            ell = self.ell
            with self._convert("pad_ell"):
                self._cache[key] = pad_ell_graph(ell, num_rows, width)
        return self._cache[key]

    @staticmethod
    def _check_ell_budget(num_rows: int, width: int) -> None:
        """Refuse a padded-ELL materialization whose bytes estimate exceeds
        ``ELL_BYTE_LIMIT`` before allocating anything."""
        est = ell_bytes_estimate(num_rows, width)
        if est > ELL_BYTE_LIMIT:
            raise LayoutOverflowError(est, ELL_BYTE_LIMIT, num_rows, width)

    def ell_bytes_estimate(self) -> int:
        """Bytes the monolithic padded-ELL form would take: a degree scan,
        no adjacency built.  The ``engine=None`` rule reads it."""
        return ell_bytes_estimate(self.num_vertices, self.max_degree)

    def hybrid(self, widths=None, spill_cap=None) -> HybridEllGraph:
        """Sliced-ELL + COO-spill layout (``graphs.hybrid``) on the handle's
        device, cached per ``(widths, spill_cap)``; never builds ``.ell``."""
        key = f"hybrid({widths},{spill_cap})"
        if key not in self._cache:
            csr = self.csr
            with self._convert("csr_to_hybrid"):
                self._cache[key] = csr_to_hybrid_ell(
                    csr, widths=widths, spill_cap=spill_cap,
                    device=self._device)
        return self._cache[key]

    def bucketed(self, boundaries: Iterable[int] = (8, 32, 128)
                 ) -> BucketedELL:
        """Degree-bucketed ELL (``csr_to_bucketed_ell``) on the handle's
        device, cached per ``boundaries``."""
        key = f"bucketed{tuple(boundaries)}"
        if key not in self._cache:
            csr = self.csr
            with self._convert("csr_to_bucketed_ell"):
                self._cache[key] = csr_to_bucketed_ell(
                    csr, tuple(boundaries), device=self._device)
        return self._cache[key]

    @property
    def digest(self) -> str:
        """Content digest (16 hex chars) of the CSR structure plus values,
        byte-compatible with ``repro.Graph.digest``."""
        if "digest" not in self._cache:
            arrays = [self.csr.indptr, self.csr.indices]
            if self.has_values:
                arrays.append(self.csr_matrix.values)
            with self._convert("digest"):
                h = hashlib.sha256()
                for arr in arrays:
                    a = np.asarray(arr)
                    h.update(str(a.dtype).encode())
                    h.update(str(a.shape).encode())
                    h.update(a.tobytes())
                self._cache["digest"] = h.hexdigest()[:16]
        return self._cache["digest"]

    # -- stats --------------------------------------------------------------

    def _ell_seeded(self) -> bool:
        return "csr" not in self._cache

    def _ell_scalar(self, key: str, fn) -> int:
        """A size of an ELL-seeded handle, reduced on the device: only the
        scalar comes to the host, once."""
        if key not in self._cache:
            self._cache[key] = int(fn(self._cache["ell"].mask))
        return self._cache[key]

    @property
    def num_vertices(self) -> int:
        if self._ell_seeded():
            return self._cache["ell"].num_vertices
        return self.csr.num_vertices

    @property
    def num_entries(self) -> int:
        if self._ell_seeded():
            return self._ell_scalar("num_entries", torch.count_nonzero)
        return self.csr.num_entries

    @property
    def degrees(self) -> np.ndarray:
        if "degrees" not in self._cache:
            with self._convert("degrees"):
                if self._ell_seeded():
                    deg = self._cache["ell"].mask.sum(dim=1).cpu().numpy()
                else:
                    deg = np.diff(self.csr.indptr)
                self._cache["degrees"] = deg
        return self._cache["degrees"]

    @property
    def max_degree(self) -> int:
        if self._ell_seeded():
            return self._ell_scalar(
                "max_degree", lambda m: m.sum(dim=1).max() if m.numel()
                else 0)
        d = self.degrees
        return int(d.max()) if len(d) else 0

    def stats(self) -> dict:
        """Sizes, degree summary and the cached formats (the reference's
        keys; the ELL-seeded handle's cached scalars are not formats)."""
        d = self.degrees
        return {
            "num_vertices": self.num_vertices,
            "num_entries": self.num_entries,
            "max_degree": self.max_degree,
            "avg_degree": float(d.mean()) if len(d) else 0.0,
            "has_values": self.has_values,
            "cached_formats": sorted(k for k in self._cache
                                     if k not in _SCALAR_KEYS),
        }

    def __repr__(self) -> str:
        fmts = ",".join(sorted(self._cache))
        return (f"Graph(V={self.num_vertices}, E={self.num_entries}, "
                f"device={self._device}, cached=[{fmts}])")


def as_graph(obj, device: torch.device | str | None = None) -> Graph:
    """Coerce a CSR or ELL container (or handle) to a Graph handle."""
    return obj if isinstance(obj, Graph) else Graph(obj, device)


def as_ell_graph(obj) -> ELLGraph:
    """An ``ELLGraph`` as is, else the handle's (cached) ``.ell``."""
    return obj if isinstance(obj, ELLGraph) else as_graph(obj).ell


def as_csr_graph(obj) -> CSRGraph:
    """A ``CSRGraph`` as is, else the handle's (cached) ``.csr``."""
    return obj if isinstance(obj, CSRGraph) else as_graph(obj).csr
