"""Result types of the facade, ported from ``repro.api.result``.

Every facade call returns a :class:`Result`: the primary output as a host
numpy ``payload``, the iteration count, convergence, the facade-measured
wall time, a determinism digest of the payload and a ``provenance`` record
(:class:`~repro_torch.obs.Provenance`: engine, platform, digest, and the
call's span with its wall time and metric deltas).  The digest is
byte-compatible with the JAX package's, so equal digests mean the port and
the reference produced bit-identical output.  A batched call returns a
:class:`BatchResult` of per-graph Results.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np


def determinism_digest(arr: np.ndarray) -> str:
    """Stable 16-hex digest over dtype, shape and raw bytes."""
    arr = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


@runtime_checkable
class ResultLike(Protocol):
    """What every facade result offers (``isinstance`` checks the names)."""

    payload: np.ndarray
    iterations: int
    converged: bool
    wall_time_s: float
    digest: str


@dataclass
class Result:
    payload: np.ndarray
    iterations: int = 0
    converged: bool = True
    wall_time_s: float = 0.0
    digest: str = ""
    # the facade's repro_torch.obs.Provenance, set after construction so
    # that the record can carry the digest computed in __post_init__
    provenance: object | None = None

    def __post_init__(self):
        self.payload = np.asarray(self.payload)
        if not self.digest:
            self.digest = determinism_digest(self.payload)


@dataclass
class Mis2Result(Result):
    """Distance-2 MIS: ``payload`` is the bool membership mask.

    ``host_syncs`` counts the device->host reads inside the fixed point:
    the resident engines read the live count once per round to decide
    whether to go on, so a solve of ``R`` rounds that converges reports
    ``R + 1``; the host-driven ones pull T and M every round (``2 R``).
    ``num_compiles`` is the reference's count of distinct jitted step
    shapes: the host-driven engines' pow2 worklist-bucket pairs, 1 for the
    resident ones, None for ``dense``.  ``collectives`` is the
    ``cuda_hybrid`` engine's traffic accounting (``slice_widths``,
    ``slice_rows_processed``, ``spill_entries``, ``spill_passes``,
    ``row_bytes_total``), in the reference's keys; None for the other
    engines."""

    engine: str = ""
    host_syncs: int = 0
    collectives: dict | None = None
    num_compiles: int | None = None

    @property
    def in_set(self) -> np.ndarray:
        return self.payload

    @property
    def size(self) -> int:
        return int(self.payload.sum())


@dataclass
class AggregationResult(Result):
    """MIS-2 coarsening: ``payload`` is the int32 aggregate label per
    vertex; ``iterations`` counts the MIS-2 rounds of every phase."""

    num_aggregates: int = 0
    roots: np.ndarray | None = None
    phase: np.ndarray | None = None
    engine: str = ""

    @property
    def labels(self) -> np.ndarray:
        return self.payload

    @property
    def mis2_iterations(self) -> int:
        return self.iterations

    @property
    def coarsening_ratio(self) -> float:
        return len(self.payload) / max(1, self.num_aggregates)


@dataclass
class ColoringResult(Result):
    """Distance-1 coloring: ``payload`` is the int32 color per vertex;
    ``iterations`` counts the Luby rounds."""

    num_colors: int = 0
    host_syncs: int = 0

    @property
    def colors(self) -> np.ndarray:
        return self.payload

    @property
    def rounds(self) -> int:
        return self.iterations


@dataclass
class PartitionResult(Result):
    """Multilevel partition: ``payload`` is the int32 part id per vertex
    (so ``digest`` is the parts digest); ``iterations`` and ``levels`` are
    the number of graphs in the hierarchy, ``history`` the ``(V, E)`` of
    each coarse one."""

    num_parts: int = 0
    edge_cut: int = 0
    levels: int = 0
    history: list = field(default_factory=list)

    @property
    def parts(self) -> np.ndarray:
        return self.payload


@dataclass
class BatchResult:
    """Result of one batched facade call (``mis2_batch`` / ``color_batch``
    / ``coarsen_batch`` / ``amg_setup_batch``): the per-graph
    :class:`Result` objects in **input order**, each with its own digest, so
    a batch is checked member by member against the single-graph calls.

    ``wall_time_s`` is the whole batched call (every bucket);
    ``bucket_shapes`` holds ``(rows, width, member count)`` per bucket;
    ``provenance`` is the one batch-level record its members share (its
    ``digest`` is the batch's, :attr:`digest`).
    """

    results: list = field(default_factory=list)
    wall_time_s: float = 0.0
    engine: str = ""
    bucket_shapes: list = field(default_factory=list)
    provenance: object | None = None

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def num_graphs(self) -> int:
        return len(self.results)

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_shapes)

    @property
    def digests(self) -> list:
        """Per-graph determinism digests, input order."""
        return [r.digest for r in self.results]

    @property
    def digest(self) -> str:
        """One digest over the members' digests in input order: the batch's
        own, which its ``provenance`` carries."""
        h = hashlib.sha256()
        for d in self.digests:
            h.update(d.encode())
        return h.hexdigest()[:16]

    @property
    def converged(self) -> bool:
        return all(r.converged for r in self.results)

    @property
    def graphs_per_second(self) -> float:
        return len(self.results) / self.wall_time_s if self.wall_time_s \
            else 0.0


@dataclass
class AmgSetup(Result):
    """AMG hierarchy setup: ``payload`` is the ``[levels, 2]`` (n, nnz)
    table; the usable hierarchy hangs off ``.hierarchy`` /
    ``.as_precond()``.  ``engine`` names the multilevel engine that built
    it (``host`` | ``resident``); ``timings`` is the setup-phase split
    (``aggregate`` / ``prolongator`` / ``galerkin`` / ``pack`` seconds);
    ``dispatches`` counts the resident engine's stage calls, 7 a level as
    the reference counts its jitted dispatches (0 on the host engine);
    ``level_digests`` are the per-level ``A_l`` ELL digests, equal to the
    reference's."""

    hierarchy: object | None = None
    aggregation: str = ""
    setup_seconds: float = 0.0
    aggregation_seconds: float = 0.0
    engine: str = ""
    timings: dict = field(default_factory=dict)
    dispatches: int = 0

    @property
    def level_sizes(self) -> list:
        return [tuple(int(x) for x in row) for row in self.payload]

    @property
    def num_levels(self) -> int:
        return int(self.payload.shape[0])

    @property
    def level_digests(self) -> list:
        return self.hierarchy.level_digests() if self.hierarchy else []

    def as_precond(self):
        return self.hierarchy.as_precond()


@dataclass
class ClusterGsSetup(Result):
    """Cluster multicolor GS setup: ``payload`` is the int32 cluster label
    per vertex (so ``digest`` gates the aggregation); ``colors`` carries the
    coarse coloring with its own digest, and ``preconditioner`` is the
    ready :class:`~repro_torch.solvers.multicolor_gs.
    MulticolorGSPreconditioner`.  ``timings`` is the setup split
    (``aggregate`` / ``color`` / ``pack`` seconds); ``color_rounds`` the
    Luby rounds of the coarse coloring."""

    preconditioner: object | None = None
    num_colors: int = 0
    num_clusters: int = 0
    colors: np.ndarray | None = None
    engine: str = ""
    timings: dict = field(default_factory=dict)
    color_rounds: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.colors is not None:
            self.colors = np.asarray(self.colors)

    @property
    def labels(self) -> np.ndarray:
        return self.payload

    @property
    def colors_digest(self) -> str:
        return determinism_digest(self.colors)

    def as_precond(self, sweeps: int = 1, symmetric: bool = True):
        return self.preconditioner.as_precond(sweeps, symmetric)
