"""``GraphBatch``: many graphs, few shapes, one pass per shape (port of
``repro.batch.container``).

``GraphBatch`` buckets a list of :class:`~repro_torch.graphs.Graph`
handles by padded ELL shape, power-of-two rows x power-of-two
``max(1, width)`` (the host-driven MIS-2 driver's bucket policy,
``core.mis2._bucket``), and stacks each bucket's padded adjacency, taken
from the handles' cached ``padded_ell``, into one ``[B, rows, width]``
tensor on the members' device.  The batched pipelines (``batch.pipeline``)
run each bucket as one block-diagonal graph of ``B * rows`` rows
(:attr:`GraphBucket.flat_neighbors`): ``B`` graphs a round, a few launches
a bucket instead of a few a graph.

Per-graph identity is kept inside the stack: each member carries its
real vertex count, a ``row_valid`` mask and its own packing id-bit count
``b = id_bits(V_real)``, so the batched results are bit-identical to the
single-graph ones.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.mis2 import _bucket
from ..core.tuples import id_bits
from ..graphs.handle import Graph, as_graph


def bucket_shape(graph) -> tuple[int, int]:
    """The ``(rows, width)`` padding bucket a graph lands in: both rounded
    up to the next power of two (the width from at least 1, so a graph with
    no entries still has its self slot)."""
    gh = as_graph(graph)
    return _bucket(gh.num_vertices), _bucket(max(1, gh.ell.width))


@dataclass
class GraphBucket:
    """One stacked shape class of a :class:`GraphBatch`."""

    rows: int                 # padded vertex count (power of two)
    width: int                # padded ELL degree (power of two)
    indices: tuple            # positions of the members in the batch order
    neighbors: torch.Tensor   # int32 [B, rows, width], member-local ids
    mask: torch.Tensor        # bool  [B, rows, width]
    row_valid: torch.Tensor   # bool  [B, rows]  (True on real vertices)
    num_vertices: np.ndarray  # int64 [B] real vertex counts
    id_bits: torch.Tensor     # int32 [B] per-graph packing bit width

    @property
    def size(self) -> int:
        return len(self.indices)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.width)

    @functools.cached_property
    def flat_neighbors(self) -> torch.Tensor:
        """The bucket as one block-diagonal graph: int64 ``[B * rows,
        width]``, member ``j``'s ids offset by ``j * rows``; built once."""
        offset = torch.arange(self.size, dtype=torch.int64,
                              device=self.neighbors.device) * self.rows
        return (self.neighbors.to(torch.int64)
                + offset[:, None, None]).view(-1, self.width)

    @functools.cached_property
    def flat_neighbors32(self) -> torch.Tensor:
        """:attr:`flat_neighbors` narrowed to int32 (the kernels' ids:
        ``B * rows < 2**31``); built once."""
        return self.flat_neighbors.to(torch.int32)


class GraphBatch:
    """An ordered collection of graphs, stacked into shape buckets::

        batch = GraphBatch([g1, g2, g3, ...])
        for bucket in batch.buckets:   # one block-diagonal pass each
            ...

    Results are always reported in the original input order (each bucket
    remembers its members' positions).  Stacking reuses each handle's
    cached padded ELL, so re-batching the same graphs is cheap.  Every
    member must live on one device.
    """

    def __init__(self, graphs: Sequence):
        if isinstance(graphs, GraphBatch):
            self.graphs = graphs.graphs
            self.buckets = graphs.buckets
            return
        self.graphs: list[Graph] = [as_graph(g) for g in graphs]
        if not self.graphs:
            raise ValueError("GraphBatch needs at least one graph")
        devices = {gh.device for gh in self.graphs}
        if len(devices) > 1:
            raise ValueError(f"GraphBatch members on several devices: "
                             f"{sorted(map(str, devices))}")
        (dev,) = devices
        by_shape: dict[tuple[int, int], list[int]] = {}
        for i, gh in enumerate(self.graphs):
            by_shape.setdefault(bucket_shape(gh), []).append(i)
        self.buckets: list[GraphBucket] = []
        for (rows, width), idxs in sorted(by_shape.items()):
            members = [self.graphs[i] for i in idxs]
            ells = [gh.padded_ell(rows, width) for gh in members]
            nv = np.asarray([gh.num_vertices for gh in members],
                            dtype=np.int64)
            self.buckets.append(GraphBucket(
                rows=rows, width=width, indices=tuple(idxs),
                neighbors=torch.stack([e.neighbors for e in ells]),
                mask=torch.stack([e.mask for e in ells]),
                row_valid=torch.from_numpy(
                    np.arange(rows)[None, :] < nv[:, None]).to(dev),
                num_vertices=nv,
                id_bits=torch.tensor([id_bits(int(v)) for v in nv],
                                     dtype=torch.int32, device=dev)))

    def __len__(self) -> int:
        return len(self.graphs)

    @property
    def device(self) -> torch.device:
        return self.graphs[0].device

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def bucket_shapes(self) -> list[tuple[int, int, int]]:
        """``[(rows, width, member count)]`` per bucket."""
        return [(b.rows, b.width, b.size) for b in self.buckets]

    def stats(self) -> dict:
        padded = sum(b.size * b.rows * b.width for b in self.buckets)
        real = sum(g.num_entries for g in self.graphs)
        return {
            "num_graphs": len(self.graphs),
            "num_buckets": self.num_buckets,
            "bucket_shapes": self.bucket_shapes,
            "padding_ratio": padded / max(1, real),
        }

    def __repr__(self) -> str:
        shapes = ", ".join(f"{r}x{w}:{n}" for r, w, n in self.bucket_shapes)
        return f"GraphBatch({len(self.graphs)} graphs, buckets=[{shapes}])"


def as_graph_batch(obj) -> GraphBatch:
    """Coerce a GraphBatch, or any sequence of graphs, to a GraphBatch."""
    return obj if isinstance(obj, GraphBatch) else GraphBatch(obj)
