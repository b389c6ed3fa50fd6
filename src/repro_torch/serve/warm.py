"""Warm registry: bring the serving bucket shapes up at startup (the JAX
package's ``repro.serve.warm``, whose ahead-of-time XLA compile becomes a
warm-up here).

A server that meets a new ``[B, rows, width]`` bucket mid-traffic should
pay nothing on the request path that it could have paid at startup.  Here
that cost is the CUDA kernels' build (``nvcc``, seconds a library) and the
first run of the batched fixed point on the device (the CUDA context, the
caching allocator's blocks for the bucket's shape).  For each configured
shape the registry builds every kernel library (``kernels._build.
build_all``, once) and runs one batched MIS-2 over inert members of that
shape (all-padding rows: ``active=False``, self-loop adjacency, decided in
0 rounds — the reference's ``_inert_members``), through the batched
pipeline's own bucket fixed point (``batch.pipeline._fixed_point``), which
the server's batched dispatch then runs.  After warm-up no request
starts an ``nvcc`` (:attr:`WarmRegistry.builds_since_warm`).

``startup_compiles`` counts warmed specs; each *distinct* cold ``(shape,
options)`` key dispatched at runtime is counted once as a runtime compile,
as the reference counts them, and exposed per uptime window so an
operator can see config drift (``runtime_compiles > 0`` means the config
is missing live shapes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..batch.container import GraphBucket
from ..batch.pipeline import _fixed_point
from ..core.mis2 import MAX_ITERS_DEFAULT, Mis2Options
from ..kernels import _build
from ..obs import metrics as _OBS


@dataclass(frozen=True)
class WarmSpec:
    """One warmed serving shape: a mis2 bucket ``[B, rows, width]``."""

    batch: int
    rows: int
    width: int
    priority: str = "xorshift_star"
    max_iters: int = MAX_ITERS_DEFAULT

    @property
    def key(self) -> tuple:
        return (self.batch, self.rows, self.width, self.priority,
                self.max_iters)


def _inert_bucket(spec: WarmSpec, device) -> GraphBucket:
    """A bucket of ``spec.batch`` padding members: self-loop neighbours,
    nothing active — the fixed point decides them in 0 rounds."""
    b, rows, width = spec.batch, spec.rows, spec.width
    nbrs = torch.arange(rows, dtype=torch.int32, device=device)[
        None, :, None].expand(b, rows, width).contiguous()
    return GraphBucket(
        rows=rows, width=width, indices=tuple(range(b)), neighbors=nbrs,
        mask=torch.zeros((b, rows, width), dtype=torch.bool, device=device),
        row_valid=torch.zeros((b, rows), dtype=torch.bool, device=device),
        num_vertices=np.zeros(b, dtype=np.int64),
        id_bits=torch.ones(b, dtype=torch.int32, device=device))


@dataclass
class WarmRegistry:
    """Warmed shapes and the compile-churn counters."""

    startup_compiles: int = 0
    _specs: dict = field(default_factory=dict)
    _cold: set = field(default_factory=set)
    _cold_window_base: int = 0
    _builds_at_warm: Optional[int] = None

    def warm(self, specs, device: torch.device) -> int:
        """Warm every spec not yet registered on ``device``; returns the
        number warmed.  On a CUDA device every kernel library is built
        first (a kernel error raises here, at startup)."""
        specs = [s for s in specs if s.key not in self._specs]
        if specs and device.type == "cuda":
            _build.build_all()
        for spec in specs:
            bucket = _inert_bucket(spec, device)
            _fixed_point(bucket, bucket.row_valid.view(-1), Mis2Options(
                priority=spec.priority, max_iters=spec.max_iters))
            self._specs[spec.key] = spec
            self.startup_compiles += 1
            _OBS.counter("serve.warm.startup_compiles").inc()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self._builds_at_warm = _build.NVCC_RUNS["count"]
        return len(specs)

    @property
    def num_executables(self) -> int:
        return len(self._specs)

    @property
    def builds_since_warm(self) -> int:
        """``nvcc`` processes started since the last warm-up."""
        base = self._builds_at_warm
        return 0 if base is None else _build.NVCC_RUNS["count"] - base

    @property
    def runtime_compiles(self) -> int:
        """Distinct cold (shape, options) keys dispatched since startup."""
        return len(self._cold)

    @property
    def runtime_compiles_window(self) -> int:
        """Cold keys since the last ``reset_window()``."""
        return len(self._cold) - self._cold_window_base

    def reset_window(self) -> None:
        self._cold_window_base = len(self._cold)

    def note(self, members: int, rows: int, width: int, priority: str,
             max_iters: int) -> None:
        """A bucket about to run: a shape no warmed spec covers (at any
        capacity) is counted once as a runtime compile."""
        if any((r, w, p, mi) == (rows, width, priority, max_iters)
               for (_, r, w, p, mi) in self._specs):
            return
        cold = (members, rows, width, priority, max_iters)
        if cold not in self._cold:
            self._cold.add(cold)
            _OBS.counter("serve.warm.runtime_compiles").inc()
