"""Execution policy: which device the pipelines run on.

``Backend()`` runs on ``cuda``; ``Backend(device="cpu")`` asks for the CPU,
where the kernels' plain-torch twins stand in for the CUDA kernels.  With
no device given and no CUDA device present, resolving the backend raises:
the port never falls back to the CPU on its own.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Backend:
    device: torch.device | str | None = None   # None = cuda

    def resolve_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes Backend(device='cpu')")
        return torch.device("cuda")


def resolve_backend(backend: Backend | None) -> Backend:
    return Backend() if backend is None else backend


def backend_platform(backend: Backend | None = None) -> str:
    """The platform a call under ``backend`` runs on, as provenance names
    it: ``gpu`` for a CUDA device, ``cpu`` otherwise."""
    dev = resolve_backend(backend).resolve_device()
    return "gpu" if dev.type == "cuda" else "cpu"


#: ``engine=None`` below the hybrid threshold: the device-resident fixed
#: point on the fused kernels over the monolithic padded ELL
DEFAULT_MIS2_ENGINE = "cuda_resident"


def default_mis2_engine(graph, options=None) -> str:
    """The ``engine=None`` rule of ``mis2`` and of the coarsening's inner
    fixed points, kernel engines first and total over ``Mis2Options``:

    * ``cuda_hybrid`` once the graph's padded-ELL bytes estimate exceeds
      ``repro_torch.graphs.hybrid.HYBRID_AUTO_BYTES`` (a skewed graph at
      scale), for options the kernels take (worklists, packed, ``ell``);
    * else :data:`DEFAULT_MIS2_ENGINE` for those options;
    * else ``compacted_resident`` with worklists (the unpacked or
      ``csr_segment`` ablations);
    * else ``cuda_compacted`` for packed ``ell`` without worklists;
    * else ``compacted``.

    The threshold is read at call time, so a test can lower it."""
    from ..graphs import hybrid as _hybrid

    worklists = options is None or options.worklists
    kernel_layout = options is None or (options.packed
                                        and options.layout == "ell")
    if worklists and kernel_layout:
        if graph.ell_bytes_estimate() > _hybrid.HYBRID_AUTO_BYTES:
            return "cuda_hybrid"
        return DEFAULT_MIS2_ENGINE
    if worklists:
        return "compacted_resident"
    return "cuda_compacted" if kernel_layout else "compacted"


def default_misk_engine() -> str:
    """The ``engine=None`` rule of ``misk``: always ``dense``, as in the
    reference (``resident``, the worklist refresh, gives the same sets and
    is kept for the ablation)."""
    return "dense"


def default_multilevel_engine(graph) -> str:
    """The ``engine=None`` rule of ``amg_setup`` / ``cluster_gs_setup``:
    ``resident`` (the whole per-level setup on the device) for a graph on
    CUDA, ``host`` (numpy/scipy) on the CPU, as the reference picks its
    device engine on accelerators and its host engine on CPU hosts."""
    return "resident" if graph.device.type == "cuda" else "host"
