"""Execution policy: which device the pipelines run on, and which process
group the distributed engines partition the vertices over.

``Backend()`` runs on ``cuda``; ``Backend(device="cpu")`` asks for the CPU,
where the kernels' plain-torch twins stand in for the CUDA kernels.  With
no device given and no CUDA device present, resolving the backend raises:
the port never falls back to the CPU on its own.

``Backend(group=...)`` names the ``torch.distributed`` process group (or
``DeviceMesh``) of the ``distributed`` engines; see :meth:`resolve_group`.

A call given no backend takes the process default (``Backend()`` until
:func:`set_default_backend` or :func:`using_backend` installs another); a
default of ``Backend(device="cpu")`` counts as the caller asking for the
CPU, and a ``Graph`` built with no device then takes it too.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Iterator

import torch

#: flattened multi-dimensional meshes: row-major rank order -> process group
_FLAT_GROUPS: dict[tuple, Any] = {}


@dataclass(frozen=True)
class Backend:
    device: torch.device | str | None = None   # None = cuda
    group: Any = None   # ProcessGroup | DeviceMesh | None (default group)

    def resolve_device(self) -> torch.device:
        dev = torch.device("cuda" if self.device is None else self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes Backend(device='cpu')")
        return dev

    def resolve_group(self) -> tuple[Any, int, int]:
        """``(group, world_size, rank)`` of the distributed engines.

        ``group=None`` takes the initialized default group; with none
        initialized it is a group of one rank (``group`` None): no
        collective is run and the model counts one device, as the
        reference's one-device mesh.  A ``DeviceMesh`` of several
        dimensions is flattened row-major, as the reference flattens a
        multi-axis mesh with ``axis=None``; its row-major order must be
        ascending global ranks (a group's ranks are ordered so)."""
        import torch.distributed as dist

        group = self.group
        if group is None:
            if not (dist.is_available() and dist.is_initialized()):
                return None, 1, 0
            group = dist.group.WORLD
        elif hasattr(group, "mesh") and hasattr(group, "get_group"):
            group = _mesh_group(group)
        return group, dist.get_world_size(group), dist.get_rank(group)

    def with_(self, **changes) -> "Backend":
        return replace(self, **changes)


def _mesh_group(mesh):
    """The process group of a ``DeviceMesh``, flattened row-major; a new
    group is made once per rank order (every rank of the default group
    takes part, as ``new_group`` asks)."""
    import torch.distributed as dist

    if mesh.ndim == 1:
        return mesh.get_group()
    order = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    if list(order) != sorted(order):
        raise ValueError(f"the mesh's row-major rank order {order} is not "
                         "ascending")
    if order == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if order not in _FLAT_GROUPS:
        _FLAT_GROUPS[order] = dist.new_group(list(order))
    return _FLAT_GROUPS[order]


_DEFAULT = Backend()


def get_default_backend() -> Backend:
    return _DEFAULT


def set_default_backend(backend: Backend) -> Backend:
    """Install ``backend`` as the process-wide default; returns the old one."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, backend
    return old


@contextmanager
def using_backend(backend: Backend) -> Iterator[Backend]:
    """Scoped default backend (restores the previous default on exit)."""
    old = set_default_backend(backend)
    try:
        yield backend
    finally:
        set_default_backend(old)


def resolve_backend(backend: Backend | None) -> Backend:
    return _DEFAULT if backend is None else backend


def accelerator_present() -> bool:
    """Whether a CUDA device is attached (``torch.cuda.is_available()``)."""
    return torch.cuda.is_available()


def backend_platform(backend: Backend | None = None) -> str:
    """The platform a call under ``backend`` runs on, as provenance names
    it: ``gpu`` for a CUDA device, ``cpu`` otherwise."""
    dev = resolve_backend(backend).resolve_device()
    return "gpu" if dev.type == "cuda" else "cpu"


#: ``engine=None`` below the hybrid threshold: the device-resident fixed
#: point over the monolithic padded ELL (one persistent kernel on the card)
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
