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


#: ``engine=None``: the device-resident fixed point on the fused kernels, for
#: every graph with a monolithic ELL layout (the only layout ported so far)
DEFAULT_MIS2_ENGINE = "cuda_resident"

#: ``engine=None`` of ``amg_setup`` / ``cluster_gs_setup``: the host setup
#: (the reference picks its device-resident engine on accelerators; that
#: engine is not ported yet)
DEFAULT_MULTILEVEL_ENGINE = "host"
