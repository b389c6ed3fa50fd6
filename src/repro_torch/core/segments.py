"""Per-segment reductions in plain torch, the port's ``jax.ops.segment_min``
/ ``segment_max``: used by the MIS-2 engines and the aggregation joins and
by the twins of the hybrid layout's spill passes."""
from __future__ import annotations

import torch


def segment_reduce(vals: torch.Tensor, seg: torch.Tensor, num: int,
                   reduce: str, identity: int) -> torch.Tensor:
    """``[num]`` per-segment ``amin`` / ``amax`` of int64 ``vals``; an empty
    segment holds ``identity`` (``jax.ops.segment_min`` / ``_max``)."""
    out = torch.full((num,), identity, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), vals, reduce)
