"""Plain-torch twin of the run-sum kernel (``csrc/run_sums.cu``).

Step ``k`` adds position ``k`` of every run still that long to the run's
sum: vectorised over the runs, sequential in ``k``, so each run is summed
in stream order, one rounded float64 add at a time, as the kernel sums it.
Given ``max_len`` it reads no value on the host, so it can be timed beside
the kernel on the card.
"""
from __future__ import annotations

import torch


def run_sums_ref(keys: torch.Tensor, vals: torch.Tensor,
                 starts: torch.Tensor, max_len: int | None = None):
    """Per run ``r`` (entries ``starts[r]`` up to the next start, or the
    end): its key, the in-order sum of its values and ``sum != 0``.
    ``max_len`` is the longest run (computed when not given)."""
    n, runs = keys.shape[0], starts.shape[0]
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:]
    if runs:
        ends[-1] = n
    lens = ends - starts
    if max_len is None:
        max_len = int(lens.max()) if runs else 0
    acc = vals[starts]
    last = max(n - 1, 0)
    for k in range(1, max_len):
        acc = torch.where(k < lens, acc + vals[(starts + k).clamp(max=last)],
                          acc)
    return keys[starts], acc, acc != 0.0
