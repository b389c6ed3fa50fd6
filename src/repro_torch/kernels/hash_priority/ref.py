"""Plain-torch twins of the hash-pack kernel (``csrc/hash_pack.cu``): the
§V-A xorshift64* priority of each id packed with the id (``core.hashing``
and ``core.tuples``), as int32 bit patterns, and the coloring's form of it
over the ids ``0..n-1``, widened."""
from __future__ import annotations

import torch

from ...core.hashing import priorities_xorshift_star
from ...core.tuples import narrow, pack, widen


def hash_pack_ref(ids: torch.Tensor, it: torch.Tensor, b: int) -> torch.Tensor:
    vids = widen(ids)
    return narrow(pack(priorities_xorshift_star(it, vids), vids, b))


def round_priorities_ref(n: int, it: torch.Tensor, b: int) -> torch.Tensor:
    """``widen(hash_pack_ref(arange(n), it, b))``: int64 ``[n]``."""
    ids = torch.arange(n, dtype=torch.int32, device=it.device)
    return widen(hash_pack_ref(ids, it, b))
