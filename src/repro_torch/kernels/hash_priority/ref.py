"""Plain-torch twin of the hash-pack kernel (``csrc/hash_pack.cu``): the
§V-A xorshift64* priority of each id packed with the id (``core.hashing``
and ``core.tuples``), as int32 bit patterns."""
from __future__ import annotations

import torch

from ...core.hashing import priorities_xorshift_star
from ...core.tuples import narrow, pack, widen


def hash_pack_ref(ids: torch.Tensor, it: torch.Tensor, b: int) -> torch.Tensor:
    vids = widen(ids)
    return narrow(pack(priorities_xorshift_star(it, vids), vids, b))
