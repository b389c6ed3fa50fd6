"""Plain-torch twins of the hash-pack kernel (``csrc/hash_pack.cu``): the
§V-A xorshift64* priority of each id packed with the id (``core.hashing``
and ``core.tuples``), as int32 bit patterns; the coloring's form of it
over the ids ``0..n-1``, widened; and the batched coloring's, that form of
each member of a bucket laid end to end."""
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


def round_priorities_batched_ref(rows: int, it: torch.Tensor,
                                 bits: torch.Tensor) -> torch.Tensor:
    """``round_priorities_ref(rows, it, bits[j])`` for each member ``j``,
    concatenated: int64 ``[B * rows]``, index ``i`` packing the local id
    ``i % rows`` with ``bits[i // rows]`` (``rows`` a power of two)."""
    idx = torch.arange(rows * bits.shape[0], device=it.device)
    ids = idx & (rows - 1)
    b = bits.to(torch.int64)[idx >> (rows.bit_length() - 1)]
    return pack(priorities_xorshift_star(it, ids), ids, b)
