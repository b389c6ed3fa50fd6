"""Compressed status tuples (paper §V-C), PyTorch port of
``repro.core.tuples``.

The 3-field tuple ``(status, rand, id)`` is packed into one 32-bit word:

* ``IN  = 0``
* ``OUT = 0xFFFFFFFF``
* undecided: ``(priority' << b) | (id + 1)`` with ``b = ceil(log2(V + 2))``
  and ``priority'`` the high ``32 - b`` bits of the hash.

torch has no usable unsigned 32-bit arithmetic (uint32 tensors lack ``min``
and shifts), so the port keeps two forms of the same word:

* **stored**: an ``int32`` tensor holding the uint32 bit pattern — what the
  CUDA kernels read as ``uint32_t`` (``IN`` is 0, ``OUT`` is -1);
* **widened**: an ``int64`` tensor holding the value in ``[0, 2**32)`` —
  where the plain torch code computes and compares, so signed order is
  unsigned order.

The unpacked 3-field tuple of the §V-C ablation keeps the status as a
``uint8`` (``S_IN`` / ``S_UND`` / ``S_OUT``) and the rand and id fields as
uint32 words in the same stored / widened forms.
"""
from __future__ import annotations

import math

import torch

IN = 0
OUT = 0xFFFFFFFF
U32_MASK = 0xFFFFFFFF

#: the stored (int32 bit pattern) form of OUT; IN is 0 in both forms
OUT_I32 = -1

#: status codes of the unpacked tuple (uint8), ordered IN < UND < OUT
S_IN, S_UND, S_OUT = 0, 1, 2
#: the largest uint32 (widened): an unpacked field's "no value"
U32MAX = 0xFFFFFFFF


def id_bits(num_vertices: int) -> int:
    """b = ceil(log2(V + 2)) — bits reserved for the id component."""
    return max(1, math.ceil(math.log2(num_vertices + 2)))


def widen(t: torch.Tensor) -> torch.Tensor:
    """Stored int32 bit pattern -> int64 value in ``[0, 2**32)``."""
    return t.to(torch.int64) & U32_MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 value in ``[0, 2**32)`` -> stored int32 bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def effective_priority(priority: torch.Tensor,
                       b: int | torch.Tensor) -> torch.Tensor:
    """The high ``32 - b`` bits of a (widened) 32-bit hash; ``b`` an int or
    an int64 tensor broadcast against ``priority`` (a batch's per-row
    bits)."""
    return priority >> b


def pack(priority: torch.Tensor, vertex_ids: torch.Tensor,
         b: int | torch.Tensor) -> torch.Tensor:
    """(priority' << b) | (id + 1), widened; ``b`` as in
    :func:`effective_priority`."""
    ids = vertex_ids.to(torch.int64)
    return (effective_priority(priority, b) << b) | ((ids + 1) & U32_MASK)


def unpack_id(t: torch.Tensor, b: int) -> torch.Tensor:
    """Vertex id of an undecided (widened) packed tuple."""
    return ((t & ((1 << b) - 1)) - 1) & U32_MASK


def is_undecided(t: torch.Tensor) -> torch.Tensor:
    """Neither IN nor OUT, for stored (int32) or widened (int64) words."""
    out = OUT_I32 if t.dtype == torch.int32 else OUT
    return (t != IN) & (t != out)
