"""Deterministic pseudo-random priorities (paper §V-A), PyTorch port of
``repro.core.hashing``.

``h(iter, v) = f(f(iter + 1) ^ f(v + 1))`` keeping the high 32 bits, with
``f`` xorshift64 ("Xor Hash") or xorshift64* ("Xor* Hash", the production
choice); ``fixed`` hashes round 0 for every round.

The 64-bit words live in int64 tensors: xor, left shift and multiply wrap
exactly as uint64 does, and a right shift is made logical by masking off
the sign-extended bits.  The CUDA kernels compute the same function on
native ``uint64_t`` (``kernels/csrc/hash.cuh``).
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_XORSHIFT_STAR_MUL = 0x2545F4914F6CDD1D


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of a 64-bit word held in int64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def xorshift64(x: torch.Tensor) -> torch.Tensor:
    """Marsaglia xorshift64 (13, 7, 17 triple)."""
    x = x ^ (x << 13)
    x = x ^ _shr(x, 7)
    return x ^ (x << 17)


def xorshift64_star(x: torch.Tensor) -> torch.Tensor:
    """xorshift64* = xorshift (12, 25, 27) then multiply (Vigna)."""
    x = x ^ _shr(x, 12)
    x = x ^ (x << 25)
    x = x ^ _shr(x, 27)
    return x * _XORSHIFT_STAR_MUL


def _combine(f, iteration, vertex_ids: torch.Tensor) -> torch.Tensor:
    """h(iter, v) = f(f(iter+1) ^ f(v+1)); the high 32 bits as int64.

    ``iteration`` is a Python int or an integer tensor (the device-resident
    round counter), broadcast against ``vertex_ids``.
    """
    it = torch.as_tensor(iteration, device=vertex_ids.device).to(torch.int64)
    a = f((it + 1) & _MASK32)
    vx = f((vertex_ids.to(torch.int64) + 1) & _MASK32)
    return _shr(f(a ^ vx), 32)


def priorities_xorshift_star(iteration, vertex_ids):
    """The paper's production hash ('Xor* Hash')."""
    return _combine(xorshift64_star, iteration, vertex_ids)


def priorities_xorshift(iteration, vertex_ids):
    """'Xor Hash' — kept for the Table I comparison."""
    return _combine(xorshift64, iteration, vertex_ids)


def priorities_fixed(iteration, vertex_ids):
    """Bell-style fixed priorities: hashed once, ignoring the iteration."""
    del iteration
    return _combine(xorshift64_star, 0, vertex_ids)


PRIORITY_FNS = {
    "xorshift_star": priorities_xorshift_star,
    "xorshift": priorities_xorshift,
    "fixed": priorities_fixed,
}

#: the ``kind`` code the CUDA kernels take for each priority
PRIORITY_CODES = {"xorshift_star": 0, "xorshift": 1, "fixed": 2}
