"""The coloring's form of the hash-pack kernel on the CPU: the twin of
``round_priorities`` (the ids ``0..n-1`` hashed and packed, widened to
int64) against the JAX package's own round priorities
(``repro.core.coloring._round_priorities``) and its Pallas kernel
(``hash_pack_pallas``, interpret mode) on ``arange``, bit for bit; the
wrappers' argument checks; and one call a Luby round.  The CUDA kernel's
two forms are held against the twins in ``test_torch_cuda.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coloring as ref_coloring
from repro.kernels.hash_priority import kernel as ref_hash_kernel
import repro_torch as rt
from repro_torch.core.tuples import id_bits, widen
from repro_torch.kernels.hash_priority import ops as hash_ops
from repro_torch.kernels.hash_priority import ref as hash_ref

from _torch_common import CPU, port_graph

ROUNDS = [0, 7, 2**31 - 1]
SIZES = [1, 5, 3001]


def _bits(v: int) -> list[int]:
    return sorted({id_bits(v), 1, 31})


CASES = [(v, r, b) for v in SIZES for r in ROUNDS for b in _bits(v)]


def _priorities(v: int, r: int, b: int) -> np.ndarray:
    before = dict(hash_ops.LAUNCHES)
    got = hash_ops.round_priorities(v, torch.tensor([r], dtype=torch.int32), b)
    assert hash_ops.LAUNCHES == before          # the twin launches nothing
    assert got.dtype == torch.int64 and got.shape == (v,)
    return got.numpy()


@pytest.mark.parametrize("v,r,b", CASES)
def test_round_priorities_equal_reference_coloring(v, r, b):
    want = np.asarray(ref_coloring._round_priorities(
        v, jnp.uint32(r), jnp.uint32(b))).astype(np.int64)
    np.testing.assert_array_equal(_priorities(v, r, b), want)


@pytest.mark.parametrize("v,r,b", CASES)
def test_round_priorities_equal_pallas_on_arange(v, r, b):
    want = np.asarray(ref_hash_kernel.hash_pack_pallas(
        r, jnp.arange(v, dtype=jnp.uint32), b, interpret=True))
    np.testing.assert_array_equal(_priorities(v, r, b),
                                  want.astype(np.int64))


@pytest.mark.parametrize("v", SIZES)
def test_every_form_of_the_wrappers_agrees(v):
    it = torch.tensor([7], dtype=torch.int32)
    b = id_bits(v)
    ids = torch.arange(v, dtype=torch.int32)
    word = hash_ops.hash_pack(ids, it, b)
    assert word.dtype == torch.int32 and word.shape == (v,)
    assert torch.equal(hash_ops.round_priorities(v, it, b), widen(word))
    assert torch.equal(hash_ops.round_priorities(v, it, b),
                       hash_ref.round_priorities_ref(v, it, b))
    # a slice that starts off a 16-byte boundary (the kernel's scalar path)
    assert torch.equal(hash_ops.hash_pack(ids[1:], it, b), word[1:])


def test_round_priorities_validates_arguments():
    it = torch.zeros(1, dtype=torch.int32)
    for b in (0, 32):
        with pytest.raises(ValueError, match="id bits"):
            hash_ops.round_priorities(8, it, b)
    with pytest.raises(ValueError, match="one element"):
        hash_ops.round_priorities(8, torch.zeros(2, dtype=torch.int32), 4)
    for bad in (it.long(), torch.zeros((1, 1), dtype=torch.int32)):
        with pytest.raises(TypeError):
            hash_ops.round_priorities(8, bad, 4)
    with pytest.raises(TypeError):
        hash_ops.round_priorities(8.0, it, 4)
    for n in (-1, 2**31):
        with pytest.raises(ValueError, match="out of range"):
            hash_ops.round_priorities(n, it, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        hash_ops.round_priorities(8, torch.zeros(1, dtype=torch.int32,
                                                 device="meta"), 4)


@pytest.mark.parametrize("form,dtype", [("round_priorities", torch.int64),
                                        ("hash_pack", torch.int32)])
def test_no_ids_give_an_empty_tensor(form, dtype):
    it = torch.zeros(1, dtype=torch.int32)
    got = (hash_ops.round_priorities(0, it, 4) if form == "round_priorities"
           else hash_ops.hash_pack(torch.zeros(0, dtype=torch.int32), it, 4))
    assert got.dtype == dtype and got.shape == (0,)


@pytest.mark.parametrize("engine", ["luby", "luby_hybrid"])
def test_one_round_priorities_call_a_luby_round(monkeypatch, engine):
    calls = []
    real = hash_ops.round_priorities

    def counted(n, it, b):
        calls.append(n)
        return real(n, it, b)

    monkeypatch.setattr(hash_ops, "round_priorities", counted)
    g = port_graph("laplace3d(8)")
    r = rt.color(g, engine=engine, backend=CPU)
    assert (r.num_colors, r.digest) == (5, "3f45a9cfe50afa1e")
    assert calls == [g.num_vertices] * r.rounds
