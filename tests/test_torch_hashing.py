"""Priorities and packed tuples of the port, bit-equal to the numpy oracle
and to the JAX package."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.core import tuples as ref_tuples
from repro_torch.core import hashing, tuples

KINDS = ["xorshift_star", "xorshift", "fixed"]


def _ids(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint32)
    ids[:4] = [0, 1, 2**31, 2**32 - 2]
    return ids


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("iteration", [0, 1, 7, 1000])
def test_priorities_match_numpy_oracle_and_jax(kind, iteration):
    ids = _ids(seed=iteration % 97)
    port = hashing.PRIORITY_FNS[kind](iteration, torch.from_numpy(
        ids.astype(np.int64)))
    want = ref_hashing.np_priorities(kind, iteration, ids)
    np.testing.assert_array_equal(port.numpy().astype(np.uint32), want)
    jax_out = ref_hashing.PRIORITY_FNS[kind](np.uint32(iteration),
                                             jnp.asarray(ids))
    np.testing.assert_array_equal(np.asarray(jax_out), want)


@pytest.mark.parametrize("kind", KINDS)
def test_device_round_counter_gives_same_priorities(kind):
    ids = torch.arange(500)
    it = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(hashing.PRIORITY_FNS[kind](it, ids),
                               hashing.PRIORITY_FNS[kind](5, ids),
                               rtol=0, atol=0)


@pytest.mark.parametrize("v", [1, 2, 6, 510, 1000, 1_000_000, 2**31 - 3])
def test_id_bits(v):
    assert tuples.id_bits(v) == ref_tuples.id_bits(v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("v", [37, 1000])
def test_pack_unpack_match_reference(kind, v):
    b = tuples.id_bits(v)
    ids = np.arange(v, dtype=np.uint32)
    prio = ref_hashing.np_priorities(kind, 3, ids)
    want = np.asarray(ref_tuples.pack(jnp.asarray(prio), jnp.asarray(ids), b))
    got = tuples.pack(torch.from_numpy(prio.astype(np.int64)),
                      torch.from_numpy(ids.astype(np.int64)), b)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        tuples.unpack_id(got, b).numpy().astype(np.uint32),
        np.asarray(ref_tuples.unpack_id(jnp.asarray(want), b)))
    eff = tuples.effective_priority(torch.from_numpy(prio.astype(np.int64)), b)
    np.testing.assert_array_equal(
        eff.numpy().astype(np.uint32),
        np.asarray(ref_tuples.effective_priority(jnp.asarray(prio), b)))


def test_stored_and_widened_words():
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     dtype=np.uint32)
    stored = torch.from_numpy(words.view(np.int32))
    wide = tuples.widen(stored)
    np.testing.assert_array_equal(wide.numpy(), words.astype(np.int64))
    assert torch.equal(tuples.narrow(wide), stored)
    want = np.asarray(ref_tuples.is_undecided(jnp.asarray(words)))
    np.testing.assert_array_equal(tuples.is_undecided(stored).numpy(), want)
    np.testing.assert_array_equal(tuples.is_undecided(wide).numpy(), want)
