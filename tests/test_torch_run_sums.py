"""The run-sum kernel's plain-torch twin against the host engine's ordered
run sums (``_run_sums_host``, numpy ``np.add.at`` over the sorted stream),
bitwise: runs of every length from 1 up, exact-zero totals, ±0.0; and, on
a card, the CUDA kernel against the twin.

This file imports neither jax nor ``repro``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.run_sums import ops, ref
from repro_torch.multilevel.galerkin import _run_sums_device, _run_sums_host

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - the image may lack hypothesis
    from _hypothesis_fallback import given, settings, st


def _stream(seed: int, runs: int, max_len: int):
    """A sorted key stream of ``runs`` runs of 1..max_len entries; values
    with cancelling pairs (exact-zero totals), ±0.0 and a spread of
    magnitudes, so that the order of the adds shows in the bits."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, runs)
    keys = np.repeat(np.sort(rng.choice(10 * runs + 1, runs, replace=False)),
                     lens).astype(np.int64)
    vals = rng.standard_normal(len(keys)) * 10.0 ** rng.integers(-8, 9,
                                                                 len(keys))
    vals[rng.random(len(keys)) < 0.1] = 0.0
    vals[rng.random(len(keys)) < 0.1] = -0.0
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    for s, n in zip(starts, lens):         # some runs cancel exactly
        if n >= 2 and rng.random() < 0.2:
            vals[s + 1] = -vals[s]
            vals[s + 2:s + n] = 0.0
    return keys, vals, starts


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).view(np.int64)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 300), st.integers(1, 40))
def test_twin_sums_each_run_in_order(seed, runs, max_len):
    keys, vals, starts = _stream(seed, runs, max_len)
    want_keys, want_sums = _run_sums_host(keys, vals)
    k, s, keep = ops.run_sums(torch.from_numpy(keys), torch.from_numpy(vals),
                              torch.from_numpy(starts))
    assert torch.equal(keep, s != 0.0)
    np.testing.assert_array_equal(k[keep].numpy(), want_keys)
    np.testing.assert_array_equal(_bits(s[keep].numpy()), _bits(want_sums))
    np.testing.assert_array_equal(k.numpy(), keys[starts])


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 200))
def test_sorted_stage_matches_host_on_unsorted_keys(seed, n):
    """The device stage (stable sort, heads, run sums) equals the host's on
    a shuffled stream with repeated keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(1, n // 3), n).astype(np.int64)
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    vals[rng.random(n) < 0.2] = -0.0
    want_keys, want_sums = _run_sums_host(keys, vals)
    k, s, keep = _run_sums_device(torch.from_numpy(keys),
                                  torch.from_numpy(vals))
    np.testing.assert_array_equal(k[keep].numpy(), want_keys)
    np.testing.assert_array_equal(_bits(s[keep].numpy()), _bits(want_sums))


def test_single_runs_zero_totals_and_empty_stream():
    before = ops.LAUNCHES["run_sums"]
    keys = torch.tensor([3, 3, 5, 7, 7, 7, 9], dtype=torch.int64)
    vals = torch.tensor([1.5, -1.5, -0.0, 1e300, 1.0, -1e300, 2.0],
                        dtype=torch.float64)
    starts = torch.tensor([0, 2, 3, 6], dtype=torch.int64)
    k, s, keep = ops.run_sums(keys, vals, starts)
    assert k.tolist() == [3, 5, 7, 9]
    assert s.tolist() == [0.0, -0.0, 0.0, 2.0]        # 1e300 + 1 - 1e300
    assert keep.tolist() == [False, False, False, True]
    empty = torch.zeros(0, dtype=torch.int64)
    k, s, keep = ops.run_sums(empty, empty.double(), empty)
    assert k.numel() == s.numel() == keep.numel() == 0
    assert ops.LAUNCHES["run_sums"] == before      # twins are not counted


def test_wrapper_checks_its_inputs():
    keys = torch.zeros(4, dtype=torch.int64)
    starts = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(TypeError, match="vals"):
        ops.run_sums(keys, torch.zeros(4, dtype=torch.float32), starts)
    with pytest.raises(TypeError, match="keys"):
        ops.run_sums(keys.to(torch.int32), torch.zeros(4).double(), starts)
    with pytest.raises(ValueError, match="vals"):
        ops.run_sums(keys, torch.zeros(3, dtype=torch.float64), starts)
    with pytest.raises(TypeError, match="starts"):
        ops.run_sums(keys, torch.zeros(4).double(), starts[None])


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("runs,max_len", [(1, 1), (1000, 1), (5000, 40),
                                          (37, 20000)])
def test_kernel_matches_twin_on_card(cuda_device, runs, max_len):
    keys, vals, starts = (torch.from_numpy(x).to(cuda_device)
                          for x in _stream(runs + max_len, runs, max_len))
    before = ops.LAUNCHES["run_sums"]
    got = ops.run_sums(keys, vals, starts)
    want = ref.run_sums_ref(keys, vals, starts)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["run_sums"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1].view(torch.int64), want[1].view(torch.int64))
