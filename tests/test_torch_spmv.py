"""The twins of the ELL SpMV and hash-pack kernels against the JAX package's
Pallas kernels in interpret mode (``spmv_ell_pallas``, ``spmv_ell_t_pallas``,
``hash_pack_pallas``), and the transposed SpMV against the SpMV of the
explicit transpose, bit for bit.  The CUDA kernels are held against the
twins in ``test_torch_cuda.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_priority import kernel as ref_hash_kernel
from repro.kernels.spmv_ell import kernel as ref_kernel
from repro_torch.kernels.hash_priority import ops as hash_ops
from repro_torch.kernels.spmv_ell import ops
from repro_torch.multilevel.prolongator import rect_ell

EPS32 = 2.0 ** -23


def _coo(rows: int, ncols: int, max_deg: int, seed: int):
    """Random COO with distinct (row, col) pairs: ragged row lengths in
    ``[0, max_deg]`` (some rows empty), float32 values."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, size=rows)
    deg[rng.random(rows) < 0.1] = 0
    r = np.repeat(np.arange(rows), deg)
    c = np.concatenate([rng.choice(ncols, size=k, replace=False)
                        for k in deg]).astype(np.int64)
    v = rng.standard_normal(len(r)).astype(np.float32)
    return r, c, v


def _square_ell(v: int, d: int, seed: int):
    """Square ELL with the graph convention: padding col = row, val 0."""
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(v, dtype=np.int32)[:, None], d, axis=1)
    vals = np.zeros((v, d), dtype=np.float32)
    deg = rng.integers(0, d + 1, size=v)
    for i in range(v):
        cols[i, :deg[i]] = rng.choice(v, size=deg[i], replace=False)
        vals[i, :deg[i]] = rng.standard_normal(deg[i])
    return cols, vals


def _bound(cols, vals, x) -> np.ndarray:
    """Per-row rounding bound D * 2^-23 * sum_j |a_ij x_j| (plus the
    smallest normal, for rows summing to ~0)."""
    d = cols.shape[1]
    return d * EPS32 * np.abs(vals * x[cols]).sum(axis=1) + 1e-38


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(300, 7), (257, 1), (100, 81)],
                         ids=["ragged-tail", "width-1", "wide"])
def test_spmv_twin_matches_pallas_interpret_square(shape):
    v, d = shape
    cols, vals = _square_ell(v, d, seed=v + d)
    x = np.random.default_rng(1).standard_normal(v).astype(np.float32)
    want = np.asarray(ref_kernel.spmv_ell_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), interpret=True))
    before = dict(ops.LAUNCHES)
    got = ops.spmv(_t(cols), _t(vals), _t(x)).numpy()
    assert ops.LAUNCHES == before      # the CPU twin is no kernel launch
    assert (np.abs(got - want) <= _bound(cols, vals, x)).all()


def test_spmv_twin_matches_pallas_interpret_rectangular():
    r, c, val = _coo(300, 37, 6, seed=2)
    p = rect_ell(r, c, val, 300, "cpu")
    cols, vals = p.cols.numpy(), p.vals.numpy()
    x = np.random.default_rng(3).standard_normal(37).astype(np.float32)
    want = np.asarray(ref_kernel.spmv_ell_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), interpret=True))
    got = ops.spmv(p.cols, p.vals, _t(x)).numpy()
    assert (np.abs(got - want) <= _bound(cols, vals, x)).all()
    assert (got[~p.mask.numpy().any(axis=1)] == 0).all()    # empty rows


@pytest.mark.parametrize("rows,num_out,max_deg", [(300, 37, 6), (64, 200, 3)],
                         ids=["tall", "wide-sparse"])
def test_spmv_t_twin_matches_pallas_interpret(rows, num_out, max_deg):
    r, c, val = _coo(rows, num_out, max_deg, seed=rows)
    p = rect_ell(r, c, val, rows, "cpu")
    x = np.random.default_rng(4).standard_normal(rows).astype(np.float32)
    want = np.asarray(ref_kernel.spmv_ell_t_pallas(
        jnp.asarray(p.cols.numpy()), jnp.asarray(p.vals.numpy()),
        jnp.asarray(x), num_out=num_out, interpret=True))
    t = ops.ell_transpose(p.cols, p.mask, num_out)
    got = ops.spmv_t(p.vals, t, _t(x)).numpy()
    terms = np.zeros(num_out)
    np.add.at(terms, c, np.abs(val * x[r]))
    bound = max(p.cols.shape[1], t.max_len) * EPS32 * terms + 1e-38
    assert (np.abs(got - want) <= bound).all()
    assert (got[np.bincount(c, minlength=num_out) == 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spmv_t_of_p_equals_spmv_of_explicit_r_bitwise(seed):
    """``R = rect_ell(cols, rows)`` lists each coarse row's entries by
    ascending fine row, the order the transposed gather sums in."""
    rows, num_out = 500, 61
    r, c, val = _coo(rows, num_out, 9, seed=seed)
    p = rect_ell(r, c, val, rows, "cpu")
    rt_ = rect_ell(c, r, val, num_out, "cpu")
    x = _t(np.random.default_rng(seed).standard_normal(rows)
           .astype(np.float32))
    got = ops.spmv_t(p.vals, ops.ell_transpose(p.cols, p.mask, num_out), x)
    want = ops.spmv(rt_.cols, rt_.vals, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ell_transpose_plan():
    r, c, val = _coo(120, 17, 5, seed=9)
    p = rect_ell(r, c, val, 120, "cpu")
    t = ops.ell_transpose(p.cols, p.mask, 17)
    counts = np.bincount(c, minlength=17)
    assert t.num_out == 17 and t.max_len == counts.max()
    np.testing.assert_array_equal(t.offsets.numpy(),
                                  np.r_[0, np.cumsum(counts)])
    d = p.cols.shape[1]
    perm = t.perm.numpy()
    keys = p.cols.numpy().reshape(-1)[perm].astype(np.int64) * 120 + perm // d
    assert (np.diff(keys) > 0).all()      # by column, then ascending row
    assert p.mask.numpy().reshape(-1)[perm].all()
    with pytest.raises(ValueError, match="num_out"):
        ops.ell_transpose(p.cols, p.mask, 5)


@pytest.mark.parametrize("bad,err", [
    (lambda a: a.update(cols=a["cols"].to(torch.int64)), TypeError),
    (lambda a: a.update(vals=a["vals"].to(torch.float64)), TypeError),
    (lambda a: a.update(vals=a["vals"][:, :2]), ValueError),
    (lambda a: a.update(x=a["x"][None]), ValueError),
    (lambda a: a.update(cols=a["cols"].t().contiguous().t()), ValueError),
    (lambda a: a.update(x=a["x"].to("meta")), ValueError),
], ids=["cols-int64", "vals-f64", "vals-narrow", "x-2d", "cols-strided",
        "x-meta"])
def test_spmv_validates_arguments(bad, err):
    cols, vals = _square_ell(10, 3, seed=0)
    a = {"cols": _t(cols), "vals": _t(vals), "x": torch.ones(10)}
    bad(a)
    with pytest.raises(err):
        ops.spmv(a["cols"], a["vals"], a["x"])


def test_spmv_t_validates_arguments():
    r, c, val = _coo(30, 7, 3, seed=1)
    p = rect_ell(r, c, val, 30, "cpu")
    t = ops.ell_transpose(p.cols, p.mask, 7)
    with pytest.raises(ValueError, match="rows"):
        ops.spmv_t(p.vals, t, torch.ones(29))
    with pytest.raises(TypeError):
        ops.spmv_t(p.vals, t._replace(perm=t.perm.long()), torch.ones(30))


@pytest.mark.parametrize("iteration", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("ids", ["arange", "random"])
def test_hash_pack_twin_matches_pallas_interpret(ids, iteration):
    n = 3000
    rng = np.random.default_rng(iteration % 97)
    vid = np.arange(n, dtype=np.uint32) if ids == "arange" else \
        rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    for b in (1, 12, 31):
        want = np.asarray(ref_hash_kernel.hash_pack_pallas(
            iteration, jnp.asarray(vid), b, interpret=True))
        before = dict(hash_ops.LAUNCHES)
        got = hash_ops.hash_pack(_t(vid.view(np.int32)),
                                 torch.tensor([iteration], dtype=torch.int32),
                                 b)
        assert hash_ops.LAUNCHES == before
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_hash_pack_validates_arguments():
    ids = torch.arange(8, dtype=torch.int32)
    it = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="id bits"):
        hash_ops.hash_pack(ids, it, 32)
    with pytest.raises(ValueError, match="one element"):
        hash_ops.hash_pack(ids, torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(TypeError):
        hash_ops.hash_pack(ids.long(), it, 4)
