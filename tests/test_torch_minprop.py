"""The twins of the fused MIS-2 kernels against the JAX package's oracles
(``fused_*_ref`` followed by the ops wrapper's drop-scatter) and, once, the
Pallas kernels in interpret mode.  The CUDA kernels are held against the
twins in ``test_torch_cuda.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro.kernels.minprop_ell import kernel as ref_kernel
from repro.kernels.minprop_ell import ref as ref_oracle
from repro_torch.core.tuples import id_bits
from repro_torch.kernels.minprop_ell import ops


PRIORITIES = ["xorshift_star", "xorshift", "fixed"]


def _inputs(graph, count_frac: float, seed: int):
    """ELL adjacency, random T/M/active and a worklist whose first ``count``
    slots hold distinct rows with some sentinels; the rest are sentinels
    (the resident loop's invariant)."""
    ell = ref_csr.csr_to_ell_graph(graph)
    nbrs = np.array(ell.neighbors)
    v = nbrs.shape[0]
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    active = rng.random(v) < 0.9
    count = max(1, int(v * count_frac))
    wl = np.full(v, v, dtype=np.int32)
    wl[:count] = rng.permutation(v)[:count]
    wl[:count][rng.random(count) < 0.1] = v
    it = int(rng.integers(0, 9))
    return nbrs, t, m, active, wl, count, it


def _port(nbrs, t, m, active, wl, count, it, device="cpu"):
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    return dict(t=as_i32(t).to(device), m=as_i32(m).to(device),
                active=torch.from_numpy(active).to(device),
                nbrs_flat=torch.from_numpy(nbrs.reshape(-1)).to(device),
                wl=torch.from_numpy(wl).to(device),
                count=torch.tensor([count], dtype=torch.int32, device=device),
                it=torch.tensor([it], dtype=torch.int32, device=device))


def _drop_scatter(x, wl, vals):
    return np.asarray(jnp.asarray(x).at[jnp.asarray(wl)].set(vals,
                                                              mode="drop"))


def _as_u32(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


GRAPHS = {
    "uniform": lambda: ref_gen.random_uniform_graph(700, 7.0, seed=3),
    "elasticity": lambda: ref_gen.elasticity3d(3).graph,
}


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("count_frac", [1.0, 0.4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_refresh_columns_twin_matches_reference(graph, count_frac, priority):
    nbrs, t, m, active, wl, count, it = _inputs(GRAPHS[graph](), count_frac,
                                                seed=len(priority))
    b = id_bits(nbrs.shape[0])
    out = ref_oracle.fused_refresh_columns_ref(
        jnp.asarray(t), jnp.asarray(nbrs), jnp.asarray(wl), count,
        jnp.uint32(it), priority, b)
    want = _drop_scatter(m, wl, out)
    x = _port(nbrs, t, m, active, wl, count, it)
    before = dict(ops.LAUNCHES)
    got = ops.fused_refresh_columns(x["t"], x["m"], x["nbrs_flat"], x["wl"],
                                    x["count"], x["it"], priority=priority,
                                    b=b)
    assert got is x["m"]
    np.testing.assert_array_equal(_as_u32(got), want)
    assert ops.LAUNCHES == before      # the CPU twin is no kernel launch


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("count_frac", [1.0, 0.4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_decide_twin_matches_reference(graph, count_frac, priority):
    nbrs, t, m, active, wl, count, it = _inputs(GRAPHS[graph](), count_frac,
                                                seed=8 + len(priority))
    b = id_bits(nbrs.shape[0])
    out = ref_oracle.fused_decide_ref(
        jnp.asarray(t), jnp.asarray(m), jnp.asarray(active),
        jnp.asarray(nbrs), jnp.asarray(wl), count, jnp.uint32(it), priority,
        b)
    want = _drop_scatter(t, wl, out)
    x = _port(nbrs, t, m, active, wl, count, it)
    got = ops.fused_decide(x["t"], x["m"], x["active"], x["nbrs_flat"],
                           x["wl"], x["count"], x["it"], priority=priority,
                           b=b)
    assert got is x["t"]
    np.testing.assert_array_equal(_as_u32(got), want)


@pytest.mark.parametrize("which", ["refresh", "decide"])
def test_twins_match_pallas_interpret(which):
    nbrs, t, m, active, wl, count, it = _inputs(
        ref_gen.random_uniform_graph(64, 5.0, seed=1), 0.6, seed=4)
    b = id_bits(nbrs.shape[0])
    x = _port(nbrs, t, m, active, wl, count, it)
    args = (jnp.asarray(nbrs.reshape(-1)), jnp.asarray(wl), jnp.int32(count),
            jnp.uint32(it))
    kw = dict(priority="xorshift_star", b=b, interpret=True)
    if which == "refresh":
        out = ref_kernel.fused_refresh_columns_pallas(jnp.asarray(t), *args,
                                                      **kw)
        want = _drop_scatter(m, wl, out)
        got = ops.fused_refresh_columns(
            x["t"], x["m"], x["nbrs_flat"], x["wl"], x["count"], x["it"],
            priority="xorshift_star", b=b)
    else:
        out = ref_kernel.fused_decide_pallas(
            jnp.asarray(t), jnp.asarray(m), jnp.asarray(active), *args, **kw)
        want = _drop_scatter(t, wl, out)
        got = ops.fused_decide(
            x["t"], x["m"], x["active"], x["nbrs_flat"], x["wl"], x["count"],
            x["it"], priority="xorshift_star", b=b)
    np.testing.assert_array_equal(_as_u32(got), want)


def _valid():
    nbrs, t, m, active, wl, count, it = _inputs(
        ref_gen.path_graph(20), 1.0, seed=0)
    return _port(nbrs, t, m, active, wl, count, it)


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.update(m=x["m"].to(torch.int64)), TypeError),
    (lambda x: x.update(active=x["active"].to(torch.int32)), TypeError),
    (lambda x: x.update(m=x["m"][:-1]), ValueError),
    (lambda x: x.update(nbrs_flat=x["nbrs_flat"][:-1]), ValueError),
    (lambda x: x.update(count=torch.zeros(2, dtype=torch.int32)), ValueError),
    (lambda x: x.update(m=torch.stack([x["m"], x["m"]], 1)[:, 0]), ValueError),
    (lambda x: x.update(t=x["t"].to("meta")), ValueError),
], ids=["m-int64", "active-int32", "m-short", "nbrs-ragged", "count-2",
        "m-strided", "t-meta"])
def test_wrappers_validate_arguments(bad, err):
    x = _valid()
    bad(x)
    with pytest.raises(err):
        ops.fused_decide(x["t"], x["m"], x["active"], x["nbrs_flat"], x["wl"],
                         x["count"], x["it"], priority="xorshift_star", b=5)


def test_wrappers_reject_bad_bits_and_priority():
    x = _valid()
    args = (x["t"], x["m"], x["nbrs_flat"], x["wl"], x["count"], x["it"])
    with pytest.raises(ValueError, match="id bits"):
        ops.fused_refresh_columns(*args, priority="fixed", b=32)
    with pytest.raises(ValueError, match="priority"):
        ops.fused_refresh_columns(*args, priority="lcg", b=5)
