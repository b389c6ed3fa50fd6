"""The degree-aware hybrid path of the port (sliced ELL + COO spill) against
the JAX package: the layout arrays, the sliced and spill passes' twins
against the reference's ops, the ``cuda_hybrid`` MIS-2 (digests, iterations
and traffic integers against ``pallas_hybrid``), hybrid coarsening and
``luby_hybrid`` coloring, the ``engine=None`` rule and the overflow
message.  All integer: every comparison is exact."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.graphs import csr_to_hybrid_ell as ref_csr_to_hybrid
from repro.graphs import generators as ref_gen
from repro.kernels.minprop_ell import ops as ref_ops
from repro_torch.core.mis2_hybrid import hybrid_fixed_point
from repro_torch.core.tuples import IN, id_bits
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs import handle as port_handle
from repro_torch.graphs import hybrid as port_hybrid
from repro_torch.kernels.minprop_ell import ops, ref

from _torch_common import (
    CPU,
    hybrid_active,
    port_hybrid_graph,
    ref_hybrid_coarsen,
    ref_hybrid_color,
    ref_hybrid_graph,
    ref_hybrid_mis2,
)

PRIORITIES = ["xorshift_star", "xorshift", "fixed"]


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _forced_spill_cap(name: str) -> int:
    """A spill cap that leaves exactly the max-degree row in the spill."""
    deg = np.diff(np.asarray(ref_hybrid_graph(name).csr.indptr))
    return max(int(np.sort(deg)[-2]), port_hybrid.MIN_SLICE_WIDTH)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

LAYOUTS = {
    "laplace3d-default": ("laplace3d", {}),
    "er-default": ("er_random", {}),
    "powerlaw-default": ("powerlaw", {}),
    "er-forced-spill": ("er_random", {"spill_cap": "forced"}),
    "powerlaw-spill16": ("powerlaw", {"spill_cap": 16}),
    "powerlaw-widths": ("powerlaw", {"widths": (8, 32, 64)}),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_layout_arrays_equal_reference(case):
    name, kw = LAYOUTS[case]
    if kw.get("spill_cap") == "forced":
        kw = {"spill_cap": _forced_spill_cap(name)}
    want = ref_csr_to_hybrid(ref_hybrid_graph(name).csr, **kw)
    got = port_hybrid_graph(name).hybrid(**kw)
    assert got.slice_widths == want.slice_widths
    assert (got.num_vertices, got.spill_cap) == (want.num_vertices,
                                                 want.spill_cap)
    for a, b in zip(got.slices, want.slices):
        for x, y in zip(a, b):            # rows, neighbors, mask
            assert _np(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(_np(x), np.asarray(y))
    for key in ("spill_rows", "spill_seg", "spill_cols"):
        np.testing.assert_array_equal(_np(getattr(got, key)),
                                      np.asarray(getattr(want, key)))
    assert got.padded_bytes == want.padded_bytes
    assert got.padding_ratio == want.padding_ratio
    if case == "er-forced-spill":
        deg = np.diff(ref_hybrid_graph(name).csr.indptr)
        assert _np(got.spill_rows).tolist() == [int(deg.argmax())]


def test_explicit_widths_must_cover():
    g = port_hybrid_graph("er_random")
    with pytest.raises(ValueError, match="do not cover"):
        g.hybrid(widths=(4,), spill_cap=10_000)


def test_handle_caches_hybrid_and_never_builds_ell():
    g = port_hybrid_graph("powerlaw")
    assert g.hybrid() is g.hybrid()
    assert g.hybrid(spill_cap=16) is not g.hybrid()
    assert g.conversions == {"csr_to_hybrid": 2}
    rt.mis2(g, engine="cuda_hybrid", backend=CPU)
    assert "csr_to_ell" not in g.conversions
    assert g.ell_bytes_estimate() == ref_hybrid_graph(
        "powerlaw").ell_bytes_estimate()
    cached = g.hybrid()
    g.place("meta")                       # the cached layout moves along
    assert g.hybrid() is not cached
    assert {x.device.type for sl in g.hybrid().slices for x in sl} == {"meta"}
    assert g.hybrid().spill_cols.device.type == "meta"
    assert g.conversions["csr_to_hybrid"] == 2


def test_powerlaw_generator_equals_reference():
    want = ref_gen.powerlaw_graph(2000, 8.0, seed=13)
    got = port_gen.powerlaw_graph(2000, 8.0, seed=13)
    np.testing.assert_array_equal(got.indptr, np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    assert port_hybrid_graph("powerlaw").digest == \
        ref_hybrid_graph("powerlaw").digest


# ---------------------------------------------------------------------------
# the sliced and spill passes against the reference's ops
# ---------------------------------------------------------------------------

def _pass_state(priority: str):
    """Random T / M / active on the power-law graph, the reference's layout
    and the port's, and a slab-local worklist of the 16-wide slab whose
    first ``count`` slots hold distinct rows and some sentinels R (the
    rest sentinels: the resident loop's invariant)."""
    name = "powerlaw"
    ref_hyb = ref_hybrid_graph(name).hybrid()
    hyb = port_hybrid_graph(name).hybrid()
    v = hyb.num_vertices
    rng = np.random.default_rng(len(priority))
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = 0xFFFFFFFF
    active = rng.random(v) < 0.9
    live = rng.random(v) < 0.7
    r = hyb.slices[1].num_rows
    count = int(r * 0.6)
    wl = np.full(r, r, dtype=np.int32)
    wl[:count] = rng.permutation(r)[:count]
    wl[:count][rng.random(count) < 0.1] = r
    it = int(rng.integers(0, 9))
    return dict(ref_hyb=ref_hyb, hyb=hyb, t=t, m=m, active=active, live=live,
                wl=wl, count=count, it=it, b=id_bits(v))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("which", ["sliced_refresh_columns", "sliced_decide",
                                   "sliced_decide_unmasked",
                                   "spill_refresh_columns", "spill_decide"])
def test_pass_twin_equals_reference_ops(which, priority):
    """Each pass's twin against the reference's op; ``_unmasked``: the
    slab decide on the word ``active ? M : IN`` with ``active=None``, equal
    to the reference's gated decide wherever M holds no IN (the hybrid
    loop's M never does)."""
    s = _pass_state(priority)
    kw = dict(priority=priority, b=s["b"])
    sl, ref_sl = s["hyb"].slices[1], s["ref_hyb"].slices[1]
    hyb, rh = s["hyb"], s["ref_hyb"]
    if which == "sliced_decide_unmasked":
        s["m"] = np.where(s["m"] == 0, np.uint32(1), s["m"])
    t, m = _i32(s["t"]), _i32(s["m"])
    active = torch.from_numpy(s["active"])
    it = torch.tensor([s["it"]], dtype=torch.int32)
    jt, jm = jnp.asarray(s["t"]), jnp.asarray(s["m"])
    jit = jnp.uint32(s["it"])
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    ref_spill = (rh.spill_rows, rh.spill_seg, rh.spill_cols)
    before = dict(ops.LAUNCHES)
    if which.startswith("sliced"):
        slab = (sl.rows, sl.neighbors.reshape(-1), torch.from_numpy(s["wl"]),
                torch.tensor([s["count"]], dtype=torch.int32), it)
        ref_slab = (ref_sl.rows, ref_sl.neighbors.reshape(-1),
                    jnp.asarray(s["wl"]), s["count"], jit)
        if which == "sliced_refresh_columns":
            want = ref_ops.sliced_refresh_columns(
                jt, jm, *ref_slab, d=sl.width, interpret=True, **kw)
            got = ops.sliced_refresh_columns(t, m, *slab, **kw)
        else:
            want = ref_ops.sliced_decide(
                jt, jm, jnp.asarray(s["active"]), *ref_slab, d=sl.width,
                interpret=True, **kw)
            if which.endswith("_unmasked"):
                word = torch.where(active, m, IN).to(torch.int32)
                got = ops.sliced_decide(t, word, None, *slab, **kw)
                m = word
            else:
                got = ops.sliced_decide(t, m, active, *slab, **kw)
    elif which == "spill_refresh_columns":
        want = ref_ops.spill_refresh_columns(
            jt, jm, *ref_spill, jnp.asarray(s["live"]), jit, **kw)
        got = ref.spill_refresh_columns(t, m, *spill,
                                        torch.from_numpy(s["live"]), it, **kw)
    else:
        want = ref_ops.spill_decide(jt, jm, jnp.asarray(s["active"]),
                                    *ref_spill, jit, **kw)
        got = ref.spill_decide(t, m, active, *spill, it, **kw)
    assert got is (m if "refresh" in which else t)      # in place
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert ops.LAUNCHES == before        # the CPU twin is no kernel launch


def test_sliced_wrappers_validate_arguments():
    s = _pass_state("fixed")
    sl = s["hyb"].slices[1]
    t, m = _i32(s["t"]), _i32(s["m"])
    wl = torch.from_numpy(s["wl"])
    one = torch.ones(1, dtype=torch.int32)
    kw = dict(priority="fixed", b=s["b"])
    with pytest.raises(ValueError, match="multiple"):
        ops.sliced_refresh_columns(t, m, sl.rows, sl.neighbors.reshape(-1)[1:],
                                   wl, one, one, **kw)
    with pytest.raises(TypeError, match="slab_rows"):
        ops.sliced_refresh_columns(t, m, sl.rows.to(torch.int64),
                                   sl.neighbors.reshape(-1), wl, one, one, **kw)
    with pytest.raises(ValueError, match="active"):
        ops.sliced_decide(t, m, torch.ones(3, dtype=torch.bool), sl.rows,
                          sl.neighbors.reshape(-1), wl, one, one, **kw)


# ---------------------------------------------------------------------------
# end to end against pallas_hybrid
# ---------------------------------------------------------------------------

MIS2_CASES = [("powerlaw", p, None) for p in PRIORITIES] + [
    ("laplace3d", "xorshift_star", None),
    ("er_random", "xorshift_star", None),
    ("powerlaw", "xorshift_star", "random"),
    ("powerlaw", "xorshift_star", "none"),
]


@pytest.mark.parametrize("name,priority,active", MIS2_CASES,
                         ids=["-".join(map(str, c)) for c in MIS2_CASES])
def test_mis2_hybrid_equals_pallas_hybrid(name, priority, active):
    want = ref_hybrid_mis2(name, priority, active)
    mask = hybrid_active(name, active)
    got = rt.mis2(port_hybrid_graph(name), engine="cuda_hybrid", active=mask,
                  options=rt.Mis2Options(priority=priority), backend=CPU)
    assert (got.digest, got.size, got.iterations, got.converged) == (
        want.digest, want.size, want.iterations, want.converged)
    assert got.collectives == want.collectives
    assert got.collectives["row_bytes_total"] == ops.hybrid_row_traffic_bytes(
        got.collectives["slice_widths"],
        got.collectives["slice_rows_processed"],
        got.collectives["spill_entries"], got.collectives["spill_passes"])
    assert got.engine == "cuda_hybrid"
    assert got.host_syncs == got.iterations + 1
    if mask is not None:
        assert not (got.in_set & ~mask).any()


def test_mis2_hybrid_equals_resident_on_laplace3d():
    g = port_hybrid_graph("laplace3d")
    a = rt.mis2(g, engine="cuda_hybrid", backend=CPU)
    b = rt.mis2(g, engine="cuda_resident", backend=CPU)
    assert (a.digest, a.iterations) == (b.digest, b.iterations)
    assert b.collectives is None


def test_forced_spill_row_goes_through_the_spill_passes():
    """The max-degree row of the ER graph alone in the spill: the fixed
    point still gives the reference's set."""
    g = port_hybrid_graph("er_random")
    hyb = g.hybrid(spill_cap=_forced_spill_cap("er_random"))
    assert hyb.num_spill_rows == 1
    v = hyb.num_vertices
    t, iters, n1, acc, _ = hybrid_fixed_point(
        hyb, torch.ones(v, dtype=torch.bool), priority="xorshift_star",
        max_iters=128, b=id_bits(v))
    want = ref_hybrid_mis2("er_random")
    got = rt.Result((t == IN).numpy())
    assert (got.digest, iters, int(n1.item())) == (want.digest,
                                                   want.iterations, 0)


def test_single_vertex_graph():
    g = rt.Graph(rt.graphs.csr_from_coo(np.array([0]), np.array([0]), 1),
                 device="cpu")
    assert g.hybrid().num_slices == 1
    r = rt.mis2(g, engine="cuda_hybrid", backend=CPU)
    assert r.in_set.tolist() == [True]
    assert r.digest == rt.mis2(g, engine="dense", backend=CPU).digest


@pytest.mark.parametrize("method", ["basic", "two_phase"])
def test_coarsen_hybrid_equals_reference(method):
    want = ref_hybrid_coarsen("powerlaw", method)
    got = rt.coarsen(port_hybrid_graph("powerlaw"), method=method,
                     mis2_engine="cuda_hybrid", backend=CPU)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.roots, want.roots)
    np.testing.assert_array_equal(got.phase, want.phase)
    assert (got.num_aggregates, got.iterations, got.digest) == (
        want.num_aggregates, want.iterations, want.digest)
    assert got.engine == "cuda_hybrid"


@pytest.mark.parametrize("name", ["laplace3d", "powerlaw"])
def test_color_hybrid_equals_reference(name):
    want = ref_hybrid_color(name)
    got = rt.color(port_hybrid_graph(name), engine="luby_hybrid", backend=CPU)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert (got.num_colors, got.rounds, got.converged) == (
        want.num_colors, want.rounds, want.converged)
    assert got.host_syncs == got.rounds


# ---------------------------------------------------------------------------
# engine=None past the threshold, and the overflow message
# ---------------------------------------------------------------------------

def test_auto_selection_takes_hybrid_past_threshold(monkeypatch):
    g = port_hybrid_graph("powerlaw")
    monkeypatch.setattr(port_hybrid, "HYBRID_AUTO_BYTES",
                        g.ell_bytes_estimate() - 1)
    r = rt.mis2(g, backend=CPU)
    assert r.engine == "cuda_hybrid"
    assert r.digest == ref_hybrid_mis2("powerlaw").digest
    a = rt.coarsen(g, method="basic", backend=CPU)
    assert a.engine == "cuda_hybrid"
    assert a.digest == ref_hybrid_coarsen("powerlaw", "basic").digest
    assert "csr_to_ell" not in g.conversions


def test_auto_selection_keeps_resident_below_threshold(monkeypatch):
    g = port_hybrid_graph("er_random")
    monkeypatch.setattr(port_hybrid, "HYBRID_AUTO_BYTES",
                        g.ell_bytes_estimate() + 1)
    assert rt.mis2(g, backend=CPU).engine == "cuda_resident"
    assert rt.coarsen(g, backend=CPU).engine == "cuda_resident"


def test_overflow_names_the_hybrid_path(monkeypatch):
    g = port_hybrid_graph("powerlaw")
    monkeypatch.setattr(port_handle, "ELL_BYTE_LIMIT",
                        g.ell_bytes_estimate() - 1)
    with pytest.raises(port_handle.LayoutOverflowError,
                       match=r"engine='cuda_hybrid' / Graph\.hybrid\(\)") as e:
        _ = g.ell
    assert e.value.estimate == g.ell_bytes_estimate()
    assert "not ported" not in str(e.value)
    r = rt.mis2(g, engine="cuda_hybrid", backend=CPU)
    assert r.digest == ref_hybrid_mis2("powerlaw").digest
