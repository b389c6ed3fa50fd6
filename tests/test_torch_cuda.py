"""The port on a CUDA card: the hand-written kernels against their torch
twins, and the main path against the JAX package's digests (recorded
below, from ``repro.mis2`` / ``repro.coarsen`` with the
``compacted_resident`` engine, ``repro.color``, and ``repro.amg_setup`` /
``repro.cluster_gs_setup`` with the ``host`` engine).  Every test skips
without a card.

The slice-10 cases drive the ``resident`` multilevel engine (the
per-level setup on the card, ``engine=None`` there) against the ``host``
one, array for array; ``tests/test_torch_run_sums.py`` holds the run-sum
kernel against its twin.  The slice-3 cases hold the sliced kernels against their twins on random
hybrid slabs and drive the hybrid path (``cuda_hybrid``, hybrid
coarsening, ``luby_hybrid``) on ``powerlaw_graph(900, 8.0, seed=4)``
against the reference's ``pallas_hybrid`` / ``luby_hybrid`` results.  The
slice-4 cases hold the unfused ``refresh_columns`` / ``decide`` kernels
against their twins on pre-gathered rows (at every group shape of the
fused kernels and at the worklist's edges) and drive the host-driven
``cuda_compacted`` engine against the plain ``compacted`` one.  The
slice-14 cases hold the persistent kernel of ``cuda_resident`` against its
twin (capped rounds, a half mask) and count one launch and no host sync a
solve; the slice-15 cases do the same for the persistent kernels of
``cuda_hybrid`` and of the Luby loops (``luby``, ``luby_hybrid``); the
slice-16 cases hold the coarsening's join kernels (``root_join``,
``phase2_join``, ``phase3_fixed_point``) against their twins on the states
of a real coarsening and on seeded ones, over the padded ELL and the
hybrid layout, one launch a call, no host sync inside one, and a
cooperative grid that does not fit refused.  The slice-20 cases hold the
redesigned persistent kernels against their twins at every cap of their
loops: ``resident_fixed_point`` (a grid sized to V below and at the
card's co-resident count), its batched form on buckets whose members stop
at different rounds and its seeded form on a reseeded region, and
``phase3_fixed_point`` at 0-4 rounds on a star whose hub is unlabeled.

This file imports neither jax nor ``repro``, so that it runs on a machine
with only torch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.mis2_hybrid import hybrid_fixed_point
from repro_torch.core.tuples import id_bits
from repro_torch.graphs import generators as gen
from repro_torch.graphs.ops import spmv_ell
from repro_torch.kernels import _build
from repro_torch.kernels.hash_priority import ops as hash_ops
from repro_torch.kernels.hash_priority import ref as hash_ref
from repro_torch.kernels.joins import ops as join_ops
from repro_torch.kernels.joins import ref as join_ref
from repro_torch.kernels.luby import ops as luby_ops
from repro_torch.kernels.luby import ref as luby_ref
from repro_torch.kernels.minprop_ell import ops, ref
from repro_torch.kernels.misk import ops as misk_ops
from repro_torch.kernels.misk import ref as misk_ref
from repro_torch.kernels.run_sums import ops as run_ops
from repro_torch.kernels.run_sums import ref as run_ref
from repro_torch.kernels.spmv_ell import ops as spmv_ops
from repro_torch.kernels.spmv_ell import ref as spmv_ref
from repro_torch.multilevel.prolongator import rect_ell
from repro_torch.solvers import cg

pytestmark = pytest.mark.gpu

# graph -> (mis2 size, iterations, digest), (aggregates, MIS-2 iterations,
# two_phase digest); the reference's values
ANCHORS = {
    "laplace3d(8)": ((55, 6, "4dfc7dee5f0f7c7f"),
                     (82, 10, "dfda3c0aa9776009")),
    "laplace3d(12)": ((181, 7, "c179301ca5a7f8bf"),
                      (267, 12, "d8f3265623dd5f02")),
    "elasticity3d(4)": ((5, 5, "775ec02a191d8677"),
                        (7, 7, "af316f92f21b9539")),
}
GRAPHS = {
    "laplace3d(8)": lambda: gen.laplace3d(8),
    "laplace3d(12)": lambda: gen.laplace3d(12),
    "elasticity3d(4)": lambda: gen.elasticity3d(4),
}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(graph, device, seed: int):
    ell = rt.Graph(graph, device=device).ell
    v = ell.num_vertices
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    wl = rng.permutation(v).astype(np.int32)      # real rows past count
    wl[rng.random(v) < 0.1] = v                   # sentinels
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(t=to(t.view(np.int32)), m=to(m.view(np.int32)),
                active=to(rng.random(v) < 0.9),
                nbrs_flat=ell.neighbors.reshape(-1), wl=to(wl),
                count=torch.tensor([int(v * 0.6)], dtype=torch.int32,
                                   device=device),
                it=torch.tensor([3], dtype=torch.int32, device=device))


@pytest.mark.parametrize("priority", ["xorshift_star", "xorshift", "fixed"])
@pytest.mark.parametrize("name", ["laplace3d(12)", "elasticity3d(4)"])
def test_kernels_match_twins(cuda_device, name, priority):
    x = _state(GRAPHS[name](), cuda_device, seed=len(priority))
    y = {k: v.clone() for k, v in x.items()}
    kw = dict(priority=priority, b=id_bits(x["t"].shape[0]))
    before = dict(ops.LAUNCHES)
    ops.fused_refresh_columns(x["t"], x["m"], x["nbrs_flat"], x["wl"],
                              x["count"], x["it"], **kw)
    ref.fused_refresh_columns_ref(y["t"], y["m"], y["nbrs_flat"], y["wl"],
                                  y["count"], y["it"], **kw)
    ops.fused_decide(x["t"], x["m"], x["active"], x["nbrs_flat"], x["wl"],
                     x["count"], x["it"], **kw)
    ref.fused_decide_ref(y["t"], y["m"], y["active"], y["nbrs_flat"],
                         y["wl"], y["count"], y["it"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(x["m"], y["m"]) and torch.equal(x["t"], y["t"])
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 1, "fused_decide": 1,
        "sliced_refresh_columns": 0, "sliced_decide": 0,
        "refresh_columns": 0, "decide": 0, "resident_fixed_point": 0,
        "resident_fixed_point_batched": 0, "resident_fixed_point_seeded": 0,
        "hybrid_fixed_point": 0}


# the fused kernels at the group shapes the host picks from D: G = 1 to 32
# lanes a row, each lane loading chunks of 1 to 16 of its slots at once,
# several chunks a row at D = 600
FUSED_WIDTHS = (1, 4, 5, 7, 8, 9, 16, 17, 32, 33, 81, 130, 600)
FUSED_V = 1037              # not a multiple of a block's 256 slots


def _sym_ell(v: int, d: int, rng) -> np.ndarray:
    """A symmetric circulant graph, relabelled at random, as an ELL
    ``[v, d]`` of closed neighbourhoods (the row's own id in one slot, and
    once more as padding where d is even), slots shuffled per row."""
    k = (d - 1) // 2
    offs = rng.choice(np.arange(1, v // 2), size=k, replace=False)
    base = np.arange(v)[:, None]
    cols = np.concatenate([base, (base + offs) % v, (base - offs) % v], 1)
    if cols.shape[1] < d:
        cols = np.concatenate([cols, base], 1)
    perm = rng.permutation(v)
    out = np.empty_like(cols)
    out[perm] = perm[cols]
    return rng.permuted(out, axis=1).astype(np.int32)


def _fused_case(d: int, device, seed: int, priority: str, *,
                w: int = FUSED_V, count: int = int(FUSED_V * 0.6),
                it: int = 2**31 - 1):
    """T with IN, OUT and undecided words, M random with some OUT, a
    tenth of the vertices inactive, and a worklist of ``w`` slots (some
    sentinels V) of which the first ``count`` are live.  ``m_round`` is M
    as a round leaves it (the twin's refresh of every row over T with IN
    made OUT), under which rows become IN."""
    v = FUSED_V
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.03] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = 0xFFFFFFFF
    wl = rng.permutation(v)[:w].astype(np.int32)
    wl[rng.random(w) < 0.1] = v
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x = dict(t=to(t.view(np.int32)), m=to(m.view(np.int32)),
             active=to(rng.random(v) < 0.9),
             nbrs_flat=to(_sym_ell(v, d, rng).reshape(-1)), wl=to(wl),
             count=torch.tensor([count], dtype=torch.int32, device=device),
             it=torch.tensor([it], dtype=torch.int32, device=device))
    x["m_round"] = ref.fused_refresh_columns_ref(
        torch.where(x["t"] == 0, -1, x["t"]), x["m"].clone(), x["nbrs_flat"],
        torch.arange(v, dtype=torch.int32, device=device),
        torch.tensor([v], dtype=torch.int32, device=device), x["it"],
        priority=priority, b=id_bits(v))
    return x


def _fused_pair(x, priority: str):
    """Kernel and twin of one refresh (on ``m``) and of two decides (on
    ``m`` and on ``m_round``): [(kernel's, twin's)] results."""
    kw = dict(priority=priority, b=id_bits(FUSED_V))
    common = (x["nbrs_flat"], x["wl"], x["count"], x["it"])
    mk, mr = x["m"].clone(), x["m"].clone()
    ops.fused_refresh_columns(x["t"], mk, *common, **kw)
    ref.fused_refresh_columns_ref(x["t"], mr, *common, **kw)
    pairs = [(mk, mr)]
    for m in (x["m"], x["m_round"]):
        tk, tr = x["t"].clone(), x["t"].clone()
        ops.fused_decide(tk, m, x["active"], *common, **kw)
        ref.fused_decide_ref(tr, m, x["active"], *common, **kw)
        pairs.append((tk, tr))
    torch.cuda.synchronize()
    return pairs


@pytest.mark.parametrize("priority", ["xorshift_star", "xorshift", "fixed"])
@pytest.mark.parametrize("d", FUSED_WIDTHS)
def test_fused_kernels_match_twins_at_every_width(cuda_device, d, priority):
    x = _fused_case(d, cuda_device, d + len(priority), priority)
    before = dict(ops.LAUNCHES)
    (mk, mr), (tk, tr), (tk_round, tr_round) = _fused_pair(x, priority)
    assert torch.equal(mk, mr) and not torch.equal(mk, x["m"])
    assert torch.equal(tk, tr) and torch.equal(tk_round, tr_round)
    assert ((tk == -1) & (x["t"] != -1)).any()          # new OUT
    if d > 1:                                           # else all IN
        assert ((tk_round != x["t"]) & (tk_round != 0)
                & (tk_round != -1)).any()               # refreshed tuples
    if d <= 17:                                         # wider: too few
        assert ((tk_round == 0) & (x["t"] != 0)).any()  # new IN
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 1, "fused_decide": 2,
        "sliced_refresh_columns": 0, "sliced_decide": 0,
        "refresh_columns": 0, "decide": 0, "resident_fixed_point": 0,
        "resident_fixed_point_batched": 0, "resident_fixed_point_seeded": 0,
        "hybrid_fixed_point": 0}


# (worklist slots, live count, it): no live slot; a count past the
# worklist's end (the kernel stops at its W slots); round 0
FUSED_EDGES = {"count-0": (FUSED_V, 0, 5),
               "count-past-w": (700, FUSED_V, 5),
               "it-0": (FUSED_V, FUSED_V, 0)}


@pytest.mark.parametrize("d", [7, 81])
@pytest.mark.parametrize("case", list(FUSED_EDGES))
def test_fused_kernels_at_the_worklist_edges(cuda_device, case, d):
    w, count, it = FUSED_EDGES[case]
    x = _fused_case(d, cuda_device, d, "xorshift_star", w=w, count=count,
                    it=it)
    pairs = _fused_pair(x, "xorshift_star")
    for got, want in pairs:
        assert torch.equal(got, want)
    if case == "count-0":
        assert torch.equal(pairs[0][0], x["m"])
        assert torch.equal(pairs[1][0], x["t"])


# the persistent kernel's cases: (max_iters, fraction of rows active);
# a mask of about half the rows is phase 2 of a coarsening
RESIDENT_CASES = [(1, 1.0), (2, 1.0), (4, 1.0), (128, 1.0), (128, 0.5),
                  (2, 0.5)]


@pytest.mark.parametrize("max_iters,frac", RESIDENT_CASES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_resident_fixed_point_kernel_matches_twin(cuda_device, name,
                                                  max_iters, frac):
    ell = rt.Graph(GRAPHS[name](), device=cuda_device).ell
    v = ell.num_vertices
    rng = np.random.default_rng(v)
    active = torch.from_numpy(rng.random(v) < frac).to(cuda_device)
    nbrs_flat = ell.neighbors.reshape(-1)
    kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=max_iters)
    before = ops.LAUNCHES["resident_fixed_point"]
    tk, sk = ops.resident_fixed_point(
        torch.empty(v, dtype=torch.int32, device=cuda_device),
        torch.empty(v, dtype=torch.int32, device=cuda_device), active,
        nbrs_flat, **kw)
    tr, sr = ref.resident_fixed_point_ref(
        torch.empty(v, dtype=torch.int32, device=cuda_device),
        torch.empty(v, dtype=torch.int32, device=cuda_device), active,
        nbrs_flat, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["resident_fixed_point"] - before == 1
    assert torch.equal(tk, tr) and sk.tolist() == sr.tolist()
    assert sk.tolist()[0] <= max_iters


@pytest.mark.parametrize("name", list(GRAPHS))
def test_cuda_resident_is_one_launch_and_no_host_sync(cuda_device,
                                                     no_twins_on_cuda, name):
    g = rt.Graph(GRAPHS[name]())
    want = rt.mis2(rt.Graph(GRAPHS[name](), device="cpu"), engine="dense",
                   backend=rt.Backend(device="cpu"))
    for opts in (rt.Mis2Options(), rt.Mis2Options(max_iters=2)):
        before = ops.LAUNCHES["resident_fixed_point"]
        with rt.obs.capture() as cap:
            r = rt.mis2(g, options=opts)
        assert ops.LAUNCHES["resident_fixed_point"] - before == 1
        assert r.host_syncs == 0 and cap.value("mis2.host_syncs") == 0
        assert cap.value("mis2.resident_dispatches") == 1
        if opts.max_iters == 2:
            assert r.iterations == 2 and not r.converged
        else:
            assert (r.digest, r.iterations) == (want.digest, want.iterations)


def test_wrapper_on_cuda_raises_instead_of_falling_back(cuda_device):
    x = _state(GRAPHS["laplace3d(8)"](), cuda_device, seed=0)
    with pytest.raises(ValueError, match="is on"):
        ops.fused_refresh_columns(x["t"], x["m"].cpu(), x["nbrs_flat"],
                                  x["wl"], x["count"], x["it"],
                                  priority="fixed", b=10)
    with pytest.raises(TypeError):
        ops.fused_decide(x["t"], x["m"], x["active"].to(torch.uint8),
                         x["nbrs_flat"], x["wl"], x["count"], x["it"],
                         priority="fixed", b=10)


def test_build_is_cached_by_source_hash(cuda_device):
    first = _build.build_all()
    assert first == _build.build_all()
    assert all(p.is_file() for p in first.values())


@pytest.mark.parametrize("name", list(ANCHORS))
def test_main_path_matches_reference_digests(cuda_device, name):
    (size, iters, digest), (nagg, agg_iters, agg_digest) = ANCHORS[name]
    g = rt.Graph(GRAPHS[name]())
    before = dict(ops.LAUNCHES)
    r = rt.mis2(g)
    assert (r.engine, r.size, r.iterations, r.digest) == (
        "cuda_resident", size, iters, digest)
    # one cooperative launch a solve, no host read inside it
    assert r.host_syncs == 0
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 0, "fused_decide": 0,
        "sliced_refresh_columns": 0, "sliced_decide": 0,
        "refresh_columns": 0, "decide": 0, "resident_fixed_point": 1,
        "resident_fixed_point_batched": 0, "resident_fixed_point_seeded": 0,
        "hybrid_fixed_point": 0}
    assert rt.mis2(g, engine="dense").digest == digest
    a = rt.coarsen(g, method="two_phase")
    assert (a.num_aggregates, a.iterations, a.digest) == (
        nagg, agg_iters, agg_digest)
    assert rt.coarsen(g, method="basic").digest == rt.coarsen(
        g, method="basic", backend=rt.Backend(device="cpu")).digest


# -- slice 2: SpMV, transposed SpMV, hash-pack; AMG and cluster GS ----------

# the reference's host engine on laplace3d(16) and its CG count (tol 1e-6)
L16_LEVELS = [(4096, 27136), (625, 17567), (27, 649)]
L16_DIGESTS = ["3079f70aeafb3316", "3b559532b398e5fc", "a8c5c06f3d2de1da"]
L16_CG_ITERS = 7


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _rand_coo(rows: int, ncols: int, max_deg: int, seed: int):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, size=rows)
    r = np.repeat(np.arange(rows), deg)
    c = np.concatenate([rng.choice(ncols, size=k, replace=False)
                        for k in deg]).astype(np.int64)
    return r, c, rng.standard_normal(len(r)).astype(np.float32)


def _rand_ell(rows: int, d: int, ncols: int, seed: int):
    """A random ELL ``[rows, d]`` with about a fifth of its slots padding
    (val 0, column 0)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, ncols, size=(rows, d)).astype(np.int32)
    vals = rng.standard_normal((rows, d)).astype(np.float32)
    pad = rng.random((rows, d)) < 0.2
    cols[pad], vals[pad] = 0, 0.0
    return cols, vals


# graphs, and random ELL widths: the kernel stages 256 rows a block at
# D <= 8, 64 at D = 81 and 32 at D = 96 (odd row strides for the even
# widths); 1,037 rows leave every width a ragged last block.  "unaligned"
# drops the first row of a [1038, 7] matrix: cols / vals then start 28
# bytes into their storage, and the kernel takes its 4-byte loads
SPMV_CASES = ["laplace3d(12)", "elasticity3d(4)",
              *(f"D={d}" for d in (1, 2, 7, 8, 81, 96)), "D=7-unaligned"]


@pytest.mark.parametrize("name", SPMV_CASES)
def test_spmv_kernel_matches_twin_bitwise(cuda_device, name):
    if name.startswith("D="):
        d = int(name[2:].split("-")[0])
        skip = int(name.endswith("unaligned"))
        cols, vals = _rand_ell(1037 + skip, d, 2000, seed=len(name))
        cols = torch.from_numpy(cols).to(cuda_device)[skip:]
        vals = torch.from_numpy(vals).to(cuda_device)[skip:]
        assert (cols.data_ptr() % 16 != 0) == bool(skip)
        n = 2000
    else:
        a = rt.Graph(GRAPHS[name](), device=cuda_device).ell_matrix
        cols, vals, n = a.cols, a.vals, a.num_rows
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        n).astype(np.float32)).to(cuda_device)
    before = dict(spmv_ops.LAUNCHES)
    y1 = spmv_ops.spmv(cols, vals, x)
    y2 = spmv_ops.spmv(cols, vals, x)
    want = spmv_ref.spmv_ref(cols, vals, x)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y1), _bits(want))
    assert torch.equal(_bits(y1), _bits(y2))
    assert spmv_ops.LAUNCHES["spmv"] - before["spmv"] == 2


# (seed, fine rows, num_out, max entries a row, hub): "hub" adds column 0
# to every row, a segment longer than the transposed kernel's staged chunk
# (kTChunk products), and so an explicit R whose row 0 is wider than one
# staged chunk of D
SPMV_T_CASES = {
    "0": (0, 3000, 257, 9, False),
    "1": (1, 3000, 257, 9, False),
    "empty-segments": (2, 2000, 1500, 2, False),
    "hub-8000": (3, 8000, 300, 3, True),
    "num_out-1": (4, 3000, 1, 1, False),
    "num_out-gt-rows": (5, 100, 4000, 9, False),
}


def _kernel_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name>`` in ``csrc/<source>.cu``."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("case", list(SPMV_T_CASES))
def test_spmv_t_kernel_matches_twin_and_explicit_transpose(cuda_device,
                                                           case):
    seed, rows, num_out, max_deg, hub = SPMV_T_CASES[case]
    r, c, v = _rand_coo(rows, num_out - hub, max_deg, seed)
    if hub:
        r = np.concatenate([r, np.arange(rows)])
        c = np.concatenate([c + 1, np.zeros(rows, np.int64)])
        v = np.concatenate([v, np.random.default_rng(seed).standard_normal(
            rows).astype(np.float32)])
    p = rect_ell(r, c, v, rows, cuda_device)
    rt_ = rect_ell(c, r, v, num_out, cuda_device)
    t = spmv_ops.ell_transpose(p.cols, p.mask, num_out)
    if case in ("empty-segments", "num_out-gt-rows"):
        assert (np.diff(t.offsets.cpu().numpy()) == 0).any()
    if hub:
        assert t.max_len > _kernel_constant("spmv_ell", "kTChunk")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        rows).astype(np.float32)).to(cuda_device)
    y1 = spmv_ops.spmv_t(p.vals, t, x)
    y2 = spmv_ops.spmv_t(p.vals, t, x)
    twin = spmv_ref.spmv_t_ref(p.vals, t.perm, t.offsets, x, t.max_len)
    explicit = spmv_ops.spmv(rt_.cols, rt_.vals, x)
    torch.cuda.synchronize()
    for other in (y2, twin, explicit):
        assert torch.equal(_bits(y1), _bits(other))


@pytest.mark.parametrize("it", [0, 7, 2**31 - 1])
def test_hash_pack_kernel_matches_twin_bitwise(cuda_device, it):
    ids = torch.arange(100_003, dtype=torch.int32, device=cuda_device)
    itd = torch.tensor([it], dtype=torch.int32, device=cuda_device)
    for b in (1, 17, 31):
        got = hash_ops.hash_pack(ids, itd, b)
        again = hash_ops.hash_pack(ids, itd, b)
        want = hash_ref.hash_pack_ref(ids, itd, b)
        cpu = hash_ops.hash_pack(ids.cpu(), itd.cpu(), b)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, again)
        assert torch.equal(got.cpu(), cpu)


def _hash_forms(n: int, itd: torch.Tensor, b: int, offset: int):
    """Each form of the hash-pack kernel -> (kernel call, its twin on the
    same device): ``hash_pack`` with ids read from ``offset`` into a longer
    tensor (off a 16-byte boundary unless ``offset`` is a multiple of 4),
    and at ``offset`` 0 the coloring's ``round_priorities``."""
    dev = itd.device
    rng = np.random.default_rng(n + offset)
    base = torch.from_numpy(rng.integers(0, 2**32, size=n + offset,
                                         dtype=np.uint64).astype(
        np.uint32).view(np.int32)).to(dev)
    ids = base[offset:]
    forms = {"hash_pack": (lambda: hash_ops.hash_pack(ids, itd, b),
                           lambda: hash_ref.hash_pack_ref(ids, itd, b))}
    if offset == 0:
        forms["round_priorities"] = (
            lambda: hash_ops.round_priorities(n, itd, b),
            lambda: hash_ref.round_priorities_ref(n, itd, b))
    return forms


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 100_003, 1_000_000])
def test_hash_pack_forms_match_twins_bitwise(cuda_device, n, offset):
    """Both forms, bitwise equal to their twins and run-to-run equal, at
    the vector path's edges (steps and the scalar rest) and with ids one to
    three elements off their tensor's start (every id scalar)."""
    for it in (0, 7, 2**31 - 1):
        itd = torch.tensor([it], dtype=torch.int32, device=cuda_device)
        for b in (1, 17, 31):
            for form, (kernel, twin) in _hash_forms(n, itd, b,
                                                    offset).items():
                before = hash_ops.LAUNCHES["hash_pack"]
                got, again, want = kernel(), kernel(), twin()
                torch.cuda.synchronize()
                assert hash_ops.LAUNCHES["hash_pack"] - before == (
                    2 if n else 0), form
                assert got.device == itd.device and got.shape == (n,), form
                assert got.dtype == (torch.int64 if form == "round_priorities"
                                     else torch.int32), form
                assert torch.equal(got, want) and torch.equal(got, again), (
                    form, it, b)


@pytest.mark.parametrize("rows,bits", [(1, [2, 9, 31]), (2, [3] * 5),
                                       (64, [7, 1]), (128, [8, 17, 31]),
                                       (4096, [13] * 9)])
def test_round_priorities_batched_matches_twin_bitwise(cuda_device, rows,
                                                       bits):
    """The batched form, bitwise equal to its twin and run-to-run equal,
    one launch a call, on buckets of one-row members (every id on the
    scalar path), pairs within a warp step and whole warp steps."""
    bits_d = torch.tensor(bits, dtype=torch.int32, device=cuda_device)
    for it in (0, 7, 2**31 - 1):
        itd = torch.tensor([it], dtype=torch.int32, device=cuda_device)
        before = hash_ops.LAUNCHES["round_priorities_batched"]
        got = hash_ops.round_priorities_batched(rows, itd, bits_d)
        again = hash_ops.round_priorities_batched(rows, itd, bits_d)
        want = hash_ref.round_priorities_batched_ref(rows, itd, bits_d)
        torch.cuda.synchronize()
        assert hash_ops.LAUNCHES["round_priorities_batched"] - before == 2
        assert got.dtype == torch.int64 and got.shape == (rows * len(bits),)
        assert torch.equal(got, want) and torch.equal(got, again), (rows, it)
        # each member's words are its single-graph round priorities
        for j, b in enumerate(bits):
            assert torch.equal(got[j * rows:(j + 1) * rows],
                               hash_ops.round_priorities(rows, itd, b))


@pytest.fixture
def no_twins_on_cuda(monkeypatch):
    """Make every twin raise on a CUDA tensor for the test's duration."""
    def guard(fn):
        def wrapped(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{fn.__name__} got a CUDA tensor")
            return fn(*args, **kw)
        return wrapped
    for mod, names in ((spmv_ref, ("spmv_ref", "spmv_t_ref")),
                       (run_ref, ("run_sums_ref",)),
                       (hash_ref, ("hash_pack_ref", "round_priorities_ref",
                                   "round_priorities_batched_ref")),
                       (ref, ("fused_refresh_columns_ref", "fused_decide_ref",
                              "sliced_refresh_columns_ref",
                              "sliced_decide_ref", "refresh_columns_ref",
                              "decide_ref", "resident_fixed_point_ref",
                              "resident_fixed_point_batched_ref",
                              "resident_fixed_point_seeded_ref",
                              "hybrid_fixed_point_ref")),
                       (luby_ref, ("luby_fixed_point_ref",
                                   "luby_fixed_point_hybrid_ref",
                                   "luby_fixed_point_batched_ref")),
                       (misk_ref, ("misk_dense_fixed_point_ref",
                                   "misk_resident_fixed_point_ref")),
                       (join_ref, ("root_join_ref", "cleanup_join_ref",
                                   "phase2_join_ref",
                                   "phase3_fixed_point_ref"))):
        for n in names:
            monkeypatch.setattr(mod, n, guard(getattr(mod, n)))


@pytest.mark.parametrize("explicit", [True, False])
def test_amg_path_on_the_card(cuda_device, no_twins_on_cuda, explicit):
    a = rt.Graph(gen.laplace3d(16))
    s = rt.amg_setup(a, explicit_restriction=explicit)
    assert s.level_sizes == L16_LEVELS and s.level_digests == L16_DIGESTS
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32)).to(cuda_device)
    before = dict(spmv_ops.LAUNCHES)
    r = cg(lambda x: spmv_ell(a.ell_matrix, x), b, precond=s.as_precond(),
           tol=1e-6)
    assert r.converged and abs(r.iterations - L16_CG_ITERS) <= 1
    coarse_levels = len(L16_LEVELS) - 1
    per_cycle = coarse_levels * (7 if explicit else 6)
    launches = {k: spmv_ops.LAUNCHES[k] - before[k] for k in before}
    assert launches == {
        "spmv": (r.iterations + 1) * (1 + per_cycle),
        "spmv_t": 0 if explicit else (r.iterations + 1) * coarse_levels}


@pytest.mark.parametrize("name,coarse_size", [("laplace3d(12)", 200),
                                              ("elasticity3d(4)", 20)])
def test_resident_setup_equals_host_on_the_card(cuda_device,
                                                no_twins_on_cuda, name,
                                                coarse_size):
    """engine=None takes the resident setup on the card: its hierarchy is
    the host engine's array for array, three run-sum launches a level."""
    a = rt.Graph(GRAPHS[name]())
    before = run_ops.LAUNCHES["run_sums"]
    s = rt.amg_setup(a, coarse_size=coarse_size)
    runs = run_ops.LAUNCHES["run_sums"] - before
    h = rt.amg_setup(a, engine="host", coarse_size=coarse_size)
    assert s.engine == "resident" and h.engine == "host"
    assert s.num_levels > 1 and s.level_digests == h.level_digests
    assert runs == 3 * (s.num_levels - 1) and s.dispatches == 7 * (
        s.num_levels - 1)
    for x, y in zip(s.hierarchy.levels, h.hierarchy.levels):
        mats = [(x.diag, y.diag)] + [
            (p, q) for m, n in ((x.a_ell, y.a_ell), (x.p_ell, y.p_ell),
                                (x.r_ell, y.r_ell)) if m is not None
            for p, q in zip(m, n)]
        assert all(p.is_cuda and torch.equal(p, q) for p, q in mats)
    c = rt.cluster_gs_setup(a, coarsen_levels=2)
    ch = rt.cluster_gs_setup(a, coarsen_levels=2, engine="host")
    assert c.engine == "resident"
    assert (c.digest, c.colors_digest) == (ch.digest, ch.colors_digest)
    rows = (c.preconditioner.color_rows, ch.preconditioner.color_rows)
    assert len(rows[0]) == len(rows[1])
    assert all(p.is_cuda and torch.equal(p, q) for p, q in zip(*rows))


def test_coloring_and_cluster_gs_on_the_card(cuda_device, no_twins_on_cuda):
    before = luby_ops.LAUNCHES["luby_fixed_point"]
    c = rt.color(rt.Graph(gen.laplace3d(8)))
    assert (c.num_colors, c.digest, c.host_syncs) == (5, "3f45a9cfe50afa1e", 0)
    assert luby_ops.LAUNCHES["luby_fixed_point"] - before == 1
    gs = rt.cluster_gs_setup(rt.Graph(gen.laplace3d(8)))
    assert (gs.num_colors, gs.num_clusters, gs.digest, gs.colors_digest) == (
        7, 82, "dfda3c0aa9776009", "d47697dd4d599e36")
    assert gs.preconditioner.color_rows[0].is_cuda


# -- slice 3: the sliced kernels and the hybrid path --------------------------

def _slab_state(r: int, w: int, count: int, device, seed: int,
                decided: bool = False, active: str = "random"):
    """A random slab of ``r`` rows and width ``w`` over V = 4r + 7 vertices
    (global rows distinct, pads holding the row's own id), random T / M /
    active, and a slab-local worklist: ``count`` live slots with some
    sentinels R, the rest sentinels.  ``decided``: the slab's rows hold IN
    or OUT; ``active``: "random", "none" or "all"."""
    rng = np.random.default_rng(seed)
    v = 4 * r + 7
    rows = np.sort(rng.choice(v, size=r, replace=False)).astype(np.int32)
    nbrs = rng.integers(0, v, size=(r, w), dtype=np.int64).astype(np.int32)
    deg = rng.integers(0, w + 1, size=r)
    pad = np.arange(w)[None, :] >= deg[:, None]
    nbrs[pad] = np.broadcast_to(rows[:, None], (r, w))[pad]
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    if decided:
        t[rows] = np.where(rng.random(r) < 0.5, 0, 0xFFFFFFFF)
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = 0xFFFFFFFF
    m[rng.random(v) < 0.05] = 0                    # IN: not active unmasked
    wl = np.full(r, r, dtype=np.int32)
    wl[:count] = rng.permutation(r)[:count]
    wl[:count][rng.random(count) < 0.1] = r
    act = {"random": rng.random(v) < 0.9, "none": np.zeros(v, dtype=bool),
           "all": np.ones(v, dtype=bool)}[active]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(t=to(t.view(np.int32)), m=to(m.view(np.int32)),
                active=to(act), slab_rows=to(rows),
                nbrs_flat=to(nbrs.reshape(-1)), wl=to(wl),
                count=torch.tensor([count], dtype=torch.int32, device=device),
                it=torch.tensor([5], dtype=torch.int32, device=device),
                b=id_bits(v))


# rows, width, live slots (and _slab_state's options).  The kernel takes
# G lanes a row from the width and the row count (G = 2, 8, 16, 32 at
# Powerlaw_1M's widths 8 to 64; 4 to 32 on the small slabs here), one row
# a group in a warp's batch of 32 / G rows: Powerlaw_1M-sized 8- and
# 64-wide slabs (16 and 2 rows a batch) whose odd live counts leave the
# last batch partly empty, and a width no power of two (a lane's last
# chunk partly past the row).
SLABS = {"8-wide": (5000, 8, 3000), "8-wide-full": (750_669, 8, 600_001),
         "16-wide": (12000, 16, 9000), "32-wide": (4000, 32, 3100),
         "64-wide": (700, 64, 420), "64-wide-ragged": (70_001, 64, 65_537),
         "81-wide": (300, 81, 250), "one-row": (1, 16, 1),
         "count-0": (300, 8, 0),
         "all-decided": (800, 16, 700, dict(decided=True)),
         "active-none": (900, 32, 800, dict(active="none")),
         "active-all": (900, 32, 800, dict(active="all"))}


@pytest.mark.parametrize("priority", ["xorshift_star", "xorshift", "fixed"])
@pytest.mark.parametrize("slab", list(SLABS))
def test_sliced_kernels_match_twins(cuda_device, slab, priority):
    """Each sliced pass against its twin, the decide both gated by
    ``active`` and without it (``active=None``, as the hybrid loop calls
    it without a mask)."""
    r, w, count, *opts = SLABS[slab]
    x = _slab_state(r, w, count, cuda_device, seed=len(slab + priority),
                    **(opts[0] if opts else {}))
    b = x.pop("b")
    y = {k: v.clone() for k, v in x.items()}
    kw = dict(priority=priority, b=b)
    args = ("slab_rows", "nbrs_flat", "wl", "count", "it")
    t0 = x["t"].clone()
    before = dict(ops.LAUNCHES)
    ops.sliced_refresh_columns(x["t"], x["m"], *(x[k] for k in args), **kw)
    ref.sliced_refresh_columns_ref(y["t"], y["m"], *(y[k] for k in args),
                                   **kw)
    ops.sliced_decide(x["t"], x["m"], x["active"], *(x[k] for k in args),
                      **kw)
    ref.sliced_decide_ref(y["t"], y["m"], y["active"], *(y[k] for k in args),
                          **kw)
    tu = ops.sliced_decide(t0.clone(), x["m"], None, *(x[k] for k in args),
                           **kw)
    tur = ref.sliced_decide_ref(t0.clone(), y["m"], None,
                                *(y[k] for k in args), **kw)
    torch.cuda.synchronize()
    assert torch.equal(x["m"], y["m"]) and torch.equal(x["t"], y["t"])
    assert torch.equal(tu, tur)
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 0, "fused_decide": 0,
        "sliced_refresh_columns": 1, "sliced_decide": 2,
        "refresh_columns": 0, "decide": 0, "resident_fixed_point": 0,
        "resident_fixed_point_batched": 0, "resident_fixed_point_seeded": 0,
        "hybrid_fixed_point": 0}


# the reference's pallas_hybrid / luby_hybrid on powerlaw_graph(900, 8, 4)
PL900_MIS2 = (77, 4, "11b467b81997991b", [3339, 860, 269, 52], 233856)
PL900_COARSEN = {"basic": (77, 4, "09eb70e071aeb5e2"),
                 "two_phase": (119, 10, "3f244de0f1b1fece")}
PL900_COLOR = (10, 15, "94e65700d0874dbb")


def test_hybrid_path_on_the_card(cuda_device, no_twins_on_cuda):
    g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4))
    before = dict(ops.LAUNCHES)
    r = rt.mis2(g, engine="cuda_hybrid")
    size, iters, digest, rows, nbytes = PL900_MIS2
    assert (r.size, r.iterations, r.digest, r.host_syncs) == (
        size, iters, digest, 0)
    assert r.collectives["slice_rows_processed"] == rows
    assert r.collectives["row_bytes_total"] == nbytes
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "hybrid_fixed_point") for k in before}
    for method, want in PL900_COARSEN.items():
        a = rt.coarsen(g, method=method, mis2_engine="cuda_hybrid")
        assert (a.num_aggregates, a.iterations, a.digest) == want
    before = luby_ops.LAUNCHES["luby_fixed_point"]
    c = rt.color(g, engine="luby_hybrid")
    assert (c.num_colors, c.rounds, c.digest, c.host_syncs) == (
        *PL900_COLOR, 0)
    assert luby_ops.LAUNCHES["luby_fixed_point"] - before == 1
    assert "csr_to_ell" not in g.conversions


@pytest.mark.parametrize("mask", [None, "random"])
def test_hybrid_fixed_point_on_the_card_equals_twins(cuda_device, mask):
    """The hybrid fixed point on the card (one launch of the persistent
    kernel; the decide without the mask's gather when there is no mask)
    against its twin on the CPU."""
    g = rt.Graph(gen.powerlaw_graph(20_000, 8.0, seed=7), device="cpu")
    hyb = g.hybrid()
    v = hyb.num_vertices
    active = None if mask is None else torch.from_numpy(
        np.random.default_rng(3).random(v) < 0.6)
    kw = dict(priority="xorshift_star", max_iters=128, b=id_bits(v))
    want = hybrid_fixed_point(hyb, active, **kw)
    before = dict(ops.LAUNCHES)
    got = hybrid_fixed_point(
        hyb.to(cuda_device), None if active is None else
        active.to(cuda_device), **kw)
    assert torch.equal(got[0].cpu(), want[0]) and got[1] == want[1]
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[3].cpu(), want[3]) and got[4] == 0
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "hybrid_fixed_point") for k in before}


@pytest.mark.parametrize("spill_cap", [None, 16])
@pytest.mark.parametrize("max_iters", [1, 2, 4, 128])
def test_hybrid_fixed_point_kernel_matches_twin(cuda_device, max_iters,
                                                spill_cap):
    """The persistent kernel against its twin on the same card, capped and
    uncapped, with a spill of 7 or of 78 heavy rows, with and without a
    mask: T bitwise, rounds, live count and per-slab rows equal."""
    g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4), device=cuda_device)
    hyb = g.hybrid(spill_cap=spill_cap)
    v = hyb.num_vertices
    slabs = [(sl.rows, sl.neighbors.reshape(-1)) for sl in hyb.slices]
    spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
    gen_ = torch.Generator().manual_seed(5)
    for active in (None, (torch.rand(v, generator=gen_) < 0.6).to(
            cuda_device)):
        for priority in ("xorshift_star", "fixed"):
            kw = dict(priority=priority, b=id_bits(v), max_iters=max_iters)
            got = ops.hybrid_fixed_point(
                *(torch.empty(v, dtype=torch.int32, device=cuda_device)
                  for _ in range(2)), active, slabs, spill, **kw)
            want = ref.hybrid_fixed_point_ref(
                *(torch.empty(v, dtype=torch.int32, device=cuda_device)
                  for _ in range(2)), active, slabs, spill, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("max_rounds", [1, 2, 3, 256])
@pytest.mark.parametrize("layout", ["ell", "hybrid", "hybrid_spill16",
                                    "clique70"])
def test_luby_kernel_matches_twins(cuda_device, layout, max_rounds):
    """The Luby persistent kernel against its twins on the same card:
    colors bitwise (a clique of 70 holds -95 where all 64 colors are
    forbidden) and rounds equal, one launch a loop."""
    if layout == "clique70":
        i, j = np.meshgrid(np.arange(70), np.arange(70))
        g = rt.Graph(rt.graphs.csr_from_coo(i[i != j], j[i != j], 70),
                     device=cuda_device)
    else:
        g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4), device=cuda_device)
    before = luby_ops.LAUNCHES["luby_fixed_point"]
    if layout in ("ell", "clique70"):
        ell = g.ell
        got = luby_ops.luby_fixed_point(ell.neighbors, ell.mask,
                                        max_rounds=max_rounds)
        want = luby_ref.luby_fixed_point_ref(ell.neighbors, ell.mask,
                                             max_rounds=max_rounds)
    else:
        hyb = g.hybrid(spill_cap=16 if layout.endswith("16") else None)
        slabs = [(sl.rows, sl.neighbors, sl.mask) for sl in hyb.slices]
        spill = (hyb.spill_rows, hyb.spill_seg, hyb.spill_cols)
        got = luby_ops.luby_fixed_point_hybrid(slabs, spill, hyb.num_vertices,
                                               max_rounds=max_rounds)
        want = luby_ref.luby_fixed_point_hybrid_ref(
            slabs, spill, hyb.num_vertices, max_rounds=max_rounds)
    assert luby_ops.LAUNCHES["luby_fixed_point"] - before == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- slice 4: the unfused kernels of the host-driven round -----------------

ROWS = {"laplace3d(12)": (0.6,), "elasticity3d(4)": (0.3,),
        "count-0": (0.0,)}


def _rows_state(name: str, device, seed: int):
    """Pre-gathered rows of a pow2-padded worklist (dead slots gather row
    V-1, as the driver's clamp does) and random T / M / active."""
    graph = GRAPHS["laplace3d(8)" if name == "count-0" else name]()
    ell = rt.Graph(graph, device=device).ell
    v = ell.num_vertices
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.1] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    m = rng.integers(0, 2**32, size=v, dtype=np.uint32)
    m[rng.random(v) < 0.2] = 0xFFFFFFFF
    count = int(v * ROWS[name][0])
    w = 1 << max(0, v - 1).bit_length()
    wl = np.full(w, v - 1, dtype=np.int64)
    wl[:count] = rng.permutation(v)[:count]
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    rows = to(wl)
    return dict(t=to(t.view(np.int32)), m=to(m.view(np.int32)),
                active=to(rng.random(v) < 0.9),
                wl_nbrs=ell.neighbors[rows].contiguous(), rows=rows,
                count=count)


# the unfused kernels at every group shape of the fused ones (G = 1 with
# the rows staged in shared memory, up to 32 lanes, several chunks a lane
# at D = 600), over W = FUSED_V slots (not a multiple of a warp's 32 or a
# block's 256); and at the edges, at D = 7 (staged) and 81 (8 lanes):
# (slots W, live count, active share, every M OUT)
UNFUSED_EDGES = {"count-0": (FUSED_V, 0, 0.9, False),
                 "count-w": (FUSED_V, FUSED_V, 0.9, False),
                 "count-past-w": (700, FUSED_V, 0.9, False),
                 "w-300": (300, 77, 0.9, False),
                 "inactive": (FUSED_V, 800, 0.0, False),
                 "m-out": (FUSED_V, 800, 0.9, True)}
UNFUSED_CASES = (list(ROWS) + [f"width-{d}" for d in FUSED_WIDTHS]
                 + [f"{e}@{d}" for e in UNFUSED_EDGES for d in (7, 81)])


def _unfused_case(name: str, device, seed: int):
    """A case of ``UNFUSED_CASES`` on a random circulant graph of FUSED_V
    vertices: T with IN, OUT and undecided words; M the twin's refresh of
    every row with a twentieth made OUT, so that decide makes rows IN and
    OUT and leaves tuples; rows of a random worklist, the first ``count``
    live."""
    if name.startswith("width-"):
        d, edge = int(name[6:]), (FUSED_V, int(FUSED_V * 0.6), 0.9, False)
    else:
        case, d = name.split("@")
        d, edge = int(d), UNFUSED_EDGES[case]
    w, count, act, m_out = edge
    v = FUSED_V
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
    t[rng.random(v) < 0.03] = 0
    t[rng.random(v) < 0.1] = 0xFFFFFFFF
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    nbrs = to(_sym_ell(v, d, rng))
    tt = to(t.view(np.int32))
    m = ref.refresh_columns_ref(torch.where(tt == 0, -1, tt), nbrs, v)
    m[to(rng.random(v) < 0.05)] = -1
    if m_out:
        m.fill_(-1)
    rows = to(rng.integers(0, v, size=w))
    return dict(t=tt, m=m, active=to(rng.random(v) < act),
                wl_nbrs=nbrs[rows].contiguous(), rows=rows, count=count)


@pytest.mark.parametrize("name", UNFUSED_CASES)
def test_unfused_kernels_match_twins(cuda_device, name):
    if name in ROWS:
        x = _rows_state(name, cuda_device, seed=len(name))
    else:
        x = _unfused_case(name, cuda_device, seed=len(name))
    before = dict(ops.LAUNCHES)
    mk = ops.refresh_columns_rows(x["t"], x["wl_nbrs"], x["count"])
    t_rows = x["t"][x["rows"]].contiguous()
    tk = ops.decide_rows(t_rows, x["m"], x["active"], x["wl_nbrs"],
                         x["count"])
    mr = ref.refresh_columns_ref(x["t"], x["wl_nbrs"], x["count"])
    tr = ref.decide_ref(t_rows, x["m"], x["active"], x["wl_nbrs"],
                        x["count"])
    torch.cuda.synchronize()
    assert torch.equal(mk, mr) and torch.equal(tk, tr)
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == {
        "fused_refresh_columns": 0, "fused_decide": 0,
        "sliced_refresh_columns": 0, "sliced_decide": 0,
        "refresh_columns": 1, "decide": 1, "resident_fixed_point": 0,
        "resident_fixed_point_batched": 0, "resident_fixed_point_seeded": 0,
        "hybrid_fixed_point": 0}
    live = min(x["count"], t_rows.shape[0])
    und = (t_rows[:live] != 0) & (t_rows[:live] != -1)
    if live == 0:
        assert (mk == -1).all() and torch.equal(tk, t_rows)
    elif name.startswith("inactive"):
        assert (tk[:live][und] == 0).all()              # all IN
    elif name.startswith("m-out"):
        assert (tk[:live][und] == -1).all()             # all OUT
    elif name not in ROWS:
        assert ((tk == -1) & (t_rows != -1)).any()      # new OUT
        if x["wl_nbrs"].shape[1] <= 17:                 # wider: too few
            assert ((tk == 0) & (t_rows != 0)).any()    # new IN


@pytest.mark.parametrize("worklists", [True, False])
def test_cuda_compacted_on_the_card(cuda_device, no_twins_on_cuda,
                                    worklists):
    g = rt.Graph(gen.laplace3d(12))
    opts = rt.Mis2Options(worklists=worklists)
    size, iters, digest = ANCHORS["laplace3d(12)"][0]
    before = dict(ops.LAUNCHES)
    r = rt.mis2(g, engine="cuda_compacted", options=opts)
    assert (r.size, r.iterations, r.digest) == (size, iters, digest)
    assert r.host_syncs == 2 * iters
    for k in ("refresh_columns", "decide"):
        assert ops.LAUNCHES[k] - before[k] == iters
    want = rt.mis2(rt.Graph(gen.laplace3d(12), device="cpu"),
                   engine="compacted", options=opts,
                   backend=rt.Backend(device="cpu"))
    assert (r.digest, r.num_compiles) == (want.digest, want.num_compiles)
    a = rt.coarsen(g, method="two_phase", mis2_engine="cuda_compacted")
    assert (a.num_aggregates, a.iterations, a.digest) == \
        ANCHORS["laplace3d(12)"][1]


# -- distance-k MIS and the multilevel partition --------------------------------

# the reference's misk (dense and resident give these) on laplace3d(8):
# k -> (size, rounds, digest)
MISK_L8 = {1: (174, 3, "bb3c6f919d05dea6"), 2: (53, 5, "0c5589862dc23fba"),
           3: (31, 4, "32c79e9bbf96fafc")}


@pytest.mark.parametrize("engine", ["dense", "resident"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_misk_on_the_card_equals_the_cpu(cuda_device, name, k, engine):
    """Both engines are one launch of the misk kernel a solve on the card,
    with no host read inside it (the CPU twin reads one a round)."""
    before = misk_ops.LAUNCHES["misk_fixed_point"]
    r = rt.misk(rt.Graph(GRAPHS[name]()), k=k, engine=engine)
    assert misk_ops.LAUNCHES["misk_fixed_point"] - before == 1
    want = rt.misk(rt.Graph(GRAPHS[name](), device="cpu"), k=k,
                   engine=engine, backend=rt.Backend(device="cpu"))
    assert (r.digest, r.iterations, r.converged) == (
        want.digest, want.iterations, want.converged)
    assert r.host_syncs == 0 and want.host_syncs == want.iterations + 1
    if name == "laplace3d(8)":
        assert (r.size, r.iterations, r.digest) == MISK_L8[k]


@pytest.mark.parametrize("name,parts", [("laplace3d(8)", 4),
                                        ("laplace3d(12)", 8),
                                        ("elasticity3d(4)", 3)])
def test_partition_on_the_card_equals_the_cpu(cuda_device, no_twins_on_cuda,
                                              name, parts):
    before = dict(ops.LAUNCHES)
    r = rt.partition(rt.Graph(GRAPHS[name]()), parts)
    launched = {k: ops.LAUNCHES[k] - before[k]
                for k in ("resident_fixed_point",)}
    want = rt.partition(rt.Graph(GRAPHS[name](), device="cpu"), parts,
                        backend=rt.Backend(device="cpu"))
    assert (r.digest, r.edge_cut, r.levels, r.history, r.converged) == (
        want.digest, want.edge_cut, want.levels, want.history,
        want.converged)
    if r.levels > 1:                 # each level coarsens on the kernels
        assert min(launched.values()) > 0
    if name == "laplace3d(12)":
        assert (r.edge_cut, r.levels, r.digest) == (766, 3,
                                                    "7bc0dcd81b18c422")


# -- slice 12: the batched pipelines -----------------------------------------

def test_batched_pipelines_on_the_card(cuda_device, no_twins_on_cuda):
    """mis2_batch / color_batch / coarsen_batch on the card, every member
    equal to the single-graph call; one launch of the batched MIS-2 kernel
    a bucket a solve (two a bucket in a two-phase coarsening) and of the
    batched Luby kernel a bucket, no host sync, every result's provenance
    on the gpu."""
    graphs = [rt.Graph(GRAPHS[name]()) for name in GRAPHS]
    graphs.append(rt.Graph(gen.random_uniform_graph(900, 6.0, seed=2)))
    batch = rt.GraphBatch(graphs)
    key, lkey = "resident_fixed_point_batched", "luby_fixed_point_batched"
    before = (ops.LAUNCHES[key], luby_ops.LAUNCHES[lkey],
              hash_ops.LAUNCHES["round_priorities_batched"])
    br = rt.mis2_batch(batch)
    cb = rt.color_batch(batch)
    mid = ops.LAUNCHES[key]
    ab = rt.coarsen_batch(batch)
    buckets = batch.num_buckets
    assert (mid - before[0], ops.LAUNCHES[key] - mid) == (buckets,
                                                          2 * buckets)
    assert luby_ops.LAUNCHES[lkey] - before[1] == buckets
    assert hash_ops.LAUNCHES["round_priorities_batched"] == before[2]
    assert all(r.host_syncs == 0 for res in (br, cb) for r in res)
    for g, m, c, a in zip(graphs, br, cb, ab):
        assert (m.digest, m.iterations) == (
            lambda s: (s.digest, s.iterations))(rt.mis2(g))
        assert (c.digest, c.rounds) == (lambda s: (s.digest, s.rounds))(
            rt.color(g))
        assert a.digest == rt.coarsen(g).digest
    for res in (br, cb, ab):
        assert res.provenance.backend == "gpu"
        assert all(r.provenance is res.provenance for r in res)


# -- slice 13: the distributed engines and the serving layer ----------------

def test_distributed_engines_on_the_card_one_rank(cuda_device,
                                                  no_twins_on_cuda):
    """With no process group the distributed engines run as one rank on
    the card: the anchors, one launch of each sliced kernel a round (and
    of the whole-graph refresh for single-gather), the two-phase
    coarsening's anchor through the sharded label rounds."""
    g = rt.Graph(GRAPHS["laplace3d(8)"]())
    (size, iters, digest), (nagg, _, cdigest) = ANCHORS["laplace3d(8)"]
    for engine in ("distributed", "distributed_single_gather"):
        ops.reset_launches()
        r = rt.mis2(g, engine=engine)
        assert (r.size, r.iterations, r.digest) == (size, iters, digest)
        assert r.collectives["counted_result_bytes"] == \
            r.collectives["result_bytes_total"]
        assert ops.LAUNCHES["sliced_decide"] == iters
        single = engine.endswith("single_gather")
        assert ops.LAUNCHES["sliced_refresh_columns"] == (0 if single
                                                          else iters)
        assert ops.LAUNCHES["fused_refresh_columns"] == (iters if single
                                                         else 0)
    for kw in ({"method": "two_phase_distributed"},
               {"method": "two_phase", "mis2_engine": "distributed"}):
        a = rt.coarsen(g, **kw)
        assert (a.num_aggregates, a.digest) == (nagg, cdigest)


def test_server_on_the_card_equals_direct_calls(cuda_device,
                                                no_twins_on_cuda):
    """A warmed server on the card: every served mis2 / color / coarsen /
    amg_setup response equals its direct facade call, no shape is cold,
    no nvcc runs after the warm-up, no fallback answers."""
    from repro_torch.serve import Server, ServerConfig, warm_buckets_for

    graphs = [rt.Graph(GRAPHS[n]()) for n in GRAPHS]
    graphs.append(rt.Graph(gen.er_laplacian(600, 6.0, seed=3)))
    srv = Server(ServerConfig(max_batch=4,
                              warm_buckets=warm_buckets_for(graphs),
                              cache_bytes=0))
    kinds = ("mis2", "color", "coarsen", "amg_setup")
    futs = [(k, g, srv.submit(k, g)) for k in kinds for g in graphs]
    srv.flush()
    direct = {"mis2": rt.mis2, "color": rt.color, "coarsen": rt.coarsen,
              "amg_setup": rt.amg_setup}
    for k, g, f in futs:
        r = f.result()
        assert r.digest == direct[k](g).digest
        assert r.provenance.backend == "gpu"
        assert r.provenance.digest == r.digest
    st = srv.server_stats()
    assert st["compiles"]["runtime_cold"] == 0
    assert st["compiles"]["nvcc_since_warm"] == 0
    assert st["fallbacks"] == 0


def test_server_on_the_card_never_falls_back_on_a_real_error(
        cuda_device, monkeypatch):
    """A device out-of-memory error inside a served request on the card
    resolves it with ``EngineFailure``, the error as its cause; an
    injected persistent fault degrades to the card's default engine."""
    from repro_torch.kernels.minprop_ell import ops
    from repro_torch.serve import (EngineFailure, Fault, FaultPlan, Server,
                                   ServerConfig)

    g = rt.Graph(gen.laplace3d(12))
    want = rt.mis2(g)
    err = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    def oom(*a, **k):
        raise err

    with monkeypatch.context() as m:
        m.setattr(ops, "resident_fixed_point", oom)
        srv = Server(ServerConfig(cache_bytes=0))
        fut = srv.submit("mis2", g)
        srv.flush()
        with pytest.raises(EngineFailure) as ei:
            fut.result()
    assert ei.value.__cause__ is err and srv.stats.fallbacks == 0
    plan = FaultPlan(seed=1, sites={
        "engine": Fault("error", transient=False)})
    srv = Server(ServerConfig(faults=plan, cache_bytes=0))
    res = srv.request("mis2", g)
    assert srv.stats.fallbacks == 1
    assert (res.engine, res.digest) == (want.engine, want.digest)


def test_streaming_repair_on_the_card(cuda_device):
    from repro_torch.serve import StreamSession

    session = StreamSession(gen.laplace3d(10), check_fraction=1.0)
    rng = np.random.default_rng(3)
    v = session.graph.num_vertices
    for _ in range(3):
        adds = rng.integers(0, v, size=(5, 2))
        before = ops.LAUNCHES["resident_fixed_point_seeded"]
        r = session.apply_delta(adds[adds[:, 0] != adds[:, 1]], None)
        # one launch a repair solve (a region that grew solves again)
        assert ops.LAUNCHES["resident_fixed_point_seeded"] - before == \
            1 + session.last_repair.expansions
        assert session.last_repair.mode == "repair"
        assert session.last_repair.checked
        assert r.digest == rt.mis2(session.graph, engine="dense",
                                   options=session.options).digest


# -- slice 16: the coarsening's joins, one launch each ---------------------

def _join_layout(graph: str, layout: str, device):
    if graph.startswith("star"):           # a hub and its n tips
        n = int(graph[4:])
        hub = np.zeros(n, dtype=np.int64)
        tips = np.arange(1, n + 1)
        g = rt.Graph(rt.graphs.csr_from_coo(np.concatenate([hub, tips]),
                                            np.concatenate([tips, hub]),
                                            n + 1), device=device)
    else:
        g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4) if graph ==
                     "powerlaw" else gen.laplace3d(12), device=device)
    if layout == "ell":
        return g, join_ref.ell_layout(*g.ell)
    return g, join_ref.hybrid_layout(g.hybrid(
        spill_cap=16 if layout == "hybrid_spill16" else None))


def _join_calls(g, layout, device, seed: int) -> list:
    """``(wrapper, args, kwargs)`` of every join on the states of a real
    two-phase coarsening (phase 1 from the MIS-2 roots, phase 2 from the
    second MIS-2's set, phase 3 from phase 2's labels) and on seeded ones
    (a third to nine tenths unlabeled, every other heavy row unlabeled)."""
    v = layout.v
    cpu = rt.Backend(device="cpu")
    gc = rt.Graph.from_reference(g.csr.indptr, g.csr.indices, device="cpu")
    roots = torch.from_numpy(np.asarray(rt.mis2(gc, backend=cpu).in_set))
    lay_cpu = join_ref.Layout(
        tuple(tuple(None if t is None else t.cpu() for t in m)
              for m in layout.maps),
        tuple(t.cpu() for t in layout.spill), v)
    labels1, phase1, aux = join_ref.root_join_ref(lay_cpu, roots)
    in_set2 = torch.from_numpy(np.asarray(rt.mis2(
        gc, active=(labels1 < 0).numpy(), backend=cpu).in_set))
    labels2, phase2, _, _ = join_ref.phase2_join_ref(
        lay_cpu, labels1, phase1, in_set2, aux[:1], min_secondary=2)
    rng = np.random.default_rng(seed)
    heavy = layout.spill[0].long().cpu()

    def labels(frac):
        lab = torch.from_numpy(np.where(
            rng.random(v) < frac, rng.integers(0, max(v // 5, 1), v),
            -1).astype(np.int32))
        lab[heavy[::2]] = -1
        return lab

    def marks():
        return torch.from_numpy(rng.integers(0, 3, v).astype(np.uint8))

    nagg = torch.tensor([v // 5], dtype=torch.int32)
    calls = [
        ("root_join", (roots,), {"cleanup_rounds": 0}),
        ("root_join", (roots,), {"cleanup_rounds": 4}),
        ("cleanup_join", (labels1, phase1), {}),
        ("phase2_join", (labels1, phase1, in_set2, aux[:1].clone()),
         {"min_secondary": 2}),
        ("phase3_fixed_point", (labels2, phase2), {}),
        ("root_join", (torch.from_numpy(rng.random(v) < 0.05),),
         {"cleanup_rounds": 4}),
        ("cleanup_join", (labels(0.6), marks()), {}),
        ("phase2_join", (labels(0.5), marks(),
                         torch.from_numpy(rng.random(v) < 0.3), nagg),
         {"min_secondary": 3}),
        ("phase3_fixed_point", (labels(0.5), marks()), {}),
        ("phase3_fixed_point", (labels(0.9), marks()), {}),
    ]
    return [(name, (layout,) + tuple(a.to(device) for a in args), kw)
            for name, args, kw in calls]


JOIN_KERNEL = {"root_join": "root_join", "cleanup_join": "root_join",
               "phase2_join": "phase2_join",
               "phase3_fixed_point": "phase3_fixed_point"}


@pytest.mark.parametrize("layout", ["ell", "hybrid", "hybrid_spill16"])
@pytest.mark.parametrize("graph", ["laplace3d(12)", "powerlaw", "star60"])
def test_join_kernels_match_twins(cuda_device, graph, layout):
    """Each join kernel against its twin on the same card: every output
    bitwise, equal on a second launch, one launch a call, and no host sync
    inside a call (after the first, which copies the layout's map table)."""
    g, lay = _join_layout(graph, layout, cuda_device)
    for i, (name, args, kw) in enumerate(_join_calls(g, lay, cuda_device,
                                                     seed=7)):
        wrapper = getattr(join_ops, name)
        wrapper(*args, **kw)                     # the map table, once
        torch.cuda.synchronize()
        before = dict(join_ops.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = wrapper(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = dict(join_ops.LAUNCHES)
        again = wrapper(*args, **kw)
        want = getattr(join_ref, name + "_ref")(*args, **kw)
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == JOIN_KERNEL[name]) for k in after}, (i, name)
        for x, y, z in zip(got, again, want):
            assert torch.equal(x, y) and torch.equal(x, z), (i, name, kw)


def test_join_coarsening_on_the_card_equals_the_cpu(cuda_device,
                                                    no_twins_on_cuda):
    """Both coarsenings on the card (the join kernels, one launch each)
    against the CPU twins, on the ELL and the hybrid layout."""
    for engine in ("cuda_resident", "cuda_hybrid"):
        for method in ("two_phase", "basic"):
            g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4))
            gc = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4), device="cpu")
            before = dict(join_ops.LAUNCHES)
            a = rt.coarsen(g, method=method, mis2_engine=engine)
            after = dict(join_ops.LAUNCHES)
            b = rt.coarsen(gc, method=method, mis2_engine=engine,
                           backend=rt.Backend(device="cpu"))
            assert a.digest == b.digest and a.num_aggregates == \
                b.num_aggregates
            want = ({"root_join": 1, "phase2_join": 1,
                     "phase3_fixed_point": 1} if method == "two_phase"
                    else {"root_join": 1, "phase2_join": 0,
                          "phase3_fixed_point": 0})
            assert {k: after[k] - before[k] for k in after} == want


def test_join_grid_that_does_not_fit_raises(cuda_device):
    """A cooperative grid past what the card holds at once is refused by
    the launch and raises; the next launch runs."""
    g, lay = _join_layout("laplace3d(12)", "ell", cuda_device)
    roots = torch.zeros(lay.v, dtype=torch.bool, device=cuda_device)
    roots[::9] = True
    before = dict(join_ops.LAUNCHES)
    with pytest.raises(_build.KernelLaunchError, match="root_join"):
        join_ops._root_join_on_card(lay, roots, None, None, 0, blocks=2000)
    assert join_ops.LAUNCHES == before
    labels, _, _ = join_ops._root_join_on_card(lay, roots, None, None, 0,
                                               blocks=4)
    assert torch.equal(labels, join_ref.root_join_ref(lay, roots)[0])


# -- slice 17: misk, the batched MIS-2 and Luby loops and the repair, one
# launch each ---------------------------------------------------------------

@pytest.mark.parametrize("max_iters", [1, 2, 256])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", ["laplace3d(12)", "elasticity3d(4)",
                                  "powerlaw"])
def test_misk_kernel_matches_twins(cuda_device, name, k, max_iters):
    """The misk kernel against both engines' twins on the same card: T
    bitwise, the rounds and the live count equal, one launch a call."""
    g = rt.Graph(gen.powerlaw_graph(900, 8.0, seed=4) if name == "powerlaw"
                 else GRAPHS[name](), device=cuda_device)
    nb = g.ell.neighbors
    kw = dict(k=k, priority="xorshift_star", max_iters=max_iters)
    before = misk_ops.LAUNCHES["misk_fixed_point"]
    got = misk_ops.misk_fixed_point(nb, **kw)
    again = misk_ops.misk_fixed_point(nb, **kw)
    launched = misk_ops.LAUNCHES["misk_fixed_point"] - before
    for twin in (misk_ref.misk_dense_fixed_point_ref,
                 misk_ref.misk_resident_fixed_point_ref):
        want = twin(nb, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(got, again, want))
    assert launched == 2


def _batch_on_card(device):
    """Three buckets, two of several members (a random graph among them
    that needs more rounds than its mates)."""
    gs = [gen.laplace3d(3), gen.random_uniform_graph(220, 4.0, seed=1),
          gen.laplace3d(5), gen.random_uniform_graph(240, 5.0, seed=2),
          gen.random_uniform_graph(200, 3.0, seed=3), gen.laplace3d(5),
          gen.random_uniform_graph(5000, 6.0, seed=4)]
    return rt.GraphBatch([rt.Graph(g, device=device) for g in gs])


@pytest.mark.parametrize("max_iters", [1, 2, 6, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_batched_resident_kernel_matches_twin(cuda_device, masked,
                                              max_iters):
    """The batched resident kernel against its twin on each bucket: T,
    the rounds, the live count and each member's rounds equal, one launch
    a bucket."""
    batch = _batch_on_card(cuda_device)
    gen_ = torch.Generator(device="cpu").manual_seed(3)
    for bucket in batch.buckets:
        n = bucket.size * bucket.rows
        act = bucket.row_valid.view(-1)
        if masked:
            act = act & (torch.rand(n, generator=gen_) < 0.7).to(cuda_device)
        args = (act, bucket.flat_neighbors32.view(-1))
        kw = dict(priority="xorshift_star", bits=bucket.id_bits,
                  rows=bucket.rows, max_iters=max_iters)

        def state():
            return (torch.empty(n, dtype=torch.int32, device=cuda_device),
                    torch.empty(n, dtype=torch.int32, device=cuda_device))

        before = ops.LAUNCHES["resident_fixed_point_batched"]
        got = ops.resident_fixed_point_batched(*state(), *args, **kw)
        launched = ops.LAUNCHES["resident_fixed_point_batched"] - before
        want = ref.resident_fixed_point_batched_ref(*state(), *args, **kw)
        torch.cuda.synchronize()
        assert launched == 1
        assert all(torch.equal(x, y) for x, y in zip(got, want)), \
            bucket.shape


@pytest.mark.parametrize("max_iters", [1, 2, 128])
@pytest.mark.parametrize("frac", [0.05, 0.5, 1.0])
def test_seeded_resident_kernel_matches_twin(cuda_device, frac, max_iters):
    """The seeded resident kernel (the streaming repair) against its twin
    from a frozen fixed-priority solution with a reseeded region."""
    g = rt.Graph(GRAPHS["laplace3d(12)"](), device=cuda_device)
    nb = g.ell.neighbors.reshape(-1)
    v = g.num_vertices
    kw = dict(priority="fixed", b=id_bits(v), max_iters=128)
    base, _ = ref.resident_fixed_point_seeded_ref(
        torch.ones(v, dtype=torch.int32, device=cuda_device),
        torch.empty(v, dtype=torch.int32, device=cuda_device), nb, **kw)
    region = torch.from_numpy(np.random.default_rng(6).random(v) < frac)
    seed = torch.where(region.to(cuda_device), 1, base).to(torch.int32)
    kw["max_iters"] = max_iters
    before = ops.LAUNCHES["resident_fixed_point_seeded"]
    got = ops.resident_fixed_point_seeded(
        seed.clone(), torch.empty_like(seed), nb, **kw)
    launched = ops.LAUNCHES["resident_fixed_point_seeded"] - before
    want = ref.resident_fixed_point_seeded_ref(
        seed.clone(), torch.empty_like(seed), nb, **kw)
    torch.cuda.synchronize()
    assert launched == 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("max_rounds", [1, 2, 6, 256])
def test_batched_luby_kernel_matches_twin(cuda_device, max_rounds):
    """The batched Luby kernel against its twin on each bucket: colors,
    done rounds and rounds equal, one launch a bucket."""
    batch = _batch_on_card(cuda_device)
    for bucket in batch.buckets:
        n = bucket.size * bucket.rows
        args = (bucket.flat_neighbors32, bucket.mask.view(n, bucket.width),
                bucket.row_valid.view(-1), bucket.id_bits, bucket.rows)
        before = luby_ops.LAUNCHES["luby_fixed_point_batched"]
        got = luby_ops.luby_fixed_point_batched(*args, max_rounds=max_rounds)
        launched = luby_ops.LAUNCHES["luby_fixed_point_batched"] - before
        want = luby_ref.luby_fixed_point_batched_ref(*args,
                                                     max_rounds=max_rounds)
        torch.cuda.synchronize()
        assert launched == 1
        assert all(torch.equal(x, y) for x, y in zip(got, want)), \
            bucket.shape


# -- slice 20: the redesigned persistent kernels at every cap of their loops

def _resident_pair(nb, active, cap: int, device, **kw):
    """The resident kernel and its twin at ``max_iters=cap``."""
    v = active.shape[0]
    kw = dict(priority="xorshift_star", b=id_bits(v), max_iters=cap) | kw

    def state():
        return (torch.empty(v, dtype=torch.int32, device=device),
                torch.empty(v, dtype=torch.int32, device=device))

    before = ops.LAUNCHES["resident_fixed_point"]
    got = ops.resident_fixed_point(*state(), active, nb, **kw)
    launched = ops.LAUNCHES["resident_fixed_point"] - before
    want = ref.resident_fixed_point_ref(*state(), active, nb, **kw)
    torch.cuda.synchronize()
    return got, want, launched


# laplace3d(64): V = 262,144 rows, a grid of every block that fits; the
# others a grid of a few blocks, sized to V below what the card holds
@pytest.mark.parametrize("name", ["laplace3d(12)", "elasticity3d(4)",
                                  "laplace3d(64)"])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_resident_kernel_matches_twin_at_every_cap(cuda_device, name, frac):
    """The two-sync resident kernel against its twin at every cap from 0
    to one past the rounds the uncapped solve runs: T bitwise, the rounds
    and the last live count equal, one launch a call."""
    g = gen.laplace3d(64) if name == "laplace3d(64)" else GRAPHS[name]()
    ell = rt.Graph(g, device=cuda_device).ell
    v = ell.num_vertices
    nb = ell.neighbors.reshape(-1)
    rng = np.random.default_rng(v)
    active = torch.from_numpy(rng.random(v) < frac).to(cuda_device)
    trace = []
    ref.resident_fixed_point_ref(
        torch.empty(v, dtype=torch.int32, device=cuda_device),
        torch.empty(v, dtype=torch.int32, device=cuda_device), active, nb,
        priority="xorshift_star", b=id_bits(v), max_iters=128, trace=trace)
    for cap in range(len(trace) + 2):
        (tk, sk), (tr, sr), launched = _resident_pair(nb, active, cap,
                                                      cuda_device)
        assert launched == 1
        assert torch.equal(tk, tr) and sk.tolist() == sr.tolist(), cap
        assert sk.tolist()[0] == min(cap, len(trace))


def test_batched_resident_kernel_members_stop_apart(cuda_device):
    """A bucket whose members stop at different rounds: the batched kernel
    against its twin at every cap, each member's rounds equal (taken by an
    atomicMax a member group of a warp, in no order of the list)."""
    apart = 0
    for bucket in _batch_on_card(cuda_device).buckets:
        n = bucket.size * bucket.rows
        args = (bucket.row_valid.view(-1), bucket.flat_neighbors32.view(-1))
        kw = dict(priority="xorshift_star", bits=bucket.id_bits,
                  rows=bucket.rows)

        def state():
            return (torch.empty(n, dtype=torch.int32, device=cuda_device),
                    torch.empty(n, dtype=torch.int32, device=cuda_device))

        _, stats, its = ref.resident_fixed_point_batched_ref(
            *state(), *args, max_iters=128, **kw)
        apart += len(set(its.tolist())) > 1
        for cap in range(int(stats[0]) + 2):
            got = ops.resident_fixed_point_batched(*state(), *args,
                                                   max_iters=cap, **kw)
            want = ref.resident_fixed_point_batched_ref(*state(), *args,
                                                        max_iters=cap, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, want)), \
                (bucket.shape, cap)
    assert apart > 0


def test_seeded_resident_kernel_at_every_cap(cuda_device):
    """The seeded kernel against its twin at every cap on a reseeded
    region of a frozen solution (the repair's state)."""
    g = rt.Graph(GRAPHS["laplace3d(12)"](), device=cuda_device)
    nb = g.ell.neighbors.reshape(-1)
    v = g.num_vertices
    kw = dict(priority="fixed", b=id_bits(v))
    base, _ = ref.resident_fixed_point_seeded_ref(
        torch.ones(v, dtype=torch.int32, device=cuda_device),
        torch.empty(v, dtype=torch.int32, device=cuda_device), nb,
        max_iters=128, **kw)
    region = torch.from_numpy(np.random.default_rng(8).random(v) < 0.2)
    seed = torch.where(region.to(cuda_device), 1, base).to(torch.int32)
    _, stats = ref.resident_fixed_point_seeded_ref(
        seed.clone(), torch.empty_like(seed), nb, max_iters=128, **kw)
    for cap in range(int(stats[0]) + 2):
        got = ops.resident_fixed_point_seeded(
            seed.clone(), torch.empty_like(seed), nb, max_iters=cap, **kw)
        want = ref.resident_fixed_point_seeded_ref(
            seed.clone(), torch.empty_like(seed), nb, max_iters=cap, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), cap


# star60's hub: a heavy row whose table fits in shared memory (ELL: its
# row at D = 61, a lane's 16 slots in registers); star1500's: one whose
# table is in global memory
@pytest.mark.parametrize("star,layout", [("star60", "hybrid_spill16"),
                                         ("star60", "ell"),
                                         ("star1500", "hybrid_spill16")])
@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4])
def test_phase3_kernel_at_every_cap_with_an_unlabeled_hub(
        cuda_device, monkeypatch, star, layout, rounds):
    """Phase 3 at each cap of its rounds against its twin capped the same,
    on a star whose hub (a heavy row of the hybrid layout) and a third of
    whose tips are unlabeled: labels and marks bitwise."""
    g, lay = _join_layout(star, layout, cuda_device)
    v = lay.v
    rng = np.random.default_rng(rounds)
    labels = torch.from_numpy(np.where(rng.random(v) < 0.66,
                                       rng.integers(0, 6, v), -1)
                              .astype(np.int32))
    labels[0] = -1
    phase = torch.from_numpy(rng.integers(0, 3, v).astype(np.uint8))
    labels, phase = labels.to(cuda_device), phase.to(cuda_device)
    got = join_ops._phase3_on_card(lay, labels, phase, rounds=rounds)
    monkeypatch.setattr(join_ref, "JOIN_ROUNDS", rounds)
    want = join_ref.phase3_fixed_point_ref(lay, labels, phase)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if rounds:
        assert int(got[0][0]) >= 0      # the hub joined in round 1
