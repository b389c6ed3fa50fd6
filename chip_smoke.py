#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   ``sm_90a``) and print the build time;
3. hold each kernel against its plain-torch twin on the card at the
   Laplace3D_100 and Elasticity3D_60 shapes: random T/M/active, a worklist
   with a live count below V, sentinel slots and real rows past the count,
   all three priorities; ``torch.equal`` on the whole state after the
   in-place write;
4. the main path: ``repro_torch.mis2`` and ``repro_torch.coarsen(method=
   "two_phase")`` with ``engine=None`` on laplace3d(8), Laplace3D_100 and
   Elasticity3D_60, asserting the reference's digests, sizes and iteration
   counts, the ``cuda_resident`` engine, one launch of each kernel per
   MIS-2 round, and the ``dense`` engine's equal digest on the card;
5. time each kernel (CUDA events, cold L2, state restored between launches)
   and its twin at the main path's round-0 shapes beside the bytes bound,
   and the end-to-end ``mis2`` / ``coarsen`` wall times.

Prints JSON lines, the kernel table, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet

# the reference's anchors (the JAX package, compacted_resident engine)
ANCHORS = {
    "laplace3d(8)": dict(n=8, kind="laplace3d", digest=None,
                         mis2=(55, 6, "4dfc7dee5f0f7c7f"),
                         coarsen=(82, None, "dfda3c0aa9776009")),
    "Laplace3D_100": dict(n=100, kind="laplace3d", digest="80bd83539a0c899d",
                          entries=6_940_000,
                          mis2=(90_207, 10, "2dbbb0f6ed5c9ac0"),
                          coarsen=(147_865, 18, "e11aa9fbaab77f88")),
    "Elasticity3D_60": dict(n=60, kind="elasticity3d",
                            digest="810c4e3742f42ece", entries=50_757_768,
                            mis2=(4_878, 10, "ef26deaefd9afee5"),
                            coarsen=(9_434, 20, "aa49f95af32b7e4f")),
}
PAPER_GRAPHS = ("Laplace3D_100", "Elasticity3D_60")
KERNELS = {
    "fused_refresh_columns": "src/repro/kernels/minprop_ell/kernel.py:216",
    "fused_decide": "src/repro/kernels/minprop_ell/kernel.py:254",
}
SOURCE = "src/repro_torch/kernels/csrc/minprop_ell.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch as rt
    from repro_torch.core.tuples import id_bits
    from repro_torch.kernels import _build
    from repro_torch.kernels.minprop_ell import ops, ref

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()}})
    for log in _build.BUILD_LOGS.values():     # registers, spills
        for ln in log.splitlines():
            if "ptxas" in ln:
                print(ln)

    # -- graphs -----------------------------------------------------------------
    graphs = {}
    for label, a in ANCHORS.items():
        t0 = time.perf_counter()
        gen = getattr(rt.graphs, a["kind"])
        g = rt.Graph(gen(a["n"]), device=dev)
        ell = g.ell
        gen_s = time.perf_counter() - t0
        if a["digest"] is not None:
            check(g.digest == a["digest"],
                  f"{label}: graph digest {g.digest} != {a['digest']}")
            check(g.num_entries == a["entries"],
                  f"{label}: {g.num_entries} entries != {a['entries']}")
        graphs[label] = g
        emit({"phase": "graph", "graph": label, "V": g.num_vertices,
              "entries": g.num_entries, "ell_width": ell.width,
              "digest": g.digest, "setup_s": gen_s})

    # -- 3. kernels against their twins ------------------------------------------
    rng = np.random.default_rng(20221)
    errs = {k: 0 for k in KERNELS}
    checks = 0
    for label in PAPER_GRAPHS:
        ell = graphs[label].ell
        v = ell.num_vertices
        nbrs_flat = ell.neighbors.reshape(-1)
        b = id_bits(v)
        t_np = rng.integers(1, 2**32 - 1, size=v, dtype=np.uint32)
        t_np[rng.random(v) < 0.1] = 0
        t_np[rng.random(v) < 0.1] = 0xFFFFFFFF
        m_np = rng.integers(0, 2**32, size=v, dtype=np.uint32)
        act_np = rng.random(v) < 0.9
        count = int(v * 0.6)
        wl_np = rng.permutation(v).astype(np.int32)   # real rows past count
        wl_np[rng.random(v) < 0.05] = v               # sentinels inside
        t = torch.from_numpy(t_np.view(np.int32)).to(dev)
        m = torch.from_numpy(m_np.view(np.int32)).to(dev)
        active = torch.from_numpy(act_np).to(dev)
        wl = torch.from_numpy(wl_np).to(dev)
        cnt = torch.tensor([count], dtype=torch.int32, device=dev)
        for priority in ("xorshift_star", "xorshift", "fixed"):
            it = torch.tensor([int(rng.integers(0, 12))], dtype=torch.int32,
                              device=dev)
            kw = dict(priority=priority, b=b)
            mk, mr = m.clone(), m.clone()
            ops.fused_refresh_columns(t, mk, nbrs_flat, wl, cnt, it, **kw)
            ref.fused_refresh_columns_ref(t, mr, nbrs_flat, wl, cnt, it, **kw)
            torch.cuda.synchronize()
            check(torch.equal(mk, mr), f"fused_refresh_columns != twin "
                  f"({label}, {priority})")
            check(not torch.equal(mk, m), "fused_refresh_columns wrote nothing")
            errs["fused_refresh_columns"] = max(
                errs["fused_refresh_columns"], _max_abs_err(mk, mr))
            tk, tr = t.clone(), t.clone()
            ops.fused_decide(tk, mk, active, nbrs_flat, wl, cnt, it, **kw)
            ref.fused_decide_ref(tr, mk, active, nbrs_flat, wl, cnt, it, **kw)
            torch.cuda.synchronize()
            check(torch.equal(tk, tr), f"fused_decide != twin "
                  f"({label}, {priority})")
            check(not torch.equal(tk, t), "fused_decide wrote nothing")
            errs["fused_decide"] = max(errs["fused_decide"],
                                       _max_abs_err(tk, tr))
            checks += 2
    emit({"phase": "kernels_vs_twins", "checks": checks, "max_abs_err": errs})

    # -- 4. the main path ---------------------------------------------------------
    ops.reset_launches()
    main_path = {}
    for label, a in ANCHORS.items():
        g = graphs[label]
        before = dict(ops.LAUNCHES)
        r = rt.mis2(g)
        after_mis2 = dict(ops.LAUNCHES)
        agg = rt.coarsen(g, method="two_phase")
        after_coarsen = dict(ops.LAUNCHES)
        size, iters, digest = a["mis2"]
        check(r.engine == "cuda_resident", f"{label}: engine {r.engine}")
        check((r.size, r.iterations, r.digest) == (size, iters, digest),
              f"{label}: mis2 {(r.size, r.iterations, r.digest)} != "
              f"{(size, iters, digest)}")
        check(r.converged, f"{label}: mis2 did not converge")
        nagg, agg_iters, agg_digest = a["coarsen"]
        check((agg.num_aggregates, agg.digest) == (nagg, agg_digest),
              f"{label}: coarsen {(agg.num_aggregates, agg.digest)} != "
              f"{(nagg, agg_digest)}")
        check(agg_iters is None or agg.iterations == agg_iters,
              f"{label}: coarsen MIS-2 iterations {agg.iterations} != "
              f"{agg_iters}")
        check(agg.engine == "cuda_resident", f"{label}: {agg.engine}")
        for k in KERNELS:
            check(after_mis2[k] - before[k] == r.iterations,
                  f"{label}: {k} launched {after_mis2[k] - before[k]} times "
                  f"in {r.iterations} rounds")
            check(after_coarsen[k] - after_mis2[k] == agg.iterations,
                  f"{label}: {k} launched {after_coarsen[k] - after_mis2[k]}"
                  f" times in coarsen's {agg.iterations} rounds")
        main_path[label] = {
            "mis2": {"size": r.size, "iterations": r.iterations,
                     "digest": r.digest, "host_syncs": r.host_syncs,
                     "first_call_s": r.wall_time_s},
            "coarsen": {"aggregates": agg.num_aggregates,
                        "mis2_iterations": agg.iterations,
                        "digest": agg.digest, "first_call_s": agg.wall_time_s},
        }
    launches = dict(ops.LAUNCHES)
    for k in KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for label in ANCHORS:
        rd = rt.mis2(graphs[label], engine="dense")
        check(rd.digest == ANCHORS[label]["mis2"][2],
              f"{label}: dense digest {rd.digest}")
        main_path[label]["dense_digest"] = rd.digest
    emit({"phase": "main_path", "launches": launches, "graphs": main_path})

    # -- 5. timing ------------------------------------------------------------------
    timing = {}
    for label in PAPER_GRAPHS:
        timing[label] = _time_kernels(torch, graphs[label], ops, ref, id_bits)
        e2e = {}
        for what, call in (("mis2", lambda g=graphs[label]: rt.mis2(g)),
                           ("coarsen", lambda g=graphs[label]: rt.coarsen(
                               g, method="two_phase"))):
            walls, res = [], None
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            e2e[what] = {"wall_ms": walls, "iterations": res.iterations}
            if what == "mis2":
                e2e[what]["host_syncs"] = res.host_syncs
        timing[label]["end_to_end"] = e2e
        emit({"phase": "timing", "graph": label, **timing[label]})

    kernels_line = []
    for k in KERNELS:
        main = timing["Elasticity3D_60"][k]
        kernels_line.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": "Elasticity3D_60 round 0",
            "by_graph": {g: timing[g][k] for g in PAPER_GRAPHS},
        })
    emit({"kernels": kernels_line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def _max_abs_err(a, b) -> int:
    import torch

    wa = a.to(torch.int64) & 0xFFFFFFFF
    wb = b.to(torch.int64) & 0xFFFFFFFF
    return int((wa - wb).abs().max().item())


def _time_kernels(torch, g, ops, ref, id_bits, reps: int = 50,
                  plain_reps: int = 5) -> dict:
    """Each kernel and its twin at the resident loop's round-0 state: every
    row live, every tuple undecided.  Each launch is timed alone with CUDA
    events, after the state it writes is restored and the L2 cache is
    flushed (a 256 MB write), so every launch sees the same inputs cold."""
    ell = g.ell
    v, d = ell.neighbors.shape
    dev = ell.neighbors.device
    nbrs_flat = ell.neighbors.reshape(-1)
    b = id_bits(v)
    kw = dict(priority="xorshift_star", b=b)
    t0 = torch.ones(v, dtype=torch.int32, device=dev)
    m0 = torch.full((v,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(v, dtype=torch.bool, device=dev)
    wl = torch.arange(v, dtype=torch.int32, device=dev)
    cnt = torch.full((1,), v, dtype=torch.int32, device=dev)
    it = torch.zeros(1, dtype=torch.int32, device=dev)
    m_ready = m0.clone()
    ops.fused_refresh_columns(t0, m_ready, nbrs_flat, wl, cnt, it, **kw)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)

    def timed(fn, restore, n):
        evs = []
        for _ in range(n):
            restore()
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            evs.append((e0, e1))
        torch.cuda.synchronize()
        times = sorted(e0.elapsed_time(e1) for e0, e1 in evs)
        return times[len(times) // 2]

    m = m0.clone()
    t = t0.clone()
    # distinct neighbour words a round-0 pass reads (every row is live)
    n_distinct = int(torch.unique(nbrs_flat).numel())
    ids = 4 * v * d
    out = {}
    # refresh: wl + ids + T at distinct neighbours + M written + count, it
    refresh_bytes = 4 * v + ids + 4 * n_distinct + 4 * v + 8
    # decide: wl + ids + own T + M, active at distinct neighbours + T written
    decide_bytes = 4 * v + ids + 4 * v + 5 * n_distinct + 4 * v + 8
    cases = {
        "fused_refresh_columns": (
            lambda: ops.fused_refresh_columns(t0, m, nbrs_flat, wl, cnt, it,
                                              **kw),
            lambda: ref.fused_refresh_columns_ref(t0, m, nbrs_flat, wl, cnt,
                                                  it, **kw),
            lambda: m.copy_(m0), refresh_bytes),
        "fused_decide": (
            lambda: ops.fused_decide(t, m_ready, active, nbrs_flat, wl, cnt,
                                     it, **kw),
            lambda: ref.fused_decide_ref(t, m_ready, active, nbrs_flat, wl,
                                         cnt, it, **kw),
            lambda: t.copy_(t0), decide_bytes),
    }
    for k, (kernel, twin, restore, nbytes) in cases.items():
        timed(kernel, restore, 3)             # warm-up
        ms = timed(kernel, restore, reps)
        plain_ms = timed(twin, restore, plain_reps)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bytes": nbytes, "V": v, "D": d,
                  "bound_share": bound_ms / ms}
    return out


if __name__ == "__main__":
    sys.exit(main())
