#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one GPU.

    python3 tools/profile_torch.py [--graphs Laplace3D_100 Elasticity3D_60
                                          Powerlaw_1M Fleet_A Fleet_B]
                                   [--calls mis2 coarsen]

For each graph: one warm ``repro_torch.mis2`` and one warm
``repro_torch.coarsen(method="two_phase")`` are timed on the host clock
(ending in ``torch.cuda.synchronize()``) and then traced once with
``torch.profiler`` (CPU + CUDA), and so are the host-driven engines
(``mis2`` with ``engine="cuda_compacted"`` and ``"compacted"``) on the two
paper graphs.  On Laplace3D_100 the same is done for one
AMG-preconditioned CG solve (``amg_setup`` once, untimed; tol 1e-6,
``b = default_rng(0).standard_normal(V)``), and on Elasticity3D_60 for one
cluster-GS-preconditioned CG solve (``cluster_gs_setup`` once, untimed;
the same tol and b); on Powerlaw_1M
(``powerlaw_graph(1_000_000, 8.0, exponent=2.5, seed=42)``, where
``engine=None`` takes the hybrid layout) for ``coarsen(method="basic")``
and ``color(engine="luby_hybrid")`` too; the setups themselves, with
``engine=None`` (the ``resident`` multilevel engine on the card), as
``amg_setup`` and ``gs_setup`` (``cluster_gs_setup``) on both paper
graphs; and, on the two paper graphs, ``misk`` (k = 2, the
``dense`` engine ``engine=None`` takes) and ``partition(g, 8)`` (the
multilevel partition, its coarsening on the persistent MIS-2 kernel); on
Laplace3D_100 one streaming delta a call too (``repair``: a
``StreamSession``'s ``apply_delta`` of ``chip_smoke.py``'s ``STREAM``
size, 100 edges added and 100 removed, a new seeded delta each call).  The two
batch fleets of ``chip_smoke.py`` (``Fleet_A``, the reference's batch
benchmark; ``Fleet_B``, 128 subdomains) are profiled through
``mis2_batch``, ``coarsen_batch`` (``two_phase``), ``coarsen_batch_basic``
and ``color_batch`` on one ``GraphBatch`` each.  Prints one JSON line per call
with the device time by kernel name (top entries, and every kernel of the
port's ``csrc/``), the summed device time, the device span of each setup
phase (``setup_range_device_ms``),
the unprofiled wall time, the device's idle share of it and the traced
call's peak device memory.  ``--calls``
keeps only the named calls (``mis2``, ``coarsen``, ``mis2_cuda_compacted``,
``mis2_compacted``, ``amg_cg``, ``gs_cg``, ``amg_setup``, ``gs_setup``,
``coarsen_basic``, ``color``, ``misk``, ``partition``, ``repair``,
``mis2_batch``, ``coarsen_batch``, ``coarsen_batch_basic``,
``color_batch``),
and skips the setups of the others.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRAPHS = {"Laplace3D_100": ("laplace3d", (100,), {}),
          "Elasticity3D_60": ("elasticity3d", (60,), {}),
          "Powerlaw_1M": ("powerlaw_graph", (1_000_000, 8.0),
                          {"exponent": 2.5, "seed": 42})}
FLEETS = ("Fleet_A", "Fleet_B")
# the resident multilevel setup's profiler ranges (multilevel.prolongator,
# .galerkin, .pack, .coarse_graph): the trace times each on the device too,
# as a span over its kernels, so it is reported apart, not summed with them
SETUP_RANGE = "multilevel."


def _wall_ms(torch, call, reps: int = 5) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _device_us(e) -> float:
    """Device time of a device-side event (a kernel or a copy); 0 for the
    host-side operator that launched it, whose device time would count the
    same kernels twice."""
    from torch.autograd import DeviceType

    if e.device_type != DeviceType.CUDA:
        return 0.0
    return float(getattr(e, "self_device_time_total", 0.0)
                 or getattr(e, "self_cuda_time_total", 0.0))


def profile_call(torch, call, top: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    walls = sorted(_wall_ms(torch, call))
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    averages = [e for e in prof.key_averages() if _device_us(e) > 0]
    rows = sorted(((e.key, _device_us(e), e.count) for e in averages
                   if not e.key.startswith(SETUP_RANGE)),
                  key=lambda r: -r[1])
    ranges = {e.key: _device_us(e) / 1e3 for e in averages
              if e.key.startswith(SETUP_RANGE)}
    device_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = walls[len(walls) // 2]
    return {"wall_ms": walls, "device_ms": device_ms,
            "setup_range_device_ms": ranges or None,
            "device_events": sum(r[2] for r in rows),
            "idle_share": 1.0 - device_ms / wall_ms if rows else None,
            "peak_memory_bytes": peak,
            "kernels": [{"name": k[:96], "device_ms": us / 1e3, "count": n}
                        for k, us, n in rows[:top]],
            "port_kernels": [{"name": k[:96], "device_ms": us / 1e3,
                              "count": n}
                             for k, us, n in rows if "repro_torch" in k]}


def _cg(torch, rt, g, setup):
    """One CG solve on ``g`` preconditioned by ``setup(g)``, which runs
    once, here, outside every timed or traced window."""
    import numpy as np

    s = setup(g)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        g.num_vertices).astype(np.float32)).to(g.device)
    a = g.ell_matrix
    return lambda: rt.solvers.cg(lambda x: rt.graphs.ops.spmv_ell(a, x), b,
                                 precond=s.as_precond(), tol=1e-6)


def _repair(rt, g):
    """A call that applies one new seeded delta to a streaming session on
    ``g`` (its fixed point the warm-started repair)."""
    import numpy as np

    from repro_torch.serve import StreamSession

    sess = StreamSession(g.csr)
    v = g.num_vertices
    rng = np.random.default_rng(23)

    def call():
        adds = rng.integers(0, v, size=(100, 2))
        rows, cols = sess._keys // v, sess._keys % v
        offd = np.flatnonzero(rows != cols)
        pick = rng.choice(offd, size=100, replace=False)
        return sess.apply_delta(adds[adds[:, 0] != adds[:, 1]],
                                np.stack([rows[pick], cols[pick]], axis=1))

    return call


def _profile_fleet(torch, rt, label: str, wanted) -> None:
    """The batched calls on one of ``chip_smoke.py``'s fleets, stacked
    once into a ``GraphBatch``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda")
    graphs = chip_smoke.fleet_a(rt, dev)[0] if label == "Fleet_A" \
        else chip_smoke.fleet_b(rt, dev)
    batch = rt.GraphBatch(graphs)
    calls = {"mis2_batch": lambda: rt.mis2_batch(batch),
             "coarsen_batch": lambda: rt.coarsen_batch(batch),
             "coarsen_batch_basic": lambda: rt.coarsen_batch(
                 batch, method="basic"),
             "color_batch": lambda: rt.color_batch(batch)}
    for what, call in calls.items():
        if wanted is not None and what not in wanted:
            continue
        call()                                      # warm-up
        rec = {"graph": label, "call": what, "graphs": len(graphs),
               "bucket_shapes": batch.bucket_shapes,
               **profile_call(torch, call)}
        print(json.dumps(rec), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", nargs="+", default=list(GRAPHS),
                    choices=[*GRAPHS, *FLEETS])
    ap.add_argument("--calls", nargs="+", default=None)
    args = ap.parse_args()
    wanted = args.calls
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    for label in args.graphs:
        if label in FLEETS:
            _profile_fleet(torch, rt, label, wanted)
            continue
        kind, gen_args, kw = GRAPHS[label]
        g = rt.Graph(getattr(rt.graphs, kind)(*gen_args, **kw))
        calls = {"mis2": lambda: rt.mis2(g),
                 "coarsen": lambda: rt.coarsen(g, method="two_phase")}
        if label != "Powerlaw_1M":
            for engine in ("cuda_compacted", "compacted"):
                calls[f"mis2_{engine}"] = \
                    lambda e=engine: rt.mis2(g, engine=e)
        # the solves' setups run when the call is first made, below
        if label == "Laplace3D_100":
            calls["amg_cg"] = lambda: _cg(torch, rt, g, rt.amg_setup)
        if label == "Elasticity3D_60":
            calls["gs_cg"] = lambda: _cg(torch, rt, g, rt.cluster_gs_setup)
        if label != "Powerlaw_1M":
            calls["gs_setup"] = lambda: rt.cluster_gs_setup(g)
            calls["amg_setup"] = lambda: rt.amg_setup(g)
            calls["misk"] = lambda: rt.misk(g, k=2)
            calls["partition"] = lambda: rt.partition(g, 8)
        if label == "Laplace3D_100" and (wanted is None
                                         or "repair" in wanted):
            calls["repair"] = _repair(rt, g)
        if label == "Powerlaw_1M":
            calls["coarsen_basic"] = lambda: rt.coarsen(g, method="basic")
            calls["color"] = lambda: rt.color(g, engine="luby_hybrid")
        for what, call in calls.items():
            if wanted is not None and what not in wanted:
                continue
            if what.endswith("_cg"):
                call = call()
            call()                                  # warm-up: ELL, kernels
            rec = {"graph": label, "call": what, **profile_call(torch, call)}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
