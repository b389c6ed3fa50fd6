#!/usr/bin/env python3
"""The JAX package's batched pipelines on the fleet of its own batch
benchmark: the anchors that ``chip_smoke.py`` holds the port's batched
calls to (``FLEET_A``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_batch.py \
        [--quick] [--calls mis2 color coarsen_two_phase coarsen_basic amg_setup]

The fleet is ``benchmarks/batch_throughput.py``'s (``quick=False``): the
structures of ``laplace3d(6, 8, 10, 12)`` and ``random_uniform_graph(n,
6.0, seed=s)`` for n in 1,000 / 2,000 / 5,000 / 10,000, four copies each,
seeds 0-15 in that order (``--quick``: its quick fleet).  Runs
``mis2_batch``, ``color_batch``, ``coarsen_batch`` (``two_phase`` and
``basic``) on the structures, and ``amg_setup_batch(engine="host")`` on the
same fleet as matrices (``laplace3d(m)`` with its values,
``er_laplacian(n, 6.0, seed=s)`` for each random graph) as far as the
reference can build the hierarchies: the meshes and the first size's
copies.  Past that its two-phase coarsening of the coarse levels, whose
rows are hundreds wide, does not return (``_phase3_resident``, ROADMAP
Queue 3; ``er_laplacian(2000, ...)`` had not after 240 s).  ``--calls``
keeps the named calls.  Prints one JSON line a call as it ends: the pipeline, its
anchor (:func:`fleet_anchor` of the ordered member digests, or of the
members' level digests, and the bucket shapes), the member digests,
iterations or rounds, ``converged``, and the seconds of the call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

FULL = dict(meshes=(6, 8, 10, 12), ns=(1_000, 2_000, 5_000, 10_000),
            copies=4)
QUICK = dict(meshes=(4, 5, 6), ns=(200, 400, 700), copies=2)


def amg_members(meshes, ns, copies) -> int:
    """The fleet's leading members whose AMG hierarchy the reference
    builds: the meshes and the first size's copies."""
    return len(meshes) + copies


def fleet_anchor(members: list, bucket_shapes: list) -> str:
    """One digest over the ordered per-member digests (strings, or lists of
    level digests) and the bucket shapes; ``chip_smoke.py`` computes the
    same."""
    text = json.dumps([members, [list(s) for s in bucket_shapes]])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def fleet_specs(meshes, ns, copies) -> list:
    """``[(kind, size, seed)]`` in the benchmark's order."""
    specs = [("laplace3d", m, None) for m in meshes]
    seeds = iter(range(len(ns) * copies))
    specs += [("random", n, next(seeds)) for n in ns for _ in range(copies)]
    return specs


def main() -> None:
    import repro
    from repro.graphs import er_laplacian, laplace3d, random_uniform_graph

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--calls", nargs="+", default=None)
    args = ap.parse_args()
    fleet = QUICK if args.quick else FULL
    specs = fleet_specs(**fleet)
    graphs = [repro.Graph(laplace3d(m).graph) if kind == "laplace3d"
              else repro.Graph(random_uniform_graph(m, 6.0, seed=s))
              for kind, m, s in specs]
    mats = [repro.Graph(laplace3d(m)) if kind == "laplace3d"
            else repro.Graph(er_laplacian(m, 6.0, seed=s))
            for kind, m, s in specs]
    calls = {
        "mis2": lambda: repro.mis2_batch(graphs),
        "color": lambda: repro.color_batch(graphs),
        "coarsen_two_phase": lambda: repro.coarsen_batch(
            graphs, method="two_phase"),
        "coarsen_basic": lambda: repro.coarsen_batch(graphs, method="basic"),
        "amg_setup": lambda: repro.amg_setup_batch(
            mats[:amg_members(**fleet)], engine="host"),
    }
    for name, call in calls.items():
        if args.calls is not None and name not in args.calls:
            continue
        t0 = time.perf_counter()
        br = call()
        seconds = time.perf_counter() - t0
        members = [r.level_digests for r in br] if name == "amg_setup" \
            else br.digests
        out = dict(
            call=name, quick=args.quick,
            anchor=fleet_anchor(members, br.bucket_shapes),
            bucket_shapes=[list(s) for s in br.bucket_shapes],
            digests=members, iterations=[r.iterations for r in br],
            converged=[bool(r.converged) for r in br], seconds=seconds)
        if name == "amg_setup":
            out["level_sizes"] = [r.level_sizes for r in br]
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
