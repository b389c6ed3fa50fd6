#!/usr/bin/env python3
"""The JAX package's distance-k MIS and multilevel partition on one
Laplace3D graph: the anchors that ``chip_smoke.py`` holds the port's
``misk`` and ``partition`` to (``MISK_L100``, ``PARTITION_L100``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/reference_misk_partition.py \
        [--n 100] [--k 1 2 3] [--parts 8] [--engines dense resident]

``repro.misk(laplace3d(n), k=k, engine=e)`` for each k and engine, then
``repro.partition(laplace3d(n), parts)`` (the ``multilevel`` engine, MIS-2
by ``compacted``).  Prints one JSON line: per k and engine the set size,
the rounds, ``converged`` and the digest; the partition's edge cut,
levels, history ``(V, E)`` per coarse level and parts digest; and the
seconds of each call.
"""
from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    import repro
    from repro.graphs import laplace3d

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--engines", nargs="+", default=["dense"],
                    choices=("dense", "resident"))
    args = ap.parse_args()
    g = repro.Graph(laplace3d(args.n))
    misk = {}
    for k in args.k:
        for engine in args.engines:
            t0 = time.perf_counter()
            r = repro.misk(g, k=k, engine=engine)
            misk[f"k={k} {engine}"] = dict(
                size=r.size, iterations=r.iterations,
                converged=r.converged, digest=r.digest,
                seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    p = repro.partition(g, args.parts)
    part = dict(num_parts=p.num_parts, edge_cut=p.edge_cut, levels=p.levels,
                history=[list(h) for h in p.history], digest=p.digest,
                converged=p.converged, seconds=time.perf_counter() - t0)
    print(json.dumps({"graph": f"laplace3d({args.n})",
                      "V": g.num_vertices, "misk": misk,
                      "partition": part}), flush=True)


if __name__ == "__main__":
    main()
